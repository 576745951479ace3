"""The port's paged flash-decode (``repro_torch.kernels.decode_attention``)
against the JAX package's Pallas kernel (interpret mode) and its
``paged_decode_ref`` oracle, on the cases of ``test_kernels.py``: ragged
lengths, permuted tables and block-size edges at 2e-5 (float32 sums taken
in another order), head_dim 8 and 16 included; physical relocation exactly
(atol 0).  ``ref.decode_split_ref``, the plain mirror of the CUDA
kernel's split of the sequence and its combine, against both oracles at
1e-6.  On the CPU the wrapper runs the plain version; the CUDA kernel is
held against it in ``test_torch_cuda.py`` and in ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.decode_attention.ops import (  # noqa: E402
    paged_decode_attention as jax_paged)
from repro.kernels.decode_attention.ref import (  # noqa: E402
    decode_ref as jax_decode_ref)
from repro.kernels.decode_attention.ref import (  # noqa: E402
    paged_decode_ref as jax_paged_ref)
from repro_torch.kernels.decode_attention import ops, ref  # noqa: E402

TOL = 2e-5


def _setup(seed, B, num_blocks, bs, mb, Hq, Hkv, D, *, permute=True,
           lens=None):
    """Random stores, tables of DISTINCT (optionally permuted) physical
    blocks, ragged lengths; logical blocks past each length point at the
    null block 0, as the engine guarantees."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, 1, Hq, D).astype(np.float32)
    ks = rng.randn(num_blocks, bs, Hkv, D).astype(np.float32)
    vs = rng.randn(num_blocks, bs, Hkv, D).astype(np.float32)
    perm = np.arange(1, num_blocks)
    if permute:
        perm = rng.permutation(perm)
    bt = perm[:B * mb].reshape(B, mb).astype(np.int32)
    if lens is None:
        lens = rng.randint(1, mb * bs + 1, size=B)
    lens = np.asarray(lens, np.int32)
    for b in range(B):
        bt[b, -(-int(lens[b]) // bs):] = 0
    return q, ks, vs, bt, lens


def _port(q, ks, vs, bt, lens):
    out = ops.paged_decode_attention(*(torch.from_numpy(a) for a in
                                       (q, ks, vs, bt, lens)))
    return out.numpy()


def _jax(q, ks, vs, bt, lens):
    B, _, Hq, D = q.shape
    Hkv = ks.shape[2]
    kern = jax_paged(*(jnp.asarray(a) for a in (q, ks, vs, bt, lens)),
                     interpret=True)
    oracle = jax_paged_ref(jnp.asarray(q[:, 0].reshape(B, Hkv, Hq // Hkv, D)),
                           jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(bt),
                           jnp.asarray(lens)).reshape(B, 1, Hq, D)
    return np.asarray(kern), np.asarray(oracle)


CASES = {
    "ragged_permuted": (5, 2, 17, 16, 4, 4, 2, 32),
    "small_blocks": (5, 3, 32, 8, 6, 8, 4, 16),
    "single_mha": (5, 1, 9, 32, 8, 2, 1, 64),
    "llama_group3": (6, 3, 40, 16, 8, 6, 2, 32),
    "head_dim_8_group3": (12, 3, 40, 16, 8, 6, 2, 8),
    "head_dim_16_group2": (13, 3, 40, 16, 8, 4, 2, 16),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_paged_decode_matches_reference(case):
    args = _setup(*CASES[case])
    out = _port(*args)
    kern, oracle = _jax(*args)
    np.testing.assert_allclose(out, kern, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out, oracle, rtol=TOL, atol=TOL)


def test_paged_decode_block_size_edges():
    """Lengths 1, bs-1, bs, bs+1 and full capacity all mask correctly."""
    bs, mb = 8, 4
    args = _setup(7, 5, 23, bs, mb, 4, 2, 16,
                  lens=[1, bs - 1, bs, bs + 1, mb * bs])
    out = _port(*args)
    kern, oracle = _jax(*args)
    np.testing.assert_allclose(out, kern, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out, oracle, rtol=TOL, atol=TOL)


def test_paged_decode_relocation_is_exact():
    """Physically relocating blocks (tables rewritten to match) leaves the
    output bit-for-bit unchanged."""
    q, ks, vs, bt, lens = _setup(8, 2, 11, 8, 4, 4, 2, 16, permute=False)
    out1 = _port(q, ks, vs, bt, lens)
    perm = np.concatenate([[0], 1 + np.random.RandomState(9).permutation(10)])
    inv = np.argsort(perm)
    out2 = _port(q, ks[inv], vs[inv], perm[bt].astype(np.int32), lens)
    np.testing.assert_allclose(out1, out2, rtol=0, atol=0)


def test_gather_kv_matches_reference():
    from repro.kernels.decode_attention.ref import gather_kv as jax_gather

    _, ks, _, bt, _ = _setup(3, 3, 20, 4, 5, 4, 2, 8)
    np.testing.assert_array_equal(
        ref.gather_kv(torch.from_numpy(ks), torch.from_numpy(bt)).numpy(),
        np.asarray(jax_gather(jnp.asarray(ks), jnp.asarray(bt))))


def _good():
    q, ks, vs, bt, lens = _setup(1, 2, 9, 8, 4, 4, 2, 16)
    return [torch.from_numpy(a) for a in (q, ks, vs, bt, lens)]


@pytest.mark.parametrize("bad", [
    "q_rank", "q_two_tokens", "store_mismatch", "head_dim", "lens_shape",
    "table_rows", "float_tables", "int64_lens", "mixed_dtype",
    "non_contiguous", "mixed_device", "meta_device"])
def test_wrapper_rejects_bad_inputs(bad):
    """The wrapper checks shapes, dtypes, contiguity and devices before it
    computes anything, on either path; on ``meta`` tensors (the dry-run)
    it returns an empty output and launches nothing."""
    q, ks, vs, bt, lens = _good()
    err = ValueError
    if bad == "q_rank":
        q = q[:, 0]
    elif bad == "q_two_tokens":
        q = torch.cat([q, q], dim=1)
    elif bad == "store_mismatch":
        vs = vs[:, :4]
    elif bad == "head_dim":
        q = q[..., :8].contiguous()
    elif bad == "lens_shape":
        lens = lens[:1]
    elif bad == "table_rows":
        bt = bt[:1]
    elif bad == "float_tables":
        bt, err = bt.float(), TypeError
    elif bad == "int64_lens":
        lens, err = lens.long(), TypeError
    elif bad == "mixed_dtype":
        ks, err = ks.double(), TypeError
    elif bad == "non_contiguous":
        ks = ks.transpose(0, 1).contiguous().transpose(0, 1)
        vs = ks
    elif bad == "mixed_device":
        q = torch.empty(q.shape, device="meta")
    elif bad == "meta_device":  # accepted: shapes only, for the dry-run
        q, ks, vs, bt, lens = (torch.empty(t.shape, dtype=t.dtype,
                                           device="meta")
                               for t in (q, ks, vs, bt, lens))
        err = None
    before = ops.launches
    if err is None:
        out = ops.paged_decode_attention(q, ks, vs, bt, lens)
        assert (out.device.type, out.shape, out.dtype) == (
            "meta", q.shape, q.dtype)
    else:
        with pytest.raises(err):
            ops.paged_decode_attention(q, ks, vs, bt, lens)
    assert ops.launches == before


def test_cpu_path_does_not_count_launches():
    before = ops.launches
    ops.paged_decode_attention(*_good())
    assert ops.launches == before


@pytest.mark.parametrize("splits", [1, 2, 3, 8])
@pytest.mark.parametrize("tile", [8, 16, 32])
def test_split_and_combine_matches_the_oracles(splits, tile):
    """The kernel's algebra: each rank's (m, l, acc) over an even,
    tile-aligned share of the valid positions, combined in rank order,
    equals the one-pass softmax of ``ref.decode_ref`` and of the JAX
    package's oracle (float32, 1e-6), at the kernel's tiles of 8 (float32
    D 192), 16 and 32 positions, with length 1, lengths at the tile
    and split edges, ranks left empty and a length past the cache."""
    rng = np.random.RandomState(40 + splits)
    S, Hkv, G, D = 200, 2, 3, 16
    lens = np.asarray([1, tile - 1, tile, tile + 1, 2 * tile + 1,
                       tile * splits, tile * splits + 1, S, S + 250],
                      np.int32)
    B = len(lens)
    q = rng.randn(B, Hkv, G, D).astype(np.float32)
    kc = rng.randn(B, S, Hkv, D).astype(np.float32)
    vc = rng.randn(B, S, Hkv, D).astype(np.float32)
    t = [torch.from_numpy(a) for a in (q, kc, vc, lens)]
    got = ref.decode_split_ref(*t, splits, tile=tile).numpy()
    np.testing.assert_allclose(got, ref.decode_ref(*t).numpy(), rtol=1e-6,
                               atol=1e-6)
    want = np.asarray(jax_decode_ref(*(jnp.asarray(a)
                                       for a in (q, kc, vc, lens))))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
