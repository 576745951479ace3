"""The hand-written CUDA kernels against their plain versions, on the card.

Needs a CUDA card and imports neither JAX nor the JAX package, so it runs
where the port runs:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py

Elsewhere every test skips."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention import ops, ref  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _paged(seed, B, num_blocks, bs, mb, Hkv, G, D, lens, dtype):
    """Random stores, permuted tables of distinct blocks (null block 0
    past each length), on the card."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, 1, Hkv * G, D).astype(np.float32)
    ks = rng.randn(num_blocks, bs, Hkv, D).astype(np.float32)
    vs = rng.randn(num_blocks, bs, Hkv, D).astype(np.float32)
    bt = rng.permutation(np.arange(1, num_blocks))[:B * mb].reshape(B, mb)
    bt = bt.astype(np.int32)
    lens = np.asarray(lens, np.int32)
    for b in range(B):
        bt[b, -(-int(lens[b]) // bs):] = 0
    dt = getattr(torch, dtype)
    q, ks, vs = (torch.from_numpy(a).cuda().to(dt) for a in (q, ks, vs))
    return q, ks, vs, torch.from_numpy(bt).cuda(), torch.from_numpy(lens).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,Hkv,G,D,atol,rtol", [
    ("float32", 4, 2, 32, 2e-5, 2e-5), ("float32", 8, 3, 128, 2e-5, 2e-5),
    ("bfloat16", 8, 3, 128, 4e-3, 2.0 ** -7)])
def test_cuda_kernel_matches_plain(cuda, dtype, Hkv, G, D, atol, rtol):
    """The paged decode kernel vs its plain version at the shapes of
    rhapsody-demo (f32) and llama3.2-3b (f32 and bf16); block-size edge
    lengths; relocating physical blocks changes no bit.  Both sides round
    bf16 outputs to bf16, so bf16 allows 4e-3 plus one bf16 ulp (2^-7) of
    the value."""
    bs, mb = 16, 6
    q, ks, vs, bt, lens = _paged(11, 6, 48, bs, mb, Hkv, G, D,
                                 [1, bs - 1, bs, bs + 1, mb * bs, 37], dtype)
    before = ops.launches
    out = ops.paged_decode_attention(q, ks, vs, bt, lens)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    B = q.shape[0]
    plain = ref.paged_decode_ref(q.reshape(B, Hkv, G, D), ks, vs, bt, lens)
    torch.testing.assert_close(out.float(), plain.reshape(out.shape).float(),
                               rtol=rtol, atol=atol)
    perm = torch.from_numpy(np.concatenate(
        [[0], 1 + np.random.RandomState(3).permutation(47)])).cuda()
    inv = torch.argsort(perm)
    moved = ops.paged_decode_attention(q, ks[inv].contiguous(),
                                       vs[inv].contiguous(),
                                       perm[bt.long()].to(torch.int32), lens)
    assert torch.equal(out, moved)


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_cannot_take(cuda):
    q, ks, vs, bt, lens = _paged(1, 2, 9, 8, 4, 2, 2, 16, [3, 9], "float32")
    before = ops.launches
    with pytest.raises(ValueError, match="head_dim"):
        ops.paged_decode_attention(q, ks, vs, bt, lens)  # D = 16
    q, ks, vs, bt, lens = _paged(1, 2, 9, 8, 4, 2, 2, 32, [3, 9], "float16")
    with pytest.raises(TypeError):
        ops.paged_decode_attention(q, ks, vs, bt, lens)
    assert ops.launches == before
