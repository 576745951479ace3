"""The plain versions of the port's chunked WKV6, chunked Mamba2 SSD and
contiguous flash-decode kernels against the JAX package's Pallas kernels
in interpret mode, on the shapes of ``test_kernels.py`` and at its
tolerances (rtol 2e-4 / atol 1e-4 for the scans, 2e-5 for decode), plus a
ragged T for WKV and a chunk as long as the sequence for SSD; the final
states against the reference's ``wkv_chunked`` / ``ssd_chunked`` from a
non-zero initial state.  On the CPU each wrapper runs its plain version;
the CUDA kernels are held against them in ``test_torch_cuda.py`` and in
``chip_smoke.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.decode_attention.ops import (  # noqa: E402
    decode_attention as jax_decode)
from repro.kernels.mamba2.ops import ssd as jax_ssd  # noqa: E402
from repro.kernels.rwkv6.ops import wkv as jax_wkv  # noqa: E402
from repro.models.mamba2 import ssd_chunked  # noqa: E402
from repro.models.rwkv6 import wkv_chunked  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.kernels.mamba2 import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.rwkv6 import ops as wkv_ops  # noqa: E402

SCAN_TOL = dict(rtol=2e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _wkv_inputs(seed, B, T, H, hd):
    rng = np.random.RandomState(seed)
    r, k, v = (rng.randn(B, T, H, hd).astype(np.float32) for _ in range(3))
    lw = -np.exp(rng.randn(B, T, H, hd).astype(np.float32) - 1.0)
    u = (rng.randn(H, hd) * 0.1).astype(np.float32)
    s0 = (rng.randn(B, H, hd, hd) * 0.1).astype(np.float32)
    return r, k, v, lw, u, s0


@pytest.mark.parametrize("B,T,H,hd,chunk", [
    (2, 64, 3, 16, 16), (1, 96, 2, 32, 32), (2, 128, 4, 8, 32)])
def test_wkv_plain_matches_pallas_kernel(B, T, H, hd, chunk):
    r, k, v, lw, u, _ = _wkv_inputs(2, B, T, H, hd)
    ref = jax_wkv(*(jnp.asarray(a) for a in (r, k, v, lw, u)), chunk=chunk,
                  interpret=True)
    y, _ = wkv_ops.wkv(*(_t(a) for a in (r, k, v, lw, u)), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), **SCAN_TOL)


@pytest.mark.parametrize("T", [8, 37, 50, 64])
def test_wkv_state_matches_reference_chunked(T):
    """A T that is no multiple of the chunk (16) is padded by the wrapper
    and cut back; y and the final state from a non-zero s0."""
    r, k, v, lw, u, s0 = _wkv_inputs(3, 2, T, 2, 8)
    jy, js = wkv_chunked(*(jnp.asarray(a) for a in (r, k, v, lw, u)), 16,
                         s0=jnp.asarray(s0))
    before = wkv_ops.launches
    y, s = wkv_ops.wkv(*(_t(a) for a in (r, k, v, lw, u)), chunk=16,
                       s0=_t(s0))
    assert wkv_ops.launches == before  # the CPU runs the plain version
    assert tuple(y.shape) == (2, T, 2, 8)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **SCAN_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **SCAN_TOL)


def _ssd_inputs(seed, B, T, H, P, N):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, H, P).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(B, T, H))).astype(np.float32)
    A = -np.exp(rng.randn(H)).astype(np.float32)
    Bm = rng.randn(B, T, N).astype(np.float32)
    Cm = rng.randn(B, T, N).astype(np.float32)
    h0 = (rng.randn(B, H, N, P) * 0.1).astype(np.float32)
    return x, dt, A, Bm, Cm, h0


@pytest.mark.parametrize("B,T,H,P,N,chunk", [
    (2, 64, 3, 8, 4, 16), (1, 128, 4, 16, 8, 32), (2, 96, 2, 32, 16, 32),
    (1, 37, 2, 8, 4, 37)])
def test_ssd_plain_matches_pallas_kernel(B, T, H, P, N, chunk):
    x, dt, A, Bm, Cm, _ = _ssd_inputs(3, B, T, H, P, N)
    ref = jax_ssd(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)),
                  chunk=chunk, interpret=True)
    y, _ = ssd_ops.ssd(*(_t(a) for a in (x, dt, A, Bm, Cm)), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), **SCAN_TOL)


@pytest.mark.parametrize("T,chunk", [(16, 16), (48, 16), (12, 16)])
def test_ssd_state_matches_reference_chunked(T, chunk):
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(4, 2, T, 3, 8, 4)
    jy, jh = ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)),
                         chunk, h0=jnp.asarray(h0))
    y, h = ssd_ops.ssd(*(_t(a) for a in (x, dt, A, Bm, Cm)), chunk=chunk,
                       h0=_t(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **SCAN_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **SCAN_TOL)


def test_ssd_raises_on_a_ragged_length_as_the_reference():
    x, dt, A, Bm, Cm, _ = _ssd_inputs(5, 1, 20, 2, 8, 4)
    with pytest.raises(ValueError, match="not divisible"):
        ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)), 16)
    with pytest.raises(ValueError, match="not divisible"):
        ssd_ops.ssd(*(_t(a) for a in (x, dt, A, Bm, Cm)), chunk=16)


@pytest.mark.parametrize("B,S,Hq,Hkv,D,bk", [
    (2, 256, 4, 2, 32, 64), (3, 128, 8, 4, 16, 128), (1, 512, 2, 1, 64, 256),
    (2, 128, 6, 2, 8, 64), (2, 64, 2, 2, 16, 64)])
def test_decode_plain_matches_pallas_kernel(B, S, Hq, Hkv, D, bk):
    ks = jax.random.split(jax.random.PRNGKey(1), 4)
    q = jax.random.normal(ks[0], (B, 1, Hq, D))
    kc = jax.random.normal(ks[1], (B, S, Hkv, D))
    vc = jax.random.normal(ks[2], (B, S, Hkv, D))
    lens = jax.random.randint(ks[3], (B,), 1, S + 1)
    ref = jax_decode(q, kc, vc, lens, block_k=bk, interpret=True)
    before = da_ops.contiguous_launches
    out = da_ops.decode_attention(
        *(_t(np.asarray(a)) for a in (q, kc, vc)),
        _t(np.asarray(lens, np.int32)))
    assert da_ops.contiguous_launches == before
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("bad", ["lw_bf16", "u_shape", "s0_shape",
                                 "mixed_device", "non_contiguous"])
def test_wkv_wrapper_rejects_bad_inputs(bad):
    r, k, v, lw, u, s0 = (_t(a) for a in _wkv_inputs(6, 1, 8, 2, 8))
    err = ValueError
    if bad == "lw_bf16":
        lw, err = lw.to(torch.bfloat16), TypeError
    elif bad == "u_shape":
        u = u[:1]
    elif bad == "s0_shape":
        s0 = s0[..., :4]
    elif bad == "mixed_device":
        r = torch.empty(r.shape, device="meta")
    elif bad == "non_contiguous":
        k = k.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(err):
        wkv_ops.wkv(r, k, v, lw, u, chunk=8, s0=s0)


@pytest.mark.parametrize("bad", ["dt_shape", "A_bf16", "B_dtype",
                                 "h0_shape", "meta_device"])
def test_ssd_wrapper_rejects_bad_inputs(bad):
    x, dt, A, Bm, Cm, h0 = (_t(a) for a in _ssd_inputs(7, 1, 8, 2, 8, 4))
    err = ValueError
    if bad == "dt_shape":
        dt = dt[:, :4]
    elif bad == "A_bf16":
        A, err = A.to(torch.bfloat16), TypeError
    elif bad == "B_dtype":
        Bm, err = Bm.double(), TypeError
    elif bad == "h0_shape":
        h0 = h0[:, :1]
    elif bad == "meta_device":  # accepted: shapes only, for the dry-run
        x, dt, A, Bm, Cm, h0 = (torch.empty(t.shape, dtype=t.dtype,
                                            device="meta")
                                for t in (x, dt, A, Bm, Cm, h0))
        err = None
    before = ssd_ops.launches
    if err is None:
        y, h = ssd_ops.ssd(x, dt, A, Bm, Cm, chunk=8, h0=h0)
        assert (y.device.type, y.shape, h.shape, h.dtype) == (
            "meta", x.shape, h0.shape, torch.float32)
    else:
        with pytest.raises(err):
            ssd_ops.ssd(x, dt, A, Bm, Cm, chunk=8, h0=h0)
    assert ssd_ops.launches == before


def test_decode_wrapper_rejects_bad_inputs():
    rng = np.random.RandomState(8)
    q = _t(rng.randn(2, 1, 4, 16).astype(np.float32))
    kc = _t(rng.randn(2, 8, 2, 16).astype(np.float32))
    lens = torch.tensor([3, 9], dtype=torch.int32)
    with pytest.raises(ValueError, match="caches must be"):
        da_ops.decode_attention(q, kc[:1], kc[:1], lens)
    with pytest.raises(TypeError):
        da_ops.decode_attention(q, kc, kc, lens.long())
    with pytest.raises(ValueError):
        da_ops.decode_attention(q[..., :8], kc, kc, lens)
