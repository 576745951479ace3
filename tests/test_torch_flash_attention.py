"""The port's causal flash attention on the CPU against the JAX package's:
the plain forward against the Pallas kernel (interpret mode) and its
``attention_ref`` on the shapes of ``tests/test_kernels.py`` (f32 2e-5,
bf16 2e-2, the reference's own limits), the row logsumexp against
``jax.nn.logsumexp`` of the masked scores (2e-5), and the
``FlashAttention`` gradient against ``jax.grad`` of ``attention_ref``
(1e-4: float32 sums in another order).  Inputs are made with numpy from a
seed."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention as jax_flash)
from repro.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402

SHAPES = [  # B, S, Hq, Hkv, D, block_q, block_k (tests/test_kernels.py)
    (2, 128, 4, 2, 32, 32, 32),
    (1, 256, 2, 2, 64, 64, 128),
    (2, 64, 8, 2, 16, 64, 32),
    (1, 128, 4, 1, 32, 128, 64),
    (1, 128, 4, 4, 80, 64, 64),  # zamba2-2.7b's head_dim
]


def _inputs(seed, B, S, Hq, Hkv, D):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, S, Hq, D).astype(np.float32),
            rng.randn(B, S, Hkv, D).astype(np.float32),
            rng.randn(B, S, Hkv, D).astype(np.float32))


@jax.jit
def _jax_ref(q, k, v):
    """attention_ref on the model layout: repeat K/V, fold heads."""
    B, S, Hq, D = q.shape
    rep = Hq // k.shape[2]

    def bhsd(x):
        return jnp.transpose(x, (0, 2, 1, 3)).reshape(B * Hq, S, D)

    out = attention_ref(bhsd(q), bhsd(jnp.repeat(k, rep, 2)),
                        bhsd(jnp.repeat(v, rep, 2)), causal=True)
    return jnp.transpose(out.reshape(B, Hq, S, D), (0, 2, 1, 3))


@pytest.mark.parametrize("B,S,Hq,Hkv,D,bq,bk", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference_kernel_and_oracle(B, S, Hq, Hkv, D, bq,
                                                     bk, dtype):
    q, k, v = _inputs(0, B, S, Hq, Hkv, D)
    jq, jk, jv = (jnp.asarray(x, getattr(jnp, dtype)) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(x).to(getattr(torch, dtype))
                  for x in (q, k, v))
    out, lse = ref.attention_fwd_ref(tq, tk, tv)
    assert out.dtype == tq.dtype and lse.dtype == torch.float32
    assert tuple(lse.shape) == (B, Hq, S)
    tol = 2e-5 if dtype == "float32" else 2e-2
    got = out.float().numpy()
    for want in (jax_flash(jq, jk, jv, causal=True, block_q=bq, block_k=bk,
                           interpret=True), _jax_ref(jq, jk, jv)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)
    # the CPU wrapper runs exactly the plain version, and counts nothing
    before = ops.launches
    assert torch.equal(ops.flash_attention(tq, tk, tv), out)
    assert ops.launches == before


@pytest.mark.parametrize("B,S,Hq,Hkv,D,bq,bk", SHAPES)
def test_lse_matches_masked_logsumexp(B, S, Hq, Hkv, D, bq, bk):
    q, k, v = _inputs(1, B, S, Hq, Hkv, D)
    kr = np.repeat(k, Hq // Hkv, 2)
    s = np.einsum("bqhd,bkhd->bhqk", q, kr) / np.float32(math.sqrt(D))
    s = np.where(np.tril(np.ones((S, S), bool)), s, np.float32(-1e30))
    want = jax.nn.logsumexp(jnp.asarray(s), axis=-1)
    _, lse = ref.attention_fwd_ref(*(torch.from_numpy(x) for x in (q, k, v)))
    np.testing.assert_allclose(lse.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("B,S,Hq,Hkv,D,bq,bk", SHAPES)
def test_gradient_matches_jax_grad(B, S, Hq, Hkv, D, bq, bk):
    q, k, v = _inputs(2, B, S, Hq, Hkv, D)
    dout = np.random.RandomState(3).randn(B, S, Hq, D).astype(np.float32)
    want = jax.jit(jax.grad(lambda a, b, c: jnp.sum(_jax_ref(a, b, c) * dout),
                            argnums=(0, 1, 2)))(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    ops.FlashAttention.apply(tq, tk, tv).backward(torch.from_numpy(dout))
    for t, w in zip((tq, tk, tv), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_backward_chunks_agree():
    """Walking the query axis in chunks (ragged last chunk) changes no
    gradient beyond float32 summation order."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(4, 2, 45, 6, 2, 16))
    out, lse = ref.attention_fwd_ref(q, k, v)
    dout = torch.from_numpy(
        np.random.RandomState(5).randn(*out.shape).astype(np.float32))
    whole = ref.attention_bwd(q, k, v, out, lse, dout, chunk=45)
    for chunk in (1, 7, 16):
        for a, b in zip(whole, ref.attention_bwd(q, k, v, out, lse, dout,
                                                 chunk=chunk)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_wrapper_rejects_bad_inputs():
    q, k, v = (torch.from_numpy(x) for x in _inputs(6, 1, 8, 4, 2, 16))
    with pytest.raises(ValueError, match="does not fit"):
        ops.flash_attention(q, k[:, :4], v[:, :4])  # cross-length
    with pytest.raises(ValueError, match="does not fit"):
        ops.flash_attention(q[:, :, :3], k, v)  # Hq % Hkv != 0
    with pytest.raises(TypeError, match="dtypes differ"):
        ops.flash_attention(q, k.double(), v)
