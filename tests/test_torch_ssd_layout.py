"""The bf16 SSD body's design, held on the CPU before any card runs it.

(a) Its rounding, emulated in plain PyTorch: x, B and C enter the tensor
cores exactly as bf16; the scores, B * w and the carried float32 state h
enter as hi + lo pairs of bf16, each pair summed in float32.  At
zamba2-2.7b's prefill shape with ``chip_smoke.py``'s input recipe the
emulation stays within the limits the card is held to: ``BF16_TOL`` for y
and ``SCAN_F32_TOL`` for the final state, against ``ref.ssd_chunked_ref``.
(b) Every shape the launchers and ``chip_smoke.py`` run is one the bf16
body takes (``kernel.check_bf16_shape``), and the shapes it cannot take
raise.  The emulation lives here only: no path of the package runs it."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels.mamba2 import kernel, ref  # noqa: E402
from repro_torch.models.mamba2 import ssm_dims  # noqa: E402

# chip_smoke.py's limits: bf16 outputs rounded on both sides (4e-3 plus one
# bf16 ulp of the value); the state at the scans' own 1e-4
BF16_TOL = (4e-3, 2.0 ** -7)
SCAN_F32_TOL = (1e-4, 1e-4)
SSD_SHAPE = (1, 384, 80, 64, 64, 128)  # zamba2-2.7b prefill: B T H P N L


def _pair(v):
    """v as a hi + lo pair of bf16 values, returned in float32."""
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def _emulate_bf16_body(x, dt, A, Bm, Cm, L, h0=None):
    """The bf16 body's arithmetic and rounding, chunk after chunk."""
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    xf, Bf, Cf = (t.to(torch.bfloat16).float() for t in (x, Bm, Cm))
    h = torch.zeros((B, H, N, P)) if h0 is None else h0.float()
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool))[None, :, :, None]
    ys = []
    for c0 in range(0, T, L):
        xb, dtb, Bb, Cb = (t[:, c0:c0 + L] for t in (xf, dt, Bf, Cf))
        cum = torch.cumsum(dtb * A, dim=1)  # [B, L, H]
        CB = torch.einsum("btn,bjn->btj", Cb, Bb)  # exact products
        delta = cum[:, :, None, :] - cum[:, None, :, :]
        scores = (CB[..., None] * torch.exp(torch.where(mask, delta, 0.0))
                  * mask * dtb[:, None, :, :])  # [B, t, j, H]
        s_hi, s_lo = _pair(scores)
        h_hi, h_lo = _pair(h)
        inter = (torch.einsum("btn,bhnp->bthp", Cb, h_hi)
                 + torch.einsum("btn,bhnp->bthp", Cb, h_lo))
        y = torch.exp(cum)[..., None] * inter
        y = y + (torch.einsum("btjh,bjhp->bthp", s_hi, xb)
                 + torch.einsum("btjh,bjhp->bthp", s_lo, xb))
        w = torch.exp(cum[:, -1:] - cum) * dtb  # [B, L, H]
        bw_hi, bw_lo = _pair(w[..., None] * Bb[:, :, None, :])  # [B,j,H,N]
        h = (torch.exp(cum[:, -1])[:, :, None, None] * h
             + torch.einsum("bjhn,bjhp->bhnp", bw_hi, xb)
             + torch.einsum("bjhn,bjhp->bhnp", bw_lo, xb))
        ys.append(y)
    return torch.cat(ys, dim=1).to(x.dtype), h


def _inputs(seed, B, T, H, P, N, h0_scale):
    """chip_smoke.py's recipe (``ssd_inputs``), on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    bf16 = torch.bfloat16
    x = torch.randn((B, T, H, P), generator=gen).to(bf16)
    dt = torch.nn.functional.softplus(
        torch.randn((B, T, H), generator=gen) - 2.0)
    A = -(1.0 + 15.0 * torch.rand((H,), generator=gen))
    Bm = torch.randn((B, T, N), generator=gen).to(bf16)
    Cm = torch.randn((B, T, N), generator=gen).to(bf16)
    h0 = (torch.randn((B, H, N, P), generator=gen) * h0_scale
          if h0_scale else None)
    return x, dt, A, Bm, Cm, h0


def _within(got, want, tol):
    atol, rtol = tol
    diff = (got.float() - want.float()).abs()
    return bool((diff <= atol + rtol * want.float().abs()).all())


@pytest.mark.parametrize("shape,h0_scale", [
    (SSD_SHAPE, 0.0), (SSD_SHAPE, 0.1), ((1, 37, 80, 64, 64, 37), 0.1),
    ((2, 96, 4, 16, 16, 16), 0.1),
    # a training step's length (2 x 2048, 16 chunks) at 8 of the 80 heads
    ((2, 2048, 8, 64, 64, 128), 0.0), ((2, 2048, 8, 64, 64, 128), 0.1)])
def test_bf16_rounding_scheme_meets_the_card_limits(shape, h0_scale):
    B, T, H, P, N, L = shape
    x, dt, A, Bm, Cm, h0 = _inputs(6, B, T, H, P, N, h0_scale)
    y, h = _emulate_bf16_body(x, dt, A, Bm, Cm, L, h0)
    py, ph = ref.ssd_chunked_ref(x, dt, A, Bm, Cm, L, h0)
    assert y.dtype == torch.bfloat16 and bool(torch.isfinite(y).all())
    assert _within(y, py, BF16_TOL)
    assert _within(h, ph, SCAN_F32_TOL)


def _run_shapes():
    """(B, T, H, P, N, L) of every SSD launch the launchers and
    chip_smoke.py make: zamba2-2.7b's prefills (B 1, T up to 384 in chunks
    of 128, one short chunk), its forward, a training step's (2 x 2048),
    the smoke config, and the card checks' shapes."""
    full, smoke = get_config("zamba2-2.7b"), get_smoke_config("zamba2-2.7b")
    shapes = []
    for cfg in (full, smoke):
        _, H, N, _ = ssm_dims(cfg)
        P, L = cfg.ssm_head_dim, cfg.ssm_chunk
        for B in (1, 2, 8):
            for T in sorted({1, 17, 20, 37, L, 2 * L, 3 * L}):
                if T <= L or T % L == 0:  # what ssd_chunked takes
                    shapes.append((B, T, H, P, N, min(L, T)))
    shapes += [(1, 1, 80, 64, 64, 1), (1, 200, 4, 64, 64, 40),
               (2, 64, 8, 16, 16, 16), (1, 256, 8, 32, 32, 128),
               (1, 128, 33, 16, 96, 128), (2, 128, 40, 32, 128, 128),
               (1, 256, 8, 64, 128, 128), (2, 2048, 80, 64, 64, 128)]
    return shapes


@pytest.mark.parametrize("shape", _run_shapes(), ids=str)
def test_every_run_shape_is_one_the_bf16_body_takes(shape):
    B, T, H, P, N, L = shape
    assert T % L == 0
    kernel.check_bf16_shape(P, N, L)


@pytest.mark.parametrize("P,N,L", [(64, 24, 128), (24, 64, 128),
                                   (64, 144, 128), (64, 64, 129),
                                   (128, 64, 128), (48, 64, 128)])
def test_check_bf16_shape_refuses_what_the_bf16_body_cannot_take(P, N, L):
    with pytest.raises(ValueError, match="bf16 SSD kernel takes"):
        kernel.check_bf16_shape(P, N, L)
