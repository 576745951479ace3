"""The bf16 WKV6 body's design, held on the CPU before any card runs it.

(a) Its arithmetic and rounding, emulated in plain PyTorch.  A chunk of L
tokens is zero-filled to Lp, L rounded up to 16 (the padded rows have
lw = 0, so the decay holds), and cut into tiles of 16 rows, each of two
blocks of 8.  Pairs of rows within one block are summed pair by pair in
float32.  A tile T of rows strictly after a tile J goes through one
product, with J's last row e as the reference, so no exponent is
positive:

    A[t, j] = sum_a (r[t,a] e^{cum[t-1,a] - cum[e,a]})
                    (k[j,a] e^{cum[e,a] - cum[j,a]});

so does a tile's second block against its first, through the first
block's last row.  (The kernel takes a pair's decay within a block as the
product of the per-token decays e^lw, the emulation as e^{cum[t-1] -
cum[j]}: both in float32.)

r, k and v enter the tensor cores exactly as bf16.  The float32 operands
made from them (those two exp-scaled factors, A, r e^{cum[t-1]}, k
e^{cum[L-1] - cum} and the carried state S) enter as hi + lo pairs of
bf16; a product of two pairs drops lo x lo.  At rwkv6-1.6b's prefill shape
with ``chip_smoke.py``'s input recipe, and where the decay reaches -e^3 a
token, the emulation stays within the limits the card is held to:
``BF16_TOL`` for y, ``SCAN_F32_TOL`` for the final state, against
``ref.wkv_chunked_ref``.  Each pair is needed: made a single bf16, it
misses a limit.
(b) Every shape the launchers and ``chip_smoke.py`` run is one the bf16
body takes (``kernel.check_bf16_shape``), and the shapes it cannot take
raise.  The emulation lives here only: no path of the package runs it."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels.rwkv6 import kernel, ref  # noqa: E402

# chip_smoke.py's limits: bf16 outputs rounded on both sides (4e-3 plus one
# bf16 ulp of the value); the state at the scans' own 1e-4
BF16_TOL = (4e-3, 2.0 ** -7)
SCAN_F32_TOL = (1e-4, 1e-4)
WKV_SHAPE = (1, 256, 32, 64, 32)  # rwkv6-1.6b prefill: B T H hd L
PAIRS = ("r_hat", "k_hat", "A", "r_s", "S", "k_u")


def _pair(x, keep):
    """x as a hi + lo pair of bf16 values (lo 0 if not ``keep``), in
    float32."""
    hi = x.to(torch.bfloat16).float()
    lo = (x - hi).to(torch.bfloat16).float() if keep else torch.zeros_like(x)
    return hi, lo


def _mm(eq, a, b):
    """A product of two pairs on the tensor cores: hi hi + hi lo + lo hi."""
    (ah, al), (bh, bl) = a, b
    return (torch.einsum(eq, ah, bh) + torch.einsum(eq, ah, bl)
            + torch.einsum(eq, al, bh))


def _emulate_bf16_body(r, k, v, lw, u, L, s0=None, single=()):
    """The bf16 body's arithmetic and rounding, chunk after chunk; the
    pairs named in ``single`` enter as one bf16 instead."""
    B, T, H, hd = r.shape
    Lp = -(-L // 16) * 16
    keep = {name: name not in single for name in PAIRS}
    S = torch.zeros((B, H, hd, hd)) if s0 is None else s0.float()
    j_idx = torch.arange(Lp)
    same = (j_idx[:, None] // 8) == (j_idx[None, :] // 8)
    lower = j_idx[None, :] < j_idx[:, None]  # [t, j]: j < t
    ys = []
    for c0 in range(0, T, L):
        pad = (0, 0, 0, 0, 0, Lp - L)
        rb, kb, vb = (torch.nn.functional.pad(t[:, c0:c0 + L].float(), pad)
                      for t in (r, k, v))
        lwb = torch.nn.functional.pad(lw[:, c0:c0 + L], pad)
        cum = torch.cumsum(lwb, dim=1)  # [B, Lp, H, hd]
        cp = torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]], dim=1)
        end = cum[:, -1]  # [B, H, hd]
        # pairs within a block of 8 rows, one by one in float32, the bonus
        # on the diagonal
        diff = cp[:, :, None] - cum[:, None, :]  # [B, t, j, H, hd]
        mask = (same & lower)[None, :, :, None, None]
        dec = torch.exp(torch.where(mask, diff, 0.0)) * mask
        A = torch.einsum("btha,btjha,bjha->bhtj", rb, dec, kb)
        bonus = torch.einsum("btha,ha,btha->bht", rb, u, kb)
        A = A + torch.diag_embed(bonus)
        # below the diagonal: one product through row e for each tile
        # against an earlier one, and for a tile's second block of 8 rows
        # against its first
        blocks = []
        for T_ in range(Lp // 16):
            o = 16 * T_
            blocks.append((slice(o + 8, o + 16), slice(o, o + 8), o + 7))
            blocks += [(slice(o, o + 16), slice(16 * J, 16 * J + 16),
                        16 * J + 15) for J in range(T_)]
        for rows, cols, e in blocks:
            r_hat = rb[:, rows] * torch.exp(cp[:, rows] - cum[:, e:e + 1])
            k_hat = kb[:, cols] * torch.exp(cum[:, e:e + 1] - cum[:, cols])
            A[:, :, rows, cols] = _mm(
                "btha,bjha->bhtj", _pair(r_hat, keep["r_hat"]),
                _pair(k_hat, keep["k_hat"]))
        A_pair = _pair(A, keep["A"])
        v_pair = (vb, torch.zeros_like(vb))
        y = _mm("bhtj,bjhc->bthc", A_pair, v_pair)
        r_s = rb * torch.exp(cp)
        y = y + _mm("btha,bhac->bthc", _pair(r_s, keep["r_s"]),
                    _pair(S, keep["S"]))
        k_u = kb * torch.exp(end[:, None] - cum)
        S = torch.exp(end)[..., None] * S + _mm(
            "btha,bthc->bhac", _pair(k_u, keep["k_u"]), v_pair)
        ys.append(y[:, :L])
    return torch.cat(ys, dim=1).to(r.dtype), S


def _inputs(seed, B, T, H, hd, s0_scale, strong=False):
    """chip_smoke.py's recipe (phase 4's ``inputs``), on the CPU; with
    ``strong`` the log-decay is -e^x for x uniform in [-3, 3], so a token
    can decay by e^-20 and cum reaches about -100 within 32 tokens."""
    gen = torch.Generator().manual_seed(seed)
    bf16 = torch.bfloat16
    r, k, v = ((torch.randn((B, T, H, hd), generator=gen) * 0.5).to(bf16)
               for _ in range(3))
    if strong:
        lw = -torch.exp(6.0 * torch.rand((B, T, H, hd), generator=gen) - 3.0)
    else:
        lw = -torch.exp(torch.randn((B, T, H, hd), generator=gen) - 1.0)
    u = torch.randn((H, hd), generator=gen) * 0.1
    s0 = (torch.randn((B, H, hd, hd), generator=gen) * s0_scale
          if s0_scale else None)
    return r, k, v, lw, u, s0


def _within(got, want, tol):
    atol, rtol = tol
    diff = (got.float() - want.float()).abs()
    return bool((diff <= atol + rtol * want.float().abs()).all())


def _run(shape, s0_scale, strong=False, single=()):
    """The emulation and the plain version on the same inputs, T padded
    to a multiple of the chunk as ``ops.wkv`` pads."""
    B, T, H, hd, chunk = shape
    r, k, v, lw, u, s0 = _inputs(7, B, T, H, hd, s0_scale, strong)
    L = min(chunk, T)
    pad = (0, 0, 0, 0, 0, -T % L)
    r, k, v, lw = (torch.nn.functional.pad(t, pad) for t in (r, k, v, lw))
    y, s = _emulate_bf16_body(r, k, v, lw, u, L, s0, single)
    py, ps = ref.wkv_chunked_ref(r, k, v, lw, u, L, s0)
    return y[:, :T], s, py[:, :T], ps


# (shape, s0 scale, strong decay): rwkv6-1.6b's prefill with s0 absent and
# set, the strong decay, one ragged chunk of 20, T 37 in chunks of 8 at
# the smoke width, head_dim 32, and a training step's length (2 x 2048,
# the state carried over 64 chunks) at 4 of the 32 heads
CASES = [(WKV_SHAPE, 0.0, False), (WKV_SHAPE, 0.1, False),
         (WKV_SHAPE, 0.1, True), ((1, 20, 32, 64, 32), 0.1, False),
         ((2, 37, 4, 16, 8), 0.1, False), ((1, 96, 4, 32, 32), 0.1, True),
         ((2, 2048, 4, 64, 32), 0.0, False),
         ((2, 2048, 4, 64, 32), 0.1, False)]


@pytest.mark.parametrize("shape,s0_scale,strong", CASES, ids=str)
def test_bf16_rounding_scheme_meets_the_card_limits(shape, s0_scale, strong):
    y, s, py, ps = _run(shape, s0_scale, strong)
    assert y.dtype == torch.bfloat16
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    assert _within(y, py, BF16_TOL)
    assert _within(s, ps, SCAN_F32_TOL)


@pytest.mark.parametrize("name", PAIRS)
def test_each_pair_is_needed(name):
    """Made a single bf16, each pair misses a limit at rwkv6-1.6b's
    prefill shape (with s0, or with the strong decay)."""
    missed = False
    for s0_scale, strong in ((0.1, False), (0.1, True)):
        y, s, py, ps = _run(WKV_SHAPE, s0_scale, strong, single=(name,))
        missed |= not (_within(y, py, BF16_TOL)
                       and _within(s, ps, SCAN_F32_TOL))
    assert missed, f"{name} as a single bf16 still meets both limits"


def _run_shapes():
    """(B, T, H, hd, L) of every WKV6 launch the launchers and
    chip_smoke.py make: rwkv6-1.6b's prefills and the smoke config's (T
    up to a chunk as one chunk, longer T padded to a multiple of it), a
    training step's (2 x 2048), and the card checks' shapes."""
    shapes = []
    for cfg in (get_config("rwkv6-1.6b"), get_smoke_config("rwkv6-1.6b")):
        hd, L = cfg.rwkv_head_dim, cfg.rwkv_chunk
        H = cfg.d_model // hd
        for B in (1, 2, 8):
            for T in sorted({1, 17, 20, 37, L, 2 * L, 3 * L, 400}):
                Lt = min(L, T)
                shapes.append((B, T + -T % Lt, H, hd, Lt))
    shapes += [(2, 40, 4, 16, 8), (1, 224, 32, 64, 32), (2, 72, 4, 16, 8),
               (1, 96, 8, 32, 32), (1, 24, 8, 64, 24), (2, 2048, 32, 64, 32)]
    return shapes


@pytest.mark.parametrize("shape", _run_shapes(), ids=str)
def test_every_run_shape_is_one_the_bf16_body_takes(shape):
    B, T, H, hd, L = shape
    assert T % L == 0
    kernel.check_bf16_shape(hd, L)


@pytest.mark.parametrize("hd,L", [(24, 32), (48, 32), (128, 32), (8, 8),
                                  (64, 33), (64, 64), (16, 0)])
def test_check_bf16_shape_refuses_what_the_bf16_body_cannot_take(hd, L):
    with pytest.raises(ValueError, match="bf16 WKV6 kernel takes"):
        kernel.check_bf16_shape(hd, L)
