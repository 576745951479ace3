"""Plain-PyTorch chunked Mamba2 SSD (the kernel's plain version).

The arithmetic of the TPU kernel ``_ssd_kernel``, in float32, chunk after
chunk: the intra-chunk scores ``(C_t . B_j) exp(cum_t - cum_j) dt_j`` for
j <= t with a scalar decay per head, the term from the carried
``[H, N, P]`` state and the state update.  The JAX package's
``models/mamba2.py:ssd_chunked`` computes the same function, with its
einsums and inter-chunk state in x's type (so the two agree in float32).
The CPU path of ``ops.ssd`` and the tests run it; ``chip_smoke.py`` holds
the CUDA kernel against it.
"""
from __future__ import annotations

import torch


def ssd_chunked_ref(x, dt, A, Bm, Cm, chunk: int, h0=None):
    """x [B,T,H,P]; dt [B,T,H]; A [H] (negative); Bm/Cm [B,T,N]; T % chunk
    == 0; h0 [B,H,N,P] or None (zeros) -> (y [B,T,H,P] in x's dtype,
    h_final [B,H,N,P] float32)."""
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    L = chunk
    xf, dtf, Bf, Cf = (t.float() for t in (x, dt, Bm, Cm))
    Af = A.float()
    h = (torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                 device=x.device))[None, :, :, None]  # j<=t
    ys = []
    for c0 in range(0, T, L):
        xb, dtb, Bb, Cb = (t[:, c0:c0 + L] for t in (xf, dtf, Bf, Cf))
        cum = torch.cumsum(dtb * Af, dim=1)  # [B,L,H] inclusive, decreasing
        CB = torch.einsum("btn,bjn->btj", Cb, Bb)
        delta = cum[:, :, None, :] - cum[:, None, :, :]  # [B,t,j,H]
        dec = torch.exp(torch.where(mask, delta, 0.0)) * mask
        scores = CB[..., None] * dec * dtb[:, None, :, :]
        y = torch.einsum("btjh,bjhp->bthp", scores, xb)
        y = y + torch.einsum("btn,bth,bhnp->bthp", Cb, torch.exp(cum), h)
        decay_to_end = torch.exp(cum[:, -1:] - cum) * dtb  # [B,L,H]
        h = torch.exp(cum[:, -1])[:, :, None, None] * h + torch.einsum(
            "bjh,bjn,bjhp->bhnp", decay_to_end, Bb, xb)
        ys.append(y)
    return torch.cat(ys, dim=1).to(x.dtype), h
