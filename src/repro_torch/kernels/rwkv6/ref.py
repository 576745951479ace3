"""Plain-PyTorch chunked WKV6 (the kernel's plain version).

The arithmetic of the TPU kernel ``_wkv_kernel`` and of the JAX package's
``models/rwkv6.py:wkv_chunked``, in float32, chunk after chunk: the
strictly-lower pairwise term with per-channel decay, the bonus diagonal,
the term from the carried ``[hd, hd]`` state and the state update.  The
CPU path of ``ops.wkv`` and the tests run it; ``chip_smoke.py`` holds the
CUDA kernel against it.
"""
from __future__ import annotations

import torch


def wkv_chunked_ref(r, k, v, lw, u, chunk: int, s0=None):
    """r/k/v/lw [B,T,H,hd] with T % chunk == 0; u [H,hd]; s0 [B,H,hd,hd] or
    None (zeros) -> (y [B,T,H,hd] in r's dtype, s_final [B,H,hd,hd]
    float32)."""
    B, T, H, hd = r.shape
    L = chunk
    rf, kf, vf, lwf = (t.float() for t in (r, k, v, lw))
    uf = u.float()
    S = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=r.device),
                     diagonal=-1)[None, :, :, None, None]  # j < t
    ys = []
    for c0 in range(0, T, L):
        rb, kb, vb, lwb = (t[:, c0:c0 + L] for t in (rf, kf, vf, lwf))
        cum = torch.cumsum(lwb, dim=1)  # inclusive, decreasing
        cum_prev = cum - lwb
        diff = cum_prev[:, :, None] - cum[:, None, :]  # [B,t,j,H,hd]
        dec = torch.exp(torch.where(tri, diff, 0.0)) * tri
        A = torch.einsum("btha,btjha,bjha->bthj", rb, dec, kb)
        diag = torch.einsum("btha,ha,btha->bth", rb, uf, kb)
        y = torch.einsum("bthj,bjhv->bthv", A, vb) + diag[..., None] * vb
        y = y + torch.einsum("btha,bhav->bthv", rb * torch.exp(cum_prev), S)
        end = cum[:, -1:]
        k_out = kb * torch.exp(end - cum)
        S = torch.exp(end[:, 0])[..., None] * S + torch.einsum(
            "bjha,bjhv->bhav", k_out, vb)
        ys.append(y)
    return torch.cat(ys, dim=1).to(r.dtype), S
