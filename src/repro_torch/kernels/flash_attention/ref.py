"""Plain-PyTorch causal attention: the flash kernel's plain version and the
gradient that the kernel's ``autograd.Function`` uses on every device.

``attention_fwd_ref`` mirrors the JAX package's
``kernels/flash_attention/ref.py``: float32 scores scaled by 1/sqrt(D),
keys after the query masked with ``-1e30``, a float32 softmax, and the
output cast to the input dtype.  It works on the model layout (q
[B,S,Hq,D], k/v [B,S,Hkv,D], query head h reading kv head h // G) and also
returns the row logsumexp, which the backward needs.

``attention_bwd`` is the gradient of that function written in PyTorch
ops (the TPU kernel has no backward either: the JAX step differentiates
the jnp attention instead).  It walks the query axis in chunks so that
its float32 [B, Hq, chunk, keys] intermediates stay bounded, and reads
only the keys up to each chunk's last query.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30
BWD_CHUNK_ELEMS = 1 << 26  # float32 scores per backward chunk (256 MB)


def _grouped(q, Hkv):
    """[B,S,Hq,D] -> [B,Hkv,G,S,D] float32."""
    B, S, Hq, D = q.shape
    return q.float().reshape(B, S, Hkv, Hq // Hkv, D).permute(0, 2, 3, 1, 4)


def _heads(k):
    """[B,S,Hkv,D] -> [B,Hkv,1,S,D] float32."""
    return k.float().permute(0, 2, 1, 3)[:, :, None]


def attention_fwd_ref(q, k, v):
    """Causal GQA attention.  q [B,S,Hq,D]; k/v [B,S,Hkv,D] ->
    (out [B,S,Hq,D] in q's dtype, lse [B,Hq,S] float32)."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    s = _grouped(q, Hkv) @ _heads(k).transpose(-1, -2) / math.sqrt(D)
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    s = torch.where(causal, s, NEG_INF)  # [B,Hkv,G,S,S]
    lse = torch.logsumexp(s, dim=-1)
    out = torch.softmax(s, dim=-1) @ _heads(v)  # [B,Hkv,G,S,D]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, D).to(q.dtype)
    return out, lse.reshape(B, Hq, S)


def attention_bwd(q, k, v, out, lse, dout, *, chunk=None):
    """Gradient of ``attention_fwd_ref`` in float32 -> (dq, dk, dv), each
    in its input's dtype.

    P = exp(s - lse) below the diagonal (exact zeros above it);
    D_i = sum(dO * O); dV = sum_g P^T dO; dS = P * (dO V^T - D);
    dQ = dS K / sqrt(D); dK = sum_g dS^T Q / sqrt(D)."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qg, og, dog = (_grouped(t, Hkv) for t in (q, out, dout))
    kh, vh = _heads(k), _heads(v)
    lse = lse.float().reshape(B, Hkv, G, S)
    delta = (dog * og).sum(-1)  # [B,Hkv,G,S]
    dq = torch.empty_like(qg)
    dk = torch.zeros_like(kh)
    dv = torch.zeros_like(vh)
    if chunk is None:
        chunk = max(1, BWD_CHUNK_ELEMS // max(1, B * Hq * S))
    rows = torch.arange(S, device=q.device)
    for q0 in range(0, S, chunk):
        q1 = min(S, q0 + chunk)  # queries q0..q1-1 see keys 0..q1-1
        kc, vc = kh[..., :q1, :], vh[..., :q1, :]
        s = qg[..., q0:q1, :] @ kc.transpose(-1, -2) * scale
        p = torch.exp(s - lse[..., q0:q1, None])
        causal = rows[q0:q1, None] >= rows[None, :q1]
        p = torch.where(causal, p, 0.0)  # [B,Hkv,G,c,q1]
        do = dog[..., q0:q1, :]
        dv[..., :q1, :] += (p.transpose(-1, -2) @ do).sum(2, keepdim=True)
        ds = p * (do @ vc.transpose(-1, -2) - delta[..., q0:q1, None])
        dq[..., q0:q1, :] = ds @ kc * scale
        dk[..., :q1, :] += (ds.transpose(-1, -2) @ qg[..., q0:q1, :]
                            ).sum(2, keepdim=True) * scale
    dq = dq.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, D).to(q.dtype)
    dk = dk[:, :, 0].permute(0, 2, 1, 3).to(k.dtype)
    dv = dv[:, :, 0].permute(0, 2, 1, 3).to(v.dtype)
    return dq, dk, dv
