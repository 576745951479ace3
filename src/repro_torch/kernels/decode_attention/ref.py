"""Plain-PyTorch oracle for paged flash-decode (the kernel's plain version).

Mirrors the JAX package's ``kernels/decode_attention/ref.py``: a float32
softmax over the gathered cache with positions at or past the length
masked by ``-1e30``.  The CPU path of ``ops.paged_decode_attention`` and
the tests run it; ``chip_smoke.py`` holds the CUDA kernel against it.
``decode_split_ref`` mirrors the kernel's split of the sequence and the
combine of the partial states, for the tests.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def decode_ref(q, k_cache, v_cache, kv_length, return_lse=False):
    """q [B,Hkv,G,D]; caches [B,S,Hkv,D]; kv_length [B] -> [B,Hkv,G,D], and
    with ``return_lse`` also each head's float32 log-sum-exp of its scaled
    scores [B,Hkv,G].  A sequence with no valid position (length 0, as a
    rank's shard of a cache under a mesh can be) gives 0 and -inf."""
    D = q.shape[-1]
    S = k_cache.shape[1]
    s = torch.einsum("bhgd,bkhd->bhgk", q.float(),
                     k_cache.float()) / math.sqrt(D)
    valid = (torch.arange(S, device=q.device)[None, :]
             < kv_length.to(q.device)[:, None])
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    some = valid.any(dim=1)[:, None, None]
    out = torch.where(some[..., None], out, 0.0).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(some, torch.logsumexp(s, dim=-1), float("-inf"))
    return out, lse


def decode_split_ref(q, k_cache, v_cache, kv_length, splits, tile=16):
    """The CUDA kernel's split-and-combine algebra in plain ops, for the
    tests only (never on a serving path).

    Each sequence's valid positions, ``min(len, S)``, are cut into tiles of
    ``tile`` positions, shared evenly among ``splits`` ranks (rank r takes
    tiles ``[r * per, (r + 1) * per)``, per = ceil(tiles / splits); late
    ranks may get none).  Each rank keeps its own float32 (m, l, acc); they
    are combined in rank order: M = max m_r, l = sum exp(m_r - M) l_r, acc
    likewise, out = acc / max(l, 1e-30).

    q [B,Hkv,G,D]; caches [B,S,Hkv,D]; kv_length [B] -> [B,Hkv,G,D]."""
    B, Hkv, G, D = q.shape
    S = k_cache.shape[1]
    dev = q.device
    out = torch.empty(q.shape, dtype=torch.float32, device=dev)
    scale = 1.0 / math.sqrt(D)
    for b in range(B):
        n = min(int(kv_length[b]), S)
        n_tiles = -(-n // tile)
        per = -(-n_tiles // splits)
        m_all = torch.full((Hkv, G), NEG_INF, device=dev)
        parts = []
        for r in range(splits):
            lo, hi = r * per * tile, min((r + 1) * per * tile, n)
            if lo >= hi:  # an empty rank: m = -1e30, l = 0, acc = 0
                parts.append((torch.full((Hkv, G), NEG_INF, device=dev),
                              torch.zeros((Hkv, G), device=dev),
                              torch.zeros((Hkv, G, D), device=dev)))
                continue
            s = torch.einsum("hgd,khd->hgk", q[b].float(),
                             k_cache[b, lo:hi].float()) * scale
            m = s.max(dim=-1).values
            p = torch.exp(s - m[..., None])
            parts.append((m, p.sum(dim=-1), torch.einsum(
                "hgk,khd->hgd", p, v_cache[b, lo:hi].float())))
            m_all = torch.maximum(m_all, m)
        l_all = torch.zeros((Hkv, G), device=dev)
        acc = torch.zeros((Hkv, G, D), device=dev)
        for m, l, a in parts:
            f = torch.exp(m - m_all)
            l_all = l_all + f * l
            acc = acc + f[..., None] * a
        out[b] = acc / torch.clamp(l_all, min=1e-30)[..., None]
    return out.to(q.dtype)


def gather_kv(store, block_tables):
    """Materialize contiguous caches from a paged store (oracle gather).

    store [num_blocks, block_size, Hkv, D]; block_tables [B, max_blocks]
    -> [B, max_blocks * block_size, Hkv, D]."""
    B, mb = block_tables.shape
    _, bs, Hkv, D = store.shape
    return store[block_tables.long()].reshape(B, mb * bs, Hkv, D)


def paged_decode_ref(q, k_store, v_store, block_tables, kv_length):
    """Paged oracle: gather through the block tables, then ``decode_ref``.

    q [B,Hkv,G,D]; stores [num_blocks, block_size, Hkv, D]; block_tables
    [B, max_blocks]; kv_length [B] -> [B,Hkv,G,D]."""
    return decode_ref(q, gather_kv(k_store, block_tables),
                      gather_kv(v_store, block_tables), kv_length)
