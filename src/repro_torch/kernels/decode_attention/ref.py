"""Plain-PyTorch oracle for paged flash-decode (the kernel's plain version).

Mirrors the JAX package's ``kernels/decode_attention/ref.py``: a float32
softmax over the gathered cache with positions at or past the length
masked by ``-1e30``.  The CPU path of ``ops.paged_decode_attention`` and
the tests run it; ``chip_smoke.py`` holds the CUDA kernel against it.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def decode_ref(q, k_cache, v_cache, kv_length):
    """q [B,Hkv,G,D]; caches [B,S,Hkv,D]; kv_length [B] -> [B,Hkv,G,D]."""
    D = q.shape[-1]
    S = k_cache.shape[1]
    s = torch.einsum("bhgd,bkhd->bhgk", q.float(),
                     k_cache.float()) / math.sqrt(D)
    valid = (torch.arange(S, device=q.device)[None, :]
             < kv_length.to(q.device)[:, None])
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
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
