"""Attention: GQA + RoPE (+ optional qk-norm / qkv-bias).

The counterpart of the JAX package's ``models/attention.py`` for the paths
the transformer families (and zamba2's shared block) train and serve
with: the full-sequence training forward (``attention_apply``, causal
through the flash-attention kernel; the encoder's non-causal and the
decoder's cross attention in PyTorch ops), prefill, chunked extend,
contiguous decode (through the contiguous flash-decode kernel) and paged
decode.  Prefill picks its algorithm as the reference's ``_pick_impl``
does: above 2048 positions the block-wise ``chunked_causal_attention``,
whose live memory is one query block's scores, else ``full_attention``.
Scores
are float32 and masked with ``NEG_INF = -1e30`` (never ``-inf``; the
kernels skip masked positions, which adds the same zeros): masked columns
then underflow to exact zeros in the softmax, which keeps chunked extend
equal to one full prefill and paged decode equal to slot decode.

Where the reference updates caches functionally (``.at[].set`` under
``donate_argnums``), these functions write into the caller's cache
tensors in place and return them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import ops as fa_ops

from . import nn
from .config import ModelConfig

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def attention_init(gen, cfg: ModelConfig, *, device="cpu"):
    d, hd = cfg.d_model, cfg.head_dim
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    if cfg.padded_heads != nh:
        raise NotImplementedError(
            "pad_heads_to is tensor-parallel padding; the port runs on one "
            "device and does not pad heads")
    dt = cfg.pdtype
    p = {
        "q": nn.linear_init(gen, d, nh * hd, dtype=dt, bias=cfg.qkv_bias,
                            device=device),
        "k": nn.linear_init(gen, d, nkv * hd, dtype=dt, bias=cfg.qkv_bias,
                            device=device),
        "v": nn.linear_init(gen, d, nkv * hd, dtype=dt, bias=cfg.qkv_bias,
                            device=device),
        "o": nn.linear_init(gen, nh * hd, d, dtype=dt,
                            stddev=1.0 / math.sqrt(nh * hd), device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = nn.rmsnorm_init(hd, dtype=dt, device=device)
        p["k_norm"] = nn.rmsnorm_init(hd, dtype=dt, device=device)
    return p


# ---------------------------------------------------------------------------
# Projections
# ---------------------------------------------------------------------------


def project_q(p, x, cfg: ModelConfig):
    """q [B,S,Hq,D] without rope: the query side of ``_project_qkv``, all
    that cross-attention over cached encoder K/V needs."""
    B, S, _ = x.shape
    q = nn.linear_apply(p["q"], x, cfg.cdtype).reshape(B, S, cfg.n_heads,
                                                       cfg.head_dim)
    if cfg.qk_norm:
        q = nn.rmsnorm_apply(p["q_norm"], q, cfg.norm_eps)
    return q


def _project_qkv(p, x, x_kv, cfg: ModelConfig, q_positions, kv_positions,
                 *, rope: bool):
    """Return q [B,S,Hq,D], k/v [B,Skv,Hkv,D]."""
    Skv = x_kv.shape[1]
    B = x.shape[0]
    cd = cfg.cdtype
    q = project_q(p, x, cfg)
    k = nn.linear_apply(p["k"], x_kv, cd).reshape(B, Skv, cfg.n_kv_heads,
                                                  cfg.head_dim)
    v = nn.linear_apply(p["v"], x_kv, cd).reshape(B, Skv, cfg.n_kv_heads,
                                                  cfg.head_dim)
    if cfg.qk_norm:
        k = nn.rmsnorm_apply(p["k_norm"], k, cfg.norm_eps)
    if rope:
        q = nn.apply_rope(q, q_positions, cfg.rope_theta)
        k = nn.apply_rope(k, kv_positions, cfg.rope_theta)
    return q, k, v


def _repeat_kv(k, n_q):
    """GQA repeat-KV: [B,S,Hkv,D] -> [B,S,Hq,D]."""
    Hkv = k.shape[2]
    if Hkv == n_q:
        return k
    return torch.repeat_interleave(k, n_q // Hkv, dim=2)


# ---------------------------------------------------------------------------
# Core attention math
# ---------------------------------------------------------------------------


def full_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                   kv_mask: Optional[torch.Tensor] = None):
    """Materialized-scores attention.

    q: [B,Sq,Hq,D]  k,v: [B,Sk,Hkv,D] with Hq % Hkv == 0.
    kv_mask: optional [B,Sk] validity mask.
    """
    Sq, Hq, D = q.shape[1], q.shape[2], q.shape[3]
    Sk = k.shape[1]
    k = _repeat_kv(k, Hq)
    v = _repeat_kv(v, Hq)
    scale = 1.0 / math.sqrt(D)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        qpos = q_offset + torch.arange(Sq, device=q.device)
        kpos = torch.arange(Sk, device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        logits = torch.where(mask[None, None], logits, NEG_INF)
    if kv_mask is not None:
        logits = torch.where(kv_mask[:, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def chunked_causal_attention(q, k, v, *, block_q: int, block_k: int):
    """Block-wise causal attention: a Python loop over query blocks.

    Query block i attends only to keys [0, (i+1)*block_q), so the FLOPs
    are those of causal attention (half of dense) and the live memory is
    one block's float32 scores [B, Hq, block_q, (i+1)*block_q].  The
    diagonal block alone is masked (``NEG_INF``); the probabilities are
    cast to v's dtype, as the reference's.  ``block_k`` is the
    reference's argument, unused there too."""
    B, S, Hq, D = q.shape
    if S % block_q != 0:
        raise ValueError(f"seq {S} not divisible by block_q {block_q}")
    k = _repeat_kv(k, Hq)
    v = _repeat_kv(v, Hq)
    scale = 1.0 / math.sqrt(D)
    outs = []
    for i in range(S // block_q):
        kv_len = (i + 1) * block_q
        logits = torch.einsum(
            "bqhd,bkhd->bhqk", q[:, i * block_q:kv_len].float(),
            k[:, :kv_len].float()) * scale
        qpos = i * block_q + torch.arange(block_q, device=q.device)
        kpos = torch.arange(kv_len, device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        logits = torch.where(mask[None, None], logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype),
                                 v[:, :kv_len]))
    return torch.cat(outs, dim=1)


def _pick_impl(cfg: ModelConfig, seq: int) -> str:
    """The reference's choice of attention algorithm for ``seq``
    positions: ``cfg.attention_impl`` unless it is "auto"; then "pallas"
    with ``use_pallas``, else "chunked" above 2048 positions, "full" up to
    them."""
    if cfg.attention_impl != "auto":
        return cfg.attention_impl
    if cfg.use_pallas:
        return "pallas"
    return "chunked" if seq > 2048 else "full"


# ---------------------------------------------------------------------------
# Training forward
# ---------------------------------------------------------------------------


def attention_apply(p, x, cfg: ModelConfig, *, causal=True, positions=None,
                    x_kv=None, rope=True):
    """Self- (or, with ``x_kv``, cross-) attention over a full sequence.

    Causal self-attention (the decoder's training forward) goes through
    ``kernels.flash_attention.ops.flash_attention``: the hand-written CUDA
    kernel whenever the tensors are on the card, its plain version on the
    CPU.  Non-causal self-attention (the encoder) and cross-attention
    (keys at positions ``0..Skv-1`` of ``x_kv``, never masked) run
    ``full_attention`` in PyTorch ops, as the reference does: it sends
    only causal self-attention to its Pallas kernel."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    if x_kv is None:
        q, k, v = _project_qkv(p, x, x, cfg, positions, positions, rope=rope)
    else:
        kv_positions = torch.arange(x_kv.shape[1], device=x.device)[None, :]
        q, k, v = _project_qkv(p, x, x_kv, cfg, positions, kv_positions,
                               rope=rope)
    if causal and x_kv is None:
        out = fa_ops.flash_attention(q, k, v)
    else:
        out = full_attention(q, k, v, causal=False)
    out = out.reshape(B, S, cfg.n_heads * cfg.head_dim)
    return nn.linear_apply(p["o"], out, cfg.cdtype)


# ---------------------------------------------------------------------------
# Serving entry points
# ---------------------------------------------------------------------------


def attention_prefill(p, x, cfg: ModelConfig, *, positions=None):
    """Prefill: forward + return (output, (k_cache_entries, v_cache_entries)).
    The algorithm is the reference's: ``chunked_causal_attention`` where
    ``_pick_impl`` says "chunked" and the blocks divide S, else
    ``full_attention``."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, x, cfg, positions, positions,
                           rope=cfg.positions == "rope")
    if _pick_impl(cfg, S) == "chunked" and S % cfg.attn_chunk_q == 0:
        out = chunked_causal_attention(q, k, v, block_q=cfg.attn_chunk_q,
                                       block_k=cfg.attn_chunk_k)
    else:
        out = full_attention(q, k, v, causal=True)
    out = out.reshape(B, S, cfg.n_heads * cfg.head_dim)
    return nn.linear_apply(p["o"], out, cfg.cdtype), (k, v)


def _write_rows(cache, pos, new):
    """``cache[b, pos[b, t]] = new[b, t]`` in place for the consecutive
    positions ``pos`` [B, T], dropping every position >= Smax.  The
    writes go through positions clamped to Smax - 1, and that row is then
    set to what it must hold: the chunk's own entry for it, or its value
    before the call (so the dropped writes, which collide there, leave no
    trace, with no host sync)."""
    B, T = pos.shape
    last = cache.shape[1] - 1
    bidx = torch.arange(B, device=pos.device)
    before = cache[:, last].clone()
    cache[bidx[:, None], pos.clamp(max=last)] = new.to(cache.dtype)
    t = last - pos[:, 0]  # the chunk entry that belongs at row Smax - 1
    own = ((t >= 0) & (t < T)).reshape((B,) + (1,) * (cache.dim() - 2))
    cache[:, last] = torch.where(
        own, new[bidx, t.clamp(0, T - 1)].to(cache.dtype), before)


def attention_extend(p, x, cache_k, cache_v, kv_length, cfg: ModelConfig):
    """Multi-token cache extension (chunked prefill).

    x: [B,T,d] new tokens appended at positions kv_length..kv_length+T-1;
    cache_k/v: [B,Smax,Hkv,D], written IN PLACE at those positions (a
    position past the cache, as a padded chunk's tail can reach, is
    dropped, as the reference's ``.at[].set`` drops it); kv_length: [B]
    valid entries *before* this chunk.  Returns (out [B,T,d], cache_k,
    cache_v, new_len).  Each chunk query attends to the cache prefix plus
    the chunk's own causal triangle, with the score math of
    ``full_attention``."""
    B, T, _ = x.shape
    Smax = cache_k.shape[1]
    pos = kv_length[:, None] + torch.arange(T, device=x.device)[None, :]
    q, k_new, v_new = _project_qkv(p, x, x, cfg, pos, pos,
                                   rope=cfg.positions == "rope")
    _write_rows(cache_k, pos, k_new)
    _write_rows(cache_v, pos, v_new)
    Hq = q.shape[2]
    k = _repeat_kv(cache_k, Hq)
    v = _repeat_kv(cache_v, Hq)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    # key j is valid for chunk query t iff j <= its absolute position
    mask = (torch.arange(Smax, device=x.device)[None, None, :]
            <= pos[:, :, None])  # [B,T,Smax]
    logits = torch.where(mask[:, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    out = out.reshape(B, T, cfg.n_heads * cfg.head_dim)
    return (nn.linear_apply(p["o"], out, cfg.cdtype), cache_k, cache_v,
            kv_length + T)


def attention_decode(p, x, cache_k, cache_v, kv_length, cfg: ModelConfig):
    """Single-token decode step against contiguous caches.

    x: [B,1,d]; cache_k/v: [B,Smax,Hkv,D], written IN PLACE at
    ``kv_length``; kv_length: [B] valid entries *before* this token.  A row
    whose cache is full (``kv_length >= Smax``, as a free slot's length
    grows past it) drops its write and attends every position, as the
    reference does (its ``.at[].set`` drops the out-of-range write and its
    mask admits all Smax positions).  Attention runs
    ``ops.decode_attention``: the hand-written CUDA kernel whenever the
    tensors are on the card, its plain version on the CPU.
    Returns (out [B,1,d], cache_k, cache_v, new_len)."""
    B = x.shape[0]
    Smax = cache_k.shape[1]
    pos = kv_length[:, None]
    q, k_new, v_new = _project_qkv(p, x, x, cfg, pos, pos,
                                   rope=cfg.positions == "rope")
    bidx = torch.arange(B, device=x.device)
    fits = (kv_length < Smax)[:, None, None]
    wpos = kv_length.clamp(max=Smax - 1).long()
    cache_k[bidx, wpos] = torch.where(fits, k_new[:, 0].to(cache_k.dtype),
                                      cache_k[bidx, wpos])
    cache_v[bidx, wpos] = torch.where(fits, v_new[:, 0].to(cache_v.dtype),
                                      cache_v[bidx, wpos])
    new_len = kv_length + 1
    out = da_ops.decode_attention(q, cache_k, cache_v, new_len)
    out = out.reshape(B, 1, cfg.n_heads * cfg.head_dim)
    return nn.linear_apply(p["o"], out, cfg.cdtype), cache_k, cache_v, new_len


def attention_decode_paged(p, x, k_store, v_store, block_tables, kv_length,
                           write_phys, write_off, cfg: ModelConfig):
    """Single-token decode directly against a block-paged KV store.

    x: [B,1,d]; k_store/v_store: [num_blocks, block_size, Hkv, D] (one
    layer's stores, shared by every sequence); block_tables: [B,
    max_blocks] int32; kv_length: [B] int32 valid positions *before* this
    token; write_phys/write_off: [B] the (physical block, in-block offset)
    cell this token's K/V is written into, IN PLACE (padded rows point at
    the null block's cell (0, 0), where collisions are harmless).

    Attention then reads K/V through the block table in
    ``ops.paged_decode_attention``: the hand-written CUDA kernel whenever
    the tensors are on the card, its plain version on the CPU.
    Returns (out [B,1,d], k_store, v_store)."""
    B = x.shape[0]
    pos = kv_length[:, None]
    q, k_new, v_new = _project_qkv(p, x, x, cfg, pos, pos,
                                   rope=cfg.positions == "rope")
    k_store[write_phys, write_off] = k_new[:, 0].to(k_store.dtype)
    v_store[write_phys, write_off] = v_new[:, 0].to(v_store.dtype)
    out = da_ops.paged_decode_attention(q, k_store, v_store, block_tables,
                                        kv_length + 1)
    out = out.reshape(B, 1, cfg.n_heads * cfg.head_dim)
    return nn.linear_apply(p["o"], out, cfg.cdtype), k_store, v_store
