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
    """q/k/v/o projections (and qk-norm scales).  With ``pad_heads_to``
    (tensor-parallel head padding) q and o carry ``padded_heads`` heads,
    laid out per kv group with the pads last; the pads' ``o`` rows are
    zeroed, so their contribution is exactly 0."""
    d, hd = cfg.d_model, cfg.head_dim
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    nhp = cfg.padded_heads
    dt = cfg.pdtype
    p = {
        "q": nn.linear_init(gen, d, nhp * hd, axes=("embed", "q_proj"),
                            dtype=dt, bias=cfg.qkv_bias, bias_axis="q_proj",
                            device=device),
        "k": nn.linear_init(gen, d, nkv * hd, axes=("embed", "kv_proj"),
                            dtype=dt, bias=cfg.qkv_bias, bias_axis="kv_proj",
                            device=device),
        "v": nn.linear_init(gen, d, nkv * hd, axes=("embed", "kv_proj"),
                            dtype=dt, bias=cfg.qkv_bias, bias_axis="kv_proj",
                            device=device),
        "o": nn.linear_init(gen, nhp * hd, d, axes=("q_proj", "embed"),
                            dtype=dt, stddev=1.0 / math.sqrt(nh * hd),
                            device=device),
    }
    if nhp != nh:
        mask = _pad_head_mask(cfg).to(device)  # [nhp] bool, True = real
        o = p["o"]["w"].value.reshape(nhp, hd, d)
        p["o"]["w"].value = (o * mask[:, None, None].to(o.dtype)).reshape(
            nhp * hd, d)
    if cfg.qk_norm:
        p["q_norm"] = nn.rmsnorm_init(hd, axis="head_dim", dtype=dt,
                                      device=device)
        p["k_norm"] = nn.rmsnorm_init(hd, axis="head_dim", dtype=dt,
                                      device=device)
    return p


def _pad_head_mask(cfg: ModelConfig):
    """[padded_heads] bool mask; heads grouped per kv head with pads last."""
    nkv = cfg.n_kv_heads
    g_real = cfg.n_heads // nkv
    g_pad = cfg.padded_heads // nkv
    m = torch.zeros((nkv, g_pad), dtype=torch.bool)
    m[:, :g_real] = True
    return m.reshape(-1)


# ---------------------------------------------------------------------------
# Projections
# ---------------------------------------------------------------------------


def _tp_ok(cfg: ModelConfig, mesh) -> bool:
    return (cfg.explicit_tp and mesh is not None
            and "model" in nn.axis_names(mesh)
            and cfg.padded_heads % nn.mesh_shape(mesh)["model"] == 0)


def project_q(p, x, cfg: ModelConfig, mesh=None):
    """q [B,S,Hq,D] without rope: the query side of ``_project_qkv``, all
    that cross-attention over cached encoder K/V needs (Hq is
    ``padded_heads``)."""
    B, S, _ = x.shape
    if _tp_ok(cfg, mesh):
        q = nn.linear_apply_tp(p["q"], x, "column", mesh, cfg.cdtype,
                               fsdp=cfg.fsdp_params)
    else:
        q = nn.linear_apply(p["q"], x, cfg.cdtype)
    q = nn.reshape(q, B, S, cfg.padded_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = nn.rmsnorm_apply(p["q_norm"], q, cfg.norm_eps)
    return q


def _project_qkv(p, x, x_kv, cfg: ModelConfig, q_positions, kv_positions,
                 *, rope: bool, mesh=None):
    """Return q [B,S,Hq,D], k/v [B,Skv,Hkv,D]."""
    Skv = x_kv.shape[1]
    B = x.shape[0]
    cd = cfg.cdtype
    q = project_q(p, x, cfg, mesh)
    k = nn.reshape(nn.linear_apply(p["k"], x_kv, cd), B, Skv,
                   cfg.n_kv_heads, cfg.head_dim)
    v = nn.reshape(nn.linear_apply(p["v"], x_kv, cd), B, Skv,
                   cfg.n_kv_heads, cfg.head_dim)
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


def _head_spec(cfg: ModelConfig, mesh, batch: int):
    """(batch, None, "model", None) when q-heads divide the model axis."""
    if mesh is None or "model" not in nn.axis_names(mesh):
        return None
    if cfg.padded_heads % nn.mesh_shape(mesh)["model"]:
        return None
    return nn.batch_pspec(mesh, batch, extra_dims=1) + ("model", None)


def _attend(q, k, v, cfg: ModelConfig, mesh, fn):
    """``fn(q, k, v)`` ([B,S,H,D] tensors, no DTensor) on each rank's
    shard: the reference's ``_constrain_heads`` and the attention after
    it.  Where the q-heads divide the model axis, q is head-sharded and
    K/V are repeated to ``padded_heads`` and sliced to the rank's heads
    (the kv heads are replicated over model), so ``fn`` sees G 1; else
    every model rank attends its batch shard over all heads."""
    if mesh is None:
        return fn(q, k, v)
    spec = _head_spec(cfg, mesh, q.shape[0])
    bspec = nn.batch_pspec(mesh, q.shape[0], extra_dims=3)
    if spec is None:
        return nn.local_map(fn, mesh, [bspec] * 3, [bspec], q, k, v)
    hl = cfg.padded_heads // nn.mesh_shape(mesh)["model"]
    j = mesh.get_local_rank("model")

    def local(ql, kl, vl):
        kl = _repeat_kv(kl, cfg.padded_heads)[:, :, j * hl:(j + 1) * hl]
        vl = _repeat_kv(vl, cfg.padded_heads)[:, :, j * hl:(j + 1) * hl]
        return fn(ql, kl, vl)

    return nn.local_map(local, mesh, [spec, bspec, bspec], [spec], q, k, v)


def attention_apply(p, x, cfg: ModelConfig, *, causal=True, positions=None,
                    x_kv=None, rope=True, mesh=None, seq_shard=False):
    """Self- (or, with ``x_kv``, cross-) attention over a full sequence.

    Causal self-attention (the decoder's training forward) goes through
    ``kernels.flash_attention.ops.flash_attention``: the hand-written CUDA
    kernel whenever the tensors are on the card, its plain version on the
    CPU.  Non-causal self-attention (the encoder) and cross-attention
    (keys at positions ``0..Skv-1`` of ``x_kv``, never masked) run
    ``full_attention`` in PyTorch ops, as the reference does: it sends
    only causal self-attention to its Pallas kernel.  Under a mesh both
    run on each rank's local shard (``_attend``); with ``explicit_tp``
    the q and o projections are the tensor-parallel linears."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    if x_kv is None:
        q, k, v = _project_qkv(p, x, x, cfg, positions, positions, rope=rope,
                               mesh=mesh)
    else:
        kv_positions = torch.arange(x_kv.shape[1], device=x.device)[None, :]
        q, k, v = _project_qkv(p, x, x_kv, cfg, positions, kv_positions,
                               rope=rope, mesh=mesh)
    if causal and x_kv is None:
        out = _attend(q, k, v, cfg, mesh, fa_ops.flash_attention)
    else:
        out = _attend(q, k, v, cfg, mesh,
                      lambda q, k, v: full_attention(q, k, v, causal=False))
    out = nn.reshape(out, B, S, cfg.padded_heads * cfg.head_dim)
    if _tp_ok(cfg, mesh):
        return nn.linear_apply_tp(p["o"], out, "row", mesh, cfg.cdtype,
                                  fsdp=cfg.fsdp_params, seq_shard=seq_shard)
    return nn.linear_apply(p["o"], out, cfg.cdtype)


# ---------------------------------------------------------------------------
# Serving entry points
# ---------------------------------------------------------------------------


def attention_prefill(p, x, cfg: ModelConfig, *, positions=None,
                      mesh=None):
    """Prefill: forward + return (output, (k_cache_entries, v_cache_entries)).
    The algorithm is the reference's: ``chunked_causal_attention`` where
    ``_pick_impl`` says "chunked" and the blocks divide S, else
    ``full_attention``.  Under a mesh it runs on each rank's shard as the
    training forward's attention does (``_attend``: heads over "model"
    where they divide it), with the tensor-parallel q and o under
    ``explicit_tp``; the K/V come back batch-sharded, replicated over
    "model"."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, x, cfg, positions, positions,
                           rope=cfg.positions == "rope", mesh=mesh)
    if _pick_impl(cfg, S) == "chunked" and S % cfg.attn_chunk_q == 0:
        def fn(q, k, v):
            return chunked_causal_attention(q, k, v, block_q=cfg.attn_chunk_q,
                                            block_k=cfg.attn_chunk_k)
    else:
        def fn(q, k, v):
            return full_attention(q, k, v, causal=True)
    out = nn.reshape(_attend(q, k, v, cfg, mesh, fn), B, S,
                     cfg.padded_heads * cfg.head_dim)
    if _tp_ok(cfg, mesh):
        return nn.linear_apply_tp(p["o"], out, "row", mesh, cfg.cdtype,
                                  fsdp=cfg.fsdp_params), (k, v)
    return nn.linear_apply(p["o"], out, cfg.cdtype), (k, v)


def _write_rows(cache, pos, new, lo: int = 0):
    """``cache[b, pos[b, t] - lo] = new[b, t]`` in place for the
    consecutive positions ``pos`` [B, T], dropping every position outside
    the cache's rows ``[lo, lo + S)`` (``lo`` > 0: a rank's shard of a
    sequence-split cache).  The writes go through positions clamped to
    the rows, and the end rows are then set to what they must hold: the
    chunk's own entry for them, or their value before the call (so the
    dropped writes, which collide there, leave no trace, with no host
    sync)."""
    B, T = pos.shape
    last = cache.shape[1] - 1
    bidx = torch.arange(B, device=pos.device)
    rel = pos - lo
    ends = (last, 0) if lo else (last,)
    before = [cache[:, row].clone() for row in ends]
    cache[bidx[:, None], rel.clamp(0, last)] = new.to(cache.dtype)
    for row, old in zip(ends, before):
        t = row - rel[:, 0]  # the chunk entry that belongs at this row
        own = ((t >= 0) & (t < T)).reshape((B,) + (1,) * (cache.dim() - 2))
        cache[:, row] = torch.where(
            own, new[bidx, t.clamp(0, T - 1)].to(cache.dtype), old)


# ---------------------------------------------------------------------------
# Serving under a mesh: each rank's shard of the cache
# ---------------------------------------------------------------------------


def _combine_model(out, lse, mesh):
    """The decode outputs of the "model" ranks' sequence shards, each
    [B,1,Hq,D] with its log-sum-exp [B,Hq], combined as the kernel
    combines its cluster's blocks: sum_r e^(lse_r - lse) out_r, lse =
    log sum_r e^lse_r (two all-reduces: the max, then the weighted output
    and the weights, summed as one tensor).  A rank with no valid
    position has lse -inf and adds 0."""
    m = nn.psum_model(lse, mesh, "max")
    w = torch.exp(lse - m)[:, None, :, None]
    sums = nn.psum_model(torch.cat([w * out.float(), w], dim=-1), mesh)
    return (sums[..., :-1] / sums[..., -1:]).to(out.dtype)


def decode_on_shards(q, cache_k, cache_v, kv_length, mesh, *, new=None):
    """Contiguous decode (``ops.decode_attention``) under ``mesh`` on each
    rank's shard of the caches [B,S,Hkv,D] (DTensors laid out by
    ``launch.specs.cache_specs``, or plain tensors, replicated): ``new``
    = (k_new, v_new) [B,1,Hkv,D] is first written at ``kv_length`` [B]
    (the row lands on the rank whose shard holds it; a full cache drops
    it), then each rank attends its positions.  A sequence split over
    "model" gives each rank the local length clamp(len + 1 - lo, 0,
    S_loc) and the kernel's log-sum-exp, and the ranks' outputs are
    combined (``_combine_model``); an unsplit one is attended whole.
    ``new=None`` (cross attention): nothing is written and every position
    is valid.  Returns out [B,1,Hq,D], batch-sharded as the cache."""
    cache_k, cache_v = (nn.as_dtensor(c, mesh) for c in (cache_k, cache_v))
    cspec = nn.spec_of(cache_k)
    if cspec[1] not in (None, "model"):
        raise ValueError(f"a decode cache splits its sequence over 'model' "
                         f"or not at all, not {cspec}")
    split = cspec[1] == "model"
    lo = nn.local_offsets(cache_k)[1]
    b, h = cspec[0], cspec[2]
    qspec = (b, None, h, None)
    S = cache_k.shape[1]

    def fn(ql, kl, vl, lens, *kv_new):
        if kv_new:
            _write_rows(kl, lens[:, None], kv_new[0], lo)
            _write_rows(vl, lens[:, None], kv_new[1], lo)
            n = lens + 1
        else:
            n = torch.full_like(lens, S)
        # the kernel reads contiguous inputs (the writes above went to
        # the shards themselves)
        ql, kl, vl = (t.contiguous() for t in (ql, kl, vl))
        if not split:
            return da_ops.decode_attention(ql, kl, vl, n.to(torch.int32))
        n_loc = (n - lo).clamp(0, kl.shape[1]).to(torch.int32)
        out, lse = da_ops.decode_attention(ql, kl, vl, n_loc, return_lse=True)
        return _combine_model(out, lse, mesh)

    args = [q, cache_k, cache_v, kv_length]
    specs = [qspec, cspec, cspec, (b,)]
    if new is not None:
        args += list(new)
        specs += [qspec, qspec]
    return nn.local_map(fn, mesh, specs, [qspec], *args)


def paged_on_shards(q, k_store, v_store, block_tables, kv_length, k_new,
                    v_new, write_phys, write_off, mesh):
    """Paged decode (``ops.paged_decode_attention``) under ``mesh``.  The
    store [num_blocks, block_size, Hkv, D] is shared by every sequence, so
    it is never split by batch or inside a block: its kv heads lie on
    "model" where Hkv divides it (each rank runs the unchanged kernel on
    its q heads and their kv heads), else it is replicated and each rank
    attends all heads.  Every data rank holds the whole store, so each
    writes every row's new K/V (its heads); each then attends its batch
    shard's sequences.  Returns out [B,1,Hq,D]."""
    k_store, v_store = (nn.as_dtensor(s, mesh) for s in (k_store, v_store))
    h = nn.spec_of(k_store)[2]
    b = nn.batch_pspec(mesh, q.shape[0], extra_dims=0)[0]
    sspec, nspec = (None, None, h, None), (None, None, h, None)

    def fn(ql, ks, vs, bt, lens, kn, vn, wp, wo):
        ks[wp.long(), wo.long()] = kn[:, 0].to(ks.dtype)
        vs[wp.long(), wo.long()] = vn[:, 0].to(vs.dtype)
        return da_ops.paged_decode_attention(
            ql.contiguous(), ks.contiguous(), vs.contiguous(), bt, lens + 1)

    qspec = (b, None, h, None)
    return nn.local_map(
        fn, mesh, [qspec, sspec, sspec, (b, None), (b,), nspec, nspec,
                   (None,), (None,)], [qspec],
        q, k_store, v_store, block_tables, kv_length, k_new, v_new,
        write_phys, write_off)


def _extend_attend(q, cache_k, cache_v, pos, cfg: ModelConfig):
    """The chunk's attention over a whole cache (``attention_extend``'s
    score math)."""
    B, T = pos.shape
    Smax = cache_k.shape[1]
    Hq = q.shape[2]
    k = _repeat_kv(cache_k, Hq)
    v = _repeat_kv(cache_v, Hq)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    # key j is valid for chunk query t iff j <= its absolute position
    mask = (torch.arange(Smax, device=q.device)[None, None, :]
            <= pos[:, :, None])  # [B,T,Smax]
    logits = torch.where(mask[:, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def _extend_on_shards(q, cache_k, cache_v, k_new, v_new, pos, cfg, mesh):
    """``attention_extend``'s writes and attention under ``mesh``: each
    rank writes the chunk's rows that fall in its shard of the cache (by
    sequence, or by kv head for a paged view), then the cache is gathered
    over "model" and each rank attends its batch shard over all of it, in
    the unsharded score math."""
    cache_k, cache_v = (nn.as_dtensor(c, mesh) for c in (cache_k, cache_v))
    cspec = nn.spec_of(cache_k)
    lo = nn.local_offsets(cache_k)[1]
    nspec = (cspec[0], None, cspec[2], None)

    def write(cl, nl, pl):
        _write_rows(cl, pl, nl, lo)
        return cl

    for c, n in ((cache_k, k_new), (cache_v, v_new)):
        nn.local_map(write, mesh, [cspec, nspec, (cspec[0], None)], [cspec],
                     c, n, pos)
    b = nn.batch_pspec(mesh, q.shape[0], extra_dims=0)[0]
    full = (b, None, None, None)
    return nn.local_map(lambda ql, kl, vl, pl: _extend_attend(ql, kl, vl, pl,
                                                              cfg),
                        mesh, [full, full, full, (b, None)], [full],
                        q, cache_k, cache_v, pos)


def attention_extend(p, x, cache_k, cache_v, kv_length, cfg: ModelConfig,
                     mesh=None):
    """Multi-token cache extension (chunked prefill).

    x: [B,T,d] new tokens appended at positions kv_length..kv_length+T-1;
    cache_k/v: [B,Smax,Hkv,D], written IN PLACE at those positions (a
    position past the cache, as a padded chunk's tail can reach, is
    dropped, as the reference's ``.at[].set`` drops it); kv_length: [B]
    valid entries *before* this chunk.  Returns (out [B,T,d], cache_k,
    cache_v, new_len).  Each chunk query attends to the cache prefix plus
    the chunk's own causal triangle, with the score math of
    ``full_attention``.  Under a mesh: ``_extend_on_shards`` (each rank
    writes its shard, then attends the gathered cache)."""
    B, T, _ = x.shape
    pos = kv_length[:, None] + torch.arange(T, device=x.device)[None, :]
    q, k_new, v_new = _project_qkv(p, x, x, cfg, pos, pos,
                                   rope=cfg.positions == "rope")
    if mesh is not None:
        out = _extend_on_shards(q, cache_k, cache_v, k_new, v_new, pos, cfg,
                                mesh)
    else:
        _write_rows(cache_k, pos, k_new)
        _write_rows(cache_v, pos, v_new)
        out = _extend_attend(q, cache_k, cache_v, pos, cfg)
    out = nn.reshape(out, B, T, cfg.padded_heads * cfg.head_dim)
    return (nn.linear_apply(p["o"], out, cfg.cdtype), cache_k, cache_v,
            kv_length + T)


def attention_decode(p, x, cache_k, cache_v, kv_length, cfg: ModelConfig,
                     mesh=None):
    """Single-token decode step against contiguous caches.

    x: [B,1,d]; cache_k/v: [B,Smax,Hkv,D], written IN PLACE at
    ``kv_length``; kv_length: [B] valid entries *before* this token.  A row
    whose cache is full (``kv_length >= Smax``, as a free slot's length
    grows past it) drops its write and attends every position, as the
    reference does (its ``.at[].set`` drops the out-of-range write and its
    mask admits all Smax positions).  Attention runs
    ``ops.decode_attention``: the hand-written CUDA kernel whenever the
    tensors are on the card, its plain version on the CPU.  Under a mesh
    it runs on each rank's shard of the caches (``decode_on_shards``).
    Returns (out [B,1,d], cache_k, cache_v, new_len)."""
    B = x.shape[0]
    Smax = cache_k.shape[1]
    pos = kv_length[:, None]
    q, k_new, v_new = _project_qkv(p, x, x, cfg, pos, pos,
                                   rope=cfg.positions == "rope")
    new_len = kv_length + 1
    if mesh is not None:
        out = decode_on_shards(q, cache_k, cache_v, kv_length, mesh,
                               new=(k_new, v_new))
        out = nn.reshape(out, B, 1, cfg.padded_heads * cfg.head_dim)
        return (nn.linear_apply(p["o"], out, cfg.cdtype), cache_k, cache_v,
                new_len)
    bidx = torch.arange(B, device=x.device)
    fits = (kv_length < Smax)[:, None, None]
    wpos = kv_length.clamp(max=Smax - 1).long()
    cache_k[bidx, wpos] = torch.where(fits, k_new[:, 0].to(cache_k.dtype),
                                      cache_k[bidx, wpos])
    cache_v[bidx, wpos] = torch.where(fits, v_new[:, 0].to(cache_v.dtype),
                                      cache_v[bidx, wpos])
    out = da_ops.decode_attention(q, cache_k, cache_v, new_len)
    out = out.reshape(B, 1, cfg.padded_heads * cfg.head_dim)
    return nn.linear_apply(p["o"], out, cfg.cdtype), cache_k, cache_v, new_len


def attention_decode_paged(p, x, k_store, v_store, block_tables, kv_length,
                           write_phys, write_off, cfg: ModelConfig,
                           mesh=None):
    """Single-token decode directly against a block-paged KV store.

    x: [B,1,d]; k_store/v_store: [num_blocks, block_size, Hkv, D] (one
    layer's stores, shared by every sequence); block_tables: [B,
    max_blocks] int32; kv_length: [B] int32 valid positions *before* this
    token; write_phys/write_off: [B] the (physical block, in-block offset)
    cell this token's K/V is written into, IN PLACE (padded rows point at
    the null block's cell (0, 0), where collisions are harmless).

    Attention then reads K/V through the block table in
    ``ops.paged_decode_attention``: the hand-written CUDA kernel whenever
    the tensors are on the card, its plain version on the CPU.  Under a
    mesh it runs on each rank's heads of the store (``paged_on_shards``).
    Returns (out [B,1,d], k_store, v_store)."""
    B = x.shape[0]
    pos = kv_length[:, None]
    q, k_new, v_new = _project_qkv(p, x, x, cfg, pos, pos,
                                   rope=cfg.positions == "rope")
    if mesh is not None:
        out = paged_on_shards(q, k_store, v_store, block_tables, kv_length,
                              k_new, v_new, write_phys, write_off, mesh)
        out = nn.reshape(out, B, 1, cfg.padded_heads * cfg.head_dim)
        return nn.linear_apply(p["o"], out, cfg.cdtype), k_store, v_store
    k_store[write_phys, write_off] = k_new[:, 0].to(k_store.dtype)
    v_store[write_phys, write_off] = v_new[:, 0].to(v_store.dtype)
    out = da_ops.paged_decode_attention(q, k_store, v_store, block_tables,
                                        kv_length + 1)
    out = out.reshape(B, 1, cfg.padded_heads * cfg.head_dim)
    return nn.linear_apply(p["o"], out, cfg.cdtype), k_store, v_store
