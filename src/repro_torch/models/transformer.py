"""Transformer LMs: decoder-only (dense, MoE), encoder-decoder (whisper)
and vision-prefix (internvl): training forward/loss and serving.

The counterpart of the JAX package's ``models/transformer.py``.  The
reference stacks layer params ``[L, ...]`` and scans them with
``jax.lax.scan`` (an MoE model's first dense layers kept apart under
``p["pre"]``); here ``p["blocks"]`` (and an encoder-decoder's
``p["enc_blocks"]``) is one list of per-layer dicts, the first dense layers
first, walked by a Python loop, on one device (no mesh).  A layer from
``first_dense_layers`` on carries ``moe`` in place of ``mlp``; its FFN
returns the router's aux loss, which the forward sums.  A decoder block of
an encoder-decoder also carries ``ln_cross``/``cross``: attention from
the text to the encoder's output.  ``cfg.remat == "full"`` wraps each
block in ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``),
so the backward runs each block's forward again; ``"dots"`` keeps the
linears' outputs and reruns the rest (``remat_wrap``).

Positions: rope inside attention, or a learned table ``pos_embed`` added
to the embeddings (read at the cache length while decoding), or the
sinusoidal table that the encoder adds to its frames.  A vision-prefix
model prepends ``patch_embeds`` to the text embeddings; its forward
scores only the text positions, its prefill keeps the prefix in the cache
and in the logits.

Caches are dicts of stacked tensors:

* contiguous (``prefill`` / ``extend_step`` / ``decode_step``):
  ``{"k": [L,B,Smax,Hkv,D], "v": [L,B,Smax,Hkv,D], "len": [B] int32}``,
  plus an encoder-decoder's ``"cross_k"``/``"cross_v"`` ``[L,B,F,Hkv,D]``:
  each layer's K/V of the F encoder frames, made once at prefill;
* paged (``paged_decode_step``): ``{"k": [L,num_blocks,block_size,Hkv,D],
  "v": ...}``, lengths kept host-side by the engine (dense and MoE only,
  as in the reference).

Cache and store tensors are updated in place (the reference's donated
functional updates) and returned.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.device import resolve_device
from repro_torch.kernels.decode_attention import ops as da_ops

from . import attention as attn
from . import moe as moe_lib
from . import nn
from .config import ModelConfig


# ---------------------------------------------------------------------------
# Block init / apply
# ---------------------------------------------------------------------------


def block_init(gen, cfg: ModelConfig, *, layer_idx: int = 0,
               cross: bool = False, device="cpu"):
    """Layer ``layer_idx``: an MoE FFN from ``first_dense_layers`` on in an
    MoE config, else a dense MLP of width ``dense_ff or d_ff``; ``cross``
    adds the encoder-decoder's cross-attention and its norm."""
    dt = cfg.pdtype
    p = {
        "ln_attn": nn.rmsnorm_init(cfg.d_model, dtype=dt, device=device),
        "attn": attn.attention_init(gen, cfg, device=device),
        "ln_mlp": nn.rmsnorm_init(cfg.d_model, dtype=dt, device=device),
    }
    if cfg.is_moe and layer_idx >= cfg.first_dense_layers:
        p["moe"] = moe_lib.moe_init(gen, cfg, device=device)
    else:
        p["mlp"] = nn.mlp_init(gen, cfg.d_model, cfg.dense_ff or cfg.d_ff,
                               gated=cfg.gated_mlp, dtype=dt, device=device)
    if cross:
        p["ln_cross"] = nn.rmsnorm_init(cfg.d_model, dtype=dt, device=device)
        p["cross"] = attn.attention_init(gen, cfg, device=device)
    return p


def _ffn(p, x, cfg: ModelConfig, decode: bool):
    """Residual FFN; returns (y, aux).  ``decode`` picks the MoE's decode
    capacity factor (every path but the training forward, as the
    reference)."""
    h = nn.rmsnorm_apply(p["ln_mlp"], x, cfg.norm_eps)
    if "moe" in p:
        h, aux = moe_lib.moe_apply(p["moe"], h, cfg, decode=decode)
    else:
        h = nn.mlp_apply(p["mlp"], h, activation=cfg.activation,
                         compute_dtype=cfg.cdtype)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + h, aux


def block_apply(p, x, cfg: ModelConfig, *, causal=True, positions=None,
                enc_out=None):
    """Full-sequence block forward (``causal=False``: an encoder block).
    Returns (y, aux_loss); aux is 0 for a dense block."""
    h = nn.rmsnorm_apply(p["ln_attn"], x, cfg.norm_eps)
    h = attn.attention_apply(p["attn"], h, cfg, causal=causal,
                             positions=positions,
                             rope=cfg.positions == "rope")
    x = x + h
    if "cross" in p and enc_out is not None:
        h = nn.rmsnorm_apply(p["ln_cross"], x, cfg.norm_eps)
        x = x + attn.attention_apply(p["cross"], h, cfg, causal=False,
                                     x_kv=enc_out, rope=False)
    return _ffn(p, x, cfg, decode=False)


def _cross_prefill(p, x, enc_out, cfg: ModelConfig):
    """Cross-attention over the encoder output; returns (out, (k, v)), the
    K/V that decode and extend read again."""
    B, S, _ = x.shape
    q, k, v = attn._project_qkv(p, x, enc_out, cfg, None, None, rope=False)
    out = attn.full_attention(q, k, v, causal=False)
    out = out.reshape(B, S, cfg.n_heads * cfg.head_dim)
    return nn.linear_apply(p["o"], out, cfg.cdtype), (k, v)


def _cross_cached(p, x, cross_k, cross_v, cfg: ModelConfig):
    """Cross-attention of x [B,T,d] over one layer's cached encoder K/V
    [B,F,Hkv,D], every frame valid: one token through
    ``ops.decode_attention`` (the contiguous CUDA kernel on the card, at
    S = F), a chunk through ``full_attention``, as the reference."""
    B, T, _ = x.shape
    q = attn.project_q(p, x, cfg)
    if T == 1:
        kv_len = torch.full((B,), cross_k.shape[1], dtype=torch.int32,
                            device=x.device)
        o = da_ops.decode_attention(q, cross_k, cross_v, kv_len)
    else:
        o = attn.full_attention(q, cross_k, cross_v, causal=False)
    o = o.reshape(B, T, cfg.n_heads * cfg.head_dim)
    return nn.linear_apply(p["o"], o, cfg.cdtype)


def block_prefill(p, x, cfg: ModelConfig, *, max_len: int, positions=None,
                  enc_out=None):
    """Prefill forward; returns (y, {"k", "v"} padded to max_len, plus
    "cross_k"/"cross_v" over the encoder output in a cross block).  More
    than ``max_len`` positions raise, as the reference's pad does (a
    negative ``F.pad`` would silently crop the cache)."""
    S = x.shape[1]
    if S > max_len:
        raise ValueError(
            f"prefill of {S} positions (a vision prefix included) does not "
            f"fit the cache's max_len {max_len}")
    h = nn.rmsnorm_apply(p["ln_attn"], x, cfg.norm_eps)
    h, (k, v) = attn.attention_prefill(p["attn"], h, cfg, positions=positions)
    pad = (0, 0, 0, 0, 0, max_len - S)
    kv = {"k": torch.nn.functional.pad(k, pad),
          "v": torch.nn.functional.pad(v, pad)}
    x = x + h
    if "cross" in p and enc_out is not None:
        h = nn.rmsnorm_apply(p["ln_cross"], x, cfg.norm_eps)
        h, (kv["cross_k"], kv["cross_v"]) = _cross_prefill(p["cross"], h,
                                                           enc_out, cfg)
        x = x + h
    y, _ = _ffn(p, x, cfg, decode=True)
    return y, kv


def block_decode(p, x, cache_k, cache_v, lens, cfg: ModelConfig, *,
                 cross=None):
    """Single-token decode against one layer's contiguous caches;
    ``cross`` is the layer's (cross_k, cross_v) in a cross block."""
    h = nn.rmsnorm_apply(p["ln_attn"], x, cfg.norm_eps)
    h, _, _, _ = attn.attention_decode(p["attn"], h, cache_k, cache_v, lens,
                                       cfg)
    x = x + h
    if "cross" in p and cross is not None:
        h = nn.rmsnorm_apply(p["ln_cross"], x, cfg.norm_eps)
        x = x + _cross_cached(p["cross"], h, *cross, cfg)
    return _ffn(p, x, cfg, decode=True)[0]


def block_decode_paged(p, x, k_store, v_store, block_tables, lens,
                       write_phys, write_off, cfg: ModelConfig):
    """Single-token decode against one layer's paged K/V stores."""
    h = nn.rmsnorm_apply(p["ln_attn"], x, cfg.norm_eps)
    h, _, _ = attn.attention_decode_paged(
        p["attn"], h, k_store, v_store, block_tables, lens, write_phys,
        write_off, cfg)
    return _ffn(p, x + h, cfg, decode=True)[0]


def block_extend(p, x, cache_k, cache_v, lens, cfg: ModelConfig, *,
                 cross=None):
    """Multi-token cache extension: x [B,T,d] appended at cache positions
    lens..lens+T-1; ``cross`` as in ``block_decode``."""
    h = nn.rmsnorm_apply(p["ln_attn"], x, cfg.norm_eps)
    h, _, _, _ = attn.attention_extend(p["attn"], h, cache_k, cache_v, lens,
                                       cfg)
    x = x + h
    if "cross" in p and cross is not None:
        h = nn.rmsnorm_apply(p["ln_cross"], x, cfg.norm_eps)
        x = x + _cross_cached(p["cross"], h, *cross, cfg)
    return _ffn(p, x, cfg, decode=True)[0]


# ---------------------------------------------------------------------------
# LM init
# ---------------------------------------------------------------------------


def lm_init(gen, cfg: ModelConfig, *, device=None):
    """LM params drawn from ``gen`` on ``device`` (lecun-normal linears and
    experts, ``o`` with std 1/sqrt(nh*hd), embedding std 1, a learned
    position table std 0.01, rmsnorm ones); ``None`` is the CUDA card
    (``resolve_device``).  An encoder-decoder has ``dec_layers`` cross
    blocks, ``enc_layers`` encoder blocks and ``enc_ln_f``."""
    device = resolve_device(device)
    dt = cfg.pdtype
    p: dict[str, Any] = {
        "embed": nn.embedding_init(gen, cfg.vocab, cfg.d_model, dtype=dt,
                                   device=device),
        "ln_f": nn.rmsnorm_init(cfg.d_model, dtype=dt, device=device),
        "blocks": [block_init(gen, cfg, layer_idx=i,
                              cross=cfg.cross_attention, device=device)
                   for i in range(cfg.dec_layers or cfg.n_layers)],
    }
    if not cfg.tie_embeddings:
        p["unembed"] = nn.linear_init(gen, cfg.d_model, cfg.vocab, dtype=dt,
                                      device=device)
    if cfg.family == "encdec":
        p["enc_blocks"] = [block_init(gen, cfg, layer_idx=i, device=device)
                           for i in range(cfg.enc_layers)]
        p["enc_ln_f"] = nn.rmsnorm_init(cfg.d_model, dtype=dt,
                                        device=device)
    if cfg.positions == "learned":
        p["pos_embed"] = {"table": nn.normal_init(
            gen, (cfg.max_seq, cfg.d_model), dt, 0.01, device)}
    return p


# ---------------------------------------------------------------------------
# Forward (training / full sequence)
# ---------------------------------------------------------------------------


# the matrix products with no batch dimension: the linears and the
# unembedding (what ``jax.checkpoint_policies.checkpoint_dots_with_no_batch_
# dims`` saves; ``bmm`` -- the attention einsums, the MoE experts -- is not)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_wrap(fn, cfg: ModelConfig):
    """``fn`` as it is (``remat="none"``), or under
    ``torch.utils.checkpoint``, as the reference's ``remat_wrap``:
    ``"dots"`` saves the outputs of ``mm``/``addmm`` and recomputes the
    rest in the backward (the hand-written kernels' forwards too); any
    other value (``"full"``) saves only the block's inputs and runs its
    forward again."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "dots":
        return lambda *args: checkpoint(
            fn, *args, use_reentrant=False,
            context_fn=lambda: create_selective_checkpoint_contexts(
                _save_dots))
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def _frame_embeds(batch, cfg: ModelConfig):
    """An encoder-decoder's stubbed audio frames [B, F, d], which a batch
    must carry (the token pipeline gives none)."""
    if "frame_embeds" not in batch:
        raise KeyError(
            f"{cfg.name} (family 'encdec') encodes audio frames: the batch "
            f"needs 'frame_embeds' [B, frames, {cfg.d_model}] beside its "
            f"tokens")
    return batch["frame_embeds"]


def _encoder_and_prefix(p, batch, cfg: ModelConfig):
    """(the encoder's output or None, the vision prefix or None)."""
    enc_out = (encode(p, _frame_embeds(batch, cfg), cfg)
               if cfg.family == "encdec" else None)
    prefix = batch.get("patch_embeds") if cfg.family == "vlm" else None
    return enc_out, prefix


def _learned_positions(p, pos, dtype):
    """Rows ``pos`` of the learned position table in ``dtype``.  A
    position past the table gives NaN, as the reference's ``jnp.take``
    fills it (only a free slot's length grows that far, and the engine
    discards that row)."""
    tab = p["pos_embed"]["table"]
    n = tab.shape[0]
    rows = tab[pos.clamp(0, n - 1).long()].to(dtype)
    return torch.where((pos < n)[..., None], rows,
                       torch.full((), float("nan"), dtype=dtype,
                                  device=rows.device))


def _embed_tokens(p, tokens, cfg: ModelConfig, *, prefix_embeds=None):
    """Token embeddings with the vision prefix prepended and learned or
    sinusoidal positions added -> (x [B,S,d], positions [1,S])."""
    x = nn.embedding_apply(p["embed"], tokens, cfg.cdtype)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    if cfg.positions == "learned":
        x = x + p["pos_embed"]["table"].to(x.dtype)[:S][None]
    elif cfg.positions == "sinusoidal":
        x = x + nn.sinusoidal_positions(S, cfg.d_model,
                                        x.device).to(x.dtype)[None]
    return x, positions


def encode(p, frame_embeds, cfg: ModelConfig):
    """The encoder stack over stubbed frame embeddings [B,F,d] (whisper):
    sinusoidal positions, non-causal blocks, ``enc_ln_f``."""
    x = frame_embeds.to(cfg.cdtype)
    S = x.shape[1]
    x = x + nn.sinusoidal_positions(S, cfg.d_model, x.device).to(x.dtype)[None]
    run = remat_wrap(lambda x, layer: block_apply(layer, x, cfg,
                                                  causal=False)[0], cfg)
    for layer in p["enc_blocks"]:
        x = run(x, layer)
    return nn.rmsnorm_apply(p["enc_ln_f"], x, cfg.norm_eps)


def _run_blocks(p, x, cfg: ModelConfig, *, positions=None, enc_out=None):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    run = remat_wrap(lambda x, layer, enc_out: block_apply(
        layer, x, cfg, causal=True, positions=positions, enc_out=enc_out),
        cfg)
    for layer in p["blocks"]:
        x, a = run(x, layer, enc_out)
        aux = aux + a
    return x, aux


def forward(p, batch, cfg: ModelConfig):
    """tokens [B,S] (with ``frame_embeds`` for an encoder-decoder and,
    optionally, ``patch_embeds`` for a vision-prefix model) -> (logits
    [B,S,V] at the text positions, aux)."""
    enc_out, prefix = _encoder_and_prefix(p, batch, cfg)
    x, positions = _embed_tokens(p, batch["tokens"], cfg,
                                 prefix_embeds=prefix)
    x, aux = _run_blocks(p, x, cfg, positions=positions, enc_out=enc_out)
    if prefix is not None:  # only score text positions
        x = x[:, prefix.shape[1]:]
    return _logits(p, x, cfg), aux


def _ce_from_logits(logits, batch, aux, cfg: ModelConfig):
    """Next-token cross entropy: float32 log-softmax, the target's
    log-likelihood, mean over ``loss_mask`` (all ones by default)."""
    targets = batch["targets"]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(targets.shape, dtype=torch.float32,
                          device=targets.device)
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    denom = torch.clamp(mask.sum(), min=1.0)
    ce = -(ll * mask).sum() / denom
    total = ce + cfg.router_aux_weight * aux
    return total, {"ce": ce, "aux": aux, "tokens": mask.sum()}


def loss_fn(p, batch, cfg: ModelConfig):
    logits, aux = forward(p, batch, cfg)
    return _ce_from_logits(logits, batch, aux, cfg)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def _logits(p, x, cfg: ModelConfig):
    x = nn.rmsnorm_apply(p["ln_f"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = nn.embedding_attend(p["embed"], x)
    else:
        logits = nn.linear_apply(p["unembed"], x, torch.float32)
    if cfg.final_logit_softcap > 0:
        c = cfg.final_logit_softcap
        logits = torch.tanh(logits / c) * c
    return logits


def prefill(p, batch, cfg: ModelConfig, *, max_len: int,
            last_only: bool = True):
    """Prefill caches; returns (cache, logits).

    A vision prefix stays in the cache and the logits (its length counts
    in ``len``); the cached positions must fit ``max_len``, or
    ``block_prefill`` raises (the reference's pad fails there too).
    ``last_only=True`` -> logits [B, vocab] at the final position; ``False``
    -> logits [B, S, vocab]."""
    enc_out, prefix = _encoder_and_prefix(p, batch, cfg)
    x, positions = _embed_tokens(p, batch["tokens"], cfg,
                                 prefix_embeds=prefix)
    B, S, _ = x.shape
    kvs = []
    for layer in p["blocks"]:
        x, kv = block_prefill(layer, x, cfg, max_len=max_len,
                              positions=positions, enc_out=enc_out)
        kvs.append(kv)
    cache = {name: torch.stack([kv[name] for kv in kvs]) for name in kvs[0]}
    cache["len"] = torch.full((B,), S, dtype=torch.int32, device=x.device)
    if last_only:
        return cache, _logits(p, x[:, -1:, :], cfg)[:, 0]
    return cache, _logits(p, x, cfg)


def _cross(cache, i):
    """Layer ``i``'s cached (cross_k, cross_v), or None."""
    if "cross_k" not in cache:
        return None
    return cache["cross_k"][i], cache["cross_v"][i]


def extend_step(p, cache, tokens, cfg: ModelConfig):
    """Chunked cache extension; tokens [B, T] -> (cache, logits [B,T,vocab]).

    The chunk is written into the cache at positions len..len+T-1 (in
    place) and logits come back for every chunk position."""
    T = tokens.shape[1]
    x = nn.embedding_apply(p["embed"], tokens, cfg.cdtype)
    lens = cache["len"]
    if cfg.positions == "learned":
        pos = lens[:, None] + torch.arange(T, device=x.device)[None, :]
        x = x + _learned_positions(p, pos, x.dtype)
    for i, layer in enumerate(p["blocks"]):
        x = block_extend(layer, x, cache["k"][i], cache["v"][i], lens, cfg,
                         cross=_cross(cache, i))
    cache["len"] = lens + T
    return cache, _logits(p, x, cfg)


def decode_step(p, cache, tokens, cfg: ModelConfig):
    """One decode step; tokens [B] -> (cache, logits [B, vocab])."""
    x = nn.embedding_apply(p["embed"], tokens[:, None], cfg.cdtype)
    lens = cache["len"]
    if cfg.positions == "learned":  # the current position: the cache length
        x = x + _learned_positions(p, lens, x.dtype)[:, None, :]
    for i, layer in enumerate(p["blocks"]):
        x = block_decode(layer, x, cache["k"][i], cache["v"][i], lens, cfg,
                         cross=_cross(cache, i))
    cache["len"] = lens + 1
    return cache, _logits(p, x, cfg)[:, 0]


def paged_decode_step(p, store, block_tables, lens, tokens, write_phys,
                      write_off, cfg: ModelConfig):
    """One decode step directly on the block-paged physical store.

    ``store`` holds k/v ``[L, num_blocks, block_size, Hkv, D]``;
    ``block_tables`` [B, max_blocks] and ``lens`` [B] (valid length before
    this token) are int32; ``write_phys``/``write_off`` [B] name the cell
    each new token's K/V is written into.  Attention reads K/V through the
    tables (the CUDA kernel on the card).  Returns (store, logits [B, V])."""
    x = nn.embedding_apply(p["embed"], tokens[:, None], cfg.cdtype)
    for i, layer in enumerate(p["blocks"]):
        x = block_decode_paged(layer, x, store["k"][i], store["v"][i],
                               block_tables, lens, write_phys, write_off,
                               cfg)
    return store, _logits(p, x, cfg)[:, 0]
