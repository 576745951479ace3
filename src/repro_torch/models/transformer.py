"""Decoder-only transformer LM (dense and MoE): training forward/loss and
serving.

The counterpart of the JAX package's ``models/transformer.py`` for dense
and MoE models.  The reference stacks layer params ``[L, ...]`` and scans
them with ``jax.lax.scan`` (an MoE model's first dense layers kept apart
under ``p["pre"]``); here ``p["blocks"]`` is one list of per-layer dicts,
the first dense layers first, walked by a Python loop, on one device (no
mesh).  A layer from ``first_dense_layers`` on carries ``moe`` in place of
``mlp``; its FFN returns the router's aux loss, which the forward sums.  ``cfg.remat == "full"`` wraps each
block in ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``), so
the backward runs each block's forward again.  Caches are dicts of stacked
tensors:

* contiguous (``prefill`` / ``extend_step`` / ``decode_step``):
  ``{"k": [L,B,Smax,Hkv,D], "v": [L,B,Smax,Hkv,D], "len": [B] int32}``;
* paged (``paged_decode_step``): ``{"k": [L,num_blocks,block_size,Hkv,D],
  "v": ...}``, lengths kept host-side by the engine.

Cache and store tensors are updated in place (the reference's donated
functional updates) and returned.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device

from . import attention as attn
from . import moe as moe_lib
from . import nn
from .config import ModelConfig


# ---------------------------------------------------------------------------
# Block init / apply
# ---------------------------------------------------------------------------


def block_init(gen, cfg: ModelConfig, *, layer_idx: int = 0, device="cpu"):
    """Layer ``layer_idx``: an MoE FFN from ``first_dense_layers`` on in an
    MoE config, else a dense MLP of width ``dense_ff or d_ff``."""
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


def block_apply(p, x, cfg: ModelConfig, *, causal=True, positions=None):
    """Full-sequence block forward.  Returns (y, aux_loss); aux is 0 for a
    dense block."""
    h = nn.rmsnorm_apply(p["ln_attn"], x, cfg.norm_eps)
    h = attn.attention_apply(p["attn"], h, cfg, causal=causal,
                             positions=positions,
                             rope=cfg.positions == "rope")
    return _ffn(p, x + h, cfg, decode=False)


def block_prefill(p, x, cfg: ModelConfig, *, max_len: int, positions=None):
    """Prefill forward; returns (y, (k, v) padded to max_len)."""
    S = x.shape[1]
    h = nn.rmsnorm_apply(p["ln_attn"], x, cfg.norm_eps)
    h, (k, v) = attn.attention_prefill(p["attn"], h, cfg, positions=positions)
    pad = (0, 0, 0, 0, 0, max_len - S)
    y, _ = _ffn(p, x + h, cfg, decode=True)
    return y, (torch.nn.functional.pad(k, pad),
               torch.nn.functional.pad(v, pad))


def block_decode(p, x, cache_k, cache_v, lens, cfg: ModelConfig):
    """Single-token decode against one layer's contiguous caches."""
    h = nn.rmsnorm_apply(p["ln_attn"], x, cfg.norm_eps)
    h, _, _, _ = attn.attention_decode(p["attn"], h, cache_k, cache_v, lens,
                                       cfg)
    return _ffn(p, x + h, cfg, decode=True)[0]


def block_decode_paged(p, x, k_store, v_store, block_tables, lens,
                       write_phys, write_off, cfg: ModelConfig):
    """Single-token decode against one layer's paged K/V stores."""
    h = nn.rmsnorm_apply(p["ln_attn"], x, cfg.norm_eps)
    h, _, _ = attn.attention_decode_paged(
        p["attn"], h, k_store, v_store, block_tables, lens, write_phys,
        write_off, cfg)
    return _ffn(p, x + h, cfg, decode=True)[0]


def block_extend(p, x, cache_k, cache_v, lens, cfg: ModelConfig):
    """Multi-token cache extension: x [B,T,d] appended at cache positions
    lens..lens+T-1."""
    h = nn.rmsnorm_apply(p["ln_attn"], x, cfg.norm_eps)
    h, _, _, _ = attn.attention_extend(p["attn"], h, cache_k, cache_v, lens,
                                       cfg)
    return _ffn(p, x + h, cfg, decode=True)[0]


# ---------------------------------------------------------------------------
# LM init
# ---------------------------------------------------------------------------


def lm_init(gen, cfg: ModelConfig, *, device=None):
    """LM params drawn from ``gen`` on ``device`` (lecun-normal linears and
    experts, ``o`` with std 1/sqrt(nh*hd), embedding std 1, rmsnorm ones);
    ``None`` is the CUDA card (``resolve_device``)."""
    device = resolve_device(device)
    dt = cfg.pdtype
    p: dict[str, Any] = {
        "embed": nn.embedding_init(gen, cfg.vocab, cfg.d_model, dtype=dt,
                                   device=device),
        "ln_f": nn.rmsnorm_init(cfg.d_model, dtype=dt, device=device),
        "blocks": [block_init(gen, cfg, layer_idx=i, device=device)
                   for i in range(cfg.n_layers)],
    }
    if not cfg.tie_embeddings:
        p["unembed"] = nn.linear_init(gen, cfg.d_model, cfg.vocab, dtype=dt,
                                      device=device)
    return p


# ---------------------------------------------------------------------------
# Forward (training / full sequence)
# ---------------------------------------------------------------------------


def remat_wrap(fn, cfg: ModelConfig):
    """``fn`` as it is (``remat="none"``), or under
    ``torch.utils.checkpoint`` (``"full"``: the backward runs its forward
    again), as the reference's ``remat_wrap``."""
    if cfg.remat not in ("none", "full"):
        raise NotImplementedError(
            f"remat={cfg.remat!r} is not ported yet: ROADMAP Queue 1 item 13 "
            f"(launch tooling)")
    if cfg.remat == "none":
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def _run_blocks(p, x, cfg: ModelConfig, *, positions=None):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    run = remat_wrap(lambda x, layer: block_apply(
        layer, x, cfg, causal=True, positions=positions), cfg)
    for layer in p["blocks"]:
        x, a = run(x, layer)
        aux = aux + a
    return x, aux


def forward(p, batch, cfg: ModelConfig):
    """tokens [B,S] -> (logits [B,S,V], aux)."""
    tokens = batch["tokens"]
    x = nn.embedding_apply(p["embed"], tokens, cfg.cdtype)
    positions = torch.arange(tokens.shape[1], device=x.device)[None, :]
    x, aux = _run_blocks(p, x, cfg, positions=positions)
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

    ``last_only=True`` -> logits [B, vocab] at the final position; ``False``
    -> logits [B, S, vocab]."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = nn.embedding_apply(p["embed"], tokens, cfg.cdtype)
    positions = torch.arange(S, device=x.device)[None, :]
    ks, vs = [], []
    for layer in p["blocks"]:
        x, (k, v) = block_prefill(layer, x, cfg, max_len=max_len,
                                  positions=positions)
        ks.append(k)
        vs.append(v)
    cache = {"k": torch.stack(ks), "v": torch.stack(vs),
             "len": torch.full((B,), S, dtype=torch.int32, device=x.device)}
    if last_only:
        return cache, _logits(p, x[:, -1:, :], cfg)[:, 0]
    return cache, _logits(p, x, cfg)


def extend_step(p, cache, tokens, cfg: ModelConfig):
    """Chunked cache extension; tokens [B, T] -> (cache, logits [B,T,vocab]).

    The chunk is written into the cache at positions len..len+T-1 (in
    place) and logits come back for every chunk position."""
    T = tokens.shape[1]
    x = nn.embedding_apply(p["embed"], tokens, cfg.cdtype)
    lens = cache["len"]
    for i, layer in enumerate(p["blocks"]):
        x = block_extend(layer, x, cache["k"][i], cache["v"][i], lens, cfg)
    cache["len"] = lens + T
    return cache, _logits(p, x, cfg)


def decode_step(p, cache, tokens, cfg: ModelConfig):
    """One decode step; tokens [B] -> (cache, logits [B, vocab])."""
    x = nn.embedding_apply(p["embed"], tokens[:, None], cfg.cdtype)
    lens = cache["len"]
    for i, layer in enumerate(p["blocks"]):
        x = block_decode(layer, x, cache["k"][i], cache["v"][i], lens, cfg)
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
