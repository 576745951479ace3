"""Transformer LMs: decoder-only (dense, MoE), encoder-decoder (whisper)
and vision-prefix (internvl): training forward/loss and serving.

The counterpart of the JAX package's ``models/transformer.py``.  The
reference stacks layer params ``[L, ...]`` and scans them with
``jax.lax.scan`` (an MoE model's first dense layers kept apart under
``p["pre"]``); here ``p["blocks"]`` (and an encoder-decoder's
``p["enc_blocks"]``) is one list of per-layer dicts, the first dense layers
first, walked by a Python loop.  Their logical axes keep the reference's
layout (``lm_init(..., with_axes=True)``: ``pre/layer_i`` apart, the
other layers stacked with ``"layers"`` first).  ``forward`` and
``loss_fn`` take the reference's ``mesh``: the residual stream is pinned
batch-parallel (and sequence-parallel over "model" with
``seq_shard_activations``), and the loss reads vocab-sharded logits
without gathering them (``_sharded_loglik``).  The serving functions take
it too: a cache laid out by ``launch.specs.cache_specs``' rule
(``nn.lay_out_cache``: the KV sequence over "model"; the pools and the
dry-run lay theirs out) has each rank's decode attend its shard, the
ranks' partial results combined by their log-sum-exp
(``attention.decode_on_shards``); the paged store splits its kv heads
(``attention.paged_on_shards``).  A layer from
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


def _sp_on(cfg: ModelConfig, mesh, x) -> bool:
    return (cfg.seq_shard_activations and mesh is not None
            and "model" in nn.axis_names(mesh)
            and x.dim() == 3 and x.shape[1] % nn.mesh_shape(mesh)["model"] == 0)


def _gather_seq(x, cfg: ModelConfig, mesh):
    """Megatron-SP: gather the seq-sharded residual before a block."""
    if not _sp_on(cfg, mesh, x):
        return x
    return nn.constrain(x, mesh, nn.batch_pspec(mesh, x.shape[0]))


def _ffn(p, x, cfg: ModelConfig, decode: bool, mesh=None):
    """Residual FFN; returns (y, aux).  ``decode`` picks the MoE's decode
    capacity factor (every path but the training forward, as the
    reference)."""
    sp = _sp_on(cfg, mesh, x)
    h = nn.rmsnorm_apply(p["ln_mlp"], _gather_seq(x, cfg, mesh), cfg.norm_eps)
    if "moe" in p:
        h, aux = moe_lib.moe_apply(p["moe"], h, cfg, decode=decode, mesh=mesh)
        if sp:
            h = nn.constrain(h, mesh, (nn.batch_pspec(mesh, x.shape[0])[0],
                                       "model", None))
    else:
        h = nn.mlp_apply(p["mlp"], h, activation=cfg.activation,
                         compute_dtype=cfg.cdtype, mesh=mesh,
                         explicit_tp=cfg.explicit_tp, fsdp=cfg.fsdp_params,
                         seq_shard=sp)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    # the branch's partial sums are reduced before they meet the residual
    # (DTensor would otherwise reduce-scatter them onto the sequence)
    return x + nn.constrain(h, mesh, _residual_spec(cfg, mesh, x.shape[0],
                                                    x.shape[1])), aux


def block_apply(p, x, cfg: ModelConfig, *, causal=True, positions=None,
                enc_out=None, mesh=None):
    """Full-sequence block forward (``causal=False``: an encoder block).
    Returns (y, aux_loss); aux is 0 for a dense block.  Under a mesh each
    branch's output is brought to the residual's layout before the add."""
    sp = _sp_on(cfg, mesh, x)
    rspec = _residual_spec(cfg, mesh, x.shape[0], x.shape[1])
    h = nn.rmsnorm_apply(p["ln_attn"], _gather_seq(x, cfg, mesh),
                         cfg.norm_eps)
    h = attn.attention_apply(p["attn"], h, cfg, causal=causal,
                             positions=positions,
                             rope=cfg.positions == "rope", mesh=mesh,
                             seq_shard=sp)
    x = x + nn.constrain(h, mesh, rspec)
    if "cross" in p and enc_out is not None:
        h = nn.rmsnorm_apply(p["ln_cross"], x, cfg.norm_eps)
        x = x + nn.constrain(
            attn.attention_apply(p["cross"], h, cfg, causal=False,
                                 x_kv=enc_out, rope=False, mesh=mesh),
            mesh, rspec)
    return _ffn(p, x, cfg, decode=False, mesh=mesh)


def _cross_prefill(p, x, enc_out, cfg: ModelConfig, mesh=None):
    """Cross-attention over the encoder output; returns (out, (k, v)), the
    K/V that decode and extend read again.  Under a mesh the attention
    runs on each rank's shard (``attention._attend``)."""
    B, S, _ = x.shape
    q, k, v = attn._project_qkv(p, x, enc_out, cfg, None, None, rope=False)
    out = attn._attend(q, k, v, cfg, mesh, lambda q, k, v:
                       attn.full_attention(q, k, v, causal=False))
    out = nn.reshape(out, B, S, cfg.n_heads * cfg.head_dim)
    return nn.linear_apply(p["o"], out, cfg.cdtype), (k, v)


def _cross_cached(p, x, cross_k, cross_v, cfg: ModelConfig, mesh=None):
    """Cross-attention of x [B,T,d] over one layer's cached encoder K/V
    [B,F,Hkv,D], every frame valid: one token through
    ``ops.decode_attention`` (the contiguous CUDA kernel on the card, at
    S = F; under a mesh on each rank's frames, ``decode_on_shards``), a
    chunk through ``full_attention``, as the reference (under a mesh over
    the gathered frames)."""
    B, T, _ = x.shape
    q = attn.project_q(p, x, cfg)
    if T == 1 and mesh is not None:
        kv_len = torch.full((B,), cross_k.shape[1], dtype=torch.int32,
                            device=x.device)
        o = attn.decode_on_shards(q, cross_k, cross_v, kv_len, mesh)
    elif T == 1:
        kv_len = torch.full((B,), cross_k.shape[1], dtype=torch.int32,
                            device=x.device)
        o = da_ops.decode_attention(q, cross_k, cross_v, kv_len)
    else:
        o = attn._attend(q, cross_k, cross_v, cfg, mesh, lambda q, k, v:
                         attn.full_attention(q, k, v, causal=False))
    o = nn.reshape(o, B, T, cfg.n_heads * cfg.head_dim)
    return nn.linear_apply(p["o"], o, cfg.cdtype)


def _pad_seq(t, max_len: int, mesh=None):
    """[B,S,H,D] K/V zero-padded to max_len positions (on each rank's
    shard under a mesh: DTensor pads no sharded tensor)."""
    pad = (0, 0, 0, 0, 0, max_len - t.shape[1])
    if mesh is None:
        return torch.nn.functional.pad(t, pad)
    spec = nn.spec_of(t)
    return nn.local_map(lambda tl: torch.nn.functional.pad(tl, pad), mesh,
                        [spec], [spec], t)


def block_prefill(p, x, cfg: ModelConfig, *, max_len: int, positions=None,
                  enc_out=None, mesh=None):
    """Prefill forward; returns (y, {"k", "v"} padded to max_len, plus
    "cross_k"/"cross_v" over the encoder output in a cross block).  More
    than ``max_len`` positions raise, as the reference's pad does (a
    negative ``F.pad`` would silently crop the cache).  Under a mesh each
    branch's output is brought to the residual's layout before the add."""
    B, S = x.shape[:2]
    if S > max_len:
        raise ValueError(
            f"prefill of {S} positions (a vision prefix included) does not "
            f"fit the cache's max_len {max_len}")
    rspec = nn.batch_pspec(mesh, B)
    h = nn.rmsnorm_apply(p["ln_attn"], x, cfg.norm_eps)
    h, (k, v) = attn.attention_prefill(p["attn"], h, cfg, positions=positions,
                                       mesh=mesh)
    kv = {"k": _pad_seq(k, max_len, mesh), "v": _pad_seq(v, max_len, mesh)}
    x = x + nn.constrain(h, mesh, rspec)
    if "cross" in p and enc_out is not None:
        h = nn.rmsnorm_apply(p["ln_cross"], x, cfg.norm_eps)
        h, (kv["cross_k"], kv["cross_v"]) = _cross_prefill(p["cross"], h,
                                                           enc_out, cfg, mesh)
        x = x + nn.constrain(h, mesh, rspec)
    y, _ = _ffn(p, x, cfg, decode=True, mesh=mesh)
    return y, kv


def block_decode(p, x, cache_k, cache_v, lens, cfg: ModelConfig, *,
                 cross=None, mesh=None):
    """Single-token decode against one layer's contiguous caches;
    ``cross`` is the layer's (cross_k, cross_v) in a cross block."""
    rspec = nn.batch_pspec(mesh, x.shape[0])
    h = nn.rmsnorm_apply(p["ln_attn"], x, cfg.norm_eps)
    h, _, _, _ = attn.attention_decode(p["attn"], h, cache_k, cache_v, lens,
                                       cfg, mesh=mesh)
    x = x + nn.constrain(h, mesh, rspec)
    if "cross" in p and cross is not None:
        h = nn.rmsnorm_apply(p["ln_cross"], x, cfg.norm_eps)
        x = x + nn.constrain(_cross_cached(p["cross"], h, *cross, cfg, mesh),
                             mesh, rspec)
    return _ffn(p, x, cfg, decode=True, mesh=mesh)[0]


def block_decode_paged(p, x, k_store, v_store, block_tables, lens,
                       write_phys, write_off, cfg: ModelConfig, *,
                       mesh=None):
    """Single-token decode against one layer's paged K/V stores."""
    h = nn.rmsnorm_apply(p["ln_attn"], x, cfg.norm_eps)
    h, _, _ = attn.attention_decode_paged(
        p["attn"], h, k_store, v_store, block_tables, lens, write_phys,
        write_off, cfg, mesh=mesh)
    x = x + nn.constrain(h, mesh, nn.batch_pspec(mesh, x.shape[0]))
    return _ffn(p, x, cfg, decode=True, mesh=mesh)[0]


def block_extend(p, x, cache_k, cache_v, lens, cfg: ModelConfig, *,
                 cross=None, mesh=None):
    """Multi-token cache extension: x [B,T,d] appended at cache positions
    lens..lens+T-1; ``cross`` as in ``block_decode``."""
    rspec = nn.batch_pspec(mesh, x.shape[0])
    h = nn.rmsnorm_apply(p["ln_attn"], x, cfg.norm_eps)
    h, _, _, _ = attn.attention_extend(p["attn"], h, cache_k, cache_v, lens,
                                       cfg, mesh=mesh)
    x = x + nn.constrain(h, mesh, rspec)
    if "cross" in p and cross is not None:
        h = nn.rmsnorm_apply(p["ln_cross"], x, cfg.norm_eps)
        x = x + nn.constrain(_cross_cached(p["cross"], h, *cross, cfg, mesh),
                             mesh, rspec)
    return _ffn(p, x, cfg, decode=True, mesh=mesh)[0]


# ---------------------------------------------------------------------------
# LM init
# ---------------------------------------------------------------------------


def lm_init(gen, cfg: ModelConfig, *, device=None, with_axes=False):
    """LM params drawn from ``gen`` on ``device`` (lecun-normal linears and
    experts, ``o`` with std 1/sqrt(nh*hd), embedding std 1, a learned
    position table std 0.01, rmsnorm ones); ``None`` is the CUDA card
    (``resolve_device``).  An encoder-decoder has ``dec_layers`` cross
    blocks, ``enc_layers`` encoder blocks and ``enc_ln_f``.  With
    ``with_axes`` -> (params, axes), the axes in the reference's layout."""
    device = resolve_device(device)
    dt = cfg.pdtype
    n_dec = cfg.dec_layers or cfg.n_layers
    n_pre = cfg.first_dense_layers if cfg.is_moe else 0
    p: dict[str, Any] = {
        "embed": nn.embedding_init(gen, cfg.vocab, cfg.d_model, dtype=dt,
                                   device=device),
        "ln_f": nn.rmsnorm_init(cfg.d_model, dtype=dt, device=device),
    }
    layers = [block_init(gen, cfg, layer_idx=i, cross=cfg.cross_attention,
                         device=device) for i in range(n_dec)]
    if not cfg.tie_embeddings:
        p["unembed"] = nn.linear_init(gen, cfg.d_model, cfg.vocab,
                                      axes=("embed", "vocab"), dtype=dt,
                                      device=device)
    enc = None
    if cfg.family == "encdec":
        enc = [block_init(gen, cfg, layer_idx=i, device=device)
               for i in range(cfg.enc_layers)]
        p["enc_ln_f"] = nn.rmsnorm_init(cfg.d_model, dtype=dt,
                                        device=device)
    if cfg.positions == "learned":
        p["pos_embed"] = {"table": nn.Px(nn.normal_init(
            gen, (cfg.max_seq, cfg.d_model), dt, 0.01, device),
            ("pos", "embed"))}
    params, axes = nn.split(p)
    params["blocks"] = []
    if n_pre:
        pre = [nn.split(t) for t in layers[:n_pre]]
        params["blocks"] = [v for v, _ in pre]
        axes["pre"] = {f"layer_{i}": a for i, (_, a) in enumerate(pre)}
    if layers[n_pre:]:  # (an MoE model cut to its dense layers has none)
        stacked, axes["blocks"] = nn.stack_layers(layers[n_pre:])
        params["blocks"] += stacked
    if enc is not None:
        params["enc_blocks"], axes["enc_blocks"] = nn.stack_layers(enc)
    return (params, axes) if with_axes else params


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


def _encoder_and_prefix(p, batch, cfg: ModelConfig, mesh=None):
    """(the encoder's output or None, the vision prefix or None)."""
    enc_out = (encode(p, _frame_embeds(batch, cfg), cfg, mesh=mesh)
               if cfg.family == "encdec" else None)
    prefix = batch.get("patch_embeds") if cfg.family == "vlm" else None
    return enc_out, prefix


def _learned_positions(p, pos, dtype, mesh=None):
    """Rows ``pos`` [B,T] of the learned position table in ``dtype`` ->
    [B,T,d].  A position past the table gives NaN, as the reference's
    ``jnp.take`` fills it (only a free slot's length grows that far, and
    the engine discards that row).  Under a mesh each rank reads its
    batch shard's rows of the (replicated) table."""
    def rows_at(tab, pos):
        n = tab.shape[0]
        rows = tab[pos.clamp(0, n - 1).long()].to(dtype)
        return torch.where((pos < n)[..., None], rows,
                           torch.full((), float("nan"), dtype=dtype,
                                      device=rows.device))

    tab = p["pos_embed"]["table"]
    if mesh is None:
        return rows_at(tab, pos)
    b = nn.batch_pspec(mesh, pos.shape[0], extra_dims=0)[0]
    return nn.local_map(rows_at, mesh, [(None, None), (b, None)],
                        [(b, None, None)], tab, pos)


def _embed_tokens(p, tokens, cfg: ModelConfig, *, prefix_embeds=None,
                  mesh=None):
    """Token embeddings with the vision prefix prepended and learned or
    sinusoidal positions added -> (x [B,S,d], positions [1,S])."""
    x = nn.embedding_apply(p["embed"], tokens, cfg.cdtype, mesh=mesh)
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


def encode(p, frame_embeds, cfg: ModelConfig, *, mesh=None):
    """The encoder stack over stubbed frame embeddings [B,F,d] (whisper):
    sinusoidal positions, non-causal blocks, ``enc_ln_f``."""
    x = frame_embeds.to(cfg.cdtype)
    S = x.shape[1]
    x = x + nn.sinusoidal_positions(S, cfg.d_model, x.device).to(x.dtype)[None]
    aspec = nn.batch_pspec(mesh, x.shape[0])

    def body(x, layer):
        x = nn.constrain(x, mesh, aspec)
        y = block_apply(layer, x, cfg, causal=False, mesh=mesh)[0]
        return nn.constrain(y, mesh, aspec)

    run = remat_wrap(body, cfg)
    for layer in p["enc_blocks"]:
        x = run(x, layer)
    return nn.rmsnorm_apply(p["enc_ln_f"], x, cfg.norm_eps)


def _residual_spec(cfg: ModelConfig, mesh, batch: int, seq: int):
    """Residual-stream sharding: batch over DP; + Megatron-SP over model
    on the sequence dim when ``seq_shard_activations``."""
    bspec = nn.batch_pspec(mesh, batch)
    if (cfg.seq_shard_activations and mesh is not None
            and "model" in nn.axis_names(mesh)
            and seq % nn.mesh_shape(mesh)["model"] == 0):
        return (bspec[0], "model", None)
    return bspec


def _run_blocks(p, x, cfg: ModelConfig, *, positions=None, enc_out=None,
                mesh=None):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    aspec = _residual_spec(cfg, mesh, x.shape[0], x.shape[1])

    def body(x, layer, enc_out):
        x = nn.constrain(x, mesh, aspec)
        y, a = block_apply(layer, x, cfg, causal=True, positions=positions,
                           enc_out=enc_out, mesh=mesh)
        return nn.constrain(y, mesh, aspec), a

    run = remat_wrap(body, cfg)
    for layer in p["blocks"]:
        x, a = run(x, layer, enc_out)
        aux = aux + a
    return x, aux


def forward(p, batch, cfg: ModelConfig, *, mesh=None):
    """tokens [B,S] (with ``frame_embeds`` for an encoder-decoder and,
    optionally, ``patch_embeds`` for a vision-prefix model) -> (logits
    [B,S,V] at the text positions, aux).  Under ``mesh`` the parameters
    and the batch are DTensors (``training.train.place_train_step``
    places them) and so are the logits, vocab-sharded over "model"."""
    with nn.mesh_context(mesh):
        enc_out, prefix = _encoder_and_prefix(p, batch, cfg, mesh)
        x, positions = _embed_tokens(p, batch["tokens"], cfg,
                                     prefix_embeds=prefix, mesh=mesh)
        bspec = nn.batch_pspec(mesh, x.shape[0])
        x = nn.constrain(x, mesh, bspec)
        x, aux = _run_blocks(p, x, cfg, positions=positions,
                             enc_out=enc_out, mesh=mesh)
        # a sequence-parallel residual is gathered before the readout
        x = nn.constrain(x, mesh, bspec)
        if prefix is not None:  # only score text positions
            x = x[:, prefix.shape[1]:]
        logits = _logits(p, x, cfg)
        if mesh is not None:
            logits = nn.constrain(logits, mesh, _logits_spec(mesh, bspec))
    return logits, aux


def _logits_spec(mesh, bspec):
    return (bspec[0], None, "model" if "model" in nn.axis_names(mesh)
            else None)


def _sharded_loglik(logits, targets, mesh, batch_size: int):
    """Per-token target log-likelihood with vocab sharded over "model".

    Runs in a local region: every vocab shard computes its local max /
    sum-exp / target logit and combines them with [B,S] reductions over
    "model"; no full-logits collective, no one-hot."""
    bspec = nn.batch_pspec(mesh, batch_size, extra_dims=1)
    v_local = logits.shape[-1] // nn.mesh_shape(mesh)["model"]
    j = mesh.get_local_rank("model")

    def local(lg, tg):
        lg = lg.float()
        # detached BEFORE the max over shards: the max shift is
        # gradient-invariant for logsumexp (the reference's stop_gradient)
        lmax = nn.psum_model(lg.max(dim=-1).values.detach(), mesh, "max")
        sumexp = torch.exp(lg - lmax[..., None]).sum(dim=-1)
        gsum = nn.psum_model(sumexp, mesh)
        local_t = tg.long() - j * v_local
        in_range = (local_t >= 0) & (local_t < v_local)
        idx = local_t.clamp(0, v_local - 1)
        tl = torch.gather(lg, -1, idx[..., None])[..., 0]
        tl = nn.psum_model(torch.where(in_range, tl, 0.0), mesh)
        return tl - lmax - torch.log(gsum)

    return nn.local_map(local, mesh, [bspec + ("model",), bspec], [bspec],
                        logits, targets)


def _loglik(logits, targets):
    logp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(logp, -1, targets.long()[..., None])[..., 0]


def _ce_from_logits(logits, batch, aux, cfg: ModelConfig, *, mesh=None):
    """Next-token cross entropy: float32 log-softmax, the target's
    log-likelihood, mean over ``loss_mask`` (all ones by default).  Under
    a mesh whose "model" divides the vocab the logits stay vocab-sharded
    (``_sharded_loglik``); else each rank reads its batch shard's whole
    rows."""
    targets = batch["targets"]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(targets.shape, dtype=torch.float32,
                          device=targets.device)
    if mesh is None:
        ll = _loglik(logits, targets)
    elif ("model" in nn.axis_names(mesh)
          and logits.shape[-1] % nn.mesh_shape(mesh)["model"] == 0):
        ll = _sharded_loglik(logits, targets, mesh, logits.shape[0])
    else:
        bspec = nn.batch_pspec(mesh, logits.shape[0], extra_dims=1)
        ll = nn.local_map(_loglik, mesh, [bspec + (None,), bspec], [bspec],
                          logits, targets)
    denom = torch.clamp(mask.sum(), min=1.0)
    ce = -(ll * mask).sum() / denom
    total = ce + cfg.router_aux_weight * aux
    return total, {"ce": ce, "aux": aux, "tokens": mask.sum()}


def loss_fn(p, batch, cfg: ModelConfig, *, mesh=None):
    with nn.mesh_context(mesh):
        logits, aux = forward(p, batch, cfg, mesh=mesh)
        return _ce_from_logits(logits, batch, aux, cfg, mesh=mesh)


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
            last_only: bool = True, mesh=None):
    """Prefill caches; returns (cache, logits).

    A vision prefix stays in the cache and the logits (its length counts
    in ``len``); the cached positions must fit ``max_len``, or
    ``block_prefill`` raises (the reference's pad fails there too).
    ``last_only=True`` -> logits [B, vocab] at the final position; ``False``
    -> logits [B, S, vocab].  Under ``mesh`` (parameters placed by
    ``SERVE_RULES``) the residual is pinned batch-parallel, the cache
    comes back as the blocks computed it (``nn.lay_out_cache`` lays it
    out by ``cache_specs``) and the logits vocab-sharded (DTensors)."""
    with nn.mesh_context(mesh):
        enc_out, prefix = _encoder_and_prefix(p, batch, cfg, mesh)
        x, positions = _embed_tokens(p, batch["tokens"], cfg,
                                     prefix_embeds=prefix, mesh=mesh)
        B, S, _ = x.shape
        aspec = nn.batch_pspec(mesh, B)
        x = nn.constrain(x, mesh, aspec)
        kvs = []
        for layer in p["blocks"]:
            x = nn.constrain(x, mesh, aspec)
            x, kv = block_prefill(layer, x, cfg, max_len=max_len,
                                  positions=positions, enc_out=enc_out,
                                  mesh=mesh)
            x = nn.constrain(x, mesh, aspec)
            kvs.append(kv)
        cache = {name: nn.stack([kv[name] for kv in kvs]) for name in kvs[0]}
        cache["len"] = torch.full((B,), S, dtype=torch.int32,
                                  device=nn.local(x).device)
        if last_only:
            return cache, _logits(p, x[:, -1:, :], cfg)[:, 0]
        return cache, _logits(p, x, cfg)


def _cross(cache, i):
    """Layer ``i``'s cached (cross_k, cross_v), or None."""
    if "cross_k" not in cache:
        return None
    return nn.index0(cache["cross_k"], i), nn.index0(cache["cross_v"], i)


def extend_step(p, cache, tokens, cfg: ModelConfig, *, mesh=None):
    """Chunked cache extension; tokens [B, T] -> (cache, logits [B,T,vocab]).

    The chunk is written into the cache at positions len..len+T-1 (in
    place; under a mesh each rank's shard) and logits come back for every
    chunk position."""
    with nn.mesh_context(mesh):
        T = tokens.shape[1]
        x = nn.embedding_apply(p["embed"], tokens, cfg.cdtype, mesh=mesh)
        x = nn.constrain(x, mesh, nn.batch_pspec(mesh, x.shape[0]))
        lens = cache["len"]
        if cfg.positions == "learned":
            pos = lens[:, None] + torch.arange(T, device=x.device)[None, :]
            x = x + _learned_positions(p, pos, x.dtype, mesh)
        for i, layer in enumerate(p["blocks"]):
            x = block_extend(layer, x, nn.index0(cache["k"], i),
                             nn.index0(cache["v"], i), lens, cfg,
                             cross=_cross(cache, i), mesh=mesh)
        cache["len"] = lens + T
        return cache, _logits(p, x, cfg)


def decode_step(p, cache, tokens, cfg: ModelConfig, *, mesh=None):
    """One decode step; tokens [B] -> (cache, logits [B, vocab])."""
    with nn.mesh_context(mesh):
        x = nn.embedding_apply(p["embed"], tokens[:, None], cfg.cdtype,
                               mesh=mesh)
        x = nn.constrain(x, mesh, nn.batch_pspec(mesh, x.shape[0]))
        lens = cache["len"]
        if cfg.positions == "learned":  # the position: the cache length
            x = x + _learned_positions(p, lens[:, None], x.dtype, mesh)
        for i, layer in enumerate(p["blocks"]):
            x = block_decode(layer, x, nn.index0(cache["k"], i),
                             nn.index0(cache["v"], i), lens, cfg,
                             cross=_cross(cache, i), mesh=mesh)
        cache["len"] = lens + 1
        return cache, _logits(p, x, cfg)[:, 0]


def paged_decode_step(p, store, block_tables, lens, tokens, write_phys,
                      write_off, cfg: ModelConfig, *, mesh=None):
    """One decode step directly on the block-paged physical store.

    ``store`` holds k/v ``[L, num_blocks, block_size, Hkv, D]``;
    ``block_tables`` [B, max_blocks] and ``lens`` [B] (valid length before
    this token) are int32; ``write_phys``/``write_off`` [B] name the cell
    each new token's K/V is written into.  Attention reads K/V through the
    tables (the CUDA kernel on the card; under a mesh on each rank's kv
    heads of the store, ``attention.paged_on_shards``).  Returns (store,
    logits [B, V])."""
    with nn.mesh_context(mesh):
        x = nn.embedding_apply(p["embed"], tokens[:, None], cfg.cdtype,
                               mesh=mesh)
        x = nn.constrain(x, mesh, nn.batch_pspec(mesh, x.shape[0]))
        for i, layer in enumerate(p["blocks"]):
            x = block_decode_paged(layer, x, nn.index0(store["k"], i),
                                   nn.index0(store["v"], i), block_tables,
                                   lens, write_phys, write_off, cfg,
                                   mesh=mesh)
        return store, _logits(p, x, cfg)[:, 0]
