"""RWKV6 ("Finch") — attention-free LM with data-dependent decay.

The counterpart of the JAX package's ``models/rwkv6.py``.  Time-mix:
token-shift with LoRA-dynamic mixing coefficients, per-channel
data-dependent decay ``w_t = exp(-exp(logit))``, bonus ``u``, and the WKV
linear-attention state ``S in [B,H,hd_k,hd_v]``.

Prefill and forward use the chunked WKV (``wkv_chunked``, through
``kernels.rwkv6.ops.wkv``: the hand-written CUDA kernel whenever the
tensors are on the card, its plain version on the CPU).  Decode is the
O(1) recurrence (``wkv_step``).  Where the reference stacks layer params
``[L, ...]`` and scans them, ``p["blocks"]`` is a list of per-layer dicts
walked by a Python loop; the serving state is a dict of stacked tensors
``{"att": {"shift": [L,B,d], "wkv": [L,B,H,hd,hd]}, "ffn": {"shift":
[L,B,d]}}``, which ``rwkv_decode_step`` updates in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.kernels.rwkv6 import ops as wkv_ops

from . import nn
from . import transformer as tfm
from .config import ModelConfig


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def _heads(cfg: ModelConfig):
    hd = cfg.rwkv_head_dim
    H = cfg.d_model // hd
    return H, hd


def rwkv_block_init(gen, cfg: ModelConfig, *, device="cpu"):
    d, ff = cfg.d_model, cfg.d_ff
    Lm, Ld = cfg.rwkv_lora_mix, cfg.rwkv_lora_decay
    dt = cfg.pdtype
    f32 = torch.float32

    def zeros(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    def linear(d_in, d_out):
        return nn.linear_init(gen, d_in, d_out, dtype=dt, device=device)

    att = {
        "ln": nn.layernorm_init(d, dtype=dt, device=device),
        "maa_x": zeros((d,)),
        "maa": zeros((5, d)),
        "tm_A": nn.lecun_init(gen, (d, 5 * Lm), dt, d, device),
        "tm_B": nn.normal_init(gen, (5, Lm, d), dt, 0.01, device),
        "r": linear(d, d),
        "k": linear(d, d),
        "v": linear(d, d),
        "g": linear(d, d),
        "decay_base": torch.full((d,), -1.0, dtype=f32, device=device),
        "dec_A": nn.lecun_init(gen, (d, Ld), dt, d, device),
        "dec_B": nn.normal_init(gen, (Ld, d), dt, 0.01, device),
        "u": zeros((d,), f32),
        "ln_x": nn.layernorm_init(d, dtype=dt, device=device),
        "o": linear(d, d),
    }
    ffn = {
        "ln": nn.layernorm_init(d, dtype=dt, device=device),
        "maa_k": zeros((d,)),
        "maa_r": zeros((d,)),
        "k": linear(d, ff),
        "v": linear(ff, d),
        "r": linear(d, d),
    }
    return {"att": att, "ffn": ffn}


# ---------------------------------------------------------------------------
# WKV core
# ---------------------------------------------------------------------------


def wkv_chunked(r, k, v, lw, u, chunk: int, s0=None):
    """Chunked WKV6.

    r,k,v [B,T,H,hd]; lw = log-decay [B,T,H,hd] (<= 0); u [H,hd].
    Returns (y [B,T,H,hd], s_final [B,H,hd,hd])."""
    return wkv_ops.wkv(r, k, v, lw.float(), u.float(), chunk=chunk,
                       s0=None if s0 is None else s0.float())


def wkv_recurrent(r, k, v, lw, u, s0=None):
    """Step-by-step oracle. Same returns as wkv_chunked."""
    B, T, H, hd = r.shape
    S = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    ys = []
    for t in range(T):
        S, y = wkv_step(S, r[:, t], k[:, t], v[:, t], lw[:, t], u)
        ys.append(y)
    return torch.stack(ys, dim=1).to(r.dtype), S


def wkv_step(S, r_t, k_t, v_t, lw_t, u):
    """One WKV step. S [B,H,hd,hd]; r/k/v/lw [B,H,hd]; u [H,hd]."""
    r_t, k_t, v_t, lw_t = (x.float() for x in (r_t, k_t, v_t, lw_t))
    kv = torch.einsum("bha,bhv->bhav", k_t, v_t)
    y = torch.einsum("bha,bhav->bhv", r_t,
                     S + u.float()[None, :, :, None] * kv)
    S_new = torch.exp(lw_t)[..., None] * S + kv
    return S_new, y


# ---------------------------------------------------------------------------
# Block apply
# ---------------------------------------------------------------------------


def _token_shift(x, shift_state=None):
    """Previous token (zeros at position 0 or shift_state). x [B,T,d]."""
    if shift_state is None:
        return F.pad(x[:, :-1], (0, 0, 1, 0))
    return torch.cat([shift_state[:, None, :].to(x.dtype), x[:, :-1]], dim=1)


def _dynamic_mix(p, x, xx):
    """RWKV6 LoRA token-shift mixing -> 5 mixed streams (w,k,v,r,g)."""
    dx = xx - x
    xxx = x + dx * p["maa_x"].to(x.dtype)[None, None, :]
    B, T, d = x.shape
    lora = torch.tanh(xxx @ p["tm_A"].to(x.dtype))  # [B,T,5*Lm]
    lora = lora.reshape(B, T, 5, -1)
    dyn = torch.einsum("btml,mld->mbtd", lora, p["tm_B"].to(x.dtype))
    maa = p["maa"].to(x.dtype)  # [5,d]
    return x[None] + dx[None] * (maa[:, None, None, :] + dyn)  # [5,B,T,d]


def time_mix_apply(p, x, cfg: ModelConfig, *, state=None, chunked=True):
    """Time-mix sub-block. state: {"shift": [B,d], "wkv": [B,H,hd,hd]}."""
    H, hd = _heads(cfg)
    B, T, d = x.shape
    shift = state["shift"] if state is not None else None
    xx = _token_shift(x, shift)
    xw, xk, xv, xr, xg = _dynamic_mix(p, x, xx)
    cd = cfg.cdtype
    r = nn.linear_apply(p["r"], xr, cd).reshape(B, T, H, hd)
    k = nn.linear_apply(p["k"], xk, cd).reshape(B, T, H, hd)
    v = nn.linear_apply(p["v"], xv, cd).reshape(B, T, H, hd)
    g = F.silu(nn.linear_apply(p["g"], xg, cd))
    # data-dependent decay (per channel)
    dec = p["decay_base"].float() + (
        torch.tanh(xw.float() @ p["dec_A"].float()) @ p["dec_B"].float())
    lw = -torch.exp(dec).reshape(B, T, H, hd)  # log w <= 0
    u = p["u"].float().reshape(H, hd)
    s0 = state["wkv"] if state is not None else None
    if chunked:
        y, s_final = wkv_chunked(r, k, v, lw, u, cfg.rwkv_chunk, s0=s0)
    else:
        y, s_final = wkv_recurrent(r, k, v, lw, u, s0=s0)
    # per-head group norm
    yh = y.reshape(B, T, H, hd)
    mu = yh.mean(-1, keepdim=True)
    var = yh.var(-1, keepdim=True, correction=0)
    yh = (yh - mu) * torch.rsqrt(var + 64e-5)
    y = yh.reshape(B, T, d) * p["ln_x"]["scale"].to(y.dtype) + \
        p["ln_x"]["bias"].to(y.dtype)
    y = nn.linear_apply(p["o"], y * g, cd)
    return y, {"shift": x[:, -1, :], "wkv": s_final}


def channel_mix_apply(p, x, cfg: ModelConfig, *, state=None):
    """Channel-mix (squared-relu FFN with receptance gate)."""
    shift = state["shift"] if state is not None else None
    xx = _token_shift(x, shift)
    dx = xx - x
    xk = x + dx * p["maa_k"].to(x.dtype)[None, None, :]
    xr = x + dx * p["maa_r"].to(x.dtype)[None, None, :]
    cd = cfg.cdtype
    k = nn.squared_relu(nn.linear_apply(p["k"], xk, cd))
    kv = nn.linear_apply(p["v"], k, cd)
    out = torch.sigmoid(nn.linear_apply(p["r"], xr, cd)) * kv
    return out, {"shift": x[:, -1, :]}


def rwkv_block_apply(p, x, cfg: ModelConfig, *, state=None, chunked=True):
    att_state = state["att"] if state is not None else None
    ffn_state = state["ffn"] if state is not None else None
    h = nn.layernorm_apply(p["att"]["ln"], x, cfg.norm_eps)
    dy, new_att = time_mix_apply(p["att"], h, cfg, state=att_state,
                                 chunked=chunked)
    x = x + dy
    h = nn.layernorm_apply(p["ffn"]["ln"], x, cfg.norm_eps)
    dy, new_ffn = channel_mix_apply(p["ffn"], h, cfg, state=ffn_state)
    return x + dy, {"att": new_att, "ffn": new_ffn}


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------


def rwkv_init(gen, cfg: ModelConfig, *, device=None):
    """RWKV6 params drawn from ``gen`` on ``device`` (the reference's
    distributions: lecun-normal linears, LoRA up-projections with std 0.01,
    zero mixing coefficients and bonus, decay base -1); ``None`` is the
    CUDA card (``resolve_device``)."""
    device = resolve_device(device)
    dt = cfg.pdtype
    return {
        "embed": nn.embedding_init(gen, cfg.vocab, cfg.d_model, dtype=dt,
                                   device=device),
        "ln_in": nn.layernorm_init(cfg.d_model, dtype=dt, device=device),
        "blocks": [rwkv_block_init(gen, cfg, device=device)
                   for _ in range(cfg.n_layers)],
        "ln_f": nn.layernorm_init(cfg.d_model, dtype=dt, device=device),
        "unembed": nn.linear_init(gen, cfg.d_model, cfg.vocab, dtype=dt,
                                  device=device),
    }


def _empty_state(cfg: ModelConfig, batch: int, device):
    H, hd = _heads(cfg)
    d = cfg.d_model
    return {
        "att": {"shift": torch.zeros((batch, d), dtype=cfg.cdtype,
                                     device=device),
                "wkv": torch.zeros((batch, H, hd, hd), dtype=torch.float32,
                                   device=device)},
        "ffn": {"shift": torch.zeros((batch, d), dtype=cfg.cdtype,
                                     device=device)},
    }


def _embed(p, tokens, cfg: ModelConfig):
    x = nn.embedding_apply(p["embed"], tokens, cfg.cdtype)
    return nn.layernorm_apply(p["ln_in"], x, cfg.norm_eps)


def _readout(p, x, cfg: ModelConfig):
    x = nn.layernorm_apply(p["ln_f"], x, cfg.norm_eps)
    return nn.linear_apply(p["unembed"], x, torch.float32)


def rwkv_forward(p, batch, cfg: ModelConfig):
    """tokens [B,T] -> (logits [B,T,V], aux = 0).  ``cfg.remat == "full"``
    checkpoints each block, as the reference's ``remat_wrap``."""
    x = _embed(p, batch["tokens"], cfg)
    run = tfm.remat_wrap(lambda x, bp: rwkv_block_apply(bp, x, cfg)[0], cfg)
    for bp in p["blocks"]:
        x = run(x, bp)
    return _readout(p, x, cfg), torch.zeros((), dtype=torch.float32,
                                             device=x.device)


def rwkv_loss(p, batch, cfg: ModelConfig):
    logits, aux = rwkv_forward(p, batch, cfg)
    return tfm._ce_from_logits(logits, batch, aux, cfg)


def rwkv_prefill(p, batch, cfg: ModelConfig, *, max_len: int = 0):
    """Prefill = full forward collecting per-layer states (no KV cache).
    Returns (state stacked over layers, logits [B,V] at the last
    position)."""
    x = _embed(p, batch["tokens"], cfg)
    init = _empty_state(cfg, x.shape[0], x.device)
    states = []
    for bp in p["blocks"]:
        x, st = rwkv_block_apply(bp, x, cfg, state=init)
        states.append(st)
    stacked = {
        "att": {name: torch.stack([st["att"][name] for st in states])
                for name in ("shift", "wkv")},
        "ffn": {"shift": torch.stack([st["ffn"]["shift"] for st in states])},
    }
    return stacked, _readout(p, x[:, -1:, :], cfg)[:, 0]


def rwkv_decode_step(p, cache, tokens, cfg: ModelConfig):
    """One recurrent step; tokens [B] -> (cache, logits [B,V]).  The
    state tensors of ``cache`` are updated in place."""
    x = _embed(p, tokens[:, None], cfg)
    for i, bp in enumerate(p["blocks"]):
        st = {"att": {"shift": cache["att"]["shift"][i],
                      "wkv": cache["att"]["wkv"][i]},
              "ffn": {"shift": cache["ffn"]["shift"][i]}}
        x, new = rwkv_block_apply(bp, x, cfg, state=st, chunked=False)
        cache["att"]["shift"][i].copy_(new["att"]["shift"])
        cache["att"]["wkv"][i].copy_(new["att"]["wkv"])
        cache["ffn"]["shift"][i].copy_(new["ffn"]["shift"])
    return cache, _readout(p, x, cfg)[:, 0]
