"""Mamba2 (SSD) blocks and the Zamba2 hybrid model.

The counterpart of the JAX package's ``models/mamba2.py``.  Prefill and
forward use the chunked SSD (``ssd_chunked``, through
``kernels.mamba2.ops.ssd``: the hand-written CUDA kernel whenever the
tensors are on the card, its plain version on the CPU); decode is a
single-step recurrence carrying ``[B,H,N,P]`` SSM state and ``[B,W-1,C]``
conv tails.

Zamba2 wiring: groups of ``attn_every`` Mamba2 blocks, each group followed
by one *shared* transformer block (one weight copy reused at every
application, the Zamba trick), which is the port's dense
``transformer.block_*``.  Where the reference stacks the group params
``[G, K, ...]`` and scans them, ``p["groups"]`` is a list of G lists of K
block dicts walked by Python loops (their axes stacked ``[G, K, ...]`` as
the reference's, ``hybrid_init(..., with_axes=True)``).  Under a mesh
(``hybrid_forward`` / ``hybrid_loss`` and the serving functions) the
residual is pinned batch-parallel, the SSD runs on each rank's batch and
head shard (heads on "model", as the "ssm_heads" rule puts them; B and C
are replicated over it) and the logits stay vocab-sharded.  The serving cache keeps the
reference's stacked layout, ``{"ssm": {"conv": {"x","B","C": [G,K,B,W-1,
C]}, "ssm": [G,K,B,H,N,P]}, "attn": {"k","v": [G,B,Smax,Hkv,D], "len":
[G,B]}}``, which ``hybrid_decode_step`` updates in place.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.kernels.mamba2 import ops as ssd_ops

from . import nn
from . import transformer as tfm
from .config import ModelConfig


# ---------------------------------------------------------------------------
# Dims helper
# ---------------------------------------------------------------------------


def ssm_dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    H = d_in // cfg.ssm_head_dim
    N = cfg.ssm_state
    conv_dim = d_in + 2 * N
    return d_in, H, N, conv_dim


# ---------------------------------------------------------------------------
# Block params
# ---------------------------------------------------------------------------


def _uniform(gen, shape, lo, hi, device):
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    return lo + (hi - lo) * u


def mamba_block_init(gen, cfg: ModelConfig, *, device="cpu"):
    """Split projections (z / x / B / C / dt, one conv per stream), as the
    reference; dt bias is the inverse softplus of dt ~ exp(U[log 1e-3,
    log 1e-1]) and A_log = log(U[1, 16])."""
    d = cfg.d_model
    d_in, H, N, _ = ssm_dims(cfg)
    W = cfg.ssm_conv
    dt = cfg.pdtype
    f32 = torch.float32

    def linear(d_out, axes, d_in_=d):
        return nn.linear_init(gen, d_in_, d_out, axes=axes, dtype=dt,
                              device=device)

    dt0 = torch.exp(_uniform(gen, (H,), math.log(1e-3), math.log(1e-1),
                             device))
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))
    conv_std = 1.0 / math.sqrt(W)
    Px = nn.Px
    return {
        "ln": nn.rmsnorm_init(d, dtype=dt, device=device),
        "in_z": linear(d_in, ("embed", "ssm_inner")),
        "in_x": linear(d_in, ("embed", "ssm_inner")),
        "in_B": linear(N, ("embed", "ssm_state")),
        "in_C": linear(N, ("embed", "ssm_state")),
        "in_dt": linear(H, ("embed", "ssm_heads")),
        "conv_x": Px(nn.normal_init(gen, (W, d_in), dt, conv_std, device),
                     ("conv_w", "ssm_inner")),
        "conv_x_b": Px(torch.zeros((d_in,), dtype=dt, device=device),
                       ("ssm_inner",)),
        "conv_B": Px(nn.normal_init(gen, (W, N), dt, conv_std, device),
                     ("conv_w", "ssm_state")),
        "conv_B_b": Px(torch.zeros((N,), dtype=dt, device=device),
                       ("ssm_state",)),
        "conv_C": Px(nn.normal_init(gen, (W, N), dt, conv_std, device),
                     ("conv_w", "ssm_state")),
        "conv_C_b": Px(torch.zeros((N,), dtype=dt, device=device),
                       ("ssm_state",)),
        "A_log": Px(torch.log(_uniform(gen, (H,), 1.0, 16.0, device)),
                    ("ssm_heads",)),
        "D": Px(torch.ones((H,), dtype=f32, device=device), ("ssm_heads",)),
        "dt_bias": Px(dt_bias, ("ssm_heads",)),
        "norm": nn.rmsnorm_init(d_in, axis="ssm_inner", dtype=dt,
                                device=device),
        "out_proj": linear(d, ("ssm_inner", "embed"), d_in),
    }


# ---------------------------------------------------------------------------
# Causal depthwise conv
# ---------------------------------------------------------------------------


def causal_conv(x, w, b, *, tail=None):
    """x [B,T,C]; w [W,C]; optional tail [B,W-1,C] from previous tokens.

    Returns (y [B,T,C], new_tail [B,W-1,C])."""
    W = w.shape[0]
    if tail is None:
        tail = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([tail.to(x.dtype), x], dim=1)  # [B, T+W-1, C]
    T = x.shape[1]
    y = sum(xp[:, i:i + T, :] * w[i][None, None, :] for i in range(W))
    y = F.silu(y + b[None, None, :])
    new_tail = xp[:, -(W - 1):, :] if W > 1 else tail
    return y, new_tail


# ---------------------------------------------------------------------------
# SSD (chunked + recurrent)
# ---------------------------------------------------------------------------


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, h0=None, mesh=None):
    """Chunked SSD.

    x [B,T,H,P]; dt [B,T,H]; A [H] (negative); Bm/Cm [B,T,N].
    Returns (y [B,T,H,P], h_final [B,H,N,P] float32).  T must be at most
    ``chunk`` or a multiple of it (``ValueError`` otherwise, as in the
    reference).  Under a mesh the scan runs on each rank's batch shard
    and, where H divides "model", its heads."""
    def scan(x, dt, A, Bm, Cm, h0):
        return ssd_ops.ssd(x, dt.float(), A.float(), Bm.to(x.dtype),
                           Cm.to(x.dtype), chunk=chunk,
                           h0=None if h0 is None else h0.float())

    if mesh is None:
        return scan(x, dt, A, Bm, Cm, h0)
    b = nn.batch_pspec(mesh, x.shape[0], extra_dims=0)[0]
    h = ("model" if "model" in nn.axis_names(mesh)
         and x.shape[2] % nn.mesh_shape(mesh)["model"] == 0 else None)
    x4, st, bc = (b, None, h, None), (b, h, None, None), (b, None, None)
    return nn.local_map(scan, mesh,
                        [x4, (b, None, h), (h,), bc, bc, st], [x4, st],
                        x, dt, A, Bm, Cm, h0)


def ssd_recurrent(x, dt, A, Bm, Cm, h0=None):
    """Step-by-step oracle; same signature/returns as ssd_chunked."""
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    h = (torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(T):
        h, y = ssd_step(h, x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t])
        ys.append(y)
    return torch.stack(ys, dim=1).to(x.dtype), h


def ssd_step(h, x_t, dt_t, A, B_t, C_t):
    """h [B,H,N,P]; x_t [B,H,P]; dt_t [B,H]; B_t/C_t [B,N]."""
    dt_t = dt_t.float()
    da = torch.exp(dt_t * A.float())  # [B,H]
    upd = torch.einsum("bh,bn,bhp->bhnp", dt_t, B_t.float(), x_t.float())
    h = da[:, :, None, None] * h.float() + upd
    y = torch.einsum("bn,bhnp->bhp", C_t.float(), h)
    return h, y


# ---------------------------------------------------------------------------
# Block apply
# ---------------------------------------------------------------------------


def _project_streams(p, u, cfg: ModelConfig, state):
    """Shared projection + conv path for train/prefill/decode."""
    cd = cfg.cdtype
    z = nn.linear_apply(p["in_z"], u, cd)
    x = nn.linear_apply(p["in_x"], u, cd)
    Bm = nn.linear_apply(p["in_B"], u, cd)
    Cm = nn.linear_apply(p["in_C"], u, cd)
    dt = nn.linear_apply(p["in_dt"], u, cd)
    tails = (state["conv"] if state is not None
             else {"x": None, "B": None, "C": None})
    x, tx = causal_conv(x, p["conv_x"].to(x.dtype), p["conv_x_b"].to(x.dtype),
                        tail=tails["x"])
    Bm, tb = causal_conv(Bm, p["conv_B"].to(x.dtype),
                         p["conv_B_b"].to(x.dtype), tail=tails["B"])
    Cm, tc = causal_conv(Cm, p["conv_C"].to(x.dtype),
                         p["conv_C_b"].to(x.dtype), tail=tails["C"])
    return z, x, Bm, Cm, dt, {"x": tx, "B": tb, "C": tc}


def mamba_block_apply(p, u, cfg: ModelConfig, *, state=None,
                      return_state: bool = False, recurrent_oracle=False,
                      mesh=None):
    """Full-sequence Mamba2 block. u [B,T,d].

    state (optional): {"conv": {x,B,C tails}, "ssm": [B,H,N,P]}.
    Returns y or (y, new_state)."""
    d_in, H, N, _ = ssm_dims(cfg)
    P = cfg.ssm_head_dim
    B, T, _ = u.shape
    x_res = u
    u = nn.rmsnorm_apply(p["ln"], u, cfg.norm_eps)
    z, x, Bm, Cm, dt, new_tails = _project_streams(p, u, cfg, state)
    x = nn.reshape(x, B, T, H, P)
    dt = F.softplus(dt.float() + p["dt_bias"][None, None, :])
    A = -torch.exp(p["A_log"])
    h0 = state["ssm"] if state is not None else None
    if recurrent_oracle:
        y, h = ssd_recurrent(x, dt, A, Bm, Cm, h0=h0)
    else:
        y, h = ssd_chunked(x, dt, A, Bm, Cm, cfg.ssm_chunk, h0=h0, mesh=mesh)
    y = y + p["D"].to(y.dtype)[None, None, :, None] * x
    y = nn.reshape(y, B, T, d_in)
    y = nn.rmsnorm_apply(p["norm"], y * F.silu(z), cfg.norm_eps)
    out = x_res + nn.constrain(nn.linear_apply(p["out_proj"], y, cfg.cdtype),
                               mesh, nn.batch_pspec(mesh, B))
    if return_state:
        return out, {"conv": new_tails, "ssm": h}
    return out


def mamba_block_step(p, u, state, cfg: ModelConfig):
    """Single-token decode. u [B,1,d]. Returns (y [B,1,d], new_state)."""
    d_in, H, N, _ = ssm_dims(cfg)
    P = cfg.ssm_head_dim
    B = u.shape[0]
    x_res = u
    u = nn.rmsnorm_apply(p["ln"], u, cfg.norm_eps)
    z, x, Bm, Cm, dt, new_tails = _project_streams(p, u, cfg, state)
    x = nn.reshape(x[:, 0], B, H, P)
    dt_t = F.softplus(dt[:, 0].float() + p["dt_bias"][None, :])
    A = -torch.exp(p["A_log"])
    h, y = ssd_step(state["ssm"], x, dt_t, A, Bm[:, 0], Cm[:, 0])
    y = y + p["D"].to(y.dtype)[None, :, None] * x
    y = nn.reshape(y, B, 1, d_in).to(z.dtype)
    y = nn.rmsnorm_apply(p["norm"], y * F.silu(z), cfg.norm_eps)
    out = x_res + nn.linear_apply(p["out_proj"], y, cfg.cdtype)
    return out, {"conv": new_tails, "ssm": h}


def init_ssm_state(cfg: ModelConfig, batch: int, *, device="cpu"):
    d_in, H, N, _ = ssm_dims(cfg)
    W = cfg.ssm_conv
    cd = cfg.cdtype
    return {
        "conv": {
            "x": torch.zeros((batch, W - 1, d_in), dtype=cd, device=device),
            "B": torch.zeros((batch, W - 1, N), dtype=cd, device=device),
            "C": torch.zeros((batch, W - 1, N), dtype=cd, device=device),
        },
        "ssm": torch.zeros((batch, H, N, cfg.ssm_head_dim),
                           dtype=torch.float32, device=device),
    }


# ---------------------------------------------------------------------------
# Zamba2 hybrid model (groups of mamba blocks + one shared attention block)
# ---------------------------------------------------------------------------


def hybrid_init(gen, cfg: ModelConfig, *, device=None, with_axes=False):
    """Zamba2 params drawn from ``gen`` on ``device``; ``None`` is the CUDA
    card (``resolve_device``).  With ``with_axes`` -> (params, axes), the
    axes in the reference's layout."""
    if cfg.attn_every <= 0 or cfg.n_layers % cfg.attn_every:
        raise ValueError("hybrid needs n_layers % attn_every == 0")
    device = resolve_device(device)
    G = cfg.n_layers // cfg.attn_every
    K = cfg.attn_every
    dt = cfg.pdtype
    params, axes = nn.split({"embed": nn.embedding_init(
        gen, cfg.vocab, cfg.d_model, dtype=dt, device=device)})
    groups = [nn.stack_layers([mamba_block_init(gen, cfg, device=device)
                               for _ in range(K)]) for _ in range(G)]
    params["groups"] = [g for g, _ in groups]
    axes["groups"] = nn.stack_axes(groups[0][1])  # [G, K, ...]
    rest, rest_axes = nn.split({
        "shared": tfm.block_init(gen, cfg, device=device),
        "ln_f": nn.rmsnorm_init(cfg.d_model, dtype=dt, device=device),
        "unembed": nn.linear_init(gen, cfg.d_model, cfg.vocab,
                                  axes=("embed", "vocab"), dtype=dt,
                                  device=device),
    })
    params.update(rest)
    axes.update(rest_axes)
    return (params, axes) if with_axes else params


def _readout(p, x, cfg: ModelConfig):
    x = nn.rmsnorm_apply(p["ln_f"], x, cfg.norm_eps)
    return nn.linear_apply(p["unembed"], x, torch.float32)


def hybrid_forward(p, batch, cfg: ModelConfig, *, mesh=None):
    """tokens [B,T] -> (logits [B,T,V], aux = 0).  The shared block runs
    ``transformer.block_apply`` (the flash-attention kernel on the card).
    ``cfg.remat == "full"`` checkpoints each group body, its Mamba2 layers
    and the shared block as one unit, as the reference's ``group_body``."""
    with nn.mesh_context(mesh):
        tokens = batch["tokens"]
        x = nn.embedding_apply(p["embed"], tokens, cfg.cdtype, mesh=mesh)
        positions = torch.arange(tokens.shape[1], device=x.device)[None, :]
        aspec = nn.batch_pspec(mesh, x.shape[0])
        x = nn.constrain(x, mesh, aspec)

        def group_body(x, group):
            for bp in group:
                x = nn.constrain(x, mesh, aspec)
                x = nn.constrain(mamba_block_apply(bp, x, cfg, mesh=mesh),
                                 mesh, aspec)
            y = tfm.block_apply(p["shared"], x, cfg, causal=True,
                                positions=positions, mesh=mesh)[0]
            return nn.constrain(y, mesh, aspec)

        run = tfm.remat_wrap(group_body, cfg)
        for group in p["groups"]:
            x = run(x, group)
        logits = _readout(p, x, cfg)
        if mesh is not None:
            logits = nn.constrain(logits, mesh, tfm._logits_spec(mesh, aspec))
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def hybrid_loss(p, batch, cfg: ModelConfig, *, mesh=None):
    with nn.mesh_context(mesh):
        logits, aux = hybrid_forward(p, batch, cfg, mesh=mesh)
        return tfm._ce_from_logits(logits, batch, aux, cfg, mesh=mesh)


def _stack(trees):
    """Stack a list of equally shaped state dicts leaf by leaf."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return nn.stack(trees)


def hybrid_prefill(p, batch, cfg: ModelConfig, *, max_len: int, mesh=None):
    """Prefill: (cache, logits [B,V] at the last position).  Under a mesh
    the Mamba2 blocks run as the training forward's (the SSD on each
    rank's batch and head shard), the shared block as
    ``transformer.block_prefill`` under the mesh; the cache comes back as
    they computed it (``nn.lay_out_cache`` lays it out by
    ``cache_specs``)."""
    with nn.mesh_context(mesh):
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = nn.embedding_apply(p["embed"], tokens, cfg.cdtype, mesh=mesh)
        aspec = nn.batch_pspec(mesh, B)
        x = nn.constrain(x, mesh, aspec)
        positions = torch.arange(S, device=nn.local(x).device)[None, :]
        ssm_states, ks, vs = [], [], []
        for group in p["groups"]:
            states = []
            for bp in group:
                x, st = mamba_block_apply(bp, x, cfg, return_state=True,
                                          mesh=mesh)
                x = nn.constrain(x, mesh, aspec)
                states.append(st)
            ssm_states.append(_stack(states))
            x, kv = tfm.block_prefill(p["shared"], x, cfg, max_len=max_len,
                                      positions=positions, mesh=mesh)
            x = nn.constrain(x, mesh, aspec)
            ks.append(kv["k"])
            vs.append(kv["v"])
        G = len(p["groups"])
        cache = {"ssm": _stack(ssm_states),
                 "attn": {"k": nn.stack(ks), "v": nn.stack(vs),
                          "len": torch.full((G, B), S, dtype=torch.int32,
                                            device=nn.local(x).device)}}
        return cache, _readout(p, x[:, -1:, :], cfg)[:, 0]


def hybrid_decode_step(p, cache, tokens, cfg: ModelConfig, *, mesh=None):
    """One decode step; tokens [B] -> (cache, logits [B,V]).  Every cache
    tensor is updated in place (each rank's shard under a mesh); the
    shared block's attention runs ``attention_decode`` (the contiguous
    flash-decode kernel on the card; under a mesh on each rank's sequence
    shard of the cache, the ranks' results combined)."""
    with nn.mesh_context(mesh):
        x = nn.embedding_apply(p["embed"], tokens[:, None], cfg.cdtype,
                               mesh=mesh)
        aspec = nn.batch_pspec(mesh, x.shape[0])
        x = nn.constrain(x, mesh, aspec)
        ssm, attn = cache["ssm"], cache["attn"]
        for g, group in enumerate(p["groups"]):
            for i, bp in enumerate(group):
                st = {"conv": {n: nn.index0(nn.index0(ssm["conv"][n], g), i)
                               for n in ("x", "B", "C")},
                      "ssm": nn.index0(nn.index0(ssm["ssm"], g), i)}
                x, new = mamba_block_step(bp, x, st, cfg)
                x = nn.constrain(x, mesh, aspec)
                for n in ("x", "B", "C"):
                    nn.assign(st["conv"][n], new["conv"][n])
                nn.assign(st["ssm"], new["ssm"])
            lens = nn.index0(attn["len"], g)
            x = tfm.block_decode(p["shared"], x, nn.index0(attn["k"], g),
                                 nn.index0(attn["v"], g), lens, cfg,
                                 mesh=mesh)
            x = nn.constrain(x, mesh, aspec)
            nn.assign(lens, lens + 1)
        return cache, _readout(p, x, cfg)[:, 0]
