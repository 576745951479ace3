"""Optimizers: AdamW with optional 8-bit blockwise-quantized moments.

The port of the JAX package's ``training/optim.py``.  ``m`` can be stored as
int8 and ``v`` as uint8, both with per-block (last-dim blocks of ``QBLOCK``)
float32 scales, in a shape-preserving layout.  Parameters and moments are
nested dicts and lists of tensors; ``adamw_update`` updates them in place
under ``torch.no_grad()``, which takes the place of the reference's
donated functional update.

The reference stacks every block leaf to ``[L, ...]`` (an
encoder-decoder's encoder blocks under ``enc_blocks``, a hybrid model's
Mamba2 blocks to ``[G, K, ...]`` under ``groups``) and decays the leaves
with ``ndim >= 2``, so every block leaf is decayed (norm scales, biases,
``A_log``, ``D`` and ``dt_bias`` included).  The port keeps the blocks as
lists of per-layer dicts, so it decides by the reference's rank: every
leaf under ``blocks``, ``enc_blocks`` or ``groups`` is decayed, and any
other leaf (a hybrid's unstacked ``shared`` block and a learned position
table among them) is decayed if it is at least 2-D.  An MoE model's first dense layers are the exception: the
reference keeps them unstacked under ``pre``, so their leaves are decayed
by their own rank.  The quantized moments block the last dimension, so per-layer codes and scales
equal the stacked ones row by row.  The schedule, the clip factor and the
bias corrections are float32, as in the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

QBLOCK = 128


@dataclasses.dataclass
class OptimizerConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    quantize_states: bool = False  # 8-bit m/v (blockwise)


# ---------------------------------------------------------------------------
# Parameter trees (nested dicts and lists of tensors)
# ---------------------------------------------------------------------------


def named_leaves(tree, path=()):
    """[(path, tensor)] in a fixed order (dict keys sorted, lists in
    order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in named_leaves(tree[k],
                                                              path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in named_leaves(v, path + (i,))]
    return [(path, tree)]


def tree_leaves(tree):
    return [t for _, t in named_leaves(tree)]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_unflatten(template, leaves):
    """A tree shaped like ``template`` holding ``leaves`` in
    ``named_leaves`` order."""
    it = iter(leaves)

    def rebuild(tree):
        if isinstance(tree, dict):
            return {k: rebuild(tree[k]) for k in sorted(tree)}
        if isinstance(tree, (list, tuple)):
            return type(tree)(rebuild(v) for v in tree)
        return next(it)

    return rebuild(template)


def unstacked_blocks(params) -> frozenset:
    """Indices of the blocks the reference keeps unstacked: in an MoE
    model (some block carries ``moe``) the dense ones, ``pre/layer_i``."""
    blocks = params.get("blocks") or []
    if not any("moe" in b for b in blocks):
        return frozenset()
    return frozenset(i for i, b in enumerate(blocks) if "moe" not in b)


def decays(path, p, unstacked=frozenset()) -> bool:
    """Whether AdamW decays the leaf at ``path`` (see the module doc);
    ``unstacked`` is ``unstacked_blocks(params)``."""
    return (path[0] == "blocks" and path[1] not in unstacked) \
        or path[0] in ("enc_blocks", "groups") or p.dim() >= 2


# ---------------------------------------------------------------------------
# Schedule
# ---------------------------------------------------------------------------


def lr_at(step, cfg: OptimizerConfig) -> float:
    """Warmup then cosine decay to ``min_lr_ratio``, in float32."""
    f = np.float32
    s = f(float(step))
    warm = np.minimum(f(1.0), (s + f(1)) / f(max(1, cfg.warmup_steps)))
    prog = np.clip((s - f(cfg.warmup_steps))
                   / f(max(1, cfg.decay_steps - cfg.warmup_steps)),
                   f(0.0), f(1.0))
    cos = f(0.5) * (f(1) + np.cos(f(np.pi) * prog))
    frac = f(cfg.min_lr_ratio) + f(1 - cfg.min_lr_ratio) * cos
    return float(f(cfg.lr) * warm * frac)


# ---------------------------------------------------------------------------
# Blockwise 8-bit quantization (shape-preserving layout)
# ---------------------------------------------------------------------------


def _blocked_shape(shape):
    last = shape[-1] if shape else 1
    if last % QBLOCK == 0:
        return shape[:-1] + (last // QBLOCK,), QBLOCK
    return shape[:-1] + (1,), last  # one scale per row


def quantize_signed(x):
    """float32 -> (int8 codes, float32 blockwise scales)."""
    shape = tuple(x.shape) if x.dim() else (1,)
    sshape, bs = _blocked_shape(shape)
    xb = x.reshape(sshape + (bs,))
    scale = xb.abs().amax(dim=-1) / 127.0
    safe = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(xb / safe[..., None]), -127, 127)
    return q.to(torch.int8).reshape(shape), scale


def dequantize_signed(q, scale):
    shape = tuple(q.shape)
    sshape, bs = _blocked_shape(shape)
    qb = q.reshape(sshape + (bs,)).float()
    return (qb * scale[..., None]).reshape(shape)


def quantize_unsigned(x):
    """Non-negative float32 -> (uint8 codes, float32 blockwise scales)."""
    shape = tuple(x.shape) if x.dim() else (1,)
    sshape, bs = _blocked_shape(shape)
    xb = x.reshape(sshape + (bs,))
    scale = xb.amax(dim=-1) / 255.0
    safe = torch.clamp(scale, min=1e-30)
    q = torch.clamp(torch.round(xb / safe[..., None]), 0, 255)
    return q.to(torch.uint8).reshape(shape), scale


def dequantize_unsigned(q, scale):
    shape = tuple(q.shape)
    sshape, bs = _blocked_shape(shape)
    qb = q.reshape(sshape + (bs,)).float()
    return (qb * scale[..., None]).reshape(shape)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw_init(params, cfg: OptimizerConfig):
    """{"moments": a tree like ``params``, "step": 0-d int32 on the CPU}."""
    def mk(p):
        zeros = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        if cfg.quantize_states:
            mq, ms = quantize_signed(zeros)
            vq, vs = quantize_unsigned(zeros)
            return {"mq": mq, "ms": ms, "vq": vq, "vs": vs}
        return {"m": zeros, "v": torch.zeros_like(zeros)}

    return {"moments": tree_map(mk, params),
            "step": torch.zeros((), dtype=torch.int32)}


def global_norm(tree):
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@torch.no_grad()
def adamw_update(grads, opt_state, params, cfg: OptimizerConfig):
    """Update ``params`` and ``opt_state`` in place; returns
    (params, opt_state, stats)."""
    step = int(opt_state["step"])
    lr = lr_at(step, cfg)
    gnorm = global_norm(grads)
    clip = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0) if cfg.grad_clip > 0 else 1.0)
    f = np.float32
    t = f(step + 1)
    bc1 = float(f(1) - f(cfg.b1) ** t)
    bc2 = float(f(1) - f(cfg.b2) ** t)

    unstacked = unstacked_blocks(params)
    for (path, p), g in zip(named_leaves(params), tree_leaves(grads)):
        g = g.float() * clip
        mom = _moment_dict(opt_state["moments"], path)
        if cfg.quantize_states:
            m = dequantize_signed(mom["mq"], mom["ms"])
            v = dequantize_unsigned(mom["vq"], mom["vs"])
        else:
            m, v = mom["m"], mom["v"]
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        del g
        upd = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
        p32 = p.float()  # p itself when p is float32
        if cfg.weight_decay > 0 and decays(path, p, unstacked):
            upd.add_(cfg.weight_decay * p32)
        p.copy_(p32.sub_(lr * upd))
        del upd, p32
        if cfg.quantize_states:
            mom["mq"], mom["ms"] = quantize_signed(m)
            mom["vq"], mom["vs"] = quantize_unsigned(v)
    opt_state["step"] = torch.tensor(step + 1, dtype=torch.int32)
    return params, opt_state, {"lr": lr, "grad_norm": gnorm}


def _moment_dict(moments, path):
    for k in path:
        moments = moments[k]
    return moments
