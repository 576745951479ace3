"""Functional layer library: plain dicts of tensors, init + apply functions.

The counterpart of the JAX package's ``models/nn.py`` for the layers the
ported families use.  Layouts are kept so weights carry over unchanged:
linear weights are ``[d_in, d_out]`` and apply as ``x @ w`` after casting
BOTH operands to the compute dtype; rmsnorm, layernorm and rope compute in
float32; rope splits the head dim into halves (no interleave).

Initializers draw from a ``torch.Generator`` on the target device, so a
large model is made directly on the card.  They draw the same
distributions as the reference, not the same numbers.
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def normal_init(gen, shape, dtype, stddev, device):
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (x * stddev).to(dtype)


def lecun_init(gen, shape, dtype, fan_in, device):
    return normal_init(gen, shape, dtype, 1.0 / math.sqrt(max(1, fan_in)),
                       device)


# ---------------------------------------------------------------------------
# Core layers
# ---------------------------------------------------------------------------


def linear_init(gen, d_in, d_out, *, dtype=torch.float32, bias=False,
                stddev=None, device="cpu"):
    """Dense projection ``[d_in] -> [d_out]``."""
    if stddev is None:
        w = lecun_init(gen, (d_in, d_out), dtype, d_in, device)
    else:
        w = normal_init(gen, (d_in, d_out), dtype, stddev, device)
    p = {"w": w}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def linear_apply(p, x, compute_dtype=None):
    w = p["w"]
    if compute_dtype is not None:
        w = w.to(compute_dtype)
        x = x.to(compute_dtype)
    y = x @ w
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def rmsnorm_init(d, *, dtype=torch.float32, device="cpu"):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm_apply(p, x, eps=1e-6):
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(dt)


def layernorm_init(d, *, dtype=torch.float32, device="cpu"):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm_apply(p, x, eps=1e-5):
    dt = x.dtype
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(dt)


def embedding_init(gen, vocab, d, *, dtype=torch.float32, device="cpu"):
    return {"table": normal_init(gen, (vocab, d), dtype, 1.0, device)}


def embedding_apply(p, ids, compute_dtype=None):
    t = p["table"]
    if compute_dtype is not None:
        t = t.to(compute_dtype)
    return t[ids]


def embedding_attend(p, x):
    """Tied readout: logits = x @ table.T (fp32 accumulation)."""
    return x.float() @ p["table"].float().T


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------


def squared_relu(x):
    r = F.relu(x)
    return r * r


ACTIVATIONS: dict[str, Callable] = {
    "silu": F.silu,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "relu2": squared_relu,
}


# ---------------------------------------------------------------------------
# MLP (gated / non-gated)
# ---------------------------------------------------------------------------


def mlp_init(gen, d_model, d_ff, *, gated=True, dtype=torch.float32,
             device="cpu"):
    p = {
        "up": linear_init(gen, d_model, d_ff, dtype=dtype, device=device),
        "down": linear_init(gen, d_ff, d_model, dtype=dtype, device=device),
    }
    if gated:
        p["gate"] = linear_init(gen, d_model, d_ff, dtype=dtype,
                                device=device)
    return p


def mlp_apply(p, x, *, activation="silu", compute_dtype=None):
    act = ACTIVATIONS[activation]
    up = linear_apply(p["up"], x, compute_dtype)
    if "gate" in p:
        h = act(linear_apply(p["gate"], x, compute_dtype)) * up
    else:
        h = act(up)
    return linear_apply(p["down"], h, compute_dtype)


# ---------------------------------------------------------------------------
# Position embeddings: rotary and sinusoidal
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device="cpu"):
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta=1e4):
    """x: [..., S, H, D]; positions: broadcastable to [..., S]."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)  # [d/2]
    angles = positions[..., :, None].float() * freqs  # [..., S, d/2]
    cos = torch.cos(angles)[..., :, None, :]  # [..., S, 1, d/2]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def sinusoidal_positions(n_pos: int, d: int, device="cpu"):
    """[n_pos, d] float32 sin/cos table (Whisper's encoder), computed in
    float64 numpy and then cast, in the reference's order."""
    pos = np.arange(n_pos)[:, None]
    dim = np.arange(d // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * dim / d)
    out = np.concatenate([np.sin(angle), np.cos(angle)], axis=-1)
    return torch.from_numpy(out.astype(np.float32)).to(device)
