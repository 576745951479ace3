"""Weight bridge: the JAX package's parameter tree -> the port's parameters.

The input is the reference tree as nested dicts of numpy arrays (for
example ``jax.tree.map(np.asarray, nn.split(api.init(key, cfg))[0])``).
Layouts are kept: linear weights stay ``[d_in, d_out]``; stacked layer
leaves are unstacked into the port's per-layer lists (``blocks`` ``[L,
...]`` of dense, encoder-decoder, vision-prefix and rwkv6 models, and an
encoder-decoder's ``enc_blocks``, into lists of L dicts, a decoder block
carrying its ``ln_cross``/``cross``; an MoE model's first dense layers
``pre/layer_i`` and its ``[L - first_dense_layers, ...]`` stacked blocks
into one list of L dicts, the dense layers first; zamba2's ``groups`` ``[G,
K, ...]`` into G lists of K dicts).  Float leaves keep their type (the
reference keeps a few float32 leaves, such as the MoE router, rwkv6's
decay base and zamba2's ``A_log``, in float32 in a bf16 model).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

from .config import DTYPES, ModelConfig

# the top-level parameter groups of each family the bridge takes
_TOP_LEVEL = {
    "dense": {"embed", "ln_f", "blocks", "unembed"},
    "moe": {"embed", "ln_f", "pre", "blocks", "unembed"},
    "ssm": {"embed", "ln_in", "blocks", "ln_f", "unembed"},
    "hybrid": {"embed", "groups", "shared", "ln_f", "unembed"},
    "encdec": {"embed", "ln_f", "blocks", "unembed", "enc_blocks",
               "enc_ln_f", "pos_embed"},
    "vlm": {"embed", "ln_f", "blocks", "unembed"},
}


def _tensor(a, device):
    a = np.asarray(a)
    if a.dtype.kind == "f" or a.dtype.name == "bfloat16":
        dtype = DTYPES.get(a.dtype.name, torch.float32)
        return torch.from_numpy(np.array(a, np.float32)).to(device, dtype)
    return torch.from_numpy(a.copy()).to(device)


def _convert(tree, device):
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


def _unstack(tree, i):
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return tree[i]


def _layers(stacked):
    """A converted ``[L, ...]`` stack -> a list of L per-layer dicts."""
    leaf = stacked
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return [_unstack(stacked, i) for i in range(leaf.shape[0])]


def params_from_numpy(tree, cfg: ModelConfig, device=None):
    """Convert a reference tree of a family in ``_TOP_LEVEL`` into the
    port's parameter dict on ``device`` (``None`` is the CUDA card,
    ``resolve_device``).  A top-level group outside the family's set
    raises."""
    device = resolve_device(device)
    family = "moe" if cfg.is_moe else cfg.family
    extra = set(tree) - _TOP_LEVEL[family]
    if extra:
        raise ValueError(
            f"parameter groups {sorted(extra)} are not part of a "
            f"{cfg.family!r} model")
    out = _convert({k: v for k, v in tree.items()
                    if k not in ("pre", "blocks", "enc_blocks", "groups")},
                   device)
    if "blocks" in tree:
        pre = tree.get("pre", {})
        pre = [_convert(pre[f"layer_{i}"], device) for i in range(len(pre))]
        out["blocks"] = pre + _layers(_convert(tree["blocks"], device))
    if "enc_blocks" in tree:
        out["enc_blocks"] = _layers(_convert(tree["enc_blocks"], device))
    if "groups" in tree:
        groups = _convert(tree["groups"], device)
        G, K = cfg.n_layers // cfg.attn_every, cfg.attn_every
        out["groups"] = [[_unstack(_unstack(groups, g), i) for i in range(K)]
                         for g in range(G)]
    return out


def _drop_layers(axes, n: int = 1):
    """A stacked axes tree's leaves without their ``n`` leading
    ``"layers"`` entries."""
    if isinstance(axes, dict):
        return {k: _drop_layers(v, n) for k, v in axes.items()}
    return tuple(axes[n:])


def unstack_axes(axes, cfg: ModelConfig):
    """The reference's axes tree (``api.init(..., with_axes=True)``) laid
    out as the port's parameters, as ``params_from_numpy`` lays out the
    values: every stacked leaf without its leading ``"layers"``, repeated
    per layer (an MoE model's ``pre/layer_i`` first; zamba2's ``groups`` as
    G lists of K)."""
    out = {k: v for k, v in axes.items()
           if k not in ("pre", "blocks", "enc_blocks", "groups")}
    if "blocks" in axes or "pre" in axes:
        pre = axes.get("pre", {})
        n = (cfg.n_layers if cfg.family == "ssm"
             else cfg.dec_layers or cfg.n_layers)
        out["blocks"] = [pre[f"layer_{i}"] for i in range(len(pre))]
        if "blocks" in axes:
            out["blocks"] += [_drop_layers(axes["blocks"])] * (n - len(pre))
    if "enc_blocks" in axes:
        out["enc_blocks"] = [_drop_layers(axes["enc_blocks"])] * cfg.enc_layers
    if "groups" in axes:
        G, K = cfg.n_layers // cfg.attn_every, cfg.attn_every
        out["groups"] = [[_drop_layers(axes["groups"], 2)] * K
                         for _ in range(G)]
    return out
