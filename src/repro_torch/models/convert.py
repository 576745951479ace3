"""Weight bridge: the JAX package's parameter tree -> the port's parameters.

The input is the reference tree as nested dicts of numpy arrays (for
example ``jax.tree.map(np.asarray, nn.split(api.init(key, cfg))[0])``).
Layouts are kept: linear weights stay ``[d_in, d_out]``; the stacked
``blocks`` leaves ``[L, ...]`` are unstacked into the port's per-layer
list.  Float leaves are stored in ``cfg.param_dtype``.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import ModelConfig


def _tensor(a, dtype, device):
    a = np.asarray(a)
    if a.dtype.kind == "f" or a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a, np.float32)).to(device, dtype)
    return torch.from_numpy(a.copy()).to(device)


def _convert(tree, dtype, device):
    if isinstance(tree, dict):
        return {k: _convert(v, dtype, device) for k, v in tree.items()}
    return _tensor(tree, dtype, device)


def _unstack(tree, i):
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return tree[i]


def params_from_numpy(tree, cfg: ModelConfig, device="cpu"):
    """Convert a reference dense-LM tree into the port's parameter dict."""
    extra = set(tree) - {"embed", "ln_f", "blocks", "unembed"}
    if extra:
        raise NotImplementedError(
            f"parameter groups {sorted(extra)} belong to families the port "
            f"does not run yet")
    out = _convert({k: v for k, v in tree.items() if k != "blocks"},
                   cfg.pdtype, device)
    blocks = _convert(tree["blocks"], cfg.pdtype, device)
    out["blocks"] = [_unstack(blocks, i) for i in range(cfg.n_layers)]
    return out
