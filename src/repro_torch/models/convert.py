"""Weight bridge: the JAX package's parameter tree -> the port's parameters.

The input is the reference tree as nested dicts of numpy arrays (for
example ``jax.tree.map(np.asarray, nn.split(api.init(key, cfg))[0])``).
Layouts are kept: linear weights stay ``[d_in, d_out]``; stacked layer
leaves are unstacked into the port's per-layer lists (``blocks`` ``[L,
...]`` of dense and rwkv6 into a list of L dicts; an MoE model's first
dense layers ``pre/layer_i`` and its ``[L - first_dense_layers, ...]``
stacked blocks into one list of L dicts, the dense layers first; zamba2's
``groups`` ``[G, K, ...]`` into G lists of K dicts).  Float leaves keep
their type (the reference keeps a few float32 leaves, such as the MoE
router, rwkv6's decay base and zamba2's ``A_log``, in float32 in a bf16
model).
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
}
# the ROADMAP item that ports a family the bridge does not take yet
_NOT_PORTED = {"encdec": "ROADMAP Queue 1 item 9 (encoder-decoder and VLM)",
               "vlm": "ROADMAP Queue 1 item 9 (encoder-decoder and VLM)"}


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


def params_from_numpy(tree, cfg: ModelConfig, device=None):
    """Convert a reference tree of a family in ``_TOP_LEVEL`` (dense, moe,
    ssm: rwkv6, hybrid: zamba2) into the port's parameter dict on
    ``device`` (``None`` is the CUDA card, ``resolve_device``).  A
    top-level group outside the family's set raises, naming the ROADMAP
    item that ports it."""
    device = resolve_device(device)
    family = "moe" if cfg.is_moe else cfg.family
    extra = set(tree) - _TOP_LEVEL.get(family, _TOP_LEVEL["dense"])
    if extra:
        raise NotImplementedError(
            f"parameter groups {sorted(extra)} of family {cfg.family!r} are "
            f"not ported to PyTorch yet: "
            f"{_NOT_PORTED.get(cfg.family, 'the ROADMAP')}")
    out = _convert({k: v for k, v in tree.items()
                    if k not in ("pre", "blocks", "groups")}, device)
    if "blocks" in tree:
        pre = tree.get("pre", {})
        pre = [_convert(pre[f"layer_{i}"], device) for i in range(len(pre))]
        blocks = _convert(tree["blocks"], device)
        out["blocks"] = pre + [_unstack(blocks, i)
                               for i in range(cfg.n_layers - len(pre))]
    if "groups" in tree:
        groups = _convert(tree["groups"], device)
        G, K = cfg.n_layers // cfg.attn_every, cfg.attn_every
        out["groups"] = [[_unstack(_unstack(groups, g), i) for i in range(K)]
                         for g in range(G)]
    return out
