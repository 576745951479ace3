"""Logical-axis -> mesh-axis sharding rules (MaxText-style).

The counterpart of the JAX package's ``launch/sharding.py``; the rules are
the reference's, verbatim.  Param trees carry logical axis names per dim
(``repro_torch.models.nn.Px``); these rules map them to mesh axes.
``make_specs`` gives the reference's ``PartitionSpec`` entries as plain
tuples (one entry per dim: a mesh axis name, a tuple of names, or None);
``make_shardings`` gives ``NamedSharding``s, each a mesh and a spec whose
``placements`` are the DTensor placements of the spec.

Training default: tensor-parallel dims on "model", FSDP on "data" via the
"embed" dim, batch on ("pod","data").  Serving keeps parameters gathered
along "data".
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.models import nn

# Rules shared by every regime; logical axes not listed are replicated.
_COMMON = {
    # tensor-parallel dims
    "vocab": "model",
    # input embedding tables: vocab must stay unsharded (token gather);
    # shard the embed dim over "model" instead
    "tokens_vocab": None,
    "embed_g": "model",
    "mlp": "model",
    "q_proj": "model",
    "kv_proj": None,  # kv heads < mesh "model" for GQA archs -> replicate
    "wkv_proj": "model",
    "ssm_inner": "model",
    "ssm_heads": "model",
    "experts": "model",
    "router_experts": None,
    "expert_in": None,
    "expert_ff": None,
    # replicated small dims
    "head_dim": None,
    "pos": None,
    "layers": None,
    "group": None,
    "conv_w": None,
    "ssm_state": None,
    "lora": None,
    "mix5": None,
}

TRAIN_RULES = dict(
    _COMMON,
    embed="data",  # FSDP: gather per layer (ZeRO-3)
)

SERVE_RULES = dict(
    _COMMON,
    embed=None,  # serving keeps params gathered along data; batch-parallel
)


def resolve_rule(axis_name: Optional[str], rules: dict):
    if axis_name is None:
        return None
    return rules.get(axis_name)


def _is_axes(x) -> bool:
    return isinstance(x, tuple)


def _tree_map(fn, tree):
    """Map ``fn`` over the axes tuples of a tree of dicts and lists."""
    if _is_axes(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    raise TypeError(f"not an axes tree: {type(tree).__name__}")


def spec_for_axes(axes: tuple, rules: dict, mesh) -> tuple:
    names = set(nn.axis_names(mesh))
    entries = []
    for a in axes:
        r = resolve_rule(a, rules)
        if isinstance(r, tuple):
            r = tuple(x for x in r if x in names) or None
        elif r is not None and r not in names:
            r = None
        entries.append(r)
    return tuple(entries)


def make_specs(axes_tree, rules: dict, mesh):
    """Spec tree mirroring an axes tree."""
    return _tree_map(lambda axes: spec_for_axes(axes, rules, mesh),
                     axes_tree)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec: the reference's ``NamedSharding``."""

    mesh: Any
    spec: tuple

    @property
    def placements(self):
        return nn.placements(self.spec, self.mesh)


def make_shardings(axes_tree, rules: dict, mesh):
    return _tree_map(lambda s: NamedSharding(mesh, s),
                     make_specs(axes_tree, rules, mesh))


def batch_spec(mesh, extra_dims: int = 1) -> tuple:
    """[B, ...] inputs: batch over (pod, data)."""
    b = tuple(a for a in ("pod", "data") if a in nn.axis_names(mesh))
    return (b if b else None,) + (None,) * extra_dims


def batch_sharding(mesh, extra_dims: int = 1) -> NamedSharding:
    return NamedSharding(mesh, batch_spec(mesh, extra_dims))


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def place(t, sharding: NamedSharding, placements=None):
    """``t`` (the same full tensor on every rank, or on ``meta``) as a
    DTensor with ``sharding`` (or ``placements`` on its mesh): each rank
    keeps its own chunk, nothing is sent.  A DTensor is redistributed."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    pl = placements if placements is not None else sharding.placements
    if isinstance(t, DTensor):
        return t.redistribute(sharding.mesh, pl)
    out = distribute_tensor(t.detach(), sharding.mesh, pl,
                            src_data_rank=None)
    return out.requires_grad_(t.requires_grad)


# ---------------------------------------------------------------------------
# Optimizer-state shardings mirror param shardings (moments share param axes;
# blockwise-quantization scales share all but the last dim's partitioning).
# ---------------------------------------------------------------------------


def opt_axes_like(param_axes_tree, quantized: bool):
    def mk(axes):
        if quantized:
            return {"mq": axes, "ms": axes, "vq": axes, "vs": axes}
        return {"m": axes, "v": axes}

    return {"moments": _tree_map(mk, param_axes_tree), "step": ()}


def place_params(params, axes, cfg, mesh):
    """``params`` (the port's layout, every rank holding them whole, or on
    ``meta``) as DTensors placed by ``SERVE_RULES`` from ``axes``, the
    reference's layout (``init(..., with_axes=True)``)."""
    from repro_torch.models.convert import unstack_axes

    sh = make_shardings(unstack_axes(axes, cfg), SERVE_RULES, mesh)

    def walk(tree, s):
        if isinstance(tree, dict):
            return {k: walk(v, s[k]) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, x) for v, x in zip(tree, s)]
        return place(tree, s)

    return walk(params, sh)
