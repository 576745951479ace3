"""Abstract inputs of the dry-run: ``meta`` tensors in place of the
reference's ``ShapeDtypeStruct``.

The counterpart of the JAX package's ``launch/specs.py``.  Every model
input (train batch, prefill batch, decode token + cache), the
parameters and the optimizer state are made on the ``meta`` device: shapes
and dtypes, nothing allocated.  The cache template mirrors the port's own
prefill cache (stacked ``k``/``v``/``len`` for the transformer families,
``ssm``/``attn`` for zamba2, ``att``/``ffn`` for rwkv6), so the dry-run's
decode cell feeds it straight into ``ModelApi.decode``.  ``cache_specs``
gives the cache's partition specs on a mesh (the reference's rule applied
by leaf name to the port's layout), as plain tuples that
``sharding.place`` lays a cache out by.
"""
from __future__ import annotations

import torch

from repro_torch.models import ModelApi, nn
from repro_torch.models.config import ModelConfig
from repro_torch.models.mamba2 import ssm_dims
from repro_torch.training.optim import adamw_init, tree_leaves

META = torch.device("meta")

# The assigned LM shape grid: name -> (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}

# long_500k needs sub-quadratic sequence state; only hybrid/ssm run it.
LONG_CONTEXT_FAMILIES = ("hybrid", "ssm")

WHISPER_FRAMES = 1500  # fixed audio context (frontend stub length)


def cell_supported(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    if shape == "long_500k" and cfg.family not in LONG_CONTEXT_FAMILIES:
        return False, ("full-attention arch: 500k-context requires "
                       "sub-quadratic attention (skip noted in DESIGN.md)")
    return True, ""


def tree_bytes(tree, device=META) -> int:
    """Bytes of the distinct storages of ``tree``'s tensors on ``device``
    (the optimizer's step counter lies on the CPU and is left out)."""
    seen, total = set(), 0
    for t in tree_leaves(tree):
        if t.device.type != torch.device(device).type:
            continue
        st = t.untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            total += st.nbytes()
    return total


# ---------------------------------------------------------------------------
# Abstract init (no allocation)
# ---------------------------------------------------------------------------


def abstract_params(api: ModelApi, cfg: ModelConfig):
    """(the parameter tree on ``meta``, requiring gradients as a train
    state's do; its logical axes in the reference's layout)."""
    params, axes = api.init(torch.Generator(), cfg, device=META,
                            with_axes=True)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return params, axes


def abstract_opt_state(params, opt_cfg):
    """AdamW's state on ``meta`` (8-bit moments when ``opt_cfg`` asks)."""
    return adamw_init(params, opt_cfg)


# ---------------------------------------------------------------------------
# Batch specs
# ---------------------------------------------------------------------------


def _empty(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


def _frontends(cfg: ModelConfig, batch: int) -> dict:
    if cfg.family == "encdec":
        return {"frame_embeds": _empty(batch, WHISPER_FRAMES, cfg.d_model)}
    if cfg.family == "vlm":
        return {"patch_embeds": _empty(batch, cfg.vision_tokens,
                                       cfg.d_model)}
    return {}


def train_batch_specs(cfg: ModelConfig, batch: int, seq: int):
    out = {
        "tokens": _empty(batch, seq, dtype=torch.int32),
        "targets": _empty(batch, seq, dtype=torch.int32),
        "loss_mask": _empty(batch, seq),
    }
    return {**out, **_frontends(cfg, batch)}


def prefill_batch_specs(cfg: ModelConfig, batch: int, seq: int):
    return {"tokens": _empty(batch, seq, dtype=torch.int32),
            **_frontends(cfg, batch)}


# ---------------------------------------------------------------------------
# Cache templates (must mirror the runtime prefill cache structure)
# ---------------------------------------------------------------------------


def cache_template(cfg: ModelConfig, batch: int, max_len: int):
    cd = cfg.cdtype
    i32 = torch.int32
    if cfg.family == "hybrid":
        G = cfg.n_layers // cfg.attn_every
        K = cfg.attn_every
        d_in, H, N, _ = ssm_dims(cfg)
        W = cfg.ssm_conv
        return {
            "ssm": {
                "conv": {
                    "x": _empty(G, K, batch, W - 1, d_in, dtype=cd),
                    "B": _empty(G, K, batch, W - 1, N, dtype=cd),
                    "C": _empty(G, K, batch, W - 1, N, dtype=cd),
                },
                "ssm": _empty(G, K, batch, H, N, cfg.ssm_head_dim),
            },
            "attn": {
                "k": _empty(G, batch, max_len, cfg.n_kv_heads, cfg.head_dim,
                            dtype=cd),
                "v": _empty(G, batch, max_len, cfg.n_kv_heads, cfg.head_dim,
                            dtype=cd),
                "len": _empty(G, batch, dtype=i32),
            },
        }
    if cfg.family == "ssm":
        H = cfg.d_model // cfg.rwkv_head_dim
        L = cfg.n_layers
        d = cfg.d_model
        return {
            "att": {
                "shift": _empty(L, batch, d, dtype=cd),
                "wkv": _empty(L, batch, H, cfg.rwkv_head_dim,
                              cfg.rwkv_head_dim),
            },
            "ffn": {"shift": _empty(L, batch, d, dtype=cd)},
        }
    # transformer families: every layer stacked (an MoE model's first dense
    # layers too), one length vector
    L = cfg.dec_layers or cfg.n_layers
    kv = (L, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    cache = {"k": _empty(*kv, dtype=cd), "v": _empty(*kv, dtype=cd)}
    if cfg.family == "encdec":
        cross = (L, batch, WHISPER_FRAMES, cfg.n_kv_heads, cfg.head_dim)
        cache["cross_k"] = _empty(*cross, dtype=cd)
        cache["cross_v"] = _empty(*cross, dtype=cd)
    cache["len"] = _empty(batch, dtype=i32)
    return cache


# ---------------------------------------------------------------------------
# Cache partition specs (by leaf name)
# ---------------------------------------------------------------------------


def cache_specs(cfg: ModelConfig, mesh, batch: int, max_len: int):
    """Spec tree of the cache of ``batch`` sequences of ``max_len``
    positions (``cache_template``'s layout) on ``mesh``: see
    ``models.nn.cache_spec``."""
    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        return nn.cache_spec(path, tuple(tree.shape), mesh, batch)

    return walk(cache_template(cfg, batch, max_len), ())
