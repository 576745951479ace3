"""Seeded weights, made on the device, shared by the program and the
reference.

Each part of a model (the embedding, the unembedding, each layer, each
router) is drawn by one ``normal_`` call into one flat buffer of the type
it is served in, from a generator on the device seeded by (seed, part);
its leaves are views of that buffer, scaled in place: lecun-normal
projections and experts, ``o`` with std 1/sqrt(Hq·D), an embedding of std
1, norm scales of one, routers in float32.  The layout is the one
``repro_torch``'s ``lm_init`` gives, so the program serves these tensors
as they are; the reference draws the same parts again, one at a time,
and reads them in float32.
"""
from __future__ import annotations

import math

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def _gen(seed: int, part: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 8191 + part) % (1 << 63))
    return g


def _draw(seed, part, leaves, dtype, device) -> dict:
    """``leaves``: [(name, shape, std)] -> {name: view}, one call."""
    sizes = [math.prod(s) for _, s, _ in leaves]
    buf = torch.empty(sum(sizes), dtype=dtype, device=device)
    buf.normal_(generator=_gen(seed, part, device))
    out, o = {}, 0
    for (name, shape, std), n in zip(leaves, sizes):
        out[name] = buf[o:o + n].view(shape).mul_(std)
        o += n
    return out


def is_moe_layer(m: dict, i: int) -> bool:
    return bool(m.get("n_experts")) and i >= m.get("first_dense_layers", 0)


def layer_leaves(m: dict, i: int) -> list:
    d, hd, hq, hkv = m["d_model"], m["head_dim"], m["n_heads"], m["n_kv_heads"]
    gated = m.get("gated_mlp", True)
    lv = [("q", (d, hq * hd), d ** -0.5), ("k", (d, hkv * hd), d ** -0.5),
          ("v", (d, hkv * hd), d ** -0.5), ("o", (hq * hd, d), (hq * hd) ** -0.5)]
    if is_moe_layer(m, i):
        E, ff = m["n_experts"], m["d_ff"]
        lv += [("e_up", (E, d, ff), d ** -0.5), ("e_down", (E, ff, d), ff ** -0.5)]
        if gated:
            lv.append(("e_gate", (E, d, ff), d ** -0.5))
        sff = m.get("n_shared_experts", 0) * ff
        if sff:
            lv += [("s_up", (d, sff), d ** -0.5), ("s_down", (sff, d), sff ** -0.5)]
            if gated:
                lv.append(("s_gate", (d, sff), d ** -0.5))
    else:
        ff = m.get("dense_ff") or m["d_ff"]
        lv += [("up", (d, ff), d ** -0.5), ("down", (ff, d), ff ** -0.5)]
        if gated:
            lv.append(("gate", (d, ff), d ** -0.5))
    return lv


def layer(m: dict, seed: int, i: int, device) -> dict:
    """Layer ``i``'s tensors by flat name (router in float32)."""
    dt = DTYPES[m["param_dtype"]]
    w = _draw(seed, 16 + i, layer_leaves(m, i), dt, device)
    if is_moe_layer(m, i):
        d, E = m["d_model"], m["n_experts"]
        w["router"] = _draw(seed, 1 << 20 | i, [("r", (d, E), d ** -0.5)],
                            torch.float32, device)["r"]
    w["ln_attn"] = torch.ones(m["d_model"], dtype=dt, device=device)
    w["ln_mlp"] = torch.ones(m["d_model"], dtype=dt, device=device)
    return w


def embedding(m: dict, seed: int, device):
    dt = DTYPES[m["param_dtype"]]
    return _draw(seed, 1, [("t", (m["vocab"], m["d_model"]), 1.0)], dt,
                 device)["t"]


def unembedding(m: dict, seed: int, device):
    dt = DTYPES[m["param_dtype"]]
    d = m["d_model"]
    return _draw(seed, 2, [("w", (d, m["vocab"]), d ** -0.5)], dt,
                 device)["w"]


def port_block(w: dict) -> dict:
    """One layer in ``repro_torch.models.transformer``'s layout."""
    blk = {"ln_attn": {"scale": w["ln_attn"]},
           "attn": {n: {"w": w[n]} for n in ("q", "k", "v", "o")},
           "ln_mlp": {"scale": w["ln_mlp"]}}
    if "router" in w:
        moe = {"router": {"w": w["router"]}, "up": w["e_up"],
               "down": w["e_down"]}
        if "e_gate" in w:
            moe["gate"] = w["e_gate"]
        if "s_up" in w:
            moe["shared"] = {n: {"w": w["s_" + n]} for n in ("up", "down", "gate")
                             if "s_" + n in w}
        blk["moe"] = moe
    else:
        blk["mlp"] = {n: {"w": w[n]} for n in ("up", "down", "gate") if n in w}
    return blk


def port_params(m: dict, seed: int, device) -> dict:
    dt = DTYPES[m["param_dtype"]]
    return {"embed": {"table": embedding(m, seed, device)},
            "ln_f": {"scale": torch.ones(m["d_model"], dtype=dt, device=device)},
            "unembed": {"w": unembedding(m, seed, device)},
            "blocks": [port_block(layer(m, seed, i, device))
                       for i in range(m["n_layers"])]}
