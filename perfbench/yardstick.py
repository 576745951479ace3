"""The frozen yardstick: the card's peaks and the work each metric divides.

These are copies, kept here so that a change to the program cannot move
what the benchmark measures against:

* ``paged_decode_bytes`` is ``repro_torch/kernels/cost.py``'s
  ``paged_decode_attention`` byte count (K and V of the attended
  positions, q read, out written, the int32 block tables and lengths);
* ``window_flops`` counts model FLOPs: two per
  multiply-add of every weight a token uses (for an MoE layer the router,
  the ``top_k`` routed experts and the shared experts, not the experts
  the dense ``bmm`` computes for nothing), ``4·context·D·Hq`` a token and
  attention layer, and the unembedding only for rows whose logits are
  used (one per prompt and one per generated token).
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet (dense, no sparsity), at its 700 W limit.
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def paged_decode_bytes(B: int, Hq: int, Hkv: int, D: int, itemsize: int,
                       table_numel: int, attended: int) -> int:
    """Bytes one paged decode call must move at least."""
    return (attended * Hkv * D * 2 * itemsize + 2 * B * Hq * D * itemsize
            + table_numel * 4 + B * 4)


def layer_weight_flops(m: dict, layer: int) -> int:
    """2 x the weights one token multiplies in layer ``layer`` of model
    keys ``m`` (the configuration file's ``model``)."""
    d, hd = m["d_model"], m["head_dim"]
    hq, hkv = m["n_heads"], m["n_kv_heads"]
    attn = d * hq * hd + 2 * d * hkv * hd + hq * hd * d
    n_lin = 3 if m.get("gated_mlp", True) else 2
    if m.get("n_experts", 0) and layer >= m.get("first_dense_layers", 0):
        ff = m["d_ff"]
        ffn = (d * m["n_experts"]
               + (m["top_k"] + m.get("n_shared_experts", 0)) * n_lin * d * ff)
    else:
        ffn = n_lin * d * (m.get("dense_ff") or m["d_ff"])
    return 2 * (attn + ffn)


def unembed_flops(m: dict) -> int:
    return 2 * m["d_model"] * m["vocab"]


def window_flops(m: dict, chunks, steps) -> int:
    """Model FLOPs of prompt chunks ``(pos0, T, last)`` and decode steps
    (each a list of the rows' positions before the step)."""
    weights = sum(layer_weight_flops(m, i) for i in range(m["n_layers"]))
    attn = 4 * m["head_dim"] * m["n_heads"] * m["n_layers"]
    un = unembed_flops(m)
    total = 0
    for pos0, T, last in chunks:
        # contexts pos0+1 .. pos0+T
        ctx = T * pos0 + T * (T + 1) // 2
        total += T * weights + attn * ctx + (un if last else 0)
    for positions in steps:
        total += len(positions) * (weights + un) + attn * sum(
            p + 1 for p in positions)
    return total
