"""Fine-grained mixture-of-experts FFN (deepseek-moe / moonlight style).

The counterpart of the JAX package's ``models/moe.py``.  Routing: softmax
over all experts in float32 -> top-k -> renormalize.
Dispatch is capacity-based (dropped-token MoE): each (token, slot)
assignment takes the next free row of its expert's ``[capacity, d]``
buffer in flat ``(token, slot)`` order, assignments past ``capacity`` are
dropped, and the expert FFN runs as three batched matmuls over
``[n_experts, capacity, d]``, every expert's weights read whatever the
batch.  The reference runs these as plain ``einsum``s outside any Pallas
kernel, so they are ``torch.bmm`` here.

Shared experts (deepseek: 2) are a dense MLP with ``ff = n_shared * d_ff``.

Expert parallelism (``mesh`` with "model" dividing ``n_experts``): the
block input is replicated over "model", so EP needs no all-to-all -- each
model rank runs its ``n_experts / model`` experts, from offset ``j *
n_local``, over the tokens of its data shard, with the capacity of that
local token count, and one sum over "model" combines them (the
reference's ``shard_map`` branch).  Capacity per shard changes which
tokens drop, so an EP step equals the unsharded one only where nothing
drops.  Without EP under a mesh every rank computes the whole layer.
Routing runs on each data shard; the aux loss's expert fractions and mean
probabilities are summed over the batch axes first, so it is the global
one.

Where a line-by-line translation would depart from the reference:

* ties: ``jax.lax.top_k`` returns the lower expert id first among equal
  probabilities, and ``torch.topk`` promises no order, so the top k come
  from a stable descending sort;
* the rank of an assignment within its expert follows ``jnp.argsort``,
  which is stable: ``torch.argsort(..., stable=True)``;
* the combine sums each token's k contributions as ``[T, k, d]`` over k,
  not by an atomic scatter-add, so two calls on the card give equal bits.
"""
from __future__ import annotations

import math

import torch

from . import nn
from .config import ModelConfig


def moe_init(gen, cfg: ModelConfig, *, device="cpu"):
    """Router (float32 even in a bf16 model, as the reference), expert
    ``up``/``gate`` ``[E, d, ff]`` and ``down`` ``[E, ff, d]``, and the
    shared experts' MLP.  The expert dim carries the "model" sharding
    (EP), so the expert-internal dims get their own replicated axes."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = cfg.pdtype
    p = {
        "router": {"w": nn.Px(nn.lecun_init(gen, (d, E), torch.float32, d,
                                            device),
                              ("embed", "router_experts"))},
        "up": nn.Px(nn.lecun_init(gen, (E, d, ff), dt, d, device),
                    ("experts", "expert_in", "expert_ff")),
        "down": nn.Px(nn.lecun_init(gen, (E, ff, d), dt, ff, device),
                      ("experts", "expert_ff", "expert_in")),
    }
    if cfg.gated_mlp:
        p["gate"] = nn.Px(nn.lecun_init(gen, (E, d, ff), dt, d, device),
                          ("experts", "expert_in", "expert_ff"))
    if cfg.n_shared_experts > 0:
        p["shared"] = nn.mlp_init(gen, d, cfg.n_shared_experts * ff,
                                  gated=cfg.gated_mlp, dtype=dt,
                                  device=device)
    return p


def _counts(ids, n: int):
    """Occurrences of each of ``0..n-1`` in ``ids`` (int64); an integer
    scatter-add, which needs no host sync (``torch.bincount`` on the card
    reads the maximum back) and is exact in any order."""
    ids = ids.reshape(-1).long()
    return torch.zeros((n,), dtype=torch.int64, device=ids.device
                       ).scatter_add_(0, ids, torch.ones_like(ids))


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------


def _route_local(router_w, x_flat, cfg: ModelConfig):
    """(weights [T,k], idx [T,k] int64, tokens a slot picked each expert
    [E], summed probabilities [E]) of T tokens."""
    logits = x_flat.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)  # [T, E]
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :cfg.top_k], top_i[:, :cfg.top_k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return top_p, top_i, _counts(top_i, cfg.n_experts).float(), \
        probs.sum(dim=0)


def route(router_w, x_flat, cfg: ModelConfig, mesh=None):
    """Returns (weights [T,k], idx [T,k] int64, aux_loss scalar).  Under a
    mesh each data shard routes its own tokens; the counts and
    probability sums of the aux loss are summed over the shards."""
    T = x_flat.shape[0]
    if mesh is None:
        top_p, top_i, f, psum = _route_local(router_w, x_flat, cfg)
    else:
        tok = nn.batch_pspec(mesh, T, extra_dims=1)
        bt = tuple(a for a in ("pod", "data") if a in nn.axis_names(mesh))
        summed = bt if tok[0] is not None else ()
        top_p, top_i, f, psum = nn.local_map(
            lambda w, x: _route_local(w, x, cfg), mesh, [(None, None), tok],
            [tok, tok, (None,), (None,)], router_w, x_flat,
            partial_out=[(), (), summed, summed])
        f, psum = (nn.constrain(t, mesh, (None,)) for t in (f, psum))
    # load-balancing aux (Switch-style): E * sum_e f_e * p_e
    aux = cfg.n_experts * torch.sum(f / (T * cfg.top_k) * (psum / T))
    return top_p, top_i, aux


def _capacity(T: int, cfg: ModelConfig, decode: bool) -> int:
    cf = max(cfg.decode_capacity_factor, cfg.capacity_factor) if decode \
        else cfg.capacity_factor
    return max(1, math.ceil(T * cfg.top_k / cfg.n_experts * cf))


# ---------------------------------------------------------------------------
# Expert compute
# ---------------------------------------------------------------------------


def _expert_compute(x_flat, top_w, top_i, up, gate, down, *, expert_offset,
                    n_local: int, capacity: int, cfg: ModelConfig):
    """Dropped-token expert FFN over experts [offset, offset+n_local).

    x_flat [T,d]; top_w/top_i [T,k]; up/gate [El,d,ff], down [El,ff,d].
    Returns y_flat [T,d] (only local experts' contributions)."""
    T, d = x_flat.shape
    k = top_i.shape[1]
    C = capacity
    cd = cfg.cdtype
    dev = x_flat.device

    flat_e = top_i.reshape(-1).long()  # [T*k] global expert ids
    # rank of each assignment within its expert in flat (token, slot)
    # order: position in the stable sort minus the expert's start
    order = torch.argsort(flat_e, stable=True)
    counts = _counts(flat_e, cfg.n_experts)
    starts = torch.cumsum(counts, 0) - counts
    rank_sorted = torch.arange(T * k, device=dev) - starts[flat_e[order]]
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)

    local_e = flat_e - expert_offset
    keep = (local_e >= 0) & (local_e < n_local) & (rank < C)
    dest = torch.where(keep, local_e * C + rank, n_local * C)  # drop row

    x_rep = x_flat.to(cd).repeat_interleave(k, dim=0)  # row of each slot
    buf = x_rep.new_zeros((n_local * C + 1, d)).index_put((dest,), x_rep)
    h_in = buf[:n_local * C].reshape(n_local, C, d)

    act = nn.ACTIVATIONS[cfg.activation]
    up_h = torch.bmm(h_in, up.to(cd))
    if gate is not None:
        h = act(torch.bmm(h_in, gate.to(cd))) * up_h
    else:
        h = act(up_h)
    out = torch.bmm(h, down.to(cd)).reshape(n_local * C, d)
    out = torch.cat([out, out.new_zeros((1, d))], dim=0)

    contrib = out[dest] * top_w.reshape(-1).to(cd)[:, None] \
        * keep.to(cd)[:, None]
    return contrib.reshape(T, k, d).sum(dim=1)


# ---------------------------------------------------------------------------
# Public apply
# ---------------------------------------------------------------------------


def moe_apply(p, x, cfg: ModelConfig, *, decode: bool = False, mesh=None):
    """x [B,S,d] -> (y [B,S,d], aux scalar).  Every row of x is routed,
    padded ones included: they count in T and in each expert's capacity,
    as in the reference."""
    B, S, d = x.shape
    T = B * S
    x_flat = x.reshape(T, d)
    if mesh is not None:
        x_flat = nn.constrain(x_flat, mesh,
                              nn.batch_pspec(mesh, T, extra_dims=1))
    top_w, top_i, aux = route(p["router"]["w"], x_flat, cfg, mesh)
    gate = p.get("gate")
    names = nn.axis_names(mesh)
    use_ep = (mesh is not None and "model" in names
              and cfg.moe_impl in ("auto", "ep")
              and cfg.n_experts % nn.mesh_shape(mesh)["model"] == 0)
    if use_ep:
        n_local = cfg.n_experts // nn.mesh_shape(mesh)["model"]
        j = mesh.get_local_rank("model")

        def local(xf, tw, ti, up, gt, dn):
            return _expert_compute(
                xf, tw, ti, up, gt, dn, expert_offset=j * n_local,
                n_local=n_local, capacity=_capacity(xf.shape[0], cfg, decode),
                cfg=cfg)

        tok = nn.batch_pspec(mesh, T, extra_dims=1)
        espec = ("model", None, None)
        y_flat = nn.local_map(local, mesh, [tok] * 3 + [espec] * 3, [tok],
                              x_flat, top_w, top_i, p["up"], gate, p["down"],
                              partial_out=("model",))
        y_flat = nn.constrain(y_flat, mesh, tok)
    elif mesh is not None:  # every rank computes the whole layer
        rep = [()] * 6
        y_flat = nn.local_map(
            lambda xf, tw, ti, up, gt, dn: _expert_compute(
                xf, tw, ti, up, gt, dn, expert_offset=0,
                n_local=cfg.n_experts, capacity=_capacity(T, cfg, decode),
                cfg=cfg),
            mesh, rep, [()], x_flat, top_w, top_i, p["up"], gate, p["down"])
    else:
        y_flat = _expert_compute(x_flat, top_w, top_i, p["up"], gate,
                                 p["down"], expert_offset=0,
                                 n_local=cfg.n_experts,
                                 capacity=_capacity(T, cfg, decode), cfg=cfg)
    y = y_flat.reshape(B, S, d)
    if "shared" in p:
        y = y + nn.mlp_apply(p["shared"], x, activation=cfg.activation,
                             compute_dtype=cfg.cdtype)
    return y.to(x.dtype), aux


# ---------------------------------------------------------------------------
# Dropless reference (tests only; loops over experts)
# ---------------------------------------------------------------------------


def moe_reference(p, x, cfg: ModelConfig):
    B, S, d = x.shape
    x_flat = x.reshape(-1, d)
    top_w, top_i, aux = route(p["router"]["w"], x_flat, cfg)
    act = nn.ACTIVATIONS[cfg.activation]
    y = torch.zeros(x_flat.shape, dtype=torch.float32, device=x.device)
    for e in range(cfg.n_experts):
        w_e = torch.where(top_i == e, top_w, 0.0).sum(-1)  # [T]
        up = x_flat @ p["up"][e]
        if "gate" in p:
            h = act(x_flat @ p["gate"][e]) * up
        else:
            h = act(up)
        y = y + (h @ p["down"][e]).float() * w_e[:, None]
    y = y.reshape(B, S, d)
    if "shared" in p:
        y = y + nn.mlp_apply(p["shared"], x, activation=cfg.activation)
    return y.to(x.dtype), aux
