"""Functional layer library: plain dicts of tensors, init + apply functions.

The counterpart of the JAX package's ``models/nn.py``.  Layouts are kept
so weights carry over unchanged: linear weights are ``[d_in, d_out]`` and
apply as ``x @ w`` after casting BOTH operands to the compute dtype;
rmsnorm, layernorm and rope compute in float32; rope splits the head dim
into halves (no interleave).

Initializers draw from a ``torch.Generator`` on the target device, so a
large model is made directly on the card.  They draw the same
distributions as the reference, not the same numbers.  Each ``*_init``
returns a tree of :class:`Px` leaves carrying the *logical axis names* of
every dimension; ``split`` separates the values from the axes, which
``repro_torch.launch.sharding`` maps to mesh axes.

Under a mesh (a ``torch.distributed.DeviceMesh`` whose dim names are the
reference's axis names) parameters and activations are ``DTensor``s:
``constrain`` is the reference's ``with_sharding_constraint``
(``redistribute``), and each ``jax.shard_map`` region of the reference is
a ``local_map`` region that runs on the local shards.  Every mesh branch
falls back to the plain path where the reference's does, on the same
divisibility tests; with ``mesh=None`` nothing changes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# Annotated params
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Px:
    """A param leaf annotated with logical axis names (one per dim)."""

    value: torch.Tensor
    axes: tuple

    def __post_init__(self):
        if len(self.axes) != self.value.dim():
            raise ValueError(
                f"axes {self.axes} rank != value rank {tuple(self.value.shape)}")


def split(tree):
    """Split a Px tree (dicts and lists) into (values, axes) trees of
    identical structure."""
    if isinstance(tree, Px):
        return tree.value, tree.axes
    if isinstance(tree, dict):
        pairs = {k: split(v) for k, v in tree.items()}
        return ({k: v[0] for k, v in pairs.items()},
                {k: v[1] for k, v in pairs.items()})
    if isinstance(tree, list):
        pairs = [split(v) for v in tree]
        return [v[0] for v in pairs], [v[1] for v in pairs]
    raise TypeError(f"not a Px tree: {type(tree).__name__}")


def stack_axes(axes_tree, n: int = 1):
    """The axes of ``axes_tree``'s leaves stacked ``n`` times along new
    leading ``"layers"`` dims, as the reference's ``stack_layers`` gives
    them (the port keeps the layers as lists; only their axes stack)."""
    if isinstance(axes_tree, dict):
        return {k: stack_axes(v, n) for k, v in axes_tree.items()}
    return ("layers",) * n + tuple(axes_tree)


def stack_layers(layer_trees):
    """A list of per-layer Px trees -> (the list of their value trees, the
    axes tree stacked as the reference's ``stack_layers`` does it: the
    first layer's axes with ``"layers"`` first)."""
    pairs = [split(t) for t in layer_trees]
    return [v for v, _ in pairs], stack_axes(pairs[0][1])


# ---------------------------------------------------------------------------
# Meshes: logical specs -> DTensor placements
# ---------------------------------------------------------------------------


def axis_names(mesh) -> tuple:
    return tuple(getattr(mesh, "mesh_dim_names", None) or ())


def mesh_shape(mesh) -> dict:
    """{axis name: size}, the reference's ``mesh.shape`` (which a stub
    mesh may hold already)."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(axis_names(mesh), tuple(mesh.shape)))


def placements(spec, mesh) -> list:
    """The DTensor placements of a PartitionSpec-like tuple (one entry per
    tensor dim: a mesh axis name, a tuple of names, or None): ``Shard(i)``
    on every mesh dim that entry i names, ``Replicate()`` on the others.  A
    tuple entry shards its dim over several mesh dims, major to minor,
    which DTensor expresses when they come in the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out = [Replicate() for _ in names]
    for i, entry in enumerate(spec or ()):
        if entry is None:
            continue
        dims = [names.index(a) for a in
                (entry if isinstance(entry, tuple) else (entry,))]
        if dims != sorted(dims):
            raise ValueError(f"spec entry {entry} is not in the mesh's "
                             f"order {names}")
        for d in dims:
            out[d] = Shard(i)
    return out


def as_dtensor(x, mesh):
    """``x`` as a DTensor on ``mesh``: a plain tensor is replicated."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate() for _ in axis_names(mesh)],
                              run_check=False)


def mesh_context(mesh):
    """The context a forward (and its backward) under ``mesh`` runs in:
    plain tensors made inside it (positions, masks, zeros) meet DTensors
    as replicated values.  Nothing without a mesh."""
    if mesh is None:
        return contextlib.nullcontext()
    return _implicit_replication()


@contextlib.contextmanager
def _implicit_replication():
    # DTensor's own context manager resets the flag to False on exit,
    # which would end an enclosing one (the train step's) early
    from torch.distributed.tensor import DTensor

    dispatcher = DTensor._op_dispatcher
    prev = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = prev


def like(x, t):
    """``t`` (a plain tensor every rank holds whole) as a replicated
    DTensor on ``x``'s mesh when ``x`` is a DTensor, else ``t``."""
    mesh = getattr(x, "device_mesh", None)
    return t if mesh is None else as_dtensor(t, mesh)


def constrain(x, mesh, spec):
    """The reference's ``with_sharding_constraint``: ``x`` redistributed to
    ``spec`` (no-op when mesh is None).  Activation shardings are pinned
    at layer boundaries, as the reference pins them."""
    if mesh is None:
        return x
    return as_dtensor(x, mesh).redistribute(mesh, placements(spec, mesh))


def batch_pspec(mesh, batch_size: int, extra_dims: int = 2):
    """(batch_axes, None, ...) if the batch divides the DP size, else
    (None, None, ...); () without a mesh."""
    if mesh is None:
        return ()
    shape = mesh_shape(mesh)
    bt = tuple(a for a in ("pod", "data") if a in shape)
    if not bt:
        return (None,) * (1 + extra_dims)
    dp = math.prod(shape[a] for a in bt)
    lead = bt if batch_size % dp == 0 else None
    return (lead,) + (None,) * extra_dims


# ---------------------------------------------------------------------------
# Cache layout under a mesh (the reference's ``cache_specs`` rule, by leaf
# name; ``launch.specs.cache_specs`` applies it to a cache template)
# ---------------------------------------------------------------------------


def batch_dim_for(keys, rank: int) -> int:
    """The slot (batch) dim of a cache leaf, from its name and rank."""
    name = keys[-1]
    if name in ("k", "v", "cross_k", "cross_v", "wkv", "ssm"):
        return rank - 4
    if name == "len":
        return rank - 1
    if name == "shift":
        return rank - 2
    if len(keys) >= 2 and keys[-2] == "conv":
        return rank - 3
    raise ValueError(f"unknown cache leaf {keys}")


def cache_spec(path: tuple, shape: tuple, mesh, batch: int) -> tuple:
    """The spec of the cache leaf at ``path`` (its dict keys) of ``shape``:
    the batch on ("pod", "data") when it divides their size; the KV
    sequence of ``k``/``v``/``cross_k``/``cross_v``, the heads of rwkv's
    ``wkv`` and zamba2's ``ssm`` state and the ``d_in`` of the conv tail
    ``x`` on "model" when they divide it; ``len`` and ``shift`` follow the
    batch.  The dims are counted from the end, so the port's stacked
    leaves and the reference's scanned ones get one rule."""
    sizes = mesh_shape(mesh)
    b_axes = tuple(a for a in ("pod", "data") if a in sizes)
    b_size = math.prod(sizes[a] for a in b_axes)
    batch_entry = None
    if b_axes and batch % b_size == 0:  # (one axis: its name, as P has it)
        batch_entry = b_axes if len(b_axes) > 1 else b_axes[0]
    model_size = sizes.get("model", 1)

    def model_if(dim: int):
        return "model" if dim % model_size == 0 else None

    rank = len(shape)
    ent = [None] * rank
    bdim = batch_dim_for(path, rank)
    ent[bdim] = batch_entry
    name = path[-1]
    if name in ("k", "v", "cross_k", "cross_v", "wkv", "ssm"):
        # the KV sequence, or rwkv's / the SSM's heads
        ent[bdim + 1] = model_if(shape[bdim + 1])
    elif name == "x" and path[-2] == "conv":
        ent[rank - 1] = model_if(shape[rank - 1])  # d_in
    return tuple(ent)


def lay_out_cache(cache, mesh):
    """``cache`` (a tree of tensors or DTensors, any layout) laid out by
    ``cache_spec`` on ``mesh``, leaf by leaf from its own shapes (a
    whisper prefill's frames may be fewer than ``WHISPER_FRAMES``): a
    plain tensor every rank holds whole is cut to its shards, a DTensor
    redistributed."""
    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        batch = tree.shape[batch_dim_for(path, tree.dim())]
        return constrain(tree, mesh, cache_spec(path, tuple(tree.shape),
                                                mesh, batch))

    return walk(cache, ())


def spec_of(x) -> tuple:
    """A DTensor's placements as a spec (one entry per dim: the mesh axis
    that shards it, a tuple of them, or None); a plain tensor's is all
    None (replicated)."""
    from torch.distributed.tensor import DTensor, Shard

    ent = [[] for _ in range(x.dim())]
    if isinstance(x, DTensor):
        names = axis_names(x.device_mesh)
        for d, p in enumerate(x.placements):
            if isinstance(p, Shard):
                ent[p.dim].append(names[d])
    return tuple(None if not e else e[0] if len(e) == 1 else tuple(e)
                 for e in ent)


def local_offsets(x) -> tuple:
    """The global index of the first element of ``x``'s local shard, dim
    by dim (zeros for a plain tensor)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return (0,) * x.dim()
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    _, off = compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, x.placements)
    return tuple(off)


def local(x):
    """A DTensor's local shard (a view of its storage), or ``x``."""
    return x.to_local() if hasattr(x, "to_local") else x


def _shift_placements(placements, by: int):
    from torch.distributed.tensor import Shard

    return [Shard(p.dim + by) if isinstance(p, Shard) else p
            for p in placements]


def stack(xs):
    """``torch.stack(xs)`` of tensors of one layout: DTensors are stacked
    shard by shard (nothing moves), their placements shifted by the new
    leading dim."""
    from torch.distributed.tensor import DTensor

    if not isinstance(xs[0], DTensor):
        return torch.stack(xs)
    return DTensor.from_local(torch.stack([x.to_local() for x in xs]),
                              xs[0].device_mesh,
                              _shift_placements(xs[0].placements, 1),
                              run_check=False)


def index0(x, i: int):
    """``x[i]`` on the leading dim as a view: a DTensor (not sharded on
    that dim) keeps its local storage, so writes into the result land in
    ``x``."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x[i]
    return DTensor.from_local(x.to_local()[i], x.device_mesh,
                              _shift_placements(x.placements, -1),
                              run_check=False)


def assign(dst, src):
    """``dst.copy_(src)``, in place; under a mesh ``src`` is first laid out
    as ``dst`` is, and each rank copies its own shard."""
    if hasattr(dst, "to_local"):
        src = as_dtensor(src, dst.device_mesh).redistribute(
            dst.device_mesh, dst.placements)
        dst.to_local().copy_(src.to_local())
    else:
        dst.copy_(src)
    return dst


def gathered(x):
    """``x`` whole on every rank, as a plain tensor (a DTensor's
    ``full_tensor()``)."""
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def psum_model(x, mesh, op: str = "sum"):
    """The reference's ``psum``/``pmax`` over "model" inside a local
    region: its backward passes the (replicated) cotangent through, as
    JAX transposes a psum in ``shard_map``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    sub = mesh["model"]
    return DTensor.from_local(x, sub, [Partial(op)], run_check=False
                              ).redistribute(sub, [Replicate()]).to_local()


def reshape(x, *shape):
    """``x.reshape(*shape)``.  A DTensor sharded on a dim the reshape
    splits or merges unevenly (7 heads over a model axis of 2) is first
    replicated on those mesh dims, as GSPMD would pad or gather (its
    shards on the leading, batch dim stay); in the backward the gradient
    is brought to the output's layout before it is reshaped back, which
    the gradient's own layout may not allow."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x.reshape(*shape)
    return _Reshape.apply(x, shape)


class _Reshape(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shape):
        from torch.distributed.tensor import Replicate, Shard

        ctx.in_shape = tuple(x.shape)
        try:
            y = x.reshape(*shape)
        except RuntimeError:
            pl = [Replicate() if isinstance(p, Shard) and p.dim != 0 else p
                  for p in x.placements]
            y = x.redistribute(x.device_mesh, pl).reshape(*shape)
        # the gradient of a partial sum is replicated
        ctx.out_pl = tuple(Replicate() if p.is_partial() else p
                           for p in y.placements)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.redistribute(g.device_mesh, ctx.out_pl)
        return g.reshape(ctx.in_shape), None


def unbind(x, dim: int = 0):
    """``x.unbind(dim)``; a DTensor sharded on ``dim`` is first replicated
    on it."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if isinstance(x, DTensor) and any(
            isinstance(p, Shard) and p.dim == dim for p in x.placements):
        pl = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
              for p in x.placements]
        x = x.redistribute(x.device_mesh, pl)
    return x.unbind(dim)


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient contiguous: DTensor
    runs the views of its own backward (a matmul's reshapes) as ``view``
    on the local shards, which a transposed gradient from a local region
    (a scan's plain backward) would refuse."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def local_map(fn, mesh, in_specs, out_specs, *args, partial_out=()):
    """The counterpart of ``jax.shard_map``: each tensor argument is
    redistributed to its spec and ``fn`` runs on the local shards; its
    outputs (one or a tuple, one spec each) become DTensors with
    ``out_specs``, partial sums over the mesh axes ``partial_out`` (a
    tuple of names for every output, or a list of them, one an output;
    the caller's ``redistribute`` then reduces them, all-reduce or
    reduce-scatter).  Gradients follow JAX's rule: an argument replicated
    over an axis over which the outputs vary gets its local gradients as
    partial sums over that axis; one sharded keeps its shards.  A
    non-tensor argument (None, a number) passes through."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    names = axis_names(mesh)
    if not partial_out or isinstance(partial_out[0], str):
        partial_out = [partial_out] * len(out_specs)
    out_pls = []
    for spec, partial in zip(out_specs, partial_out):
        pl = placements(spec, mesh)
        for a in partial:
            pl[names.index(a)] = Partial()
        out_pls.append(pl)
    varying = {d for pl in out_pls for d, p in enumerate(pl)
               if not isinstance(p, Replicate)}
    local = []
    for spec, a in zip(in_specs, args):
        if not isinstance(a, torch.Tensor):
            local.append(a)
            continue
        a = constrain(a, mesh, spec)
        if a.requires_grad:
            grad_pl = [Partial() if isinstance(p, Replicate) and d in varying
                       else p for d, p in enumerate(a.placements)]
            local.append(_ContiguousGrad.apply(
                a.to_local(grad_placements=grad_pl)))
        else:
            local.append(a.to_local())
    out = fn(*local)
    single = not isinstance(out, tuple)
    outs = (out,) if single else out
    wrapped = tuple(
        None if o is None else
        DTensor.from_local(o, mesh, pl, run_check=False)
        for o, pl in zip(outs, out_pls))
    return wrapped[0] if single else wrapped


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def normal_init(gen, shape, dtype, stddev, device):
    # scaled in place: a float32 leaf holds one copy while it is drawn (a
    # nemotron-4-340b embedding is 18.9 GB), not two
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return x.mul_(stddev).to(dtype)


def lecun_init(gen, shape, dtype, fan_in, device):
    return normal_init(gen, shape, dtype, 1.0 / math.sqrt(max(1, fan_in)),
                       device)


# ---------------------------------------------------------------------------
# Core layers
# ---------------------------------------------------------------------------


def linear_init(gen, d_in, d_out, *, axes, dtype=torch.float32, bias=False,
                bias_axis=None, stddev=None, device="cpu"):
    """Dense projection ``[d_in] -> [d_out]`` with logical axes for
    sharding."""
    if stddev is None:
        w = lecun_init(gen, (d_in, d_out), dtype, d_in, device)
    else:
        w = normal_init(gen, (d_in, d_out), dtype, stddev, device)
    p = {"w": Px(w, axes)}
    if bias:
        p["b"] = Px(torch.zeros((d_out,), dtype=dtype, device=device),
                    (bias_axis if bias_axis is not None else axes[-1],))
    return p


def fsdp_gather(w):
    """A DTensor weight gathered over the batch axes ("pod", "data"): the
    ZeRO-3 all-gather before its use on batch-sharded activations, which
    GSPMD places there too (left to DTensor's own choice, the product may
    shard the sequence over "model" instead, a layout the reference's
    constraints rule out).  A plain tensor is returned as it is."""
    mesh = getattr(w, "device_mesh", None)
    if mesh is None:
        return w
    from torch.distributed.tensor import Replicate

    names = axis_names(mesh)
    pl = [Replicate() if names[d] in ("pod", "data") else p
          for d, p in enumerate(w.placements)]
    return w.redistribute(mesh, pl) if pl != list(w.placements) else w


def linear_apply(p, x, compute_dtype=None):
    w = p["w"]
    if compute_dtype is not None:
        w = w.to(compute_dtype)
        x = x.to(compute_dtype)
    w = fsdp_gather(w)
    y = x @ w
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def linear_apply_tp(p, x, mode: str, mesh, compute_dtype, *,
                    fsdp: bool = False, seq_shard: bool = False):
    """Explicit Megatron-style tensor-parallel linear in a local region:

      * mode="column": w [d_in, out(model)]; x replicated over model ->
        y sharded on out (its backward sums dx over model);
      * mode="row":    w [in(model), d_out]; x sharded on in ->
        y = psum(x @ w) over model in the compute dtype, or, with
        ``seq_shard`` (Megatron-SP), reduce-scattered over the sequence.

    ``fsdp=True`` gathers the weight over "data" first (ZeRO-3, in the
    compute dtype).  Falls back to the plain matmul when the mesh or
    divisibility prerequisites do not hold, as the reference."""
    w = p["w"]
    if mesh is None or "model" not in axis_names(mesh):
        return linear_apply(p, x, compute_dtype)
    shape = mesh_shape(mesh)
    msize = shape["model"]
    dsize = shape.get("data", 1) if fsdp else 1
    d_in, d_out = w.shape
    if mode == "column":
        if d_out % msize or (fsdp and d_in % dsize):
            return linear_apply(p, x, compute_dtype)
    elif d_in % msize or (fsdp and d_out % dsize):
        return linear_apply(p, x, compute_dtype)
    cd = compute_dtype or x.dtype
    x = x.to(cd)
    w = w.to(cd)
    bias = p.get("b")
    bspec = batch_pspec(mesh, x.shape[0], extra_dims=x.dim() - 2)
    fs = "data" if fsdp and "data" in shape else None

    if mode == "column":
        w = constrain(w, mesh, (fs, "model"))
        if fs:  # the ZeRO-3 gather, in the compute dtype
            w = constrain(w, mesh, (None, "model"))
        args = [x, w]
        specs = [bspec + (None,), (None, "model")]
        if bias is not None:
            args.append(bias.to(cd))
            specs.append(("model",))

        def local(xl, wl, *b):
            y = xl @ wl
            return y + b[0] if b else y

        return local_map(local, mesh, specs, [bspec + ("model",)], *args)

    w = constrain(w, mesh, ("model", fs))
    if fs:
        w = constrain(w, mesh, ("model", None))
    # a psum left as a partial sum, reduced by the redistribute below
    y = local_map(lambda xl, wl: (xl @ wl).to(cd), mesh,
                  [bspec + ("model",), ("model", None)], [bspec + (None,)],
                  x, w, partial_out=("model",))
    use_sp = seq_shard and x.dim() == 3 and x.shape[1] % msize == 0
    y = constrain(y, mesh, (bspec[0], "model", None) if use_sp
                  else bspec + (None,))
    if bias is not None:
        y = y + bias.to(cd)
    return y


def rmsnorm_init(d, *, axis="embed", dtype=torch.float32, device="cpu"):
    return {"scale": Px(torch.ones((d,), dtype=dtype, device=device),
                        (axis,))}


def rmsnorm_apply(p, x, eps=1e-6):
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(dt)


def layernorm_init(d, *, axis="embed", dtype=torch.float32, device="cpu"):
    return {"scale": Px(torch.ones((d,), dtype=dtype, device=device),
                        (axis,)),
            "bias": Px(torch.zeros((d,), dtype=dtype, device=device),
                       (axis,))}


def layernorm_apply(p, x, eps=1e-5):
    dt = x.dtype
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(dt)


def embedding_init(gen, vocab, d, *, dtype=torch.float32, device="cpu"):
    # the token gather must run over an UNsharded vocab dim, so input
    # tables are sharded on the embed dim ("embed_g") instead
    return {"table": Px(normal_init(gen, (vocab, d), dtype, 1.0, device),
                        ("tokens_vocab", "embed_g"))}


def embedding_apply(p, ids, compute_dtype=None, mesh=None):
    """Token lookup; under a mesh with "model", each model shard takes its
    rows from its ``[vocab, embed/model]`` slice locally (the reference's
    ``shard_map``)."""
    t = p["table"]
    if compute_dtype is not None:
        t = t.to(compute_dtype)
    if mesh is not None and "model" in axis_names(mesh):
        tok_spec = batch_pspec(mesh, ids.shape[0], extra_dims=ids.dim() - 1)
        return local_map(lambda tt, ii: tt[ii.long()], mesh,
                         [(None, "model"), tok_spec], [tok_spec + ("model",)],
                         t, ids)
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
             device="cpu", in_axis="embed", ff_axis="mlp"):
    p = {
        "up": linear_init(gen, d_model, d_ff, axes=(in_axis, ff_axis),
                          dtype=dtype, device=device),
        "down": linear_init(gen, d_ff, d_model, axes=(ff_axis, in_axis),
                            dtype=dtype, device=device),
    }
    if gated:
        p["gate"] = linear_init(gen, d_model, d_ff, axes=(in_axis, ff_axis),
                                dtype=dtype, device=device)
    return p


def mlp_apply(p, x, *, activation="silu", compute_dtype=None, mesh=None,
              explicit_tp=False, fsdp=False, seq_shard=False):
    act = ACTIVATIONS[activation]
    if explicit_tp and mesh is not None and "model" in axis_names(mesh):
        up = linear_apply_tp(p["up"], x, "column", mesh, compute_dtype,
                             fsdp=fsdp)
        if "gate" in p:
            h = act(linear_apply_tp(p["gate"], x, "column", mesh,
                                    compute_dtype, fsdp=fsdp)) * up
        else:
            h = act(up)
        return linear_apply_tp(p["down"], h, "row", mesh, compute_dtype,
                               fsdp=fsdp, seq_shard=seq_shard)
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
    cos = like(x, torch.cos(angles)[..., :, None, :])  # [..., S, 1, d/2]
    sin = like(x, torch.sin(angles)[..., :, None, :])
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
