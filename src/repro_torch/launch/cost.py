"""Cost model of one eager step: the counterpart of the JAX package's
``launch/hlo_cost.py``.

The reference parses a compiled HLO module; the port has none, so it
counts the aten ops the step dispatches, with a ``TorchDispatchMode``
(``CostCounter``).  It runs on any device; on ``meta`` tensors (the
dry-run) nothing is allocated and the hand-written kernels launch nothing,
their wrappers charging each call's work from ``kernels/cost.py``.  Four
quantities, per device:

  * flops            — the formulas of ``torch.utils.flop_counter`` (mm,
                       addmm, bmm, baddbmm, convolution, SDPA), plus each
                       kernel's charge;
  * bytes            — per-op surface traffic, the reference's rule on
                       eager ops: each distinct operand read once, each
                       written tensor written once.  An op that writes in
                       place is charged once for what it writes (and once
                       for reading it, where it reads it: ``add_`` does,
                       ``copy_``/``fill_``/``zero_`` and ``out=`` do not).
                       Views, ``_to_copy`` to the same dtype, ``detach``,
                       ``empty`` and the like move nothing and count 0.
                       A gather reads the rows it gathers (at most its
                       output's bytes) and a scatter in place reads and
                       writes the values it scatters, as ``hlo_cost`` counts
                       ``gather`` / ``scatter``.  A kernel counts its formula;
  * collective bytes — the output bytes of each ``_c10d_functional``
                       collective this rank runs, all-gather /
                       reduce-scatter / all-to-all x1 and all-reduce x2 (a
                       ring all-reduce is a reduce-scatter and an
                       all-gather), as the reference weighs the HLO's
                       collectives; under a mesh the counter sees each
                       DTensor op as the local ops and collectives it
                       runs on this rank, so every count is per device;
  * peak_bytes       — the most tensor storage alive at once during the
                       run: the arguments' storages, then every storage an
                       op makes, released when Python frees it (activations
                       recomputed under ``torch.utils.checkpoint`` are freed
                       and counted as freed).  Storages made before the run
                       and not reachable from the arguments are not seen.

``repeat(k)`` charges the work of the ops run inside it ``k`` times (the
reference's while-loop trip counts): the dry-run counts one microbatch of
a step and charges it once for each microbatch.
"""
from __future__ import annotations

import contextlib
import sys
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import cost as kernel_cost

aten = torch.ops.aten

# ops that move no data of their own (the views are found by ``is_view``)
_FREE = {
    aten.detach.default, aten.alias.default, aten.lift_fresh.default,
    aten.empty.memory_format, aten.empty_like.default,
    aten.empty_strided.default, aten.new_empty.default,
    aten.new_empty_strided.default, aten._unsafe_view.default,
    aten._reshape_alias.default, aten.set_.source_Storage_storage_offset,
    aten.resize_.default, aten.lift_fresh_copy.default,
}
# shape queries, which FlopCounterMode also passes over
_QUERIES = {
    aten.is_contiguous.default, aten.is_contiguous.memory_format,
    aten.is_strides_like_format.default,
    aten.is_non_overlapping_and_dense.default, aten.size.default,
    aten.sym_size.default, aten.stride.default, aten.sym_stride.default,
    aten.storage_offset.default, aten.sym_storage_offset.default,
    aten.numel.default, aten.sym_numel.default, aten.dim.default,
    torch.ops.prim.layout.default, torch.ops.prim.device.default,
}
# in place, writing their target without reading it
_WRITE_ONLY = {aten.copy_.default, aten.fill_.Scalar, aten.fill_.Tensor,
               aten.zero_.default, aten.normal_.default,
               aten.uniform_.default, aten.random_.default}
# read only the rows they gather: the source counts at most the output
_GATHERS = {aten.index.Tensor, aten.index_select.default,
            aten.gather.default, aten.embedding.default}
# in place, reading and writing only the values they scatter
_SCATTERS = {aten.index_put_.default, aten._index_put_impl_.default,
             aten.index_add_.default, aten.index_copy_.default,
             aten.scatter_.src, aten.scatter_add_.default}


def _nbytes(t) -> int:
    """The bytes of the distinct elements ``t`` addresses (a broadcast,
    stride-0 dim read once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


def _tensors(tree, out=None):
    """The tensors of a tree of lists, tuples and dicts, in order."""
    if out is None:
        out = []
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


_COMPOSITE = torch._C.DispatchKey.CompositeImplicitAutograd

# functional collectives -> (the reference's HLO name, its weight)
_COLLECTIVES = {
    "all_gather_into_tensor": ("all-gather", 1.0),
    "all_gather_into_tensor_coalesced": ("all-gather", 1.0),
    "reduce_scatter_tensor": ("reduce-scatter", 1.0),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", 1.0),
    "all_reduce": ("all-reduce", 2.0),
    "all_reduce_coalesced": ("all-reduce", 2.0),
    "all_to_all_single": ("all-to-all", 1.0),
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd")


def _collective(func):
    """(HLO name, weight) of a functional collective, None for any other
    op (``wait_tensor`` and the autograd wrappers move nothing)."""
    if func.namespace not in _COLLECTIVE_NAMESPACES:
        return None
    return _COLLECTIVES.get(func._schema.name.split("::")[-1], ("", 0.0))


class _Plan:
    """What the counter needs to know of an op, found once per overload."""

    def __init__(self, func):
        packet = func._overloadpacket
        self.name = str(packet)
        self.flop_fn = flop_registry.get(packet)
        # as FlopCounterMode: an op it has no formula for is decomposed
        self.decompose = self.flop_fn is None and (
            _COMPOSITE in func.py_kernels
            or torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), _COMPOSITE))
        self.free = func.is_view or func in _FREE
        self.kind = ("scatter" if func in _SCATTERS else
                     "gather" if func in _GATHERS else
                     "to_copy" if func is aten._to_copy.default else "op")
        args = func._schema.arguments
        self.writes = [(i, a.name) for i, a in enumerate(args)
                       if a.alias_info is not None and a.alias_info.is_write]
        self.write_only = func in _WRITE_ONLY or any(
            args[i].is_out for i, _ in self.writes)


_PLANS: dict = {}


def _in_sharding_propagation(depth: int = 24) -> bool:
    """Whether DTensor's sharding propagation is on the call stack."""
    f = sys._getframe(2)
    for _ in range(depth):
        if f is None:
            return False
        if f.f_code.co_filename.endswith("_sharding_prop.py"):
            return True
        f = f.f_back
    return False


class CostCounter(TorchDispatchMode):
    """Counts the flops, bytes and peak storage of what runs inside it;
    ``by_op`` holds [calls, flops, bytes] an op, ``kernels`` the same a
    hand-written kernel, ``largest`` the biggest tensor an op made (bytes,
    shape, dtype, op)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.by_op = defaultdict(lambda: [0, 0.0, 0.0])
        self.kernels = defaultdict(lambda: [0, 0.0, 0.0])
        self.live = 0
        self.peak = 0
        self.largest = (0, None, None, None)
        self.collective = defaultdict(lambda: [0, 0.0])  # name -> [n, bytes]
        self._scale = 1
        self._refs = {}  # id(storage) -> weakref to it

    # -- storage tracking --------------------------------------------------
    def track(self, tree):
        """Count the storages of the tensors in ``tree`` as alive (a
        DTensor's: its local shard's, this device's)."""
        for t in _tensors(tree):
            if hasattr(t, "to_local"):
                t = t.to_local()
            st = t.untyped_storage()
            key = id(st)
            ref = self._refs.get(key)
            if ref is not None and ref() is st:
                continue
            n = st.nbytes()
            self._refs[key] = weakref.ref(
                st, lambda _, key=key, n=n: self._release(key, n))
            self.live += n
        self.peak = max(self.peak, self.live)

    def _release(self, key, n):
        if self._refs.pop(key, None) is not None:
            self.live -= n

    # -- charging ----------------------------------------------------------
    @contextlib.contextmanager
    def repeat(self, k: int):
        """Charge what runs inside ``k`` times (peak storage once)."""
        prev, self._scale = self._scale, self._scale * k
        try:
            yield
        finally:
            self._scale = prev

    def charge_kernel(self, name, flops, nbytes):
        rec = self.kernels[name]
        rec[0] += self._scale
        rec[1] += flops * self._scale
        rec[2] += nbytes * self._scale
        self.flops += flops * self._scale
        self.bytes += nbytes * self._scale

    def _op_bytes(self, plan, args, kwargs, ins, outs):
        if plan.free:
            return 0
        if plan.kind == "to_copy" and ins and outs \
                and ins[0].dtype == outs[0].dtype:
            return 0
        if plan.kind == "scatter":  # indices and values, read; values, written
            return sum(_nbytes(t) for t in ins[1:]) + sum(
                _nbytes(t) for t in ins[1:] if t.dtype.is_floating_point)
        written = {}
        for i, name in plan.writes:
            val = args[i] if i < len(args) else kwargs.get(name)
            for t in _tensors(val):
                written[id(t)] = t
        for t in outs:
            written.setdefault(id(t), t)
        read = {id(t): t for t in ins
                if not (plan.write_only and id(t) in written)}
        if plan.kind == "gather":  # the source (table) is the first operand
            out_b = sum(t.numel() * t.element_size() for t in outs)
            src = ins[0]
            rest = sum(_nbytes(t) for k, t in read.items() if k != id(src))
            return min(_nbytes(src), out_b) + rest + out_b
        return (sum(_nbytes(t) for t in read.values())
                + sum(t.numel() * t.element_size()
                      for t in written.values()))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _QUERIES:
            return func(*args, **kwargs)
        if any(t.__name__ == "DTensor" for t in types):
            # DTensor dispatches it: its local ops and collectives come back
            # here on this rank's shards
            return NotImplemented
        if any(t.__name__ == "FakeTensor" for t in types) or (
                not types and _in_sharding_propagation()):
            # DTensor's shape propagation: fake tensors of the global
            # shapes, made by factory ops with no tensor argument
            return func(*args, **kwargs)
        coll = _collective(func)
        if coll is not None:
            out = func(*args, **kwargs)
            name, weight = coll
            if name:
                rec = self.collective[name]
                rec[0] += self._scale
                rec[1] += weight * self._scale * sum(
                    t.numel() * t.element_size() for t in _tensors(out))
            return out
        plan = _PLANS.get(func)
        if plan is None:
            plan = _PLANS[func] = _Plan(func)
        if plan.decompose:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        flops = 0
        if plan.flop_fn is not None:
            flops = plan.flop_fn(*args, **kwargs, out_val=out)
        outs = _tensors(out)
        nbytes = self._op_bytes(plan, args, kwargs,
                                _tensors(kwargs, _tensors(args)), outs)
        k = self._scale
        rec = self.by_op[plan.name]
        rec[0] += k
        rec[1] += flops * k
        rec[2] += nbytes * k
        self.flops += flops * k
        self.bytes += nbytes * k
        for t in outs:
            b = t.numel() * t.element_size()
            if b > self.largest[0]:
                self.largest = (b, tuple(t.shape), str(t.dtype), plan.name)
        self.track(outs)
        return out

    def __enter__(self):
        kernel_cost.push(self)
        return super().__enter__()

    def __exit__(self, *exc):
        kernel_cost.pop(self)
        return super().__exit__(*exc)

    def summary(self) -> dict:
        return {"flops": float(self.flops), "bytes": float(self.bytes),
                "collective_bytes": float(sum(
                    b for _, b in self.collective.values())),
                "collective_detail": {
                    "per_op_bytes": {k: v[1] for k, v in
                                     self.collective.items()},
                    "counts": {k: v[0] for k, v in
                               self.collective.items()}}
                if self.collective else {},
                "peak_bytes": int(self.peak),
                "largest_output": list(self.largest),
                "kernels": {k: {"calls": v[0], "flops": v[1], "bytes": v[2]}
                            for k, v in self.kernels.items()}}


@contextlib.contextmanager
def repeat(k: int):
    """``CostCounter.repeat`` on the active counter; nothing without one."""
    c = kernel_cost.active()
    if c is None:
        yield
        return
    with c.repeat(k):
        yield


def run(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` under a fresh counter -> (its result,
    the counter)."""
    counter = CostCounter()
    counter.track((args, kwargs))
    with counter:
        result = fn(*args, **kwargs)
    return result, counter


def analyze(fn, *args, **kwargs) -> dict:
    """The reference's keys (``flops``, ``bytes``, ``collective_bytes``,
    ``collective_detail``) for one call of ``fn``, plus ``peak_bytes``,
    ``largest_output`` and the kernels' charges."""
    return run(fn, *args, **kwargs)[1].summary()


def top_bytes(fn, *args, n: int = 30, **kwargs):
    """Debug: the ops that move the most bytes in one call of ``fn`` ->
    [(bytes, calls, op, flops)], most first."""
    counter = run(fn, *args, **kwargs)[1]
    rows = [(b, calls, op, f) for op, (calls, f, b) in counter.by_op.items()]
    rows += [(b, calls, f"kernel:{k}", f)
             for k, (calls, f, b) in counter.kernels.items()]
    rows.sort(reverse=True)
    return rows[:n]
