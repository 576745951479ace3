"""Declarative resources, partitions, and the resource mapper (§III-C).

``ResourceDescription`` declares what the middleware may use; ``Allocation``
tracks free cores/gpus per node with O(1) freelists; ``ResourceMapper`` binds
task requirements (ranks x cores x gpus) to concrete node/core/gpu ids.
Allocations can be partitioned into disjoint node sets, each servable by a
different backend (e.g. MPI partition + function-task partition).

The claim API is what makes tasks and *services* share one ledger, the
paper's §III-C premise that every workload category runs inside one job
allocation under uniform resource abstractions: a long-running entity (a
service replica) calls ``Allocation.claim(requirements)`` and holds the
returned ``Claim`` — concrete node/core/gpu ids booked against the same
free lists transient tasks map through — until it retires and releases it.
``free_capacity()`` / ``fits()`` let admission control (the replica-set
autoscaler) bound scale-up decisions by what is physically left instead of
scaling past the allocation.  Packing is first-fit by default; best-fit
(tightest node that still fits, minimizing stranded fragments) is available
per allocation or per call.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Iterable, Optional, Union


@dataclasses.dataclass(frozen=True)
class ResourceDescription:
    nodes: int = 1
    cores_per_node: int = 8
    gpus_per_node: int = 0

    @property
    def total_cores(self) -> int:
        return self.nodes * self.cores_per_node

    @property
    def total_gpus(self) -> int:
        return self.nodes * self.gpus_per_node


@dataclasses.dataclass
class Placement:
    """Concrete binding: rank -> (node, cores, gpus)."""

    ranks: list  # [(node_id, (core ids...), (gpu ids...)), ...]

    @property
    def nodes(self):
        return sorted({r[0] for r in self.ranks})

    @property
    def n_cores(self) -> int:
        return sum(len(r[1]) for r in self.ranks)

    @property
    def n_gpus(self) -> int:
        return sum(len(r[2]) for r in self.ranks)


class Claim:
    """A held reservation: a ``Placement`` plus the allocation it came from.

    Unlike a task's placement (released by the middleware on completion), a
    claim is owned by a long-running entity — a service replica — and stays
    booked until ``release()``.  Release is idempotent: retire paths can
    race (scale-down vs reap vs shutdown) without double-freeing cores.
    """

    __slots__ = ("placement", "allocation", "owner", "_released", "_lock")

    def __init__(self, placement: Placement, allocation: "Allocation",
                 owner: str = ""):
        self.placement = placement
        self.allocation = allocation
        self.owner = owner
        self._released = False
        self._lock = threading.Lock()

    @property
    def n_cores(self) -> int:
        return 0 if self._released else self.placement.n_cores

    @property
    def n_gpus(self) -> int:
        return 0 if self._released else self.placement.n_gpus

    @property
    def released(self) -> bool:
        return self._released

    def release(self) -> bool:
        """Return the claimed cores/gpus to the allocation; True only for
        the call that actually freed them."""
        with self._lock:
            if self._released:
                return False
            self._released = True
        self.allocation.release(self.placement)
        return True

    def __repr__(self):
        state = "released" if self._released else (
            f"{self.placement.n_cores}c/{self.placement.n_gpus}g"
            f"@nodes{self.placement.nodes}")
        return f"Claim({self.owner or 'anon'}: {state})"


class NodeState:
    __slots__ = ("node_id", "free_cores", "free_gpus")

    def __init__(self, node_id: int, cores: int, gpus: int):
        self.node_id = node_id
        self.free_cores = list(range(cores))
        self.free_gpus = list(range(gpus))


class Allocation:
    """Mutable free-resource view over a ResourceDescription (or subset)."""

    def __init__(self, desc: ResourceDescription, node_ids=None,
                 name: str = "default", strategy: str = "first_fit"):
        self.desc = desc
        self.name = name
        if strategy not in ("first_fit", "best_fit"):
            raise ValueError(f"unknown packing strategy {strategy!r}")
        self.strategy = strategy
        ids = list(node_ids) if node_ids is not None else list(range(desc.nodes))
        self.nodes = {i: NodeState(i, desc.cores_per_node, desc.gpus_per_node)
                      for i in ids}
        self._lock = threading.Lock()
        self.used_cores = 0
        self.used_gpus = 0

    # -- capacity ---------------------------------------------------------
    @property
    def total_cores(self) -> int:
        return len(self.nodes) * self.desc.cores_per_node

    @property
    def total_gpus(self) -> int:
        return len(self.nodes) * self.desc.gpus_per_node

    def utilization(self) -> dict:
        return {
            "cores": self.used_cores / max(1, self.total_cores),
            "gpus": self.used_gpus / max(1, self.total_gpus),
        }

    def free_capacity(self) -> dict:
        """What is left to claim right now: total free cores/gpus plus the
        largest node-local contiguous chunk of each (a rank's cores are
        node-local, so the *shape* of the leftovers bounds admission, not
        just the sum)."""
        with self._lock:
            cores = [len(n.free_cores) for n in self.nodes.values()]
            gpus = [len(n.free_gpus) for n in self.nodes.values()]
        return {
            "cores": sum(cores),
            "gpus": sum(gpus),
            "max_cores_per_node": max(cores, default=0),
            "max_gpus_per_node": max(gpus, default=0),
            "nodes": len(cores),
        }

    def fits(self, ranks: int, cores_per_rank: int,
             gpus_per_rank: int = 0) -> int:
        """How many MORE placements of this shape fit right now, without
        booking anything (the autoscaler's admission bound)."""
        if ranks <= 0:
            return 0
        cores_per_rank = max(0, cores_per_rank)
        gpus_per_rank = max(0, gpus_per_rank)
        if cores_per_rank == 0 and gpus_per_rank == 0:
            return 1 << 30  # zero-footprint shape: admission never binds
        # rank slots of one shape are interchangeable across placements,
        # so the count is just total node-local rank capacity // ranks —
        # O(nodes), not a placement-by-placement simulation (this runs on
        # every autoscaler grow tick)
        slots = 0
        with self._lock:
            for n in self.nodes.values():
                per_node = []
                if cores_per_rank:
                    per_node.append(len(n.free_cores) // cores_per_rank)
                if gpus_per_rank:
                    per_node.append(len(n.free_gpus) // gpus_per_rank)
                slots += min(per_node)
        return slots // ranks

    # -- mapping ------------------------------------------------------------
    def _pick_node(self, cores_per_rank: int, gpus_per_rank: int,
                   strategy: str) -> Optional[NodeState]:
        """Node for one rank.  ``first_fit`` scans in id order; ``best_fit``
        picks the eligible node with the fewest leftover cores (then gpus),
        so small claims pack into already-fragmented nodes and big ranks
        keep finding whole ones."""
        if strategy == "best_fit":
            best = None
            for node in self.nodes.values():
                if (len(node.free_cores) >= cores_per_rank
                        and len(node.free_gpus) >= gpus_per_rank):
                    key = (len(node.free_cores) - cores_per_rank,
                           len(node.free_gpus) - gpus_per_rank)
                    if best is None or key < best[0]:
                        best = (key, node)
            return best[1] if best else None
        for node in self.nodes.values():
            if (len(node.free_cores) >= cores_per_rank
                    and len(node.free_gpus) >= gpus_per_rank):
                return node
        return None

    def try_map(self, ranks: int, cores_per_rank: int,
                gpus_per_rank: int, strategy: Optional[str] = None
                ) -> Optional[Placement]:
        """Rank placement (each rank's cores/gpus are node-local); rolls
        back fully on failure.  ``strategy`` overrides the allocation's
        default packing for this call."""
        strategy = strategy or self.strategy
        # a 0-core (gpu-only) or 0-gpu rank books nothing of that kind:
        # [-0:] would silently grab a node's ENTIRE free list
        cores_per_rank = max(0, cores_per_rank)
        gpus_per_rank = max(0, gpus_per_rank)
        with self._lock:
            bound = []
            for _ in range(ranks):
                node = self._pick_node(cores_per_rank, gpus_per_rank,
                                       strategy)
                if node is None:
                    # roll back partial binding
                    for (nid, cores, gpus) in bound:
                        n = self.nodes[nid]
                        n.free_cores.extend(cores)
                        n.free_gpus.extend(gpus)
                    return None
                cores = tuple(node.free_cores[-cores_per_rank:]) \
                    if cores_per_rank else ()
                if cores_per_rank:
                    del node.free_cores[-cores_per_rank:]
                gpus = tuple(node.free_gpus[-gpus_per_rank:]) \
                    if gpus_per_rank else ()
                if gpus_per_rank:
                    del node.free_gpus[-gpus_per_rank:]
                bound.append((node.node_id, cores, gpus))
            self.used_cores += ranks * cores_per_rank
            self.used_gpus += ranks * gpus_per_rank
            return Placement(bound)

    def claim(self, requirements, owner: str = "",
              strategy: Optional[str] = None) -> Optional[Claim]:
        """Book ``requirements`` (anything with ranks/cores_per_rank/
        gpus_per_rank) as a held ``Claim``; None when the allocation cannot
        fit it — the caller degrades (admission denied), it does not crash.
        """
        placement = self.try_map(requirements.ranks,
                                 requirements.cores_per_rank,
                                 requirements.gpus_per_rank,
                                 strategy=strategy)
        if placement is None:
            return None
        return Claim(placement, self, owner=owner)

    def release(self, placement: Placement):
        with self._lock:
            for (nid, cores, gpus) in placement.ranks:
                node = self.nodes[nid]
                node.free_cores.extend(cores)
                node.free_gpus.extend(gpus)
                self.used_cores -= len(cores)
                self.used_gpus -= len(gpus)

    # -- elasticity -----------------------------------------------------------
    def add_nodes(self, n: int):
        """Grow the allocation (elastic scale-up)."""
        start = max(self.nodes) + 1 if self.nodes else 0
        for i in range(start, start + n):
            self.nodes[i] = NodeState(i, self.desc.cores_per_node,
                                      self.desc.gpus_per_node)

    def drain_node(self, node_id: int) -> bool:
        """Remove a node if idle (elastic scale-down / failure simulation)."""
        node = self.nodes.get(node_id)
        if node is None:
            return False
        if (len(node.free_cores) < self.desc.cores_per_node
                or len(node.free_gpus) < self.desc.gpus_per_node):
            return False
        del self.nodes[node_id]
        return True


def partition(desc: ResourceDescription,
              sizes: Union[dict, Iterable],
              strategy: str = "first_fit") -> dict:
    """Split a resource description into named disjoint node partitions.

    ``sizes`` maps partition name -> either a node COUNT (taken from the
    lowest remaining ids, in declaration order) or an explicit iterable of
    node ids.  One entry may be named ``"*"``: it absorbs every node left
    over after all the named partitions, so a demo config that under-counts
    no longer silently strands capacity.  A sequence of ``(name, spec)``
    pairs is also accepted; duplicate names, overlapping or out-of-range
    explicit ids, and over-subscription all raise instead of silently
    mis-partitioning.
    """
    items = list(sizes.items()) if isinstance(sizes, dict) else list(sizes)
    seen: set = set()
    for name, _ in items:
        if name in seen:
            raise ValueError(f"duplicate partition name {name!r}")
        seen.add(name)
    if sum(1 for name, _ in items if name == "*") > 1:
        raise ValueError('at most one "*" remainder partition allowed')

    remaining = list(range(desc.nodes))
    assigned: dict = {}  # name -> node id list
    # explicit id lists first: counts and "*" draw from what is left
    for name, spec in items:
        if name == "*" or isinstance(spec, int):
            continue
        ids = sorted(int(i) for i in spec)
        for i in ids:
            if i < 0 or i >= desc.nodes:
                raise ValueError(
                    f"partition {name!r} names node {i} outside "
                    f"0..{desc.nodes - 1}")
        if len(set(ids)) != len(ids):
            raise ValueError(f"partition {name!r} repeats node ids")
        taken = set(remaining)
        overlap = [i for i in ids if i not in taken]
        if overlap:
            raise ValueError(
                f"partition {name!r} overlaps nodes {overlap} already "
                f"assigned to another partition")
        ids_set = set(ids)
        remaining = [i for i in remaining if i not in ids_set]
        assigned[name] = ids
    for name, spec in items:
        if name == "*" or not isinstance(spec, int):
            continue
        if spec < 0:
            raise ValueError(f"partition {name!r} has negative size {spec}")
        if spec > len(remaining):
            raise ValueError(
                f"partition {name!r} needs {spec} nodes but only "
                f"{len(remaining)} of {desc.nodes} remain")
        assigned[name] = remaining[:spec]
        remaining = remaining[spec:]
    for name, _ in items:
        if name == "*":
            if not remaining:
                raise ValueError(
                    '"*" remainder partition would be empty: every node '
                    "is already assigned")
            assigned[name] = remaining
            remaining = []
    # preserve declaration order in the returned dict
    return {name: Allocation(desc, assigned[name], name=name,
                             strategy=strategy)
            for name, _ in items}
