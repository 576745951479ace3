"""Inference request routing across service replicas (Exp 4, Fig 5d).

Two APIs on every router:

  * ``assign(requests, n_instances, cost)`` — batch: split a known request
    set into per-instance index lists (offline benchmarks, launchers).
  * ``route(env, ctx)`` — incremental: route ONE ``InferenceRequest``
    envelope as it arrives given a ``RouteContext`` (candidate count,
    balance group, live queue depths, stable member identities, sticky
    namespace); this is what the middleware dispatch path uses.  State is
    kept per ``ctx.group`` (one group per replicated service) so a single
    shared router instance balances each replica set independently.
    ``pick(cost, n_instances=..., ...)`` remains as a deprecation shim
    over ``route`` for callers of the old keyword surface.

Routers also own per-tenant token-bucket ADMISSION (``TenantThrottle``):
``configure_tenants`` arms a cost-units/s rate per tenant (with burst)
and ``admit(env, cost)`` gates a request before any placement state is
touched — the first stage of multi-tenant QoS isolation.

``RandomRouter`` assigns uniformly at random; ``RoundRobinRouter`` cycles;
the paper's ``TokenAwareBalancedRouter`` greedily equalizes BOTH request
count and estimated input-token volume per instance (longest-processing-
time-first bin packing in batch mode), which suppresses stragglers under
heterogeneous prompt costs; ``LeastLoadedRouter`` additionally reads live
per-replica queue depths so slow or backed-up replicas shed load.

``PrefixAffinityRouter`` adds KV-cache awareness on top of least-loaded:
requests carrying the same ``affinity_key`` (a hash of a bounded prompt
prefix, see ``request_signature``) stick to the replica that served the
key before — the replica whose KV cache already holds the shared prefix —
spilling to the least-loaded replica only when the sticky one is backed
up past ``spill_factor``.  This is the vLLM-prefix-caching / SGLang-
RadixAttention scheduling insight: affinity beats pure balance once the
serving side can reuse prefill work (see ``repro.serving.engine``).

``RadixAffinityRouter`` replaces the fixed-length hash with true radix
longest-prefix-match over the raw token prefix (``request_prefix``):
sessions whose turns diverge *after* the hashed window still route to
their warmest replica, an overloaded sticky replica sheds to the replica
holding the **second-longest** matching prefix (not blindly to
least-loaded), and per-replica residency summaries gossiped by the
replica set (``update_residency``) ground those decisions in what each
replica's KV cache actually holds.  See ``repro.core.prefix`` for the
unified residency architecture.

Sticky state (the affinity maps / radix indices) lives in a store keyed
separately from per-membership balance state: callers that pass stable
``members`` identities and an ``affinity_group`` (see
``ReplicaSet.route``) keep session assignments across replica-set
membership changes, so an autoscale or crash re-homes only the sessions
whose replica actually left.
"""
from __future__ import annotations

import hashlib
import random
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Optional, Sequence

from .prefix import RadixIndex
from .request import InferenceRequest, RouteContext


def default_cost(request) -> float:
    """Estimated cost of one request: its token count when discernible.
    Dict payloads are costed by their prompt alone — a dict's key count
    says nothing about the work it requests."""
    if isinstance(request, dict):
        prompt = request.get("prompt")
        if prompt is not None and hasattr(prompt, "__len__"):
            return float(len(prompt))
        return 1.0
    if hasattr(request, "__len__"):
        return float(len(request))
    return 1.0


def request_model(request) -> Optional[str]:
    """Model tag of one request: multi-model services route a payload only
    among the replicas of its model group.  Dict payloads are tagged by
    ``payload["model"]``; anything else is untagged (None) and routes to
    the service's default group."""
    if isinstance(request, dict):
        model = request.get("model")
        if model is not None:
            return str(model)
    return None


def request_signature(request, prefix_len: int = 32) -> Optional[int]:
    """Affinity key for one request: a stable hash of its bounded prompt
    prefix.  Requests sharing the first ``prefix_len`` prompt tokens (or
    characters) map to the same key, so a prefix-affinity router can pin
    them to the replica whose KV cache already holds that prefix.  Dict
    payloads are keyed by ``payload["prompt"]``; requests with no
    discernible prompt return ``None`` (no affinity — route by load).
    """
    prompt = request.get("prompt") if isinstance(request, dict) else request
    if prompt is None or prefix_len <= 0:
        return None
    if isinstance(prompt, (str, bytes)):
        prefix = prompt[:prefix_len]
    else:
        try:
            prefix = tuple(prompt[:prefix_len])
        except TypeError:  # not sliceable (int uid, object payload, ...)
            return None
        try:
            # canonicalize integer token ids: the hash must not depend on
            # the element type (python int vs numpy scalar) or on numpy's
            # repr, or value-equal turns of one session would key apart
            prefix = tuple(x.__index__() for x in prefix)
        except (AttributeError, TypeError):
            pass  # non-integer elements: hash their repr as-is
    # blake2b, not hash(): stable across processes/PYTHONHASHSEED so
    # offline traces and live routing agree on session identity
    digest = hashlib.blake2b(repr(prefix).encode(), digest_size=8)
    return int.from_bytes(digest.digest(), "big")


def request_prefix(request, max_len: int = 128) -> Optional[tuple]:
    """Raw bounded prompt prefix of one request, as a canonical tuple —
    the radix router's affinity key.  Unlike ``request_signature`` this is
    lossless up to ``max_len``, so longest-prefix-match can see WHERE two
    sessions diverge instead of collapsing them to equal/unequal hashes.
    Dict payloads are keyed by ``payload["prompt"]``; requests with no
    sliceable prompt return ``None`` (no affinity — route by load)."""
    prompt = request.get("prompt") if isinstance(request, dict) else request
    if prompt is None or max_len <= 0:
        return None
    if isinstance(prompt, (str, bytes)):
        return tuple(prompt[:max_len]) or None
    try:
        prefix = tuple(prompt[:max_len])
    except TypeError:  # not sliceable (int uid, object payload, ...)
        return None
    try:
        # same integer canonicalization as request_signature: value-equal
        # token ids must compare equal whatever their element type
        prefix = tuple(x.__index__() for x in prefix)
    except (AttributeError, TypeError):
        pass  # non-integer elements: match by their own equality
    return prefix or None


class TenantThrottle:
    """Per-tenant token-bucket admission control.

    Each tenant accrues ``rate`` cost units per second (its own override
    from ``rates`` when present, else the default), up to a bucket depth
    of ``rate * burst_s``.  A request of cost ``c`` is admitted iff the
    bucket holds ``min(c, depth)`` tokens — the clamp keeps a single
    request costlier than the whole burst admittable at full bucket
    instead of starving its tenant forever.

    ``rate=None`` means unlimited (tenants without an override are not
    throttled); ``rate <= 0`` means deny everything for that tenant (a
    hard off-switch).  Untenanted requests are never throttled — they
    have no bucket to charge.  Denials are counted per tenant for the
    replica set's ``per_tenant`` stats."""

    def __init__(self, rate: Optional[float] = None,
                 rates: Optional[dict] = None, burst_s: float = 2.0,
                 clock: Callable[[], float] = time.monotonic):
        self.rate = rate
        self.rates = dict(rates or {})
        self.burst_s = max(burst_s, 1e-9)
        self._clock = clock
        self._lock = threading.Lock()
        self._buckets: dict = {}  # tenant -> [tokens, last_refill]
        self.denied: dict = {}  # tenant -> denial count

    def rate_for(self, tenant) -> Optional[float]:
        return self.rates.get(tenant, self.rate)

    def admit(self, tenant, cost: float = 1.0) -> bool:
        if tenant is None:
            return True
        rate = self.rate_for(tenant)
        if rate is None:
            return True
        with self._lock:
            if rate <= 0:
                self.denied[tenant] = self.denied.get(tenant, 0) + 1
                return False
            depth = rate * self.burst_s
            now = self._clock()
            tokens, last = self._buckets.get(tenant, (depth, now))
            tokens = min(depth, tokens + (now - last) * rate)
            need = min(max(cost, 0.0), depth)
            if tokens >= need:
                self._buckets[tenant] = (tokens - need, now)
                return True
            self._buckets[tenant] = (tokens, now)
            self.denied[tenant] = self.denied.get(tenant, 0) + 1
            return False

    def denials(self) -> dict:
        with self._lock:
            return dict(self.denied)


class Router:
    """Base router: per-group incremental state + a generic batch assign.

    Subclasses implement ``_new_state(n)`` and ``_pick(state, cost,
    queue_depths)``; ``pick`` handles locking, group bookkeeping, and
    resizing state when a replica set grows or shrinks (autoscaling).
    Affinity-aware subclasses override ``_pick_affinity`` instead, which
    additionally sees the request's ``affinity_key`` and may report how
    the pick was made through the ``info`` out-dict.
    """

    uses_affinity = False  # True -> callers should compute signature()
    uses_residency = False  # True -> callers should gossip residency
    #                         summaries via update_residency()

    def __init__(self):
        self._lock = threading.Lock()
        self._groups: dict[str, Any] = {}
        # sticky/affinity state, keyed SEPARATELY from balance state: a
        # caller that keys ``group`` by membership (so positional load
        # history resets on churn) can still pass a stable
        # ``affinity_group`` so session assignments survive membership
        # changes (LRU-bounded like _groups)
        self._affinity: "OrderedDict[Any, dict]" = OrderedDict()
        self._throttle: Optional[TenantThrottle] = None

    def signature(self, request) -> Optional[Any]:
        """Affinity key for ``request``; None for affinity-blind routers
        (so callers can pass ``signature(payload)`` unconditionally)."""
        return None

    # -- per-tenant admission -----------------------------------------------
    def configure_tenants(self, rate: Optional[float] = None,
                          rates: Optional[dict] = None,
                          burst_s: float = 2.0,
                          clock: Callable[[], float] = time.monotonic):
        """Arm per-tenant token-bucket admission (``TenantThrottle``).
        ``rate`` is the default cost-units/s per tenant (None = tenants
        without an override are unlimited); ``rates`` overrides per
        tenant; ``burst_s`` sizes the bucket in seconds at the rate."""
        self._throttle = TenantThrottle(rate=rate, rates=rates,
                                        burst_s=burst_s, clock=clock)

    def admit(self, env: InferenceRequest, cost: float = 1.0) -> bool:
        """Token-bucket admission for one envelope; True when no throttle
        is configured or the tenant's bucket covers the cost.  Callers
        check this BEFORE ``route()`` so a denied request never perturbs
        placement state."""
        if self._throttle is None:
            return True
        return self._throttle.admit(env.tenant, cost)

    def admission_denials(self) -> dict:
        """Per-tenant denial counts (empty when no throttle is armed)."""
        return self._throttle.denials() if self._throttle else {}

    # -- incremental API ----------------------------------------------------
    def route(self, env: InferenceRequest, ctx: RouteContext,
              cost: Optional[float] = None) -> int:
        """Route one envelope given its candidate-set context; returns a
        replica index into the candidates.

        ``env.affinity`` (see ``request_signature``/``request_prefix``;
        derived from ``env.payload`` via ``signature()`` when unset) lets
        sticky routers pin requests sharing a prompt prefix to one
        replica; ``ctx.info``, if given, is filled with ``{"affinity":
        "hit"|"miss"|"spill"}`` so the caller can account KV-reuse
        without a second lookup.

        ``ctx.members`` names the current candidates with STABLE
        identities (e.g. replica indices that are never reused); sticky
        routers store assignments against those identities, so a
        membership change re-homes only sessions whose member actually
        left.  Defaults to positions ``0..n-1``.  ``ctx.affinity_group``
        keys the sticky state (defaults to ``ctx.group``); pass something
        stable across membership changes to carry assignments through
        autoscale/crash churn.

        ``cost`` defaults to ``default_cost(env.payload)``.
        """
        n_instances = ctx.n_instances
        if n_instances <= 0:
            raise ValueError("n_instances must be >= 1")
        members = ctx.members
        if members is not None and len(members) != n_instances:
            raise ValueError("members must have n_instances entries")
        if cost is None:
            cost = default_cost(env.payload)
        affinity_key = env.affinity
        if affinity_key is None and self.uses_affinity \
                and env.payload is not None:
            affinity_key = self.signature(env.payload)
        if n_instances == 1 and (affinity_key is None
                                 or not self.uses_affinity):
            return 0  # trivial: skip state bookkeeping entirely
        # keyed picks on an affinity router take the full path even at
        # n=1, so first contact still counts as a miss and hit rates stay
        # comparable across replica counts
        group, info = ctx.group, ctx.info
        with self._lock:
            state = self._groups.pop(group, None)
            if state is None or state["n"] != n_instances:
                state = self._resize(state, n_instances)
                if len(self._groups) >= 512:  # LRU-evict a group:
                    # membership-keyed groups (see ReplicaSet.route) churn
                    # under autoscaling and would otherwise grow unbounded
                    self._groups.pop(next(iter(self._groups)))
            # pop + reinsert keeps insertion order = recency order, so
            # the eviction above drops the least-recently-USED group
            self._groups[group] = state
            astate = None
            if self.uses_affinity:
                astate = self._affinity_state(
                    group if ctx.affinity_group is None
                    else ctx.affinity_group)
            mem = tuple(members) if members is not None \
                else tuple(range(n_instances))
            idx = self._pick_affinity(state, cost, ctx.queue_depths,
                                      affinity_key, info,
                                      astate=astate, members=mem)
        return idx

    def pick(self, cost: float = 1.0, *, n_instances: int,
             group: str = "default",
             queue_depths: Optional[Sequence[float]] = None,
             affinity_key: Optional[Any] = None,
             info: Optional[dict] = None,
             members: Optional[Sequence] = None,
             affinity_group: Optional[Any] = None) -> int:
        """Deprecated keyword-surface shim over ``route(env, ctx)``.

        Kept for callers of the pre-envelope API; new code should build
        an ``InferenceRequest`` (or let ``ReplicaSet.request`` wrap the
        payload) and pass a ``RouteContext``."""
        env = InferenceRequest(payload=None, affinity=affinity_key)
        ctx = RouteContext(n_instances=n_instances, group=group,
                           queue_depths=queue_depths, members=members,
                           affinity_group=affinity_group, info=info)
        return self.route(env, ctx, cost=cost)

    def _affinity_state(self, key) -> dict:
        """Get-or-create the sticky state for one affinity group (caller
        holds the lock)."""
        astate = self._affinity.pop(key, None)
        if astate is None:
            astate = self._new_affinity_state()
            while len(self._affinity) >= 512:
                self._affinity.popitem(last=False)
        self._affinity[key] = astate
        return astate

    def update_residency(self, affinity_group, member, seqs: Sequence):
        """Feed one member's resident prefix sequences (replica-set
        gossip); affinity-blind routers ignore it."""

    def note_residency(self, affinity_group, member, seq: Sequence):
        """Merge ONE resident sequence into ``member``'s gossiped
        residency without replacing the rest — the disagg handoff path's
        proactive re-home (the importer now holds the migrated blocks,
        and waiting for the next full gossip pull would leave a staleness
        window where follow-up turns route to the emptied exporter).
        Affinity-blind routers ignore it."""

    def update_headroom(self, affinity_group, member, free: int,
                        capacity: int):
        """Feed one member's physical KV headroom (free / total blocks,
        replica-set gossip); routers without headroom awareness ignore
        it."""

    def forget_member(self, affinity_group, member):
        """Drop all sticky state pointing at ``member`` (it left the
        replica set for good); affinity-blind routers ignore it."""

    def reset(self, group: str = "default", affinity_group=None):
        """Drop one group's balance state and its sticky state.  Callers
        that route with a distinct ``affinity_group`` (see
        ``ReplicaSet.route``) must pass it too — sticky state lives under
        that key, not under ``group``."""
        with self._lock:
            self._groups.pop(group, None)
            self._affinity.pop(
                group if affinity_group is None else affinity_group, None)

    # -- batch API ----------------------------------------------------------
    def _batch_order(self, requests: Sequence, cost: Callable):
        """Iteration order for batch assign; subclasses may reorder."""
        return range(len(requests))

    def assign(self, requests: Sequence, n_instances: int,
               cost: Optional[Callable] = None) -> list:
        """Return per-instance request index lists."""
        cost = cost or default_cost
        out: list = [[] for _ in range(n_instances)]
        group = object()  # private throwaway group for this batch
        for i in self._batch_order(requests, cost):
            out[self.pick(cost(requests[i]), n_instances=n_instances,
                          group=group)].append(i)
        self.reset(group)
        return out

    # -- subclass hooks -----------------------------------------------------
    def _new_state(self, n: int) -> dict:
        return {"n": n}

    def _new_affinity_state(self) -> dict:
        return {}

    def _resize(self, state: Optional[dict], n: int) -> dict:
        """Default: start fresh when the replica count changes."""
        return self._new_state(n)

    def _overloaded(self, idx: int,
                    queue_depths: Optional[Sequence[float]]) -> bool:
        """Spill signal shared by the sticky routers: a replica whose live
        queue depth exceeds ``spill_factor * (min_depth + 1)`` sheds."""
        factor = getattr(self, "spill_factor", 0.0)
        if queue_depths is None or factor <= 0:
            return False  # no live load signal: stickiness wins
        return queue_depths[idx] > factor * (min(queue_depths) + 1.0)

    def _pick_affinity(self, state: dict, cost: float,
                       queue_depths: Optional[Sequence[float]],
                       affinity_key: Optional[Any],
                       info: Optional[dict], *, astate: Optional[dict],
                       members: tuple) -> int:
        """Affinity-blind default: ignore the key, delegate to ``_pick``."""
        return self._pick(state, cost, queue_depths)

    def _pick(self, state: dict, cost: float,
              queue_depths: Optional[Sequence[float]]) -> int:
        raise NotImplementedError


class RandomRouter(Router):
    def __init__(self, seed: int = 0):
        super().__init__()
        self.rng = random.Random(seed)

    def _pick(self, state, cost, queue_depths):
        return self.rng.randrange(state["n"])


class RoundRobinRouter(Router):
    def _new_state(self, n):
        return {"n": n, "i": 0}

    def _resize(self, state, n):
        fresh = self._new_state(n)
        if state is not None:  # keep cycling through the new size
            fresh["i"] = state["i"] % n
        return fresh

    def _pick(self, state, cost, queue_depths):
        idx = state["i"] % state["n"]
        state["i"] = idx + 1
        return idx


class TokenAwareBalancedRouter(Router):
    """Greedy balance of BOTH cumulative token load and request count: each
    request goes to the instance with minimum (load, count).  Batch mode is
    LPT: sort by estimated token cost descending first."""

    def _new_state(self, n):
        return {"n": n, "loads": [0.0] * n, "counts": [0] * n}

    def _resize(self, state, n):
        fresh = self._new_state(n)
        if state is not None:
            # carry balance history when a FIXED group changes size (the
            # incremental pick() API contract; the middleware path keys
            # groups by replica membership, so it starts fresh instead):
            # new replicas start at the current minimum so they pick up
            # work immediately without a thundering herd
            old_n = state["n"]
            base_l = min(state["loads"]) if old_n else 0.0
            base_c = min(state["counts"]) if old_n else 0
            for k in range(n):
                fresh["loads"][k] = state["loads"][k] if k < old_n else base_l
                fresh["counts"][k] = (state["counts"][k] if k < old_n
                                      else base_c)
        return fresh

    def _pick(self, state, cost, queue_depths):
        loads, counts = state["loads"], state["counts"]
        j = min(range(state["n"]), key=lambda k: (loads[k], counts[k]))
        loads[j] += cost
        counts[j] += 1
        return j

    def _batch_order(self, requests, cost):
        # LPT: place the most expensive requests first
        return sorted(range(len(requests)), key=lambda i: -cost(requests[i]))


class LeastLoadedRouter(TokenAwareBalancedRouter):
    """Queue-depth-aware: prefer the replica with the shallowest live queue
    (outstanding requests), breaking ties by cumulative token load.  Falls
    back to token-aware balancing when no depths are observable (batch
    mode, or endpoints without stats)."""

    def _pick(self, state, cost, queue_depths):
        n = state["n"]
        if queue_depths is not None and len(queue_depths) == n:
            loads, counts = state["loads"], state["counts"]
            j = min(range(n),
                    key=lambda k: (queue_depths[k], loads[k], counts[k]))
            loads[j] += cost
            counts[j] += 1
            return j
        return super()._pick(state, cost, queue_depths)


class PrefixAffinityRouter(LeastLoadedRouter):
    """Sticky-session routing keyed by prompt-prefix hash (KV-cache reuse).

    Per affinity group, a bounded LRU map ``affinity_key -> member`` pins
    a session (all requests sharing a prompt prefix) to one replica, so
    the serving engine behind it can skip prefill for the resident prefix.
    Unkeyed requests and first-seen keys fall through to the least-loaded
    policy; a sticky replica whose live queue depth exceeds
    ``spill_factor * (min_depth + 1)`` sheds the request (and re-homes the
    session) rather than letting affinity defeat load balance.  Sticky
    entries name stable member identities, so membership changes (an
    autoscale shrink, a crash) re-home only the sessions whose member
    actually left the candidate set.
    """

    uses_affinity = True

    def __init__(self, prefix_len: int = 32, spill_factor: float = 2.0,
                 map_capacity: int = 4096):
        super().__init__()
        self.prefix_len = prefix_len
        self.spill_factor = spill_factor
        self.map_capacity = map_capacity

    def signature(self, request) -> Optional[int]:
        return request_signature(request, prefix_len=self.prefix_len)

    def _new_affinity_state(self):
        return {"amap": OrderedDict()}  # affinity_key -> member id (LRU)

    def forget_member(self, affinity_group, member):
        with self._lock:
            astate = self._affinity.get(affinity_group)
            if astate is None:
                return
            amap = astate["amap"]
            for k in [k for k, v in amap.items() if v == member]:
                del amap[k]

    def _pick_affinity(self, state, cost, queue_depths, affinity_key, info,
                       *, astate, members):
        if affinity_key is None:
            return self._pick(state, cost, queue_depths)
        amap = astate["amap"]
        sticky = amap.get(affinity_key)
        pos = members.index(sticky) if sticky in members else None
        if pos is not None:
            if not self._overloaded(pos, queue_depths):
                amap.move_to_end(affinity_key)
                # charge the balance history the fallback policy reads, so
                # sticky traffic still counts as load on its home replica
                state["loads"][pos] += cost
                state["counts"][pos] += 1
                if info is not None:
                    info["affinity"] = "hit"
                return pos
            if info is not None:
                info["affinity"] = "spill"
        elif info is not None:
            info["affinity"] = "miss"
        idx = self._pick(state, cost, queue_depths)
        amap[affinity_key] = members[idx]  # (re-)home the session here
        amap.move_to_end(affinity_key)
        while len(amap) > self.map_capacity:
            amap.popitem(last=False)
        return idx


class RadixAffinityRouter(LeastLoadedRouter):
    """Radix longest-prefix-match routing (the SGLang RadixAttention
    scheduling insight, applied at the router layer).

    Per affinity group, TWO ``RadixIndex`` structures over raw token
    prefixes (``request_prefix``, lossless up to ``max_prefix`` tokens):

      * ``sessions`` — observed prompt prefix -> member that served it
        (assignment memory, replacing the hashed LRU map).  Because the
        match is longest-common-prefix, a session whose turns diverge
        after any fixed hash window still finds its warmest replica, and
        two sessions sharing only a system-prompt stem are distinguished
        by their own turns.
      * ``residency`` — prefixes each member's KV cache actually holds,
        gossiped by the replica set (``update_residency``) from the
        engines' residency summaries.

    A pick routes to the member with the deepest match of at least
    ``min_match`` tokens (ties prefer the shallower queue); when that
    member is overloaded (same ``spill_factor`` rule as
    ``PrefixAffinityRouter``) it sheds to the member holding the
    *second-longest* matching prefix — prefix-aware spill — and only
    falls back to least-loaded when no other member knows the prefix.
    Assignments name stable member identities, so membership churn
    re-homes only sessions homed on a departed member.

    Residency matches are additionally weighed by PHYSICAL headroom
    (``update_headroom``, gossiped from the paged engines' free/total
    block gauges): a member whose free-block fraction is below
    ``headroom_watermark`` ranks after every non-starved match, so a
    deep prefix match on a memory-starved replica — one about to evict
    the very residency being matched — no longer beats a shallow match
    (or an empty replica) with room to grow.
    """

    uses_affinity = True
    uses_residency = True

    def __init__(self, max_prefix: int = 128, min_match: int = 8,
                 spill_factor: float = 2.0, map_capacity: int = 4096,
                 headroom_watermark: float = 0.1):
        super().__init__()
        self.max_prefix = max_prefix
        self.min_match = max(1, min_match)
        self.spill_factor = spill_factor
        self.map_capacity = map_capacity
        self.headroom_watermark = headroom_watermark

    def signature(self, request) -> Optional[tuple]:
        return request_prefix(request, max_len=self.max_prefix)

    def _new_affinity_state(self):
        return {"sessions": RadixIndex(capacity=self.map_capacity),
                "residency": RadixIndex(capacity=self.map_capacity),
                "headroom": {}}  # member -> (free_blocks, total_blocks)

    def update_residency(self, affinity_group, member, seqs):
        """Replace ``member``'s gossiped residency with ``seqs`` (its
        engine's current resident prefix sequences)."""
        with self._lock:
            astate = self._affinity_state(affinity_group)
            res = astate["residency"]
            res.remove_value(member)
            # cap is a runaway guard only: normal payloads are bounded by
            # the engine's slot count (and the index's own LRU capacity)
            for s in list(seqs)[:1024]:
                res.insert(tuple(s)[:self.max_prefix], member)

    def note_residency(self, affinity_group, member, seq):
        """Merge one sequence into ``member``'s residency (handoff
        re-home): unlike ``update_residency`` this does NOT drop the
        member's other gossiped prefixes."""
        seq = tuple(seq)[:self.max_prefix]
        if not seq:
            return
        with self._lock:
            astate = self._affinity_state(affinity_group)
            astate["residency"].insert(seq, member)

    def update_headroom(self, affinity_group, member, free, capacity):
        """Replace ``member``'s gossiped physical headroom (free / total
        KV blocks of its paged engine)."""
        with self._lock:
            astate = self._affinity_state(affinity_group)
            astate.setdefault("headroom", {})[member] = (free, capacity)

    def forget_member(self, affinity_group, member):
        with self._lock:
            astate = self._affinity.get(affinity_group)
            if astate is None:
                return
            astate["sessions"].remove_value(member)
            astate["residency"].remove_value(member)
            astate.get("headroom", {}).pop(member, None)

    def _starved(self, astate, member) -> bool:
        """True when the member's gossiped free-block fraction is below
        the watermark — its next admissions will evict residency, so its
        prefix matches should not win placement.  Members with no
        gossiped headroom (slot-pool engines, pre-first-gossip) are never
        starved."""
        hr = astate.get("headroom", {}).get(member)
        if hr is None:
            return False
        free, capacity = hr
        return capacity > 0 and free < self.headroom_watermark * capacity

    def _pick_affinity(self, state, cost, queue_depths, affinity_key, info,
                       *, astate, members):
        if not isinstance(affinity_key, tuple) or not affinity_key:
            return self._pick(state, cost, queue_depths)
        seq = affinity_key[:self.max_prefix]
        # best common-prefix length per member, across BOTH assignment
        # memory and gossiped residency (one O(len(seq)) descent each)
        depth = astate["sessions"].match_lengths(seq)
        for v, d in astate["residency"].match_lengths(seq).items():
            if d > depth.get(v, 0):
                depth[v] = d
        pos = {m: i for i, m in enumerate(members)}
        ranked = [(self._starved(astate, m), d, pos[m])
                  for m, d in depth.items()
                  if d >= self.min_match and m in pos]
        # deepest match first; equal depths (e.g. several members holding
        # the same shared stem) prefer the shallower live queue; matches
        # on memory-starved members rank after EVERY non-starved match,
        # however shallow — their engine is about to evict the matched
        # residency anyway, so the prefill saving is illusory
        ranked.sort(key=lambda t: (
            t[0], -t[1],
            queue_depths[t[2]] if queue_depths is not None else 0.0))
        eligible = [t for t in ranked if not t[0]]
        starved_max = max((d for s, d, _i in ranked if s), default=-1)
        outcome = "miss"
        idx = None
        for _s, d, i in eligible:
            if not self._overloaded(i, queue_depths):
                idx = i
                if outcome == "miss":
                    # landing on a shallower match than a starved member's
                    # deeper one is a headroom spill, not a plain hit
                    outcome = "hit" if d >= starved_max else "spill"
                break
            outcome = "spill"  # matching member overloaded: try the next-
            #                    longest matching prefix holder
        if idx is None and eligible and queue_depths is not None and \
                self.spill_factor > 0 and \
                queue_depths[eligible[0][2]] <= 2 * self.spill_factor * (
                    min(queue_depths) + 1.0):
            # every prefix holder is past the eager threshold, but going
            # COLD re-pays the whole prefill — stay with the deepest
            # non-starved match until pressure doubles the spill threshold
            # (two-tier spill: warm->warm moves are cheap, warm->cold
            # moves are not)
            idx = eligible[0][2]
            outcome = "hit" if eligible[0][1] >= starved_max else "spill"
        if idx is None:
            if ranked:
                outcome = "spill"  # every match starved or overloaded
            idx = self._pick(state, cost, queue_depths)  # charges balance
        else:
            state["loads"][idx] += cost
            state["counts"][idx] += 1
        if info is not None:
            info["affinity"] = outcome
        # remember where this (possibly grown) prefix landed; compaction
        # inside RadixIndex replaces the session's shorter earlier turns
        astate["sessions"].insert(seq, members[idx])
        return idx


ROUTERS = {
    "random": RandomRouter,
    "round_robin": RoundRobinRouter,
    "balanced": TokenAwareBalancedRouter,
    "least_loaded": LeastLoadedRouter,
    "prefix_affinity": PrefixAffinityRouter,
    "radix_affinity": RadixAffinityRouter,
}


def make_router(kind: str, **kw) -> Router:
    return ROUTERS[kind](**kw)


def router_from_policy(policy) -> Router:
    """Build the policy's router, threading through its affinity knobs."""
    kind = getattr(policy, "routing", None) or "round_robin"
    kw = {}
    if kind == "prefix_affinity":
        kw = {
            "prefix_len": getattr(policy, "affinity_prefix_len", 32),
            "spill_factor": getattr(policy, "affinity_spill_factor", 2.0),
        }
    elif kind == "radix_affinity":
        kw = {
            "max_prefix": getattr(policy, "affinity_max_prefix", 128),
            "min_match": getattr(policy, "affinity_min_match", 8),
            "spill_factor": getattr(policy, "affinity_spill_factor", 2.0),
            "headroom_watermark": getattr(
                policy, "affinity_headroom_watermark", 0.1),
        }
    r = make_router(kind, **kw)
    rate = getattr(policy, "tenant_rate", None)
    rates = getattr(policy, "tenant_rates", None)
    if rate is not None or rates:
        r.configure_tenants(rate=rate, rates=rates,
                            burst_s=getattr(policy, "tenant_burst_s", 2.0))
    return r
