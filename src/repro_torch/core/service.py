"""Services as first-class, replicated workflow entities (§III-B, Fig 5d).

A ``ServiceDescription`` declares a factory for a *servicer* — anything with
``submit(payload) -> uid`` / ``step() -> [(uid, result)]`` (pumped, e.g. a
continuous-batching engine) or just ``handle(payload) -> result`` (sync RPC)
— plus how many replicas to run.  The ``ServiceManager`` owns a *replica
set* per service name: per-replica ``ServiceInstance`` + ``ServiceEndpoint``,
aggregated stats, per-replica restart-on-crash (exponential backoff via
``restart_backoff_s``/``restart_backoff_max_s``, giving up after
``restart_max_attempts`` consecutive crashes so a persistently broken
servicer degrades the set instead of hot-looping), and (optionally)
queue-depth driven autoscaling within policy bounds.  Requests fan out
across replicas through the shared router (see ``repro.core.router``);
with ``routing="prefix_affinity"`` / ``"radix_affinity"`` each request's
prompt-prefix signature pins sessions to their cache-warm replica, and the
outcome is accounted per endpoint as ``prefix_hits``/``prefix_misses`` in
``stats()``.

Cross-layer residency (see ``repro.core.prefix``): routes pass each
replica's STABLE identity (``replica_idx``, never reused) plus a stable
affinity group to the router, so sticky assignments survive membership
churn — after an autoscale or crash only sessions homed on the departed
replica re-home.  The stats tick (and every ``residency_sync_every``-th
route) collects per-replica residency summaries from servicers that
expose ``residency_summary()`` and gossips them to the router, grounding
prefix-aware spill in what each replica's KV cache actually holds.  A
replica that exhausts its restart budget is declared dead, counted in
``stats()["dead_replicas"]``, and after ``dead_replica_grace_s`` folded
out of the set with its stats merged into the aggregate.

Multi-model services (§III, Fig 5: heterogeneous AI workloads in ONE job
allocation): a ``ServiceDescription`` may declare several ``ModelGroup``s
— one replica set then serves several model configs.  Each replica is
tagged with its group, a request's ``model`` tag (payload ``{"model":
...}``) narrows routing to that group's replicas BEFORE any
affinity/least-loaded logic runs (sticky state is keyed per group, so
per-model affinity falls out), ``stats()["per_group"]`` breaks out
requests/hits/latency/claims per model, and ``scale_to(n, group=)`` /
``scale_groups(targets)`` scale one group at a time — ``scale_groups``
applies shrinks first, so the ``weighted_capacity`` autoscaler's
rebalances (retire a replica from an over-provisioned group to admit one
for an SLO-violating group) stay capacity-neutral inside a full
partition.

Resource claims (§III-C: one ledger for tasks AND services): when the
manager is given the middleware's partition ``Allocation``s, every replica
spawn first books ``ServiceDescription.requirements`` as a concrete
``Claim`` (node/core/gpu ids) against the set's partition, held until the
replica retires.  Scale-up is therefore *admission-controlled*: a full
partition denies the claim and the set degrades gracefully — a
``SCALE_DENIED`` event plus the ``stats()["admission_denied"]`` counter,
never an exception — instead of scaling past physical capacity.  The same
claims surface in ``Rhapsody.utilization()``, so services and tasks are
finally visible on one ledger.  With ``ExecutionPolicy.warmup`` a new
replica also completes a warm-up prime (``servicer.warmup()``: compile + a
token of decode) before ``ready`` is set — the router never routes to a
cold replica, so autoscale-up stops adding tail latency.  Autoscaling
itself is pluggable (``repro.core.autoscale``): queue-depth (default) or
p95-latency-SLO policies, both bounded by ``Allocation.free_capacity()``.
"""
from __future__ import annotations

import dataclasses
import itertools
import queue
import threading
import time
from typing import Any, Callable, Optional

from .autoscale import LatencyWindow, autoscaler_from_policy, percentile
from .request import AdmissionDenied, InferenceRequest, RouteContext
from .router import Router, default_cost, router_from_policy
from .task import ResourceRequirements


@dataclasses.dataclass
class ModelGroup:
    """One model config served inside a multi-model replica set.

    A ``ServiceDescription`` may declare several of these (``models=[...]``)
    behind ONE service name: each replica is tagged with the group it hosts,
    requests carry a ``model`` tag (payload ``{"model": ...}`` or
    ``request(..., model=...)``) and are routed only among that group's
    replicas, and capacity is shared — every group's replicas claim from the
    same partition ledger, with ``weight`` naming the group's entitlement to
    it (initial replica split, and who donates first when the
    ``weighted_capacity`` autoscaler rebalances).
    """

    name: str
    factory: Optional[Callable[[], Any]] = None  # None -> desc.factory
    weight: float = 1.0  # share of the set's capacity this group is
    #                      entitled to, relative to its siblings
    replicas: Optional[int] = None  # initial count; None -> weighted share
    #                                 of ServiceDescription.replicas
    slo_p95_ms: Optional[float] = None  # per-group SLO target; None ->
    #                                     ExecutionPolicy.slo_p95_ms
    requirements: Optional[ResourceRequirements] = None  # per-replica
    #                                 claim shape; None -> desc.requirements
    role: str = "serve"  # | "draft" | "prefill" | "decode".
    #   "draft": a speculative-decoding draft group.  Draft groups share
    #   their target group's affinity namespace under residency-aware
    #   routers (both legs of one prompt pin to the same radix key,
    #   keeping both KV stems warm), and the weighted_capacity autoscaler
    #   scales their entitlement by the set's measured acceptance rate —
    #   a low-acceptance workload shrinks the draft toward min_replicas
    #   instead of burning cores.
    #   "prefill"/"decode": disaggregated serving pools for ONE model.
    #   New prompts route to the prefill group (large chunked-prefill
    #   budget, no decode interleave); on first token the sequence
    #   migrates to the paired decode group via a paged-KV handoff
    #   (engine.export_sequence -> engine.import_sequence), orchestrated
    #   by the set (see ``ReplicaSet._handoff``).  The prefill group's
    #   SLO is a TTFT target, the decode group's an ITL target — the
    #   weighted_capacity autoscaler reads the matching per-phase latency
    #   window for each (see ``latency_p95(phase=...)``).
    paired_with: Optional[str] = None  # draft role: target group sharing
    #   the affinity namespace; None -> the first serve-role group.
    #   prefill role: the decode group sequences hand off to; None -> the
    #   first decode-role group
    min_replicas: Optional[int] = None  # per-group autoscale floor; None
    #   -> 1 (every model keeps a replica).  An EXPLICIT 0 allows the
    #   rebalancer to retire the group entirely (spec-decode off)
    max_replicas: Optional[int] = None  # per-group autoscale ceiling;
    #   None -> bounded only by the set total / ledger
    borrow_limit: Optional[int] = None  # burst-borrow cap: how many
    #   replicas BELOW its weight-anchored entitlement this group may be
    #   shrunk when acting as a donor in a weighted_capacity rebalance.
    #   None -> unbounded (donate down to min_replicas); 0 -> never
    #   donate below entitlement


@dataclasses.dataclass
class ServiceDescription:
    name: str
    factory: Optional[Callable[[], Any]] = None  # builds one servicer
    #   (called per replica); optional when every ModelGroup in ``models``
    #   brings its own factory
    requirements: ResourceRequirements = dataclasses.field(
        default_factory=ResourceRequirements)  # claimed PER REPLICA
    ready_timeout: float = 30.0
    partition: Optional[str] = None
    replicas: Optional[int] = None  # None -> ExecutionPolicy.replicas
    warmup: Optional[bool] = None  # None -> ExecutionPolicy.warmup
    models: Optional[list] = None  # [ModelGroup, ...]: serve several model
    #                                configs from ONE replica set (None ->
    #                                a single implicit "default" group)


def weighted_split(total: int, weights: dict) -> dict:
    """Split ``total`` replicas across groups proportionally to weight
    (largest-remainder rounding), guaranteeing every group at least 1 —
    a model with no replica cannot serve at all."""
    names = list(weights)
    w = {g: max(0.0, float(weights[g])) for g in names}
    total_w = sum(w.values())
    if total_w <= 0:
        w = {g: 1.0 for g in names}
        total_w = float(len(names))
    out = {g: 1 for g in names}
    rem = total - len(names)
    if rem <= 0:
        return out
    exact = {g: rem * w[g] / total_w for g in names}
    for g in names:
        out[g] += int(exact[g])
    left = rem - sum(int(exact[g]) for g in names)
    # leftover replicas go to the largest fractional remainders, ties in
    # declaration order (deterministic across runs)
    for g in sorted(names, key=lambda g: -(exact[g] - int(exact[g])))[:left]:
        out[g] += 1
    return out


_STAT_KEYS = ("requests", "completed", "errors", "cost",
              "prefix_hits", "prefix_misses")


def _merge_tenant_stats(snaps, folded, denied) -> dict:
    """Merge per-endpoint tenant counters (``snaps``: list of
    {tenant: {requests, completed, errors}}), folded retired aggregates
    and router-bucket denial counts into one per-tenant view."""
    per_tenant: dict = {t: dict(v) for t, v in folded.items()}
    for snap in snaps:
        for t, ts in snap.items():
            tt = per_tenant.setdefault(
                t, {"requests": 0, "completed": 0, "errors": 0})
            for k in ("requests", "completed", "errors"):
                tt[k] = tt.get(k, 0) + ts.get(k, 0)
    for t, n in denied.items():
        tt = per_tenant.setdefault(
            t, {"requests": 0, "completed": 0, "errors": 0})
        tt["admission_denied"] = tt.get("admission_denied", 0) + n
    return per_tenant


class _Future:
    __slots__ = ("_event", "_result", "_error", "_callbacks")

    def __init__(self):
        self._event = threading.Event()
        self._result = None
        self._error = None
        self._callbacks: list = []

    def add_done_callback(self, cb: Callable):
        """Run ``cb(self)`` when the future resolves (immediately if it
        already has) — the handoff orchestration chains the decode leg's
        future into the one the original caller holds this way.  Callback
        errors are swallowed: a misbehaving observer must not poison the
        resolve path."""
        if self._event.is_set():
            try:
                cb(self)
            except Exception:
                pass
            return
        self._callbacks.append(cb)
        if self._event.is_set():  # resolved while appending: fire now
            self._fire_callbacks()

    def _fire_callbacks(self):
        cbs, self._callbacks = self._callbacks, []
        for cb in cbs:
            try:
                cb(self)
            except Exception:
                pass

    def set_result(self, r):
        self._result = r
        self._event.set()
        self._fire_callbacks()

    def set_error(self, e):
        self._error = e
        self._event.set()
        self._fire_callbacks()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError("service request timed out")
        if self._error is not None:
            raise self._error
        return self._result

    def done(self) -> bool:
        return self._event.is_set()


class ServiceEndpoint:
    """Client-visible handle for ONE replica; requests are async futures."""

    def __init__(self, name: str, replica_idx: int = 0,
                 group: str = "default"):
        self.name = name
        self.replica_idx = replica_idx
        self.group = group  # model group this replica hosts (multi-model
        #                     sets route a request only within its group)
        self.requests: "queue.Queue" = queue.Queue()
        self.ready = threading.Event()
        self.stats = {"requests": 0, "completed": 0, "errors": 0,
                      "cost": 0.0,  # routed token-cost (load imbalance)
                      # sticky-routing outcomes (prefix_affinity): a hit
                      # means this replica was the request's cache-warm home
                      "prefix_hits": 0, "prefix_misses": 0}
        self._stats_lock = threading.Lock()
        self.retired = False  # set when scaled away / replaced
        self.on_retired: Optional[Callable] = None  # drains my queue
        self.claim = None  # resources.Claim held while this replica lives
        #                    (None when the manager has no allocations)
        self.latency = LatencyWindow()  # end-to-end request latencies —
        #                    the SLO autoscaler's per-endpoint signal
        # per-phase windows fed from result dicts that carry the engine's
        # first_token_at stamps: ttft for prefill(/unified) replicas, itl
        # (mean inter-token gap per request) for decode(/unified) ones —
        # the per-role SLO signals of disaggregated serving
        self.ttft = LatencyWindow()
        self.itl = LatencyWindow()
        # multi-tenant QoS accounting: per-tenant request counters and
        # per-priority-class end-to-end latency windows (the isolation
        # signal — "is the high class's p95 flat while low saturates")
        self.tenant_stats: dict = {}  # tenant -> {requests/completed/errors}
        self.class_latency: dict = {}  # qos class -> LatencyWindow

    def bump(self, key: str, by: int = 1, tenant: Optional[str] = None):
        # stats feed depth(), which drives routing and autoscaling — a
        # lost += under concurrent clients would skew a control signal
        with self._stats_lock:
            self.stats[key] += by
            if tenant is not None:
                ts = self.tenant_stats.setdefault(
                    tenant, {"requests": 0, "completed": 0, "errors": 0})
                if key in ts:
                    ts[key] += by

    def observe_latency(self, seconds: float,
                        qos_class: Optional[str] = None):
        self.latency.observe(seconds)
        if qos_class is not None:
            win = self.class_latency.get(qos_class)
            if win is None:
                win = self.class_latency.setdefault(qos_class,
                                                    LatencyWindow())
            win.observe(seconds)

    def request(self, payload, **meta) -> _Future:
        """Legacy keyword surface: wraps the payload into an
        ``InferenceRequest`` (lifting the pre-envelope ``_t0``/``_model``
        meta side-channels onto it) and enqueues.  New code builds the
        envelope itself and calls ``request_env``."""
        t0 = meta.pop("_t0", None)
        model = meta.pop("_model", None)
        env = InferenceRequest.wrap(payload, model=model, meta=meta)
        if t0 is not None:
            env.submitted_at = t0
        return self.request_env(env)

    def request_env(self, env: InferenceRequest) -> _Future:
        """Enqueue one envelope on this replica.  ``env.submitted_at``
        was stamped when the envelope was first built, so replays,
        reroutes and handoffs all observe true end-to-end latency."""
        fut = _Future()
        self.bump("requests", tenant=env.tenant)
        self.requests.put((env, fut))
        # closes the route()/retire race: if this endpoint was retired
        # between the route decision and the put, hand the queue (which
        # now holds this request) to the replica set for rerouting
        if self.retired and self.on_retired is not None:
            self.on_retired(self)
        return fut

    def depth(self) -> int:
        """Outstanding requests (queued + in service) — the live load signal
        the least-loaded router and the autoscaler consume."""
        s = self.stats
        return max(0, s["requests"] - s["completed"] - s["errors"])


class ServiceInstance(threading.Thread):
    """Drives one servicer replica: admits endpoint requests, pumps,
    resolves."""

    def __init__(self, desc: ServiceDescription, endpoint: ServiceEndpoint,
                 on_exit: Optional[Callable] = None, warmup: bool = False,
                 residency_listener: Optional[Callable] = None,
                 factory: Optional[Callable] = None):
        super().__init__(
            name=f"service-{desc.name}[{endpoint.replica_idx}]", daemon=True)
        self.desc = desc
        self.endpoint = endpoint
        self.factory = factory or desc.factory  # a multi-model set passes
        #                                         the replica's GROUP factory
        self.alive = True
        self.last_beat = time.perf_counter()
        self.ready_at: Optional[float] = None  # when this instance came up
        self.servicer = None
        self._pending: dict = {}
        self._on_exit = on_exit
        self._warmup = warmup
        self._residency_listener = residency_listener
        self._drain = False
        self.error: Optional[BaseException] = None
        # disaggregated serving: the replica set installs this on
        # prefill-role replicas.  A servicer result dict carrying a
        # "handoff_export" payload (an exported sequence) is diverted
        # here — the hook re-dispatches the decode leg and chains the
        # futures — instead of resolving the caller's future with a
        # half-finished generation.
        self.on_handoff: Optional[Callable] = None

    def run(self):
        try:
            self.servicer = self.factory()
            if self._residency_listener is not None and \
                    hasattr(self.servicer, "set_residency_listener"):
                # gossip push channel: the engine notifies on KV eviction
                # so the router's residency view refreshes immediately
                self.servicer.set_residency_listener(self._residency_listener)
            if hasattr(self.servicer, "setup"):
                self.servicer.setup()
            if self._warmup and hasattr(self.servicer, "warmup"):
                # prime (compile + a token of decode) BEFORE ready: the
                # router never sees a cold replica, so autoscale-up does
                # not add first-request tail latency.  A warm-up crash is
                # a factory crash: _await_ready bails out early on it.
                self.servicer.warmup()
            self.endpoint.ready.set()
            self.ready_at = time.perf_counter()
            pumped = hasattr(self.servicer, "step")
            while self.alive or (self._drain and self._pending):
                self.last_beat = time.perf_counter()
                moved = self._admit() if self.alive else False
                if pumped:
                    if self._pending:
                        for uid, result in self.servicer.step() or []:
                            self._resolve(uid, result)
                        self._drain_finished()
                    elif not moved:
                        time.sleep(1e-4)
                elif not moved:
                    time.sleep(1e-4)
        except BaseException as e:  # noqa: BLE001
            self.error = e
            self.endpoint.ready.clear()
            # preemption-safe: replay in-flight requests on the relaunched
            # instance (bounded by env.replays), else fail their futures
            for uid, (fut, env) in self._pending.items():
                if env.replays < 2:
                    env.replays += 1
                    self.endpoint.requests.put((env, fut))
                else:
                    fut.set_error(e)
                    self.endpoint.bump("errors", tenant=env.tenant)
            # same post-put re-check as request(): if this endpoint was
            # retired while we crashed, hand the replays to the reroute
            if self.endpoint.retired and self.endpoint.on_retired:
                self.endpoint.on_retired(self.endpoint)
        finally:
            if self.error is None:
                # non-drain stop with work still in flight: fail those
                # futures now instead of letting clients hit their own
                # (much longer) timeouts
                for uid, (fut, env) in self._pending.items():
                    if not fut.done():
                        fut.set_error(RuntimeError(
                            f"service {self.desc.name} stopped"))
                        self.endpoint.bump("errors", tenant=env.tenant)
                self._pending.clear()
            if hasattr(self.servicer, "teardown") and self.servicer is not None:
                try:
                    self.servicer.teardown()
                except Exception:
                    pass
            if self._on_exit:
                self._on_exit(self)

    # -- internals ----------------------------------------------------------
    def _admit(self) -> bool:
        moved = False
        for _ in range(64):
            try:
                env, fut = self.endpoint.requests.get_nowait()
            except queue.Empty:
                break
            moved = True
            kw = env.servicer_kwargs()
            if hasattr(self.servicer, "submit"):
                if getattr(self.servicer, "accepts_envelope", False):
                    # envelope-aware servicers (LLMServicer) get the full
                    # record (tenant/priority/handoff); plain test
                    # servicers keep the bare payload + public meta
                    kw["envelope"] = env
                try:
                    uid = self.servicer.submit(env.payload, **kw)
                except BaseException as e:  # noqa: BLE001
                    # crash mid-submit: requeue THIS request for replay on
                    # the relaunched instance before propagating
                    if env.replays < 2:
                        env.replays += 1
                        self.endpoint.requests.put((env, fut))
                    else:
                        fut.set_error(e)
                        self.endpoint.bump("errors", tenant=env.tenant)
                    raise
                self._pending[uid] = (fut, env)
            else:  # sync RPC servicer (same public-meta kwargs as submit)
                try:
                    fut.set_result(self.servicer.handle(env.payload, **kw))
                    self.endpoint.bump("completed", tenant=env.tenant)
                    self._observe(env)
                except BaseException as e:  # noqa: BLE001
                    fut.set_error(e)
                    self.endpoint.bump("errors", tenant=env.tenant)
        return moved

    def _observe(self, env: InferenceRequest):
        if env.submitted_at is not None:
            self.endpoint.observe_latency(
                time.perf_counter() - env.submitted_at,
                qos_class=env.priority)

    def _resolve(self, uid, result):
        entry = self._pending.pop(uid, None)
        if entry is None:
            return
        fut, env = entry
        if isinstance(result, dict):
            self._observe_phases(result)
            if result.get("handoff_export") is not None \
                    and self.on_handoff is not None:
                # prefill leg done: this replica's work is complete (count
                # it) but the REQUEST is not — divert to the handoff hook,
                # which dispatches the decode leg and resolves the caller's
                # future when that leg finishes
                self.endpoint.bump("completed", tenant=env.tenant)
                self._observe(env)
                try:
                    self.on_handoff(fut, result, env)
                except BaseException as e:  # noqa: BLE001
                    fut.set_error(e)
                    self.endpoint.bump("errors", tenant=env.tenant)
                return
        fut.set_result(result)
        self.endpoint.bump("completed", tenant=env.tenant)
        self._observe(env)

    def _observe_phases(self, result: dict):
        """Feed the endpoint's per-phase latency windows from a result
        dict.  TTFT is observed where it was MEASURED: a decode-side final
        result of a handed-off sequence carries the prefill replica's
        ttft_s for the client, flagged ``handoff`` — the prefill endpoint
        already observed it, so it is skipped here (phase-pure windows)."""
        t = result.get("ttft_s")
        if t is not None and not result.get("handoff"):
            self.endpoint.ttft.observe(t)
        i = result.get("itl_s")
        if i is not None:
            self.endpoint.itl.observe(i)

    def _drain_finished(self):
        if hasattr(self.servicer, "drain"):
            for uid, result in self.servicer.drain() or []:
                self._resolve(uid, result)

    def stop(self, drain: bool = False):
        self._drain = drain
        self.alive = False


def _await_ready(inst: ServiceInstance, timeout: float) -> bool:
    """Wait for a replica to come ready, bailing out as soon as its
    factory crashes instead of burning the whole timeout."""
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if inst.endpoint.ready.wait(0.05):
            return True
        if inst.error is not None and not inst.is_alive():
            return False
    return inst.endpoint.ready.is_set()


_replica_set_seq = itertools.count()  # unique per-set id for router group
#                                       keys (id(self) could be reused by
#                                       the allocator after a stop/relaunch)


class ReplicaSet:
    """All replicas behind one service name — the unit of scaling.

    Exposes the same ``request()`` surface a single endpoint used to, but
    routes each request to a replica through the manager's shared router,
    so existing callers transparently load-balance.
    """

    def __init__(self, desc: ServiceDescription, manager: "ServiceManager"):
        self.desc = desc
        self.manager = manager
        # the partition ledger this set's replicas claim resources from
        # (None when the manager was built without allocations: claims and
        # admission control are skipped, the pre-claim behavior)
        self.allocation = manager.allocation_for(desc)
        self._warmup = (desc.warmup if desc.warmup is not None
                        else bool(getattr(manager.policy, "warmup", False)))
        # model groups served by this ONE set (multi-model services): a
        # plain single-model description gets one implicit "default" group,
        # so every internal path is uniformly per-group
        self.model_groups: dict = {}
        if desc.models:
            for mg in desc.models:
                if mg.name in self.model_groups:
                    raise ValueError(
                        f"service {desc.name}: duplicate model group "
                        f"{mg.name!r}")
                if (mg.factory or desc.factory) is None:
                    raise ValueError(
                        f"service {desc.name}: model group {mg.name!r} "
                        f"has no factory (and no service-level default)")
                self.model_groups[mg.name] = mg
        elif desc.factory is None:
            raise ValueError(f"service {desc.name}: factory is required "
                             f"when no model groups are declared")
        else:
            self.model_groups["default"] = ModelGroup(
                name="default", factory=desc.factory,
                replicas=desc.replicas, requirements=desc.requirements)
        self._default_group = next(iter(self.model_groups))
        self.endpoints: list[ServiceEndpoint] = []
        self.instances: list[ServiceInstance] = []
        # endpoints retired by scale-down, kept live for stats() so
        # aggregates survive shrinks (and late drains still count);
        # bounded: older ones are folded into _retired_agg once their
        # drains have long finished (autoscale oscillation must not leak)
        self._retired: list[ServiceEndpoint] = []
        self._retired_agg = {k: 0 for k in _STAT_KEYS}
        self._retired_agg_groups: dict = {}  # group -> same shape, so the
        #                                      per_group stats survive folds
        self._retired_agg_tenants: dict = {}  # tenant -> {requests,
        #                     completed, errors}: folded endpoints'
        #                     tenant_stats, so per_tenant survives folds
        self._tenant_denied: dict = {}  # tenant -> request admissions the
        #                     router's token bucket refused (pre-placement)
        self._scaling = False  # an async autoscale grow/shrink in flight
        self._scale_lock = threading.Lock()  # serializes scale_to callers
        self._gen = 0  # bumped on every membership change so recurring
        #                memberships never resume stale router history
        self._next_idx = 0  # monotonic replica_idx allocator
        self._uid = next(_replica_set_seq)
        self._crash_history: dict[int, dict] = {}  # replica_idx -> backoff
        self._route_count = 0  # drives the periodic residency gossip pull
        self._sync_inflight = False  # at most one async gossip pull at once
        self._gossip_lock = threading.Lock()  # orders gossip pulls vs
        #                     forget_member so an in-flight pull can't
        #                     re-insert a reaped replica's residency
        self._dead_count = 0  # replicas declared dead (operator-visible)
        self._dead_pending: list = []  # (declared_at, endpoint) to fold
        self._admission_denied = 0  # replica spawns denied by the ledger
        self._denied_episode = False  # one SCALE_DENIED event per episode
        #                               (cleared when capacity frees up)
        self._closed = False
        self._successor: Optional["ReplicaSet"] = None  # set on re-launch
        self._lock = threading.RLock()

    # -- client surface -----------------------------------------------------
    @property
    def name(self) -> str:
        return self.desc.name

    @property
    def n_replicas(self) -> int:
        return len(self.endpoints)

    @property
    def n_live(self) -> int:
        """Replicas actually able to serve (or come back): excludes ones
        retired in place, e.g. after exhausting their restart budget.  The
        autoscaler bounds-checks against THIS count, so a dead replica
        doesn't permanently consume configured capacity."""
        with self._lock:
            return sum(1 for ep in self.endpoints if not ep.retired)

    # -- model groups -------------------------------------------------------
    @property
    def multi_model(self) -> bool:
        return bool(self.desc.models)

    def group_names(self) -> list:
        return list(self.model_groups)

    def group_weight(self, group: str) -> float:
        return max(0.0, float(self.model_groups[group].weight))

    def group_slo_ms(self, group: str) -> float:
        """The group's p95 SLO target: its own, else the policy default."""
        slo = self.model_groups[group].slo_p95_ms
        if slo is None:
            slo = getattr(self.manager.policy, "slo_p95_ms", 250.0)
        return float(slo)

    def group_role(self, group: str) -> str:
        return self.model_groups[group].role

    def group_bounds(self, group: str) -> tuple:
        """Per-group autoscale bounds ``(min, max)``: min defaults to 1
        (every model keeps a replica); an explicit ``min_replicas=0``
        allows scale-to-zero; max is None when unbounded."""
        mg = self.model_groups[group]
        gmin = 1 if mg.min_replicas is None else max(0, mg.min_replicas)
        gmax = mg.max_replicas
        if gmax is not None:
            gmax = max(gmin, gmax)
        return gmin, gmax

    def _affinity_alias(self, group: str) -> str:
        """Affinity-namespace alias: a draft-role group shares its target
        group's namespace (``paired_with``, else the first serve-role
        group), so the draft and target legs of one prompt pin to the
        same radix key and residency view — replica indices are unique
        set-wide, so both groups' members coexist in one index and each
        leg still only picks among its own group's candidates."""
        mg = self.model_groups.get(group)
        if mg is None or mg.role != "draft":
            return group
        if mg.paired_with is not None and mg.paired_with in self.model_groups:
            return mg.paired_with
        for g, other in self.model_groups.items():
            if other.role != "draft":
                return g
        return group

    def _decode_pair(self, group: str) -> Optional[str]:
        """The decode-role group a prefill group hands sequences to:
        ``paired_with`` when declared, else the first decode-role group.
        None when the set has no decode pool (the prefill result is then
        served to completion as-is)."""
        mg = self.model_groups.get(group)
        if mg is None or mg.role != "prefill":
            return None
        if mg.paired_with is not None \
                and mg.paired_with in self.model_groups:
            return mg.paired_with
        for g, other in self.model_groups.items():
            if other.role == "decode":
                return g
        return None

    def _handoff(self, src_group: str, fut: _Future, result: dict,
                 env: InferenceRequest):
        """Disaggregated-serving migration: a prefill replica finished a
        sequence's prompt (and produced its first token) — dispatch the
        exported paged-KV payload to the paired decode group and chain
        that leg's future into the one the original caller holds.

        Runs on the prefill replica's instance thread (from ``_resolve``);
        route()/request() are thread-safe.  The decode leg's envelope
        carries the ORIGINAL ``submitted_at`` (and tenant/priority) so
        the decode endpoint's end-to-end window covers the WHOLE request,
        and the importer's residency is gossiped to the router
        immediately — follow-up turns with the same prefix route warm to
        the new holder instead of the (now empty) prefill replica."""
        payload = result.pop("handoff_export", None)
        dec = self._decode_pair(src_group)
        if payload is None or dec is None:
            # no decode pool configured: the prefill leg's result is final
            fut.set_result(result)
            return
        req_payload = {"prompt": list(payload["prompt"])}
        router = self.manager.router
        env2 = InferenceRequest(
            payload=req_payload, model=dec, tenant=env.tenant,
            priority=env.priority, deadline_s=env.deadline_s,
            handoff=payload,
            submitted_at=(env.submitted_at
                          if env.submitted_at is not None
                          else time.perf_counter()),
            affinity=router.signature(req_payload))
        try:
            # affinity accounting stays off: the prefill route already
            # counted this request's outcome (same rule as reroutes)
            ep = self.route(env2, router, account_affinity=False)
        except KeyError as e:
            fut.set_error(RuntimeError(
                f"service {self.name}: decode group {dec!r} has no live "
                f"replicas for handoff ({e})"))
            return
        f2 = ep.request_env(env2)
        if getattr(router, "uses_residency", False):
            # proactive re-home: the exported blocks now live on the
            # importer — tell the router NOW instead of waiting for the
            # next gossip pull
            max_len = getattr(self.manager.policy,
                              "affinity_max_prefix", 128)
            seq = (list(payload.get("prompt") or [])
                   + list(payload.get("output") or []))[:max_len]
            if seq:
                router.note_residency(
                    (self.name, self._uid, self._affinity_alias(dec)),
                    ep.replica_idx, seq)

        def chain(done: _Future):
            try:
                fut.set_result(done.result(0))
            except BaseException as e:  # noqa: BLE001
                fut.set_error(e)

        f2.add_done_callback(chain)

    def handoff_totals(self) -> dict:
        """Set-wide disaggregation counters summed over live replicas
        whose servicers track them: ``exports`` (prefill side),
        ``imports`` and ``recomputes`` (decode side, recompute = the
        reservation-gated import was denied and the sequence re-entered
        via the normal prompt path)."""
        with self._lock:
            pairs = [(ep, inst) for ep, inst
                     in zip(self.endpoints, self.instances)
                     if not ep.retired]
        out = {"exports": 0, "imports": 0, "recomputes": 0}
        for ep, inst in pairs:
            fn = getattr(getattr(inst, "servicer", None),
                         "handoff_stats", None)
            if fn is None:
                continue
            try:
                hs = fn()
            except Exception:
                continue  # crashed mid-read: next tick retries
            if hs:
                for k in out:
                    out[k] += int(hs.get(k, 0))
        return out

    def spec_totals(self) -> tuple:
        """Set-wide speculative-decoding counters ``(proposed, accepted)``
        summed over live replicas whose servicers run a spec-decode
        session — the acceptance signal the ``weighted_capacity``
        autoscaler scales draft-group entitlements by."""
        with self._lock:
            pairs = [(ep, inst) for ep, inst
                     in zip(self.endpoints, self.instances)
                     if not ep.retired]
        proposed = accepted = 0
        for ep, inst in pairs:
            fn = getattr(getattr(inst, "servicer", None), "spec_stats", None)
            if fn is None:
                continue
            try:
                ss = fn()
            except Exception:
                continue  # crashed mid-read: next tick retries
            if ss:
                proposed += int(ss.get("proposed", 0))
                accepted += int(ss.get("accepted", 0))
        return proposed, accepted

    def _group_requirements(self, group: str) -> ResourceRequirements:
        return self.model_groups[group].requirements or self.desc.requirements

    def _group_factory(self, group: str) -> Callable:
        return self.model_groups[group].factory or self.desc.factory

    def _resolve_group(self, model: Optional[str]) -> str:
        """Model tag -> group name; untagged requests go to the FIRST
        declared group, unknown tags on a multi-model set are a routing
        error.  Single-model sets IGNORE the tag: a payload carrying
        {"model": "llama-7b"} routed fine before groups existed (the key
        passed through to the servicer), and must keep doing so."""
        if model is None or not self.multi_model:
            return self._default_group
        if model not in self.model_groups:
            raise KeyError(
                f"service {self.name} serves no model {model!r} "
                f"(has {sorted(self.model_groups)})")
        return model

    def n_live_group(self, group: str) -> int:
        with self._lock:
            return sum(1 for ep in self.endpoints
                       if ep.group == group and not ep.retired)

    def group_counts(self) -> dict:
        """Live replica count per model group (the rebalancer's view)."""
        with self._lock:
            out = {g: 0 for g in self.model_groups}
            for ep in self.endpoints:
                if not ep.retired:
                    out[ep.group] = out.get(ep.group, 0) + 1
        return out

    def initial_group_counts(self) -> dict:
        """Replicas to launch per group: explicit ``ModelGroup.replicas``
        first, the rest split the remaining ``ServiceDescription.replicas``
        (or the policy default) proportionally to weight, >= 1 each."""
        pol_default = max(1, getattr(self.manager.policy, "replicas", 1) or 1)
        total = max(1, self.desc.replicas or pol_default)
        counts = {g: max(1, mg.replicas)
                  for g, mg in self.model_groups.items()
                  if mg.replicas is not None}
        rest = [g for g in self.model_groups if g not in counts]
        if rest:
            budget = max(len(rest), total - sum(counts.values()))
            counts.update(weighted_split(
                budget, {g: self.model_groups[g].weight for g in rest}))
        return {g: counts[g] for g in self.model_groups}  # declaration order

    def request(self, payload, model: Optional[str] = None,
                tenant: Optional[str] = None,
                priority: Optional[str] = None,
                deadline_s: Optional[float] = None, **meta) -> _Future:
        """Submit one request: wraps bare payloads into an
        ``InferenceRequest`` (the normalization adapter — existing
        callers keep working unchanged), admits it through the router's
        per-tenant token bucket, routes it within its model group, and
        enqueues the envelope on the chosen replica.  A denied admission
        resolves the future with ``AdmissionDenied`` immediately — rate
        limiting is backpressure to the CLIENT, never queued load."""
        router = self.manager.router
        env = InferenceRequest.wrap(payload, model=model, tenant=tenant,
                                    priority=priority,
                                    deadline_s=deadline_s, meta=meta)
        cost = default_cost(env.payload)
        if not router.admit(env, cost):
            self.note_tenant_denied(env.tenant)
            fut = _Future()
            fut.set_error(AdmissionDenied(env.tenant))
            return fut
        ep = self.route(env, router, cost=cost)
        return ep.request_env(env)

    def note_tenant_denied(self, tenant: Optional[str]):
        """Count one router-bucket admission denial against ``tenant``
        (surfaced per tenant in ``stats()['per_tenant']``)."""
        with self._lock:
            self._tenant_denied[tenant] = \
                self._tenant_denied.get(tenant, 0) + 1

    def tenant_usage(self) -> dict:
        """Lightweight per-tenant accounting snapshot — same shape as
        ``stats()['per_tenant']`` but without the full stats tick (no
        gossip pull, no dead-replica reap)."""
        with self._lock:
            snaps = [{t: dict(ts) for t, ts in ep.tenant_stats.items()}
                     for ep in self.endpoints + self._retired]
            folded = {t: dict(v)
                      for t, v in self._retired_agg_tenants.items()}
            denied = dict(self._tenant_denied)
        return _merge_tenant_stats(snaps, folded, denied)

    def route(self, env: InferenceRequest, router: Router,
              cost: Optional[float] = None,
              account_affinity: bool = True) -> ServiceEndpoint:
        """Pick the replica endpoint for one envelope.

        ``env.affinity`` (derived from the payload by the router when
        unset) makes sticky routers pin same-prefix requests to one
        replica; the outcome is accounted on the chosen endpoint as
        ``prefix_hits``/``prefix_misses`` unless ``account_affinity`` is
        False (reroutes: the original route already counted this
        request's outcome, counting the second hop too would break
        hits+misses == keyed requests).

        ``env.model`` (see ``InferenceRequest.wrap``) narrows the
        candidates to ONE model group's replicas before any
        affinity/least-loaded logic runs — multi-model sets never route
        a request to a wrong-model replica.  Untagged requests go to the
        first declared group; unknown tags raise ``KeyError`` (a routing
        error, not a silent misroute).

        Only READY replicas are candidates: a freshly spawned replica is
        in ``endpoints`` before its factory finishes, and routing to it
        would queue work nothing admits yet."""
        gsel = self._resolve_group(env.model)
        if cost is None:
            cost = default_cost(env.payload)
        with self._lock:
            pairs = [(ep, inst) for ep, inst
                     in zip(self.endpoints, self.instances)
                     if ep.group == gsel]
            eps = [ep for ep, _ in pairs
                   if ep.ready.is_set() and not ep.retired]
            self._route_count += 1  # under the lock: lost increments
            route_count = self._route_count  # would starve gossip ticks
            if not eps:
                # none ready yet (launch/relaunch window): queue on a
                # replica that is still coming up. A crashed replica
                # counts only when restarts are enabled (its endpoint
                # survives the relaunch and the queue is served then);
                # otherwise the request would sit on a dead queue forever
                restart = getattr(self.manager.policy,
                                  "restart_failed_services", False)
                eps = [ep for ep, inst in pairs
                       if not ep.retired and (inst.error is None or restart)]
            successor = self._successor
        if not eps:
            if successor is not None:  # name was re-launched; follow it
                return successor.route(env, router, cost=cost,
                                       account_affinity=account_affinity)
            raise KeyError(f"service {self.name} has no live replicas"
                           + (f" for model {gsel!r}" if self.multi_model
                              else ""))
        # periodically gossip replica residency summaries to the router so
        # prefix-aware spill sees fresh caches (stats() also syncs); the
        # pull runs on a background thread — snapshotting every engine's
        # index must not add inline latency to the unlucky Nth request
        if getattr(router, "uses_residency", False):
            every = getattr(self.manager.policy, "residency_sync_every", 32)
            if every and every > 0 and route_count % every == 0:
                self._sync_residency_async()
        # key BALANCE state by generation + candidate MEMBERSHIP, not just
        # the name: positions in eps shift as replicas crash/recover, and
        # reusing positional load history across different subsets (or a
        # recurring subset from before a membership change) would charge
        # one replica's history to another.  Sticky state instead keys on
        # the stable (name, uid) affinity group with stable replica_idx
        # member identities, so session assignments survive membership
        # churn and only sessions homed on a departed replica re-home.
        # Both keys also carry the MODEL GROUP, so each model balances and
        # sticks independently — per-group affinity falls out of the keying
        # (two models sharing a token prefix never share a session home).
        members = tuple(ep.replica_idx for ep in eps)
        group = (self.name, self._uid, self._gen, gsel) + members
        info: dict = {}
        # residency-aware routers get the PAIR namespace: a draft-role
        # group's sticky/residency state keys under its target group, so
        # the draft and target legs of one prompt share a radix key (the
        # radix indices hold many members per prefix, and each leg only
        # picks among its own group's candidates).  Hash-map affinity
        # routers keep per-group namespaces — one key -> one member there,
        # and two legs would evict each other's assignment every request.
        gaff = (self._affinity_alias(gsel)
                if getattr(router, "uses_residency", False) else gsel)
        ctx = RouteContext(n_instances=len(eps), group=group,
                           queue_depths=[ep.depth() for ep in eps],
                           members=members,
                           affinity_group=(self.name, self._uid, gaff),
                           info=info)
        idx = router.route(env, ctx, cost=cost)
        eps[idx].bump("cost", cost)
        if account_affinity:
            affinity = info.get("affinity")
            if affinity == "hit":
                eps[idx].bump("prefix_hits")
            elif affinity is not None:  # miss or spill: prefix not reused
                eps[idx].bump("prefix_misses")
        return eps[idx]

    def ready(self) -> bool:
        with self._lock:
            eps = list(self.endpoints)
        return bool(eps) and all(ep.ready.is_set() for ep in eps)

    def stats(self) -> dict:
        """Aggregate request stats plus the per-replica breakdown.  This is
        the stats tick: it also gossips residency summaries to the router
        and folds any dead replica whose grace period expired."""
        self.reap_dead()
        self._sync_residency()
        with self._lock:
            eps = list(self.endpoints)
            insts = list(self.instances)
            per = [dict(ep.stats) for ep in eps]
            retired_pairs = [(ep.group, dict(ep.stats))
                             for ep in self._retired]
            folded = dict(self._retired_agg)
            folded_groups = {g: dict(v)
                             for g, v in self._retired_agg_groups.items()}
            tenant_snaps = [{t: dict(ts)
                             for t, ts in ep.tenant_stats.items()}
                            for ep in eps + self._retired]
            folded_tenants = {t: dict(v)
                              for t, v in self._retired_agg_tenants.items()}
            tenant_denied = dict(self._tenant_denied)
            dead = self._dead_count
            denied = self._admission_denied
        retired = [p for _, p in retired_pairs]
        # live paged-pool gauges per replica (free/total/reserved/shared
        # blocks, CoW copies, evictions): the physical-memory view the
        # per-group aggregation and headroom-aware routing build on.
        # Slot-pool engines (and replicas still starting up) report None.
        block_tel: dict = {}  # replica_idx -> telemetry dict
        spec_tel: dict = {}  # replica_idx -> spec-decode session counters
        handoff_tel: dict = {}  # replica_idx -> disagg handoff counters
        qos_tel: dict = {}  # replica_idx -> WFQ/preemption counters
        for ep, inst in zip(eps, insts):
            if ep.retired:
                continue
            fn = getattr(getattr(inst, "servicer", None),
                         "block_telemetry", None)
            if fn is not None:
                try:
                    tel = fn()
                except Exception:
                    tel = None  # crashed mid-read: next stats tick retries
                if tel:
                    block_tel[ep.replica_idx] = tel
            sfn = getattr(getattr(inst, "servicer", None),
                          "spec_stats", None)
            if sfn is not None:
                try:
                    ss = sfn()
                except Exception:
                    ss = None
                if ss:
                    spec_tel[ep.replica_idx] = ss
            hfn = getattr(getattr(inst, "servicer", None),
                          "handoff_stats", None)
            if hfn is not None:
                try:
                    hs = hfn()
                except Exception:
                    hs = None
                if hs:
                    handoff_tel[ep.replica_idx] = hs
            qfn = getattr(getattr(inst, "servicer", None),
                          "qos_stats", None)
            if qfn is not None:
                try:
                    qs = qfn()
                except Exception:
                    qs = None
                if qs:
                    qos_tel[ep.replica_idx] = qs
        all_samples: list = []
        ep_samples: dict = {}  # replica_idx -> latency snapshot (reused by
        #                        the per-group aggregation below)
        ep_ttft: dict = {}  # replica_idx -> per-phase snapshots, same reuse
        ep_itl: dict = {}
        for ep, p in zip(eps, per):
            samples = ep.latency.samples()
            ep_samples[ep.replica_idx] = samples
            ep_ttft[ep.replica_idx] = ep.ttft.samples()
            ep_itl[ep.replica_idx] = ep.itl.samples()
            p95 = percentile(samples, 0.95)
            p["group"] = ep.group
            p["latency_p95_ms"] = None if p95 is None else p95 * 1e3
            p["latency_histogram"] = ep.latency.histogram(samples=samples)
            tp = percentile(ep_ttft[ep.replica_idx], 0.95)
            ip = percentile(ep_itl[ep.replica_idx], 0.95)
            p["ttft_p95_ms"] = None if tp is None else tp * 1e3
            p["itl_p95_ms"] = None if ip is None else ip * 1e3
            p["block_telemetry"] = block_tel.get(ep.replica_idx)
            if not ep.retired:
                all_samples.extend(samples)
        agg = {k: folded[k] + sum(p[k] for p in per)
               + sum(p[k] for p in retired)
               for k in _STAT_KEYS}
        agg["replicas"] = len(per)
        agg["dead_replicas"] = dead  # lifetime count of replicas that
        #                              exhausted their restart budget (or
        #                              crashed with restarts disabled)
        agg["admission_denied"] = denied  # replica admissions the ledger
        #                                   refused: every denied spawn,
        #                                   plus one per sustained
        #                                   autoscaler denial episode
        p95 = percentile(all_samples, 0.95)
        agg["latency_p95_ms"] = None if p95 is None else p95 * 1e3
        agg["per_replica"] = per
        # per-tenant accounting: live + retired + folded endpoint counters
        # plus router-bucket denials — the QoS bench's conservation check
        # (requests == completed + errors per tenant) reads THIS
        agg["per_tenant"] = _merge_tenant_stats(tenant_snaps,
                                                folded_tenants,
                                                tenant_denied)
        # WFQ/preemption counters summed over the qos-armed replicas (the
        # QoS bench asserts preemptions == resumes off THIS); None when no
        # replica has a scheduler armed
        if qos_tel:
            agg["qos"] = {k: sum(int(q.get(k, 0))
                                 for q in qos_tel.values())
                          for k in ("preempted", "engine_preemptions",
                                    "engine_preempt_resumes")}
            agg["qos"]["reporting_replicas"] = len(qos_tel)
        else:
            agg["qos"] = None
        # per-model-group view: endpoints, request/hit accounting, latency
        # windows, and live ledger claims — the multi-model operator (and
        # the weighted-capacity rebalancer's bench validation) reads THIS
        per_group: dict = {}
        for g in self.model_groups:
            gl = [(ep, p) for ep, p in zip(eps, per) if ep.group == g]
            gr = [p for gp, p in retired_pairs if gp == g]
            gf = folded_groups.get(g, {k: 0 for k in _STAT_KEYS})
            gs = {k: gf[k] + sum(p[k] for _, p in gl) + sum(p[k] for p in gr)
                  for k in _STAT_KEYS}
            live = [ep for ep, _ in gl if not ep.retired]
            gs["replicas"] = len(live)
            gs["endpoints"] = [ep.replica_idx for ep in live]
            gs["weight"] = self.group_weight(g)
            gs["slo_p95_ms"] = self.group_slo_ms(g)
            gsamples: list = []
            gttft: list = []
            gitl: list = []
            for ep in live:
                gsamples.extend(ep_samples.get(ep.replica_idx, ()))
                gttft.extend(ep_ttft.get(ep.replica_idx, ()))
                gitl.extend(ep_itl.get(ep.replica_idx, ()))
            p95g = percentile(gsamples, 0.95)
            gs["latency_p95_ms"] = None if p95g is None else p95g * 1e3
            # per-phase p95s: the disagg autoscaler's per-role signals
            # (TTFT for prefill groups, ITL for decode groups); unified
            # groups report both from the same replicas
            tp = percentile(gttft, 0.95)
            ip = percentile(gitl, 0.95)
            gs["ttft_p95_ms"] = None if tp is None else tp * 1e3
            gs["itl_p95_ms"] = None if ip is None else ip * 1e3
            # disaggregation counters: exports on the prefill side,
            # imports/recomputes on the decode side
            ghand = [handoff_tel[ep.replica_idx] for ep in live
                     if ep.replica_idx in handoff_tel]
            for k in ("exports", "imports", "recomputes"):
                gs["handoff_" + k] = sum(int(h.get(k, 0)) for h in ghand)
            claims = [ep.claim for ep in live if ep.claim is not None]
            gs["cores"] = sum(c.n_cores for c in claims)
            gs["gpus"] = sum(c.n_gpus for c in claims)
            gtel = [block_tel[ep.replica_idx] for ep in live
                    if ep.replica_idx in block_tel]
            if gtel:
                summed = {k: sum(t.get(k, 0) for t in gtel)
                          for k in ("free_blocks", "total_blocks",
                                    "reserved_blocks", "shared_blocks",
                                    "cow_copies", "evicted_residencies")}
                summed["reporting_replicas"] = len(gtel)
                gs["block_telemetry"] = summed
            else:  # no paged replicas in the group (slot pool / starting)
                gs["block_telemetry"] = None
            # speculative-decoding counters: a group's own sessions'
            # proposed/accepted (the target group hosts the sessions —
            # its servicers embed the draft engine), plus the group role
            gs["role"] = self.group_role(g)
            gspec = [spec_tel[ep.replica_idx] for ep in live
                     if ep.replica_idx in spec_tel]
            gs["proposed"] = sum(int(s.get("proposed", 0)) for s in gspec)
            gs["accepted"] = sum(int(s.get("accepted", 0)) for s in gspec)
            gs["acceptance_rate"] = (gs["accepted"] / gs["proposed"]
                                     if gs["proposed"] else None)
            per_group[g] = gs
        agg["per_group"] = per_group
        # a draft-role group runs no sessions itself (the target group's
        # servicers do); surface the SET-WIDE acceptance on it so the
        # signal that scales its entitlement is observable where the
        # operator looks for it
        tot_p = sum(int(s.get("proposed", 0)) for s in spec_tel.values())
        tot_a = sum(int(s.get("accepted", 0)) for s in spec_tel.values())
        for g, gs in per_group.items():
            if gs["role"] == "draft" and not gs["proposed"]:
                gs["acceptance_rate"] = (tot_a / tot_p) if tot_p else None
        return agg

    def latency_p95(self, window_s: Optional[float] = None,
                    started_after: Optional[float] = None,
                    group: Optional[str] = None,
                    phase: Optional[str] = None,
                    tenant_class: Optional[str] = None) -> Optional[float]:
        """p95 end-to-end latency (seconds) across live replicas, the SLO
        autoscaler's signal; optionally windowed, restricted to requests
        *started* after a given perf_counter instant, and/or to one model
        group's replicas (the per-group rebalancer's signal).

        ``phase`` selects a per-phase window instead of end-to-end:
        ``"ttft"`` (time-to-first-token, a prefill-group's SLO) or
        ``"itl"`` (mean inter-token latency per request, a decode-group's
        SLO).  ``tenant_class`` restricts the end-to-end window to one
        QoS priority class (``policy.qos_protected_class`` isolation
        signal); returns None when no replica has samples for it."""
        if phase not in (None, "ttft", "itl"):
            raise ValueError(f"unknown latency phase {phase!r} "
                             f"(expected None, 'ttft' or 'itl')")
        if tenant_class is not None and phase is not None:
            raise ValueError("tenant_class and phase are exclusive "
                             "(per-class windows are end-to-end only)")
        with self._lock:
            eps = [ep for ep in self.endpoints if not ep.retired
                   and (group is None or ep.group == group)]
        samples: list = []
        for ep in eps:
            if tenant_class is not None:
                win = ep.class_latency.get(tenant_class)
                if win is None:
                    continue
            else:
                win = (ep.latency if phase is None
                       else ep.ttft if phase == "ttft" else ep.itl)
            samples.extend(win.samples(window_s, started_after))
        return percentile(samples, 0.95)

    def group_borrow_limit(self, group: str) -> Optional[int]:
        """The group's burst-borrow cap (``ModelGroup.borrow_limit``):
        how far below its weight-anchored entitlement a donor may be
        shrunk; None -> unbounded."""
        bl = self.model_groups[group].borrow_limit
        return None if bl is None else max(0, int(bl))

    def claimed(self, group: Optional[str] = None) -> dict:
        """Live resources this set's replicas hold on the shared ledger,
        optionally for one model group only."""
        with self._lock:
            claims = [ep.claim for ep in self.endpoints
                      if ep.claim is not None
                      and (group is None or ep.group == group)]
        return {"cores": sum(c.n_cores for c in claims),
                "gpus": sum(c.n_gpus for c in claims),
                "replicas": sum(1 for c in claims if not c.released)}

    def claimed_by_group(self) -> dict:
        """Per-model-group slice of ``claimed()`` — what each model costs
        on the shared ledger right now."""
        return {g: self.claimed(group=g) for g in self.model_groups}

    def capacity_headroom(self, group: Optional[str] = None) -> Optional[int]:
        """How many MORE replicas of this shape (the named group's, else
        the service default) the partition can admit right now; None when
        the set has no allocation (unbounded)."""
        if self.allocation is None:
            return None
        req = (self._group_requirements(group) if group is not None
               else self.desc.requirements)
        return self.allocation.fits(req.ranks, req.cores_per_rank,
                                    req.gpus_per_rank)

    def _note_admission_denied(self, where: str = "spawn",
                               once_per_episode: bool = False):
        """Record a denied replica admission: bump the operator counter
        and emit SCALE_DENIED once per denial episode (re-armed when a
        claim succeeds or capacity is released back).  The autoscaler tick
        passes ``once_per_episode=True`` — it re-evaluates every interval,
        and counting each tick would inflate one sustained denial into
        thousands; spawn-level denials always count."""
        with self._lock:
            first = not self._denied_episode
            if once_per_episode and not first:
                return
            self._admission_denied += 1
            self._denied_episode = True
        if first and self.manager.events:
            self.manager.events.emit(self.name, "SCALE_DENIED", "service",
                                     f"partition_full:{where}")

    def _sync_residency_async(self):
        """Run one residency gossip pull off the routing path; coalesces
        with a pull already in flight."""
        with self._lock:
            if self._sync_inflight or self._closed:
                return
            self._sync_inflight = True

        def work():
            try:
                self._sync_residency()
            finally:
                self._sync_inflight = False

        threading.Thread(target=work, name=f"residency-{self.name}",
                         daemon=True).start()

    def _sync_residency(self):
        """Collect per-replica residency summaries from servicers that
        expose them and feed the router's residency index (no-op for
        routers that don't consume gossip and for summary-less
        servicers)."""
        router = self.manager.router
        if not getattr(router, "uses_residency", False):
            return  # nobody consumes the gossip: skip the collection cost
        # gossip at the router's own match fidelity: truncating below the
        # sessions index's max_prefix would silently cap residency matches
        max_len = getattr(self.manager.policy, "affinity_max_prefix", 128)
        with self._gossip_lock:  # a retire's forget_member (see
            # _fold_retired) waits for this pull, so a member reaped AFTER
            # the snapshot below is forgotten AFTER its last update here
            with self._lock:
                pairs = [(ep, inst) for ep, inst
                         in zip(self.endpoints, self.instances)
                         if not ep.retired and ep.ready.is_set()]
            for ep, inst in pairs:
                fn = getattr(inst.servicer, "residency_summary", None)
                if fn is None:
                    continue
                try:
                    try:
                        seqs = fn(max_len=max_len)
                    except TypeError:  # fixed-fidelity servicer summary
                        seqs = fn()
                except Exception:
                    continue  # crashed mid-snapshot: next tick retries
                # draft-role groups gossip into their PAIR namespace (see
                # route()): the shared radix index is what lets a target
                # leg see which replica holds the draft's warm stem
                gkey = (self.name, self._uid, self._affinity_alias(ep.group))
                router.update_residency(gkey, ep.replica_idx, seqs)
                # piggyback physical headroom on the same gossip tick so
                # residency matches are weighed by free-block pressure
                tel_fn = getattr(inst.servicer, "block_telemetry", None)
                if tel_fn is None:
                    continue
                try:
                    tel = tel_fn()
                except Exception:
                    continue
                if tel:
                    router.update_headroom(
                        gkey, ep.replica_idx,
                        tel["free_blocks"], tel["total_blocks"])

    def mean_depth(self, group: Optional[str] = None) -> float:
        with self._lock:
            # a replica declared dead (restart budget exhausted -> retired
            # in place) serves nothing: averaging in its empty queue would
            # dilute the autoscaler's scale-up signal
            eps = [ep for ep in self.endpoints if not ep.retired
                   and (group is None or ep.group == group)]
        if not eps:
            return 0.0
        return sum(ep.depth() for ep in eps) / len(eps)

    # -- lifecycle (driven by the manager) ----------------------------------
    def _spawn(self, group: Optional[str] = None
               ) -> Optional[ServiceInstance]:
        """Create + start one replica of ``group`` (default: the first
        declared model group); caller waits for readiness.
        Returns None if the set was closed (shutdown raced a grow) OR the
        partition allocation denied the replica's resource claim
        (admission control: the set degrades, with a SCALE_DENIED event
        and the ``admission_denied`` stat, instead of overbooking).
        Replica indices are monotonic so identities stay unambiguous
        even after a middle replica is shrunk away."""
        gname = group if group is not None else self._default_group
        with self._lock:
            if self._closed:
                return None
        claim = None
        if self.allocation is not None:
            owner = (f"service:{self.desc.name}/{gname}" if self.multi_model
                     else f"service:{self.desc.name}")
            claim = self.allocation.claim(
                self._group_requirements(gname), owner=owner)
            if claim is None:
                self._note_admission_denied()
                return None
        with self._lock:
            if self._closed:  # closed while we were claiming
                if claim is not None:
                    claim.release()
                return None
            self._denied_episode = False  # capacity exists again
            ep = ServiceEndpoint(self.desc.name, self._next_idx,
                                 group=gname)
            ep.claim = claim
            self._next_idx += 1
            inst = ServiceInstance(self.desc, ep,
                                   on_exit=self.manager._handle_exit,
                                   warmup=self._warmup,
                                   residency_listener=self._on_engine_evict,
                                   factory=self._group_factory(gname))
            if self.group_role(gname) == "prefill":
                inst.on_handoff = (lambda fut, result, env, _g=gname:
                                   self._handoff(_g, fut, result, env))
            self.endpoints.append(ep)
            self.instances.append(inst)
            self._gen += 1
        inst.start()
        return inst

    def _on_engine_evict(self):
        """Residency gossip PUSH: an engine dropped resident KV — refresh
        the router's view now (async, coalesced) instead of leaving a
        staleness window until the next pull tick."""
        if getattr(self.manager.router, "uses_residency", False):
            self._sync_residency_async()

    def _release_claim(self, ep: ServiceEndpoint):
        """Return a retired replica's resources to the ledger (idempotent:
        retire paths may race)."""
        claim = getattr(ep, "claim", None)
        if claim is not None and claim.release():
            with self._lock:
                self._denied_episode = False  # capacity freed: re-arm the
                #                               SCALE_DENIED episode event

    def _reclaim(self):
        """Best-effort re-book claims for live replicas.  Used when a
        blue/green relaunch released this set's claims to admit a
        successor that then FAILED: the old replicas keep serving, so
        their cores must go back on the ledger.  A claim that no longer
        fits (a task grabbed the cores meanwhile) stays unbooked — the
        replica serves under-accounted rather than being killed."""
        if self.allocation is None:
            return
        with self._lock:
            eps = [ep for ep in self.endpoints if not ep.retired]
        for ep in eps:
            claim = getattr(ep, "claim", None)
            if claim is not None and not claim.released:
                continue
            fresh = self.allocation.claim(
                self._group_requirements(ep.group),
                owner=f"service:{self.desc.name}")
            if fresh is None:
                continue
            # a concurrent retire (autoscale shrink, reap, stop) may have
            # removed this endpoint between the snapshot and here; a claim
            # attached now would never be released again.  Membership is
            # mutated under the lock, so re-check before attaching.
            with self._lock:
                attach = ep in self.endpoints and not ep.retired
                if attach:
                    ep.claim = fresh
            if not attach:
                fresh.release()

    def _relaunch(self, dead: ServiceInstance):
        """Restart ONE crashed replica on its existing endpoint (whose queue
        holds the replayed in-flight requests) without disturbing siblings.
        The replica's resource claim survives the relaunch — same replica,
        same booked cores."""
        with self._lock:
            try:
                idx = self.instances.index(dead)
            except ValueError:  # already replaced or scaled away
                return
            inst = ServiceInstance(self.desc, dead.endpoint,
                                   on_exit=self.manager._handle_exit,
                                   warmup=self._warmup,
                                   residency_listener=self._on_engine_evict,
                                   factory=self._group_factory(
                                       dead.endpoint.group))
            if self.group_role(dead.endpoint.group) == "prefill":
                inst.on_handoff = (
                    lambda fut, result, env, _g=dead.endpoint.group:
                    self._handoff(_g, fut, result, env))
            self.instances[idx] = inst
            self._gen += 1  # recovered replica starts with fresh history
        inst.start()
        router = self.manager.router
        if getattr(router, "uses_residency", False):
            # the relaunched servicer starts with an EMPTY cache: drop the
            # pre-crash gossiped residency so prefix-aware picks stop
            # chasing a cache that no longer exists.  Sticky assignments
            # stay — the session must re-warm somewhere, and its home is
            # as good a place as any.
            with self._gossip_lock:
                router.update_residency(
                    (self.name, self._uid, dead.endpoint.group),
                    dead.endpoint.replica_idx, [])
        _await_ready(inst, self.desc.ready_timeout)

    def _restart_backoff(self, inst: ServiceInstance) -> tuple[float, bool]:
        """Exponential-backoff bookkeeping for one crashed replica.

        Returns ``(delay_s, give_up)``: how long to wait before relaunching
        on the replica's existing endpoint, and whether the replica has
        exhausted its ``restart_max_attempts`` budget and should be declared
        dead instead (the set degrades rather than hot-looping a replica
        whose factory/servicer crashes persistently).  A replica that
        SERVED healthily (came ready, then ran) for 4x the backoff ceiling
        before this crash earns a fresh budget — wall time between crashes
        doesn't count, or a factory that burns seconds initializing before
        dying would reset its own budget every cycle.
        """
        pol = self.manager.policy
        base = max(0.0, getattr(pol, "restart_backoff_s", 0.05))
        cap = max(base, getattr(pol, "restart_backoff_max_s", 2.0))
        max_attempts = getattr(pol, "restart_max_attempts", 6)
        now = time.perf_counter()
        with self._lock:
            hist = self._crash_history.setdefault(
                inst.endpoint.replica_idx, {"attempts": 0})
            if hist["attempts"] and inst.ready_at is not None \
                    and now - inst.ready_at > 4 * cap:
                hist["attempts"] = 0  # recovered: crashes are not consecutive
            hist["attempts"] += 1
            if max_attempts and max_attempts > 0 and \
                    hist["attempts"] > max_attempts:
                return 0.0, True
            return min(cap, base * 2 ** (hist["attempts"] - 1)), False

    def scale_to(self, n: int, ready_timeout: Optional[float] = None,
                 group: Optional[str] = None):
        """Grow or shrink to ``n`` replicas; shrink re-routes queued work.
        Multi-model sets scale ONE group at a time (``group=`` required —
        a bare total is ambiguous across models); single-model sets keep
        the original signature."""
        if group is None:
            if self.multi_model:
                raise ValueError(
                    f"service {self.name} is multi-model: scale_to needs "
                    f"group= (one of {sorted(self.model_groups)})")
            group = self._default_group
        elif group not in self.model_groups:
            raise KeyError(f"service {self.name} has no model group "
                           f"{group!r}")
        with self._scale_lock:  # concurrent callers (user + autoscaler)
            self._scale_group_locked(group, n, ready_timeout)

    def scale_groups(self, targets: dict,
                     ready_timeout: Optional[float] = None):
        """Apply per-group LIVE replica targets in ONE scaling action,
        shrinks first by default: a rebalance inside a full partition
        retires the donor group's replica (releasing its claim) before
        the growing group claims — capacity-neutral moves need no free
        headroom.

        WARM HANDOFF: when the partition has enough free headroom to
        admit every grow WITHOUT the donors' released claims, the order
        flips to grows-first — the growing group's replica spawns, warms
        up and joins routing BEFORE the donor drains (a bounded
        claim-overlap window), so a rebalance stops costing tail latency
        on the growing group.  Inside a full partition the order stays
        shrink-first (the grow could not be admitted anyway).

        Targets count live replicas (what ``group_counts()`` and the
        ``weighted_capacity`` scaler see), so a replica declared dead but
        still visible in the set during its grace window does not make a
        replacement grow silently no-op; the membership-level target is
        the live target plus any such corpses (which the shrink path
        retires FIRST, being the least healthy)."""
        for g in targets:
            if g not in self.model_groups:
                raise KeyError(f"service {self.name} has no model group "
                               f"{g!r}")
        with self._scale_lock:
            raw = {g: 0 for g in targets}
            live = {g: 0 for g in targets}
            with self._lock:
                for ep in self.endpoints:
                    if ep.group in raw:
                        raw[ep.group] += 1
                        if not ep.retired:
                            live[ep.group] += 1
            adj = {g: targets[g] + (raw[g] - live[g]) for g in targets}
            grow_amt = {g: adj[g] - raw[g] for g in targets
                        if adj[g] > raw[g]}
            warm = bool(grow_amt)
            total_grow = sum(grow_amt.values())
            for g in grow_amt:
                # conservative: each growing group's shape must fit the
                # WHOLE grow count in free headroom (shapes are uniform
                # in the common case; mixed shapes only over-require)
                hr = self.capacity_headroom(g)
                if hr is not None and hr < total_grow:
                    warm = False
                    break
            if warm:
                order = sorted(targets, key=lambda g: adj[g] < raw[g])
            else:
                order = sorted(targets, key=lambda g: adj[g] >= raw[g])
            for g in order:
                self._scale_group_locked(g, adj[g], ready_timeout)

    def _scale_group_locked(self, gname: str, n: int,
                            ready_timeout: Optional[float]):
        gmin, gmax = self.group_bounds(gname)
        n = max(gmin, n)  # default floor 1; an explicit min_replicas=0
        #                   lets a draft group scale all the way off
        if gmax is not None:
            n = min(n, gmax)
        timeout = (self.desc.ready_timeout if ready_timeout is None
                   else ready_timeout)

        def group_size():
            with self._lock:
                return sum(1 for ep in self.endpoints if ep.group == gname)

        if group_size() < n and not self._closed:
            # spawn all missing replicas first so factories initialize in
            # parallel (same pattern as launch()), then await readiness
            # against a shared deadline
            spawned = [self._spawn(gname) for _ in range(n - group_size())]
            deadline = time.perf_counter() + timeout
            for inst in spawned:
                if inst is None:  # set closed while growing
                    continue
                remaining = max(0.0, deadline - time.perf_counter())
                if _await_ready(inst, remaining):
                    continue
                # unready replica must not stay in the routing set — yank
                # it back out and reroute anything that slipped onto its
                # queue (an autoscale grow degrades to fewer replicas
                # instead of failing)
                with self._lock:
                    popped = inst in self.instances
                    if popped:
                        idx = self.instances.index(inst)
                        self.instances.pop(idx)
                        self.endpoints.pop(idx)
                if popped:
                    inst.endpoint.on_retired = self._reroute
                    inst.endpoint.retired = True
                    inst.stop()
                    self._reroute(inst.endpoint)
                    self._release_claim(inst.endpoint)
                # not popped: the replica crashed and _relaunch already
                # replaced it on the same endpoint — leave that recovery
                # alone (do NOT retire the endpoint out from under it)
        removed: list[tuple[ServiceInstance, ServiceEndpoint]] = []
        with self._lock:
            while True:
                gidx = [i for i, ep in enumerate(self.endpoints)
                        if ep.group == gname]
                if len(gidx) <= n:
                    break
                # retire the least healthy GROUP replica first (crashed,
                # then unready, then highest index) — shrinking must never
                # take a healthy replica while leaving a dead one behind
                idx = min(gidx,
                          key=lambda i: (self.instances[i].error is None,
                                         self.endpoints[i].ready.is_set(),
                                         -i))
                removed.append((self.instances.pop(idx),
                                self.endpoints.pop(idx)))
            if removed:
                self._gen += 1
        for inst, ep in removed:
            # retire BEFORE stopping: a racing route()->request() that
            # already chose this endpoint will see the flag after its put
            # and trigger the reroute itself
            ep.on_retired = self._reroute
            ep.retired = True
            inst.stop(drain=True)  # finish in-flight work, admit no more
        for inst, ep in removed:
            try:
                inst.join(timeout=timeout)
            except RuntimeError:
                pass  # registered by _relaunch but not yet started
            self._reroute(ep)
            # keep the retired endpoint for stats(): a drain that outlives
            # the join timeout still lands its completions somewhere visible
            self._fold_retired([ep])

    def _reroute(self, ep: ServiceEndpoint):
        """Move requests still queued on a retired endpoint to live ones."""
        while True:
            try:
                env, fut = ep.requests.get_nowait()
            except queue.Empty:
                return
            cost = default_cost(env.payload)
            # the request is leaving this endpoint: un-count it so the
            # retired replica's folded stats don't double-count it with
            # the target's own increment (route() re-adds cost there)
            ep.bump("requests", -1, tenant=env.tenant)
            ep.bump("cost", -cost)
            router = self.manager.router
            try:
                # sticky keys still steer the reroute, but the affinity
                # outcome is NOT re-counted: the original route() already
                # accounted this request.  ``env.model`` keeps the
                # reroute inside the SAME model group.
                target = self.route(env, router, cost=cost,
                                    account_affinity=False)
            except KeyError:
                # keep the request accounted where it died so stats()
                # still balances (requests = completed + errors + depth)
                ep.bump("requests", 1, tenant=env.tenant)
                ep.bump("cost", cost)
                ep.bump("errors", tenant=env.tenant)
                fut.set_error(RuntimeError(
                    f"service {self.name} scaled to zero"))
                continue
            target.bump("requests", tenant=env.tenant)
            target.requests.put((env, fut))
            # same post-put re-check as request(): the target may have
            # been retired between route() and the put
            if target.retired and target.on_retired is not None:
                target.on_retired(target)

    def _retire_all(self, drain: bool, sink: Callable, join_timeout: float):
        """Shared teardown: close the set, retire every endpoint (so a
        racing post-put re-check routes to ``sink``), stop + join the
        instances, then drain each queue into ``sink``."""
        with self._lock:
            self._closed = True  # a racing scale_to grow must not respawn
            instances = list(self.instances)
            endpoints = list(self.endpoints)
            self.instances.clear()
            self.endpoints.clear()
        for ep in endpoints:
            ep.on_retired = sink
            ep.retired = True
        for inst in instances:
            inst.stop(drain=drain)
        for inst in instances:
            try:
                inst.join(timeout=join_timeout)
            except RuntimeError:
                pass  # registered by _relaunch but not yet started
        for ep in endpoints:
            sink(ep)
        # preserve served-request history on the old handle, same as the
        # scale-down path does
        self._fold_retired(endpoints)

    def _fold_retired(self, endpoints):
        """Track retired endpoints for stats(), folding the oldest (whose
        drains have long finished) into a flat aggregate so churn stays
        bounded.  Retired replicas also hand their resource claims back to
        the partition ledger here (idempotent; dead replicas already
        released at declare time)."""
        for ep in endpoints:
            self._release_claim(ep)
        with self._lock:
            self._retired.extend(endpoints)
            for ep in endpoints:  # replica_idx is never reused: drop its
                #                   backoff bookkeeping with the endpoint
                self._crash_history.pop(ep.replica_idx, None)
            while len(self._retired) > 8:
                if self._retired[0].depth() > 0:
                    break  # drain still landing completions; keep it live
                old = self._retired.pop(0)
                gagg = self._retired_agg_groups.setdefault(
                    old.group, {k: 0 for k in _STAT_KEYS})
                for k in self._retired_agg:
                    self._retired_agg[k] += old.stats[k]
                    gagg[k] += old.stats[k]
                for t, ts in old.tenant_stats.items():
                    tagg = self._retired_agg_tenants.setdefault(
                        t, {"requests": 0, "completed": 0, "errors": 0})
                    for k in tagg:
                        tagg[k] += ts.get(k, 0)
        with self._gossip_lock:  # after any in-flight gossip pull, so a
            # pull that snapshotted these endpoints can't resurrect them
            for ep in endpoints:
                # the replica is gone for good: sticky sessions homed on
                # it must re-home, and its gossiped residency is stale.
                # Forget under both the plain and (for draft groups) the
                # pair-aliased namespace — sticky state lives under the
                # plain key on hash-affinity routers and under the alias
                # on residency-aware ones, and forgetting is idempotent
                keys = {ep.group, self._affinity_alias(ep.group)}
                for g in keys:
                    self.manager.router.forget_member(
                        (self.name, self._uid, g), ep.replica_idx)

    def _declare_dead(self, inst: ServiceInstance):
        """Mark one replica permanently dead (restart budget exhausted, or
        restarts disabled): fail its queued futures, count it for
        operators, and schedule the grace-period fold that removes it from
        the set with its stats merged into the aggregate."""
        ep = inst.endpoint
        ep.on_retired = self._fail_queue
        ep.retired = True
        self._fail_queue(ep)
        # a permanently dead replica serves nothing: free its claim NOW so
        # a replacement scale-up can be admitted (n_live already excludes
        # it from the autoscaler's configured-capacity bound)
        self._release_claim(ep)
        grace = getattr(self.manager.policy, "dead_replica_grace_s", 2.0)
        with self._lock:
            if self._closed:
                return
            self._dead_count += 1
            if grace is None or grace < 0:
                return  # operator opted to keep the corpse visible forever
            self._dead_pending.append((time.perf_counter() + grace, ep))
        timer = threading.Timer(max(grace, 0.0) + 1e-3, self.reap_dead)
        timer.daemon = True
        timer.start()

    def reap_dead(self):
        """Fold replicas declared dead whose grace period has expired:
        remove them from the routing membership (bumping the generation)
        and merge their stats into the retired aggregate.  Idempotent;
        also called on every stats tick."""
        now = time.perf_counter()
        # membership change: serialize vs scaling — but never BLOCK a
        # stats tick behind a slow in-flight scale; retry shortly instead
        if not self._scale_lock.acquire(blocking=False):
            with self._lock:
                pending = bool(self._dead_pending) and not self._closed
            if pending:
                timer = threading.Timer(0.1, self.reap_dead)
                timer.daemon = True
                timer.start()
            return
        try:
            folded: list[ServiceEndpoint] = []
            with self._lock:
                if self._closed:
                    self._dead_pending.clear()
                    return
                for item in list(self._dead_pending):
                    due, ep = item
                    if now < due:
                        continue
                    self._dead_pending.remove(item)
                    try:
                        i = self.endpoints.index(ep)
                    except ValueError:
                        continue  # already swept by a scale-down
                    self.endpoints.pop(i)
                    self.instances.pop(i)
                    self._gen += 1
                    folded.append(ep)
        finally:
            self._scale_lock.release()
        for ep in folded:
            self._fold_retired([ep])

    def _stop_all(self, join_timeout: float = 2.0):
        # queued futures fail fast instead of hanging to client timeouts
        self._retire_all(False, self._fail_queue, join_timeout)

    def _fail_queue(self, ep: ServiceEndpoint):
        err = RuntimeError(f"service {self.name} stopped")
        while True:
            try:
                env, fut = ep.requests.get_nowait()
            except queue.Empty:
                return
            fut.set_error(err)
            ep.bump("errors", tenant=env.tenant)

    def _drain_into(self, other: "ReplicaSet", join_timeout: float = 5.0):
        """Retire this whole set, moving queued work to ``other`` — used
        when a service name is re-launched so outstanding futures are
        served by the new replicas instead of hanging."""
        with self._lock:
            self._successor = other  # stale handles keep routing
        self._retire_all(True, other._reroute, join_timeout)


class ServiceManager:
    """Launch / discover / monitor / restart / scale replicated services."""

    def __init__(self, policy=None, event_log=None,
                 router: Optional[Router] = None,
                 allocations: Optional[dict] = None):
        self.policy = policy
        self.events = event_log
        self.replica_sets: dict[str, ReplicaSet] = {}
        self.router = router or router_from_policy(policy)
        # named partition Allocations (the middleware's ledger).  When
        # given, every replica spawn claims its ServiceDescription
        # requirements here — admission-controlled scaling; when absent
        # (standalone manager), claims are skipped entirely.
        self.allocations: dict = allocations or {}
        self.autoscaler = (autoscaler_from_policy(policy)
                           if policy is not None else None)
        self._lock = threading.Lock()
        self._autoscale_thread: Optional[threading.Thread] = None
        self._autoscale_stop = threading.Event()

    def allocation_for(self, desc: ServiceDescription):
        """Partition ledger a service's replicas claim from (same
        resolution order as task dispatch): its pinned partition, the
        policy default, else the first allocation.  None when the manager
        has no allocations."""
        if not self.allocations:
            return None
        part = desc.partition or getattr(self.policy, "default_partition",
                                         None)
        if part and part in self.allocations:
            return self.allocations[part]
        return next(iter(self.allocations.values()))

    def claimed(self) -> dict:
        """Per-partition resources currently claimed by service replicas:
        {partition: {"cores", "gpus", "replicas", "models": {...},
        "services": {name: ...}}} — the services half of the shared ledger
        that ``Rhapsody.utilization()`` reports.  Each service entry (and
        the partition-level ``models`` rollup) breaks the claims out per
        model group, so a multi-model set's ledger cost is visible per
        model, not just per service."""
        out: dict = {}
        for name, rs in list(self.replica_sets.items()):
            if rs.allocation is None:
                continue
            c = rs.claimed()
            c["groups"] = rs.claimed_by_group()
            agg = out.setdefault(rs.allocation.name,
                                 {"cores": 0, "gpus": 0, "replicas": 0,
                                  "models": {}, "services": {}})
            agg["cores"] += c["cores"]
            agg["gpus"] += c["gpus"]
            agg["replicas"] += c["replicas"]
            for g, gc in c["groups"].items():
                m = agg["models"].setdefault(
                    g, {"cores": 0, "gpus": 0, "replicas": 0})
                for k in m:
                    m[k] += gc[k]
            agg["services"][name] = c
        return out

    # -- back-compat views --------------------------------------------------
    @property
    def instances(self) -> dict:
        """name -> primary (replica 0) instance, as before replication."""
        out = {}
        for name, rs in list(self.replica_sets.items()):  # snapshot vs
            insts = list(rs.instances)  # concurrent launch/stop
            if insts:
                out[name] = insts[0]
        return out

    @property
    def endpoints(self) -> dict:
        """name -> replica set (request()-compatible with the old endpoint)."""
        return dict(self.replica_sets)

    # -- lifecycle ----------------------------------------------------------
    def launch(self, desc: ServiceDescription) -> ReplicaSet:
        with self._lock:
            predecessor = self.replica_sets.get(desc.name)
        if predecessor is not None:
            # blue/green relaunch of a live name: the predecessor hands its
            # claims back NOW so the successor can be admitted on the same
            # capacity (otherwise a full partition would deny every spawn
            # and a partial one would silently downsize the service).  The
            # old replicas keep serving claim-less only for the bounded
            # window until _drain_into below retires them.
            for ep in list(predecessor.endpoints):
                predecessor._release_claim(ep)
        rs = ReplicaSet(desc, self)
        deadline = time.perf_counter() + desc.ready_timeout
        try:
            # spawn all replicas first so factories initialize in parallel
            # (each is its own thread); THEN wait — the shared deadline is
            # per set, not per serially-started replica.  A spawn denied by
            # the partition ledger comes back None: the launch degrades to
            # the admitted count (event already emitted) as long as at
            # least one replica fits.  Multi-model sets spawn each group's
            # initial count (explicit or weight-proportional, >= 1 each).
            insts = [rs._spawn(g)
                     for g, c in rs.initial_group_counts().items()
                     for _ in range(c)]
            spawned = [inst for inst in insts if inst is not None]
            if not spawned:
                raise RuntimeError(
                    f"service {desc.name}: no replica admitted — "
                    f"partition "
                    f"{rs.allocation.name if rs.allocation else '?'} "
                    f"cannot fit {desc.requirements}")
            for inst in spawned:
                remaining = deadline - time.perf_counter()
                if not _await_ready(inst, max(0.0, remaining)):
                    err = inst.error
                    raise TimeoutError(
                        f"service {desc.name} replica "
                        f"{inst.endpoint.replica_idx} not ready"
                        + (f" (factory failed: {err!r})" if err else ""))
        except BaseException:
            # the set was never registered, so nothing could have routed
            # to it — tear it down; a live old set keeps serving untouched
            # (and gets the claims it lent the failed successor re-booked,
            # or admission control would silently lapse for its cores)
            rs._stop_all()
            if predecessor is not None:
                predecessor._reclaim()
            raise
        # register only once fully ready: during the spawn window the old
        # set (if any) keeps serving, and dispatch never sees a set whose
        # endpoints nothing admits yet
        with self._lock:
            old = self.replica_sets.get(desc.name)
            self.replica_sets[desc.name] = rs
        if old is not None:
            # re-launch of a live name: finish the old set's in-flight
            # work and hand its queued requests to the new replicas
            old._drain_into(rs)
        if self.events:
            self.events.emit(desc.name, "RUNNING", "service", "service_up")
        self._maybe_start_autoscaler()
        return rs

    def get(self, name: str) -> ReplicaSet:
        rs = self.replica_sets.get(name)
        if rs is None:
            raise KeyError(f"unknown service {name}")
        return rs

    def list(self, verbose: bool = False):
        """name -> 'ready' (all replicas up) | 'degraded' (some up, e.g.
        mid scale-up warm-up or crash-restart) | 'down' (none serving).
        With ``verbose=True`` each value is a dict that also carries the
        replica count and the operator-visible ``dead_replicas`` tally
        (replicas that exhausted their restart budget and were — or are
        about to be — folded out of the set)."""
        out = {}
        for n, rs in list(self.replica_sets.items()):  # snapshot: launch()
            # on another thread may insert while we iterate
            if rs.ready():
                status = "ready"
            elif any(ep.ready.is_set() for ep in list(rs.endpoints)):
                status = "degraded"
            else:
                status = "down"
            if verbose:
                out[n] = {"status": status, "replicas": rs.n_replicas,
                          "live": rs.n_live,
                          "dead_replicas": rs._dead_count}
            else:
                out[n] = status
        return out

    def stats(self, name: str) -> dict:
        return self.get(name).stats()

    def stop(self, name: str):
        with self._lock:
            rs = self.replica_sets.pop(name, None)
        if rs is not None:
            rs._stop_all()
        if self.events:
            self.events.emit(name, "DONE", "service", "service_down")

    def stop_all(self):
        self._autoscale_stop.set()
        with self._lock:
            scaler = self._autoscale_thread
            self._autoscale_thread = None  # a later launch() may start a new one
        if scaler is not None:
            scaler.join(timeout=2.0)
        for name in list(self.replica_sets):
            self.stop(name)

    def _handle_exit(self, inst: ServiceInstance):
        if inst.error is None or not inst.alive:
            return  # clean shutdown (stop/scale-down)
        if self.events:
            self.events.emit(inst.desc.name, "FAILED", "service",
                             "service_crash")
        rs = self.replica_sets.get(inst.desc.name)
        if rs is None:
            return
        if self.policy is not None and getattr(
                self.policy, "restart_failed_services", False):
            delay, give_up = rs._restart_backoff(inst)
            if not give_up:
                if delay > 0:
                    # runs on the dying replica's own thread, so the wait
                    # stalls nobody else; siblings keep serving and the
                    # router skips this (not-ready) endpoint meanwhile
                    time.sleep(delay)
                try:
                    rs._relaunch(inst)
                except Exception:
                    pass
                return
            # budget exhausted: a persistently crashing replica must not
            # hot-loop.  Declare it dead (set degrades; route() skips it)
            # and fail its queued futures instead of abandoning them.
            if self.events:
                self.events.emit(inst.desc.name, "FAILED", "service",
                                 "restart_exhausted")
        # no restart is coming: nothing will ever drain this dead
        # replica's queue (including crash-replayed in-flight requests),
        # so fail those futures now instead of letting clients hang to
        # their own timeouts; after dead_replica_grace_s the corpse is
        # folded out of the set with its stats merged into the aggregate
        rs._declare_dead(inst)

    # -- autoscaling --------------------------------------------------------
    def _maybe_start_autoscaler(self):
        pol = self.policy
        if pol is None or not getattr(pol, "autoscale", False):
            return
        with self._lock:
            if self._autoscale_thread is not None:
                return
            self._autoscale_stop.clear()
            self._autoscale_thread = threading.Thread(
                target=self._autoscale_loop, name="service-autoscaler",
                daemon=True)
            self._autoscale_thread.start()

    def _autoscale_loop(self):
        """Pluggable-policy control loop (``repro.core.autoscale``): each
        tick asks the configured ``Autoscaler`` for every set's desired
        size, bounds scale-up by the partition ledger
        (``Allocation.fits``), and applies the change asynchronously.
        Bounded by [autoscale_min_replicas, autoscale_max_replicas] inside
        the policy, and by physical free capacity here."""
        pol = self.policy
        scaler = self.autoscaler
        while not self._autoscale_stop.wait(pol.autoscale_interval_s):
            try:
                self._autoscale_tick(scaler)
            except Exception as e:
                # one bad tick (e.g. a scale racing shutdown) must not
                # kill autoscaling for the rest of the process — but a
                # persistently failing tick must be visible to operators
                if self.events:
                    self.events.emit("autoscaler", "FAILED", "service",
                                     f"tick_error={e!r}")

    def _autoscale_tick(self, scaler):
        scaler.prune(set(self.replica_sets))
        for name, rs in list(self.replica_sets.items()):
            if rs._scaling:  # previous grow/shrink still in flight
                continue
            group_fn = getattr(scaler, "desired_groups", None)
            if group_fn is not None:
                # per-group policy (weighted_capacity): one dict of group
                # targets per tick, applied as a single rebalance action
                targets = group_fn(name, rs)
                if targets:
                    self._scale_groups_async(name, rs, targets)
                continue
            if rs.multi_model:
                continue  # a set-level target is ambiguous across model
                #           groups; only per-group scalers may steer these
            n = rs.n_replicas
            target = scaler.desired(name, rs)
            if target is None:
                continue
            target = max(1, target)
            if target > n:
                # admission control: never target more replicas than the
                # partition can physically claim.  A fully clamped grow is
                # a DENIAL (event + stat on the set), not an exception.
                headroom = rs.capacity_headroom()
                if headroom is not None:
                    target = min(target, n + headroom)
                if target <= n:
                    rs._note_admission_denied("autoscale",
                                              once_per_episode=True)
                    continue
                self._scale_async(name, rs, n, target, "SCALE_UP")
            elif target < n:
                self._scale_async(name, rs, n, target, "SCALE_DOWN")

    def _scale_async(self, name, rs, n_before, n_target, tag):
        """Run one scaling action off the control loop: a slow replica
        factory must not stall sampling for every other service.  The
        in-flight flag is cleared on EVERY exit path (including a scale_to
        error or a thread that never started), so a denied or failed grow
        can never wedge autoscaling for this set."""
        rs._scaling = True

        def work():
            try:
                rs.scale_to(n_target)
                # emit what actually happened: a grow can degrade if the
                # new replica misses its ready timeout or is denied
                # admission by the partition ledger
                if self.events and rs.n_replicas != n_before:
                    self.events.emit(name, tag, "service",
                                     f"replicas={rs.n_replicas}")
            except Exception as e:
                if self.events:
                    self.events.emit(name, "FAILED", "service",
                                     f"scale_error={e!r}")
            finally:
                # stamp the action COMPLETION (not initiation): a slow grow
                # (factory + warm-up) must not let latency served under the
                # old replica count pass the SLO scaler's post-action
                # filter and trigger an oscillating second correction
                if self.autoscaler is not None:
                    self.autoscaler.note_scaled(name)
                rs._scaling = False

        t = threading.Thread(target=work, name=f"scale-{name}", daemon=True)
        try:
            t.start()
        except BaseException:
            rs._scaling = False
            raise

    def _scale_groups_async(self, name, rs, targets: dict):
        """Apply one per-group rebalance off the control loop (same
        in-flight discipline as ``_scale_async``); emits SCALE_REBALANCE
        with the counts that actually materialized — a grow half can still
        degrade on a denied claim or a missed ready timeout."""
        rs._scaling = True
        before = rs.group_counts()

        def work():
            try:
                rs.scale_groups(targets)
                after = rs.group_counts()
                if self.events and after != before:
                    self.events.emit(
                        name, "SCALE_REBALANCE", "service",
                        "groups=" + ",".join(f"{g}:{c}"
                                             for g, c in after.items()))
            except Exception as e:
                if self.events:
                    self.events.emit(name, "FAILED", "service",
                                     f"rebalance_error={e!r}")
            finally:
                if self.autoscaler is not None:
                    self.autoscaler.note_scaled(name)
                rs._scaling = False

        t = threading.Thread(target=work, name=f"rebalance-{name}",
                             daemon=True)
        try:
            t.start()
        except BaseException:
            rs._scaling = False
            raise
