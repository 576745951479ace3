"""RHAPSODY middleware: the central orchestrator (§III-A/B/C).

Interprets task/resource descriptions under an ExecutionPolicy, resolves
dependencies, maps tasks to resources (with intentional logical
oversubscription + backfilling), dispatches to backends, manages service
lifecycles, and tracks every state transition in the event log.

Single dispatcher thread; completions arrive on backend worker threads and
are folded back through ``_complete``.  The hot path (no-op FUNCTION task)
costs a few tens of microseconds — the Exp-1 scaling benchmark measures it.
"""
from __future__ import annotations

import statistics
import threading
import time
from collections import deque
from typing import Any, Iterable, Optional, Sequence, Union

from .events import EventLog
from .policy import ExecutionPolicy
from .resources import Allocation, ResourceDescription, partition
from .request import AdmissionDenied, InferenceRequest
from .router import default_cost, router_from_policy
from .service import ServiceDescription, ServiceManager
from .task import Task, TaskDescription, TaskKind, TaskState


class Rhapsody:
    """The middleware facade (public API layer of Fig. 1)."""

    def __init__(self,
                 resources: Union[ResourceDescription, dict, None] = None,
                 policy: Optional[ExecutionPolicy] = None,
                 backends: Optional[dict] = None,
                 partitions: Optional[dict] = None,
                 n_workers: int = 4):
        from repro_torch.backends.local import PoolBackend  # avoid import cycle

        self.policy = policy or ExecutionPolicy()
        self.events = EventLog()
        resources = resources or ResourceDescription(nodes=1, cores_per_node=8)
        strategy = getattr(self.policy, "placement", "first_fit")
        if partitions:
            self.allocations = partition(resources, partitions,
                                         strategy=strategy)
        else:
            self.allocations = {"default": Allocation(resources,
                                                      strategy=strategy)}
        self.backends: dict = backends or {
            "pool": PoolBackend(n_workers=n_workers)
        }
        for b in self.backends.values():
            b.start(self._backend_complete)
            if hasattr(b, "on_start"):
                b.on_start = self._backend_start
        self.router = router_from_policy(self.policy)
        # services share the task allocations: every replica claims its
        # ServiceDescription.requirements from its partition's ledger
        self.services = ServiceManager(self.policy, self.events,
                                       router=self.router,
                                       allocations=self.allocations)

        self.tasks: dict[str, Task] = {}
        self.ready: deque[Task] = deque()
        self._lock = threading.RLock()
        self._done_cond = threading.Condition(self._lock)
        self._wake = threading.Event()
        self._alive = True
        self._durations: dict[str, list] = {}
        self._inflight = 0
        self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                            name="rhapsody-dispatcher",
                                            daemon=True)
        self._dispatcher.start()

    # ------------------------------------------------------------------
    # Public API: tasks
    # ------------------------------------------------------------------
    def submit(self, descs: Union[TaskDescription, Sequence[TaskDescription]]
               ) -> list:
        """Submit task descriptions; returns their uids."""
        if isinstance(descs, TaskDescription):
            descs = [descs]
        uids = []
        with self._lock:
            new_ready = 0
            for desc in descs:
                task = Task(desc, submitted_at=time.perf_counter())
                self.tasks[desc.uid] = task
                uids.append(desc.uid)
                unresolved = 0
                for dep in desc.dependencies:
                    dep_task = self.tasks.get(dep)
                    if dep_task is None:
                        raise KeyError(f"unknown dependency {dep}")
                    if not dep_task.state.terminal:
                        dep_task.dependents.append(task)
                        unresolved += 1
                task.unresolved = unresolved
                if unresolved:
                    task.state = TaskState.WAITING
                else:
                    task.state = TaskState.READY
                    self.ready.append(task)
                    new_ready += 1
                self._inflight += 1
            if new_ready:
                self._wake.set()
        return uids

    def wait(self, uids: Optional[Iterable[str]] = None,
             timeout: Optional[float] = None) -> bool:
        """Block until the given tasks (or all) are terminal."""
        deadline = None if timeout is None else time.perf_counter() + timeout
        with self._done_cond:
            while True:
                if uids is None:
                    pending = self._inflight
                else:
                    pending = sum(
                        0 if self.tasks[u].state.terminal else 1
                        for u in uids)
                if pending == 0:
                    return True
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        return False
                self._done_cond.wait(timeout=remaining if remaining else 0.25)

    def result(self, uid: str):
        task = self.tasks[uid]
        if task.state == TaskState.FAILED:
            raise task.error
        if not task.state.terminal:
            raise TimeoutError(
                f"task {uid} not finished (state={task.state.value}); "
                f"wait() for it before reading its result")
        return task.result

    def state(self, uid: str) -> TaskState:
        return self.tasks[uid].state

    # ------------------------------------------------------------------
    # Public API: services
    # ------------------------------------------------------------------
    def add_service(self, desc: ServiceDescription):
        return self.services.launch(desc)

    def get_service(self, name: str):
        return self.services.get(name)

    # ------------------------------------------------------------------
    # Public API: lifecycle / introspection
    # ------------------------------------------------------------------
    def utilization(self) -> dict:
        """Per-partition utilization of the SHARED ledger: the core/gpu
        fractions cover tasks and service replicas alike (§III-C), the
        ``service_*`` keys break out what live replica claims hold, and
        ``service_models`` slices those claims per model group — so a
        multi-model set's per-model footprint is first-class on the one
        ledger, next to the tasks it coexists with.  ``tenants`` rolls
        up per-tenant request accounting (requests/completed/errors and
        router-bucket ``admission_denied``) across every service whose
        replicas claim from that partition."""
        claimed = self.services.claimed()
        tenants: dict = {name: {} for name in self.allocations}
        for rs in list(self.services.replica_sets.values()):
            pname = next((n for n, a in self.allocations.items()
                          if a is rs.allocation), None)
            if pname is None:
                continue
            for t, ts in rs.tenant_usage().items():
                tt = tenants[pname].setdefault(t, {})
                for k, v in ts.items():
                    tt[k] = tt.get(k, 0) + v
        out = {}
        for name, alloc in self.allocations.items():
            u = alloc.utilization()
            svc = claimed.get(name, {})
            u["service_cores"] = svc.get("cores", 0)
            u["service_gpus"] = svc.get("gpus", 0)
            u["service_replicas"] = svc.get("replicas", 0)
            u["service_models"] = svc.get("models", {})
            u["tenants"] = tenants.get(name, {})
            u["free"] = alloc.free_capacity()
            out[name] = u
        return out

    def close(self):
        self._alive = False
        self._wake.set()
        self.services.stop_all()
        for b in self.backends.values():
            b.shutdown(wait=False)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------
    # Dispatch
    # ------------------------------------------------------------------
    def _allocation_for(self, task: Task) -> Allocation:
        part = task.desc.partition or self.policy.default_partition
        if part and part in self.allocations:
            return self.allocations[part]
        return next(iter(self.allocations.values()))

    def _backend_for(self, task: Task):
        part = task.desc.partition
        if part and part in self.backends:
            return self.backends[part]
        return next(iter(self.backends.values()))

    def _dispatch_loop(self):
        while self._alive:
            dispatched = self._dispatch_some()
            if not dispatched:
                self._wake.wait(timeout=0.002)
                self._wake.clear()
                if self.policy.straggler_factor > 0:
                    self._check_stragglers()

    def _dispatch_some(self) -> int:
        n = 0
        with self._lock:
            if not self.ready:
                return 0
            window = (len(self.ready) if not self.policy.backfill
                      else min(len(self.ready), self.policy.backfill_window))
            blocked: list = []
            while self.ready and window > 0:
                task = self.ready.popleft()
                window -= 1
                if task.desc.kind == TaskKind.INFERENCE:
                    # zero-footprint: the request's compute is charged to
                    # the SERVICE replica's claim on the same ledger —
                    # booking a core here would throttle the very
                    # partition the task is merely waiting on (a full
                    # partition of replicas used to starve its own
                    # clients)
                    task.state = TaskState.SCHEDULED
                    self._start_task(task)
                    n += 1
                    continue
                req = task.desc.requirements
                alloc = self._allocation_for(task)
                placement = alloc.try_map(req.ranks, req.cores_per_rank,
                                          req.gpus_per_rank)
                if placement is None:
                    blocked.append(task)
                    if not self.policy.backfill:
                        break
                    continue
                task.placement = placement
                task.state = TaskState.SCHEDULED
                self._start_task(task)
                n += 1
            for t in reversed(blocked):
                self.ready.appendleft(t)
        return n

    def _start_task(self, task: Task):
        desc = task.desc
        if desc.kind == TaskKind.INFERENCE:
            self._dispatch_inference(task)
            return
        backend = self._backend_for(task)
        task.state = TaskState.RUNNING
        task.started_at = time.perf_counter()
        self.events.emit(task.uid, "RUNNING", desc.task_type)
        backend.submit(task)

    def _dispatch_inference(self, task: Task):
        desc = task.desc
        # the task's payload + metadata become one InferenceRequest
        # envelope: ``wrap`` lifts the {"model": ...} tag and any
        # tenant/priority/deadline_s metadata onto first-class fields,
        # so QoS identity rides the task into the serving layer.
        env = InferenceRequest.wrap(desc.payload, meta=dict(desc.metadata))
        cost = default_cost(env.payload)
        try:
            replica_set = self.services.get(desc.service)
            if not self.router.admit(env, cost=cost):
                # rate limiting is backpressure to the CLIENT: the task
                # fails immediately instead of queueing over-quota load
                replica_set.note_tenant_denied(env.tenant)
                raise AdmissionDenied(env.tenant)
            # the load-balancing spine: every INFERENCE task picks its
            # replica through the policy router (token-cost + queue-depth
            # aware), not a fixed endpoint; under prefix_affinity routing
            # the payload's prompt-prefix signature makes same-session
            # requests stick to their cache-warm replica.  An envelope
            # with ``model`` set routes only among that model group's
            # replicas (multi-model services); an unknown tag fails the
            # task like an unknown service would.
            endpoint = replica_set.route(env, self.router, cost=cost)
        except (KeyError, AdmissionDenied) as e:
            self._complete(task, None, e)
            return
        task.state = TaskState.RUNNING
        task.started_at = time.perf_counter()
        self.events.emit(task.uid, "RUNNING", desc.task_type,
                         f"replica={endpoint.replica_idx}")
        fut = endpoint.request_env(env)
        timeout = self.policy.inference_timeout_s

        def waiter():
            try:
                self._complete(task, fut.result(timeout=timeout), None)
            except BaseException as e:  # noqa: BLE001
                self._complete(task, None, e)

        threading.Thread(target=waiter, daemon=True).start()

    # ------------------------------------------------------------------
    # Completion path
    # ------------------------------------------------------------------
    def _backend_start(self, task: Task):
        pass  # RUNNING already emitted at submit (cheap path)

    def _backend_complete(self, task: Task, result, error):
        self._complete(task, result, error)

    def _complete(self, task: Task, result, error):
        with self._lock:
            if task.state.terminal:  # duplicate (straggler twin) finished
                return
            task.finished_at = time.perf_counter()
            limit = task.desc.max_retries or self.policy.max_retries
            if error is not None and task.retries < limit:
                task.retries += 1
                self.events.emit(task.uid, "RETRY", task.desc.task_type)
                if task.placement is not None:
                    self._allocation_for(task).release(task.placement)
                    task.placement = None
                task.state = TaskState.READY
                self.ready.append(task)
                self._wake.set()
                return
            self._finalize(task, result, error)
            # first-completion-wins: a straggler twin resolves its original
            orig_uid = task.desc.metadata.get("_resolve")
            if orig_uid:
                orig = self.tasks.get(orig_uid)
                if orig is not None and not orig.state.terminal:
                    orig.finished_at = time.perf_counter()
                    self._finalize(orig, result, error)
            self._done_cond.notify_all()

    def _finalize(self, task: Task, result, error):
        """Terminal-state bookkeeping; caller holds the lock."""
        task.result = result
        task.error = error
        task.state = (TaskState.FAILED if error is not None
                      else TaskState.DONE)
        self.events.emit(task.uid, task.state.value, task.desc.task_type)
        if task.placement is not None:
            self._allocation_for(task).release(task.placement)
            task.placement = None
        self._durations.setdefault(task.desc.task_type, []).append(
            task.duration)
        self._inflight -= 1
        woke = False
        for dep in task.dependents:
            dep.unresolved -= 1
            if dep.unresolved == 0 and dep.state == TaskState.WAITING:
                dep.state = TaskState.READY
                self.ready.append(dep)
                woke = True
        if woke or self.ready:
            self._wake.set()

    # ------------------------------------------------------------------
    # Straggler mitigation (policy.straggler_factor > 0)
    # ------------------------------------------------------------------
    def _check_stragglers(self):
        now = time.perf_counter()
        with self._lock:
            # snapshot: issuing a twin inserts into self.tasks mid-scan
            for task in list(self.tasks.values()):
                if task.state != TaskState.RUNNING:
                    continue
                if task.desc.metadata.get("_straggler_twin"):
                    continue
                hist = self._durations.get(task.desc.task_type, [])
                if len(hist) < self.policy.straggler_min_samples:
                    continue
                med = statistics.median(hist)
                if now - task.started_at < self.policy.straggler_factor * med:
                    continue
                if task.desc.metadata.get("_dup_issued"):
                    continue
                task.desc.metadata["_dup_issued"] = True
                # full copy of the description (minus dependencies, which
                # the running original already resolved): dropping fields
                # like partition/service/payload would let a twin run on
                # the wrong partition or lose its inference target
                clone = TaskDescription(
                    kind=task.desc.kind, fn=task.desc.fn,
                    args=task.desc.args, kwargs=task.desc.kwargs,
                    requirements=task.desc.requirements,
                    task_type=task.desc.task_type,
                    service=task.desc.service,
                    payload=task.desc.payload,
                    partition=task.desc.partition,
                    max_retries=task.desc.max_retries,
                    metadata={**task.desc.metadata,
                              "_straggler_twin": True,
                              "_original": task.uid},
                )
                clone.metadata["_resolve"] = task.uid
                twin = Task(clone, submitted_at=now)
                twin.state = TaskState.READY
                self.tasks[clone.uid] = twin
                self._inflight += 1
                self.events.emit(clone.uid, "DUPLICATED",
                                 task.desc.task_type)
                self.ready.append(twin)
                self._wake.set()
