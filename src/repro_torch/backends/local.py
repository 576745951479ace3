"""Pool backend — the Dragon-runtime analogue.

Multi-worker executor with per-worker deques + work stealing, matching
Dragon's lightweight-worker/distributed-queue execution model (§III-D) at
single-host scale.  Multi-rank EXECUTABLE tasks run their payload once with a
``rank_count``/placement context (the MPI-launch analogue); worker failure is
injectable for the fault-tolerance tests.
"""
from __future__ import annotations

import itertools
import queue
import random
import threading
import time
from collections import deque
from typing import Any, Callable, Optional

from repro_torch.core.task import Task, TaskKind
from .base import Backend, BackendCapabilities


class _Worker(threading.Thread):
    def __init__(self, backend: "PoolBackend", wid: int):
        super().__init__(name=f"rhapsody-worker-{wid}", daemon=True)
        self.backend = backend
        self.wid = wid
        self.queue: deque = deque()
        self.lock = threading.Lock()
        self.alive = True
        self.busy = False
        self.executed = 0

    def push(self, task: Task):
        with self.lock:
            self.queue.append(task)
        self.backend._wake.set()

    def pop(self) -> Optional[Task]:
        with self.lock:
            return self.queue.popleft() if self.queue else None

    def steal(self) -> Optional[Task]:
        with self.lock:
            return self.queue.pop() if self.queue else None

    def run(self):
        b = self.backend
        while self.alive:
            task = self.pop()
            if task is None:
                # work stealing: grab from the busiest sibling
                victim = max(b.workers, key=lambda w: len(w.queue),
                             default=None)
                if victim is not None and victim is not self:
                    task = victim.steal()
            if task is None:
                b._wake.wait(timeout=0.001)
                b._wake.clear()
                continue
            if not self.alive:  # killed while holding a task -> requeue
                b._requeue(task)
                break
            self.busy = True
            self._execute(task)
            self.busy = False
            self.executed += 1

    def _execute(self, task: Task):
        b = self.backend
        try:
            desc = task.desc
            if desc.fn is None:
                result = None
            elif desc.kind == TaskKind.EXECUTABLE and desc.requirements.ranks > 1:
                result = desc.fn(*desc.args, _ranks=desc.requirements.ranks,
                                 _placement=task.placement, **desc.kwargs)
            else:
                result = desc.fn(*desc.args, **desc.kwargs)
            b._on_complete(task, result, None)
        except BaseException as e:  # noqa: BLE001 — report to middleware
            b._on_complete(task, None, e)


class PoolBackend(Backend):
    name = "pool"

    def __init__(self, n_workers: int = 4, seed: int = 0):
        self.n_workers = n_workers
        self.workers: list[_Worker] = []
        self._rr = itertools.count()
        self._wake = threading.Event()
        self._on_complete_cb = None
        self.rng = random.Random(seed)

    # -- Backend API --------------------------------------------------------
    def start(self, on_complete):
        self._on_complete_cb = on_complete
        self.workers = [_Worker(self, i) for i in range(self.n_workers)]
        for w in self.workers:
            w.start()
        return self

    def submit(self, task: Task):
        # least-loaded of two random choices (power of two)
        if len(self.workers) == 1:
            self.workers[0].push(task)
            return
        a, b = self.rng.sample(self.workers, 2)
        (a if len(a.queue) <= len(b.queue) else b).push(task)

    def capabilities(self):
        return BackendCapabilities(
            kinds=(TaskKind.FUNCTION, TaskKind.EXECUTABLE, TaskKind.COUPLED),
            max_concurrency=self.n_workers,
        )

    def shutdown(self, wait=True):
        for w in self.workers:
            w.alive = False
        self._wake.set()
        if wait:
            for w in self.workers:
                w.join(timeout=1.0)

    def stats(self):
        return {
            "workers": len(self.workers),
            "executed": sum(w.executed for w in self.workers),
            "queued": sum(len(w.queue) for w in self.workers),
        }

    # -- internals ------------------------------------------------------------
    def _on_complete(self, task, result, error):
        self._on_complete_cb(task, result, error)

    def _requeue(self, task: Task):
        live = [w for w in self.workers if w.alive]
        if live:
            self.rng.choice(live).push(task)
        else:
            self._on_complete_cb(task, None,
                                 RuntimeError("no live workers"))

    # -- failure injection (tests / fault-tolerance benchmarks) --------------
    def kill_worker(self, wid: int) -> list:
        """Kill a worker; returns the tasks stranded in its queue."""
        w = self.workers[wid]
        w.alive = False
        stranded = []
        with w.lock:
            while w.queue:
                stranded.append(w.queue.popleft())
        self.workers = [x for x in self.workers if x.wid != wid]
        self._wake.set()
        return stranded

    def add_workers(self, n: int):
        start = (max((w.wid for w in self.workers), default=-1)) + 1
        for i in range(start, start + n):
            w = _Worker(self, i)
            self.workers.append(w)
            w.start()
