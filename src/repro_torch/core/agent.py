"""Agentic AI-HPC control loop (Exp 6, Fig 7).

An ``Agent`` repeatedly (1) issues an inference request to a middleware
service (the decision), (2) realizes the decision as HPC task submissions,
(3) observes results and decides again — with feedback: high realization
backlog moderates the decision rate (the emergent behavior the paper
observes).  Decision events are tagged in the event log so the benchmark can
compute decision rate vs ARR and their lag.

Agents carry a QoS identity: ``AgentConfig.tenant`` / ``priority`` ride
every decision request as first-class ``InferenceRequest`` fields, so a
population mixing priority classes exercises the multi-tenant admission,
weighted-fair queueing, and preemption path end to end.  Per-decision
latencies are recorded (``Agent.latencies``) for the QoS bench's p95s.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Optional

from .middleware import Rhapsody
from .task import TaskDescription, TaskKind, ResourceRequirements


@dataclasses.dataclass
class AgentConfig:
    name: str = "agent"
    service: str = "llm"
    n_decisions: int = 10
    tasks_per_decision: int = 2
    decision_payload: Callable[[int], Any] = lambda i: [1, 2, 3]
    make_task: Optional[Callable[[int, int], TaskDescription]] = None
    backlog_limit: int = 16  # feedback: pause deciding when backlog high
    think_time: float = 0.0
    tenant: Optional[str] = None  # QoS identity on every decision request
    priority: Optional[str] = None  # priority class (None -> "normal")
    pipeline_depth: int = 1  # decisions kept in flight concurrently (>1:
    #                          agent issues its next request before the
    #                          previous resolves — concurrent tool calls)


class Agent(threading.Thread):
    """One autonomous agent driving decisions -> HPC realizations."""

    def __init__(self, rhapsody: Rhapsody, cfg: AgentConfig):
        super().__init__(name=f"agent-{cfg.name}", daemon=True)
        self.rh = rhapsody
        self.cfg = cfg
        self.submitted: list = []
        self.decisions = 0
        self.latencies: list = []  # per-decision end-to-end seconds
        self.errors = 0  # decision requests that failed (e.g. denied)
        self.error: Optional[BaseException] = None
        self._pending: set = set()  # submitted-but-not-terminal task uids

    def run(self):
        try:
            ep = self.rh.get_service(self.cfg.service)
            inflight: list = []  # (decision index, submit time, future)
            for i in range(self.cfg.n_decisions):
                # feedback loop: wait while too many realized tasks pending
                while self._backlog() > self.cfg.backlog_limit:
                    time.sleep(0.001)
                t0 = time.perf_counter()
                fut = ep.request(self.cfg.decision_payload(i),
                                 tenant=self.cfg.tenant,
                                 priority=self.cfg.priority)
                inflight.append((i, t0, fut))
                # pipelined decisions: only block once the window is full
                # (depth 1 is the classic decide -> realize -> decide loop)
                while len(inflight) >= max(1, self.cfg.pipeline_depth):
                    self._realize(*inflight.pop(0))
                if self.cfg.think_time:
                    time.sleep(self.cfg.think_time)
            while inflight:  # drain the tail of the pipeline
                self._realize(*inflight.pop(0))
        except BaseException as e:  # noqa: BLE001
            self.error = e

    def _realize(self, i: int, t0: float, fut):
        """Resolve one decision and realize it as HPC task submissions."""
        try:
            fut.result(timeout=60.0)
        except Exception:
            self.errors += 1
            return  # a denied/failed decision costs the slot
        self.latencies.append(time.perf_counter() - t0)
        self.decisions += 1
        self.rh.events.emit(f"{self.cfg.name}.d{i}", "DECISION",
                            "agent", "decision")
        descs = []
        for j in range(self.cfg.tasks_per_decision):
            if self.cfg.make_task is not None:
                descs.append(self.cfg.make_task(i, j))
            else:
                from repro_torch.substrate.simulation import noop

                descs.append(TaskDescription(
                    kind=TaskKind.FUNCTION, fn=noop,
                    task_type="agent_tool",
                ))
        uids = self.rh.submit(descs)
        self.submitted.extend(uids)
        self._pending.update(uids)

    def _backlog(self) -> int:
        """Outstanding realized tasks.  Tracked incrementally: terminal
        uids leave the pending set for good, so the cost is O(pending),
        not O(history) — and unlike the old last-64 window, a long-lived
        agent can never outrun its own backlog accounting."""
        done = [uid for uid in self._pending
                if self.rh.tasks[uid].state.terminal]
        self._pending.difference_update(done)
        return len(self._pending)


def run_agent_population(rhapsody: Rhapsody, configs) -> dict:
    agents = [Agent(rhapsody, c) for c in configs]
    for a in agents:
        a.start()
    for a in agents:
        a.join()
    uids = [u for a in agents for u in a.submitted]
    rhapsody.wait(uids)
    by_class: dict = {}
    for a in agents:
        by_class.setdefault(a.cfg.priority or "normal",
                            []).extend(a.latencies)
    return {
        "agents": len(agents),
        "decisions": sum(a.decisions for a in agents),
        "tasks": len(uids),
        "decision_errors": sum(a.errors for a in agents),
        "latencies": [lat for a in agents for lat in a.latencies],
        "latencies_by_class": by_class,
        "errors": [repr(a.error) for a in agents if a.error],
    }
