"""Task abstraction: the paper's uniform middleware-level representation.

One description type covers the four task categories of §III-B:
  * EXECUTABLE — multi-rank compute payloads (MPI-simulation analogue),
  * FUNCTION   — language-level functions (fine-grained tasks),
  * SERVICE    — long-running services (inference engines, stores),
  * COUPLED    — tightly coupled AI-HPC tasks exchanging data in a loop,
  * INFERENCE  — client-side requests against a SERVICE endpoint.

Tasks carry declarative resource requirements (ranks x cores x gpus) and
dependencies; the middleware owns scheduling/dispatch/lifecycle uniformly.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
import time
from typing import Any, Callable, Optional


class TaskKind(enum.Enum):
    EXECUTABLE = "executable"
    FUNCTION = "function"
    SERVICE = "service"
    COUPLED = "coupled"
    INFERENCE = "inference"


class TaskState(enum.Enum):
    NEW = "NEW"
    WAITING = "WAITING"  # unresolved dependencies
    READY = "READY"
    SCHEDULED = "SCHEDULED"
    RUNNING = "RUNNING"
    DONE = "DONE"
    FAILED = "FAILED"
    CANCELED = "CANCELED"

    @property
    def terminal(self) -> bool:
        return self in (TaskState.DONE, TaskState.FAILED, TaskState.CANCELED)


_uid_counter = itertools.count()


def _next_uid(prefix: str) -> str:
    return f"{prefix}.{next(_uid_counter):08d}"


@dataclasses.dataclass
class ResourceRequirements:
    ranks: int = 1
    cores_per_rank: int = 1
    gpus_per_rank: int = 0

    @property
    def cores(self) -> int:
        return self.ranks * self.cores_per_rank

    @property
    def gpus(self) -> int:
        return self.ranks * self.gpus_per_rank


@dataclasses.dataclass
class TaskDescription:
    """Declarative task submission record (backend-agnostic)."""

    kind: TaskKind = TaskKind.FUNCTION
    fn: Optional[Callable] = None  # FUNCTION / COUPLED / EXECUTABLE payload
    args: tuple = ()
    kwargs: dict = dataclasses.field(default_factory=dict)
    requirements: ResourceRequirements = dataclasses.field(
        default_factory=ResourceRequirements)
    dependencies: list = dataclasses.field(default_factory=list)  # uids
    task_type: str = "function"  # heterogeneity label (HW metric)
    service: Optional[str] = None  # INFERENCE: target service name
    payload: Any = None  # INFERENCE: request payload
    partition: Optional[str] = None  # pin to a named partition
    uid: Optional[str] = None
    max_retries: int = 0
    metadata: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.uid is None:
            self.uid = _next_uid("task")


@dataclasses.dataclass
class Task:
    """Runtime record tracked by the middleware."""

    desc: TaskDescription
    state: TaskState = TaskState.NEW
    result: Any = None
    error: Optional[BaseException] = None
    unresolved: int = 0
    dependents: list = dataclasses.field(default_factory=list)
    placement: Any = None  # binding produced by the resource mapper
    retries: int = 0
    submitted_at: float = 0.0
    started_at: float = 0.0
    finished_at: float = 0.0

    @property
    def uid(self) -> str:
        return self.desc.uid

    @property
    def duration(self) -> float:
        if self.finished_at and self.started_at:
            return self.finished_at - self.started_at
        return 0.0
