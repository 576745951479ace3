"""Backend ABC: concrete execution mechanisms composed by the middleware."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from repro_torch.core.task import Task


@dataclasses.dataclass
class BackendCapabilities:
    kinds: tuple  # TaskKind values this backend executes
    max_concurrency: int = 0  # 0 = unbounded
    supports_mpi: bool = False
    supports_gpu: bool = False


class Backend:
    """Executes tasks; reports completion via the middleware callback."""

    name = "backend"

    def start(self, on_complete: Callable[[Task, Any, Optional[BaseException]], None]):
        raise NotImplementedError

    def submit(self, task: Task) -> None:
        raise NotImplementedError

    def cancel(self, task: Task) -> bool:
        return False

    def capabilities(self) -> BackendCapabilities:
        raise NotImplementedError

    def shutdown(self, wait: bool = True) -> None:
        raise NotImplementedError

    # introspection used by benchmarks
    def stats(self) -> dict:
        return {}
