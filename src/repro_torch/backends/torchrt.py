"""PyTorch compute backend: executes array payloads on the card.

The counterpart of the JAX package's ``backends/jaxrt.py``.  The
middleware composes this *alongside* the pool backend (the paper's central
claim: multiple runtimes coexist in one allocation, each serving the
partition it's suited for).  Payloads are ``fn(*args, **kwargs)``; the
backend runs them on a dedicated executor thread (keeping device work off
middleware worker threads) and synchronizes the device before it reports
a task complete, so completion means data-ready.  The reference jit-caches
payloads; here they run eagerly (no ``torch.compile``), so ``stats()``
reports ``jit_cache`` as 0.
"""
from __future__ import annotations

import queue
import threading
from typing import Optional

import torch

from repro_torch.core.task import Task, TaskKind
from repro_torch.device import resolve_device
from .base import Backend, BackendCapabilities


class TorchBackend(Backend):
    name = "torch"

    def __init__(self, *, device=None):
        self.device = resolve_device(device)
        self._queue: "queue.Queue" = queue.Queue()
        self._on_complete = None
        self._alive = True
        self._thread: Optional[threading.Thread] = None
        self.executed = 0

    # -- Backend API --------------------------------------------------------
    def start(self, on_complete):
        self._on_complete = on_complete
        self._thread = threading.Thread(target=self._loop,
                                        name="torch-backend", daemon=True)
        self._thread.start()
        return self

    def submit(self, task: Task):
        self._queue.put(task)

    def capabilities(self):
        return BackendCapabilities(
            kinds=(TaskKind.FUNCTION, TaskKind.EXECUTABLE, TaskKind.COUPLED),
            max_concurrency=1,  # one device stream
            supports_gpu=True,
        )

    def shutdown(self, wait=True):
        self._alive = False
        self._queue.put(None)
        if wait and self._thread is not None:
            self._thread.join(timeout=2.0)

    def stats(self):
        return {"executed": self.executed, "queued": self._queue.qsize(),
                "jit_cache": 0}

    # -- internals ------------------------------------------------------------
    def _loop(self):
        while self._alive:
            task = self._queue.get()
            if task is None:
                break
            try:
                result = task.desc.fn(*task.desc.args, **task.desc.kwargs)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                self.executed += 1
                self._on_complete(task, result, None)
            except BaseException as e:  # noqa: BLE001
                self._on_complete(task, None, e)
