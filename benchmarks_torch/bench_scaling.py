"""Experiment 1 (Fig. 3): baseline runtime performance with no-op tasks.

The port's ``benchmarks/bench_scaling.py``, on the port's middleware and
substrate.  Weak scaling: tasks grow with worker count (constant work per
worker).  Strong scaling: fixed task count, growing worker count.
Metrics: throughput (tasks/s) and runtime overhead (s; us/task) — the
paper reports ~100-300 us/task for RHAPSODY+Dragon.  No-op tasks touch no
device.
"""
from __future__ import annotations

import time

from repro_torch.core import Rhapsody, ResourceDescription, TaskDescription
from repro_torch.substrate.simulation import noop

from .common import Reporter


def run_batch(n_tasks: int, n_workers: int) -> dict:
    rh = Rhapsody(ResourceDescription(nodes=n_workers, cores_per_node=64),
                  n_workers=n_workers)
    try:
        descs = [TaskDescription(fn=noop, task_type="noop")
                 for _ in range(n_tasks)]
        t0 = time.perf_counter()
        uids = rh.submit(descs)
        rh.wait(uids)
        dt = time.perf_counter() - t0
        return {
            "tasks": n_tasks,
            "workers": n_workers,
            "seconds": dt,
            "tasks_per_s": n_tasks / dt,
            "us_per_task": dt / n_tasks * 1e6,
            "done": sum(1 for u in uids if rh.tasks[u].state.name == "DONE"),
        }
    finally:
        rh.close()


def main(rep: Reporter, *, weak_per_worker: int = 2048,
         strong_total: int = 8192, worker_counts=(1, 2, 4, 8)) -> dict:
    weak, strong = [], []
    for w in worker_counts:
        r = run_batch(weak_per_worker * w, w)
        weak.append(r)
        rep.add(f"exp1_weak_w{w}", r["us_per_task"],
                f"{r['tasks_per_s']:.0f} tasks/s n={r['tasks']}")
    for w in worker_counts:
        r = run_batch(strong_total, w)
        strong.append(r)
        rep.add(f"exp1_strong_w{w}", r["us_per_task"],
                f"{r['tasks_per_s']:.0f} tasks/s n={r['tasks']}")
    return {"weak": weak, "strong": strong}


if __name__ == "__main__":
    main(Reporter())
