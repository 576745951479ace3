"""Experiment 2 (Fig. 4): heterogeneity width under a mixed campaign.

The port's ``benchmarks/bench_heterogeneity.py``: the same task types,
sizes and pipelines, with the port's payloads computing on ``device`` (the
CUDA card unless the caller asks for the CPU).  Task types along the
paper's three heterogeneity dimensions — execution model (serial vs
multi-rank), accelerator usage (cpu vs gpu-tagged), and rank scale.
Submission order is driven only by dependencies; HW(t) measures how many
distinct types the runtime overlaps.
"""
from __future__ import annotations

import random
import time

from repro_torch.core import (ExecutionPolicy, ResourceDescription, Rhapsody,
                              ResourceRequirements, TaskDescription, TaskKind)
from repro_torch.device import resolve_device
from repro_torch.substrate.simulation import (heat_stencil, lj_step,
                                              surrogate_eval)

from .common import Reporter

TASK_TYPES = [
    # (type label, kind, fn, kwargs, ranks, cores/rank, gpus/rank)
    ("serial_cpu_analysis", TaskKind.FUNCTION, surrogate_eval,
     {"dim": 32, "hidden": 64}, 1, 1, 0),
    ("serial_gpu_score", TaskKind.FUNCTION, surrogate_eval,
     {"dim": 64, "hidden": 128}, 1, 1, 1),
    ("mpi_cpu_sim_small", TaskKind.EXECUTABLE, heat_stencil,
     {"n": 48, "steps": 8}, 2, 2, 0),
    ("mpi_cpu_sim_large", TaskKind.EXECUTABLE, heat_stencil,
     {"n": 96, "steps": 16}, 8, 2, 0),
    ("mpi_gpu_md", TaskKind.EXECUTABLE, lj_step,
     {"n_particles": 96, "steps": 8}, 4, 1, 1),
    ("preprocess", TaskKind.FUNCTION, surrogate_eval,
     {"dim": 8, "hidden": 16}, 1, 1, 0),
]


def build_campaign(n_pipelines: int, seed: int = 0, device=None):
    """Pipelines of sim -> analysis -> surrogate with cross-type diversity;
    every payload computes on ``device``."""
    dev = resolve_device(device)
    rng = random.Random(seed)
    descs = []
    for p in range(n_pipelines):
        sim_t = rng.choice(TASK_TYPES[2:5])
        sim = TaskDescription(
            kind=sim_t[1], fn=sim_t[2],
            kwargs=dict(sim_t[3], seed=p, device=dev),
            requirements=ResourceRequirements(ranks=sim_t[4],
                                              cores_per_rank=sim_t[5],
                                              gpus_per_rank=sim_t[6]),
            task_type=sim_t[0])
        pre_t = TASK_TYPES[5]
        pre = TaskDescription(
            kind=pre_t[1], fn=pre_t[2],
            kwargs=dict(pre_t[3], seed=p, device=dev),
            task_type=pre_t[0], dependencies=[sim.uid])
        an_t = rng.choice(TASK_TYPES[0:2])
        analysis = TaskDescription(
            kind=an_t[1], fn=an_t[2],
            kwargs=dict(an_t[3], seed=p, device=dev),
            requirements=ResourceRequirements(gpus_per_rank=an_t[6]),
            task_type=an_t[0], dependencies=[pre.uid])
        descs.extend([sim, pre, analysis])
    return descs


def run_campaign(n_pipelines: int, nodes: int, n_workers: int = 8,
                 device=None) -> dict:
    rh = Rhapsody(ResourceDescription(nodes=nodes, cores_per_node=16,
                                      gpus_per_node=4),
                  policy=ExecutionPolicy(backfill=True),
                  n_workers=n_workers)
    try:
        descs = build_campaign(n_pipelines, device=device)
        t0 = time.perf_counter()
        uids = rh.submit(descs)
        rh.wait(uids)
        dt = time.perf_counter() - t0
        hw = rh.events.heterogeneity_width()
        peak = max((h for _, h in hw), default=0)
        sustained = sorted(h for _, h in hw)[len(hw) // 2] if hw else 0
        return {
            "pipelines": n_pipelines,
            "nodes": nodes,
            "seconds": dt,
            "peak_hw": peak,
            "median_hw": sustained,
            "timeline_points": len(hw),
            "distinct_types": len({d.task_type for d in descs}),
            "tasks": len(uids),
            "done": sum(1 for u in uids if rh.tasks[u].state.name == "DONE"),
        }
    finally:
        rh.close()


def main(rep: Reporter, *, scales=((24, 4), (48, 16)), device=None) -> dict:
    out = []
    for n_pipelines, nodes in scales:
        r = run_campaign(n_pipelines, nodes, device=device)
        out.append(r)
        rep.add(f"exp2_hw_n{nodes}", r["seconds"] * 1e6 / max(1, r['pipelines']),
                f"peak_hw={r['peak_hw']} median_hw={r['median_hw']} "
                f"types={r['distinct_types']}")
    return {"campaigns": out}


if __name__ == "__main__":
    main(Reporter())
