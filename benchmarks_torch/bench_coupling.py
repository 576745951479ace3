"""Experiment 5 (Fig. 6): coupled AI-HPC data-exchange overheads.

The port's ``benchmarks/bench_coupling.py``: the same pairs and tensor
size, the surrogate computing on ``device`` (the CUDA card unless the
caller asks for the CPU).  N simulation-inference pairs per "node"; each
simulation produces a 4,000-element tensor (~16 KB, the paper's size)
consumed by an inference task.  Compares memory-based vs filesystem-based
coupling, reports PUT/GET latency and decomposes runtime into compute /
data transfer / orchestration / middleware overhead.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core import (ResourceDescription, Rhapsody, TaskDescription,
                              TaskKind)
from repro_torch.core.coupling import make_store
from repro_torch.device import resolve_device
from repro_torch.substrate.simulation import surrogate_eval

from .common import Reporter

TENSOR = 4000  # elements (paper: 4,000-element tensors, ~16KB)


def sim_task(store, key: str, seed: int):
    rng = np.random.RandomState(seed)
    t0 = time.perf_counter()
    data = rng.normal(size=TENSOR).astype(np.float32)  # "simulation"
    compute = time.perf_counter() - t0
    store.put(key, data)
    return compute


def infer_task(store, key: str, device=None):
    data = store.get(key)
    t0 = time.perf_counter()
    out = surrogate_eval(data[:64][None, :].repeat(4, 0), device=device)
    compute = time.perf_counter() - t0
    return compute, float(out.mean())


def run_pairs(n_pairs: int, kind: str, n_workers: int = 4,
              device=None) -> dict:
    dev = resolve_device(device)
    rh = Rhapsody(ResourceDescription(nodes=max(1, n_pairs // 32),
                                      cores_per_node=64),
                  n_workers=n_workers)
    store = make_store(kind)
    try:
        t0 = time.perf_counter()
        descs = []
        for i in range(n_pairs):
            s = TaskDescription(kind=TaskKind.COUPLED, fn=sim_task,
                                args=(store, f"pair{i}", i),
                                task_type="coupled_sim")
            f = TaskDescription(kind=TaskKind.COUPLED, fn=infer_task,
                                args=(store, f"pair{i}", dev),
                                dependencies=[s.uid],
                                task_type="coupled_infer")
            descs.extend([s, f])
        uids = rh.submit(descs)
        rh.wait(uids)
        total = time.perf_counter() - t0
        sim_compute = sum(rh.result(d.uid) for d in descs
                          if d.task_type == "coupled_sim")
        inf_compute = sum(rh.result(d.uid)[0] for d in descs
                          if d.task_type == "coupled_infer")
        st = store.stats.summary()
        transfer = (sum(store.stats.put_times)
                    + sum(store.stats.get_times))
        compute = sim_compute + inf_compute
        overhead = max(0.0, total - compute - transfer)
        return {
            "pairs": n_pairs, "store": kind, "total_s": total,
            "compute_s": compute, "transfer_s": transfer,
            "overhead_s": overhead,
            "overhead_frac": overhead / total,
            "avg_put_ms": st["avg_put_ms"], "avg_get_ms": st["avg_get_ms"],
            "puts": st["puts"], "gets": st["gets"],
            "bytes_moved": st["put_bytes"] + st["get_bytes"],
        }
    finally:
        store.close()
        rh.close()


def main(rep: Reporter, *, pair_counts=(32, 128), device=None) -> dict:
    dev = resolve_device(device)
    # first call off the clock
    surrogate_eval(np.zeros((4, 64), np.float32), device=dev)
    out = []
    for n in pair_counts:
        for kind in ("memory", "filesystem"):
            r = run_pairs(n, kind, device=dev)
            out.append(r)
            rep.add(f"exp5_{kind}_n{n}", r["total_s"] * 1e6 / n,
                    f"put={r['avg_put_ms']:.3f}ms get={r['avg_get_ms']:.3f}ms "
                    f"ovh={r['overhead_frac'] * 100:.1f}%")
    # paper headline: memory vs filesystem speedup
    for n in pair_counts:
        mem = next(r for r in out if r["pairs"] == n and r["store"] == "memory")
        fs = next(r for r in out if r["pairs"] == n and r["store"] == "filesystem")
        rep.add(f"exp5_speedup_n{n}", 0.0,
                f"mem_vs_fs={fs['total_s'] / mem['total_s']:.2f}x")
    return {"runs": out}


if __name__ == "__main__":
    main(Reporter())
