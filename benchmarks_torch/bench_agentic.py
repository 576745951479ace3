"""Experiment 6 (Fig. 7): agent decision rate vs AI-HPC realization rate.

The port's ``benchmarks/bench_agentic.py``: the same agents, decisions,
prompts and tool tasks, with the port's LLM service and payloads on
``device`` (the CUDA card unless the caller asks for the CPU).  A
population of agents issues LLM decisions through a middleware service and
realizes each as HPC task submissions.  We verify sustained temporal
overlap (no phase separation) and bounded decision->realization lag.
``run_population`` takes another model config (and its parameters) in
place of the reference's two-layer demo model.

``--qos`` runs the multi-tenant QoS campaign instead: agent sessions in
two priority classes plus batch FUNCTION tasks on one ledger, three phases
(unloaded high-class baseline; contended with QoS off; contended with QoS
on), as the reference's.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import (ExecutionPolicy, ResourceDescription, Rhapsody,
                              ServiceDescription, TaskDescription)
from repro_torch.core.agent import AgentConfig, run_agent_population
from repro_torch.device import resolve_device
from repro_torch.serving.client import llm_service_factory
from repro_torch.substrate.simulation import surrogate_eval

from .common import Reporter


def demo_cfg():
    """The reference's agent model: rhapsody-demo cut to two layers."""
    return get_config("rhapsody-demo").scaled(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512)


def run_population(n_agents: int, n_decisions: int = 4, *, device=None,
                   cfg=None, params=None, max_new_tokens: int = 4) -> dict:
    dev = resolve_device(device)
    cfg = cfg or demo_cfg()
    rh = Rhapsody(ResourceDescription(nodes=4, cores_per_node=16),
                  n_workers=4)
    try:
        rs = rh.add_service(ServiceDescription(
            name="llm", ready_timeout=600, factory=llm_service_factory(
                cfg, params, device=dev, max_num_seqs=8, max_len=64,
                prefill_buckets=(16,))))
        rng = np.random.RandomState(0)

        def payload(i):
            return {"prompt": list(rng.randint(0, 512, size=12)),
                    "max_new_tokens": max_new_tokens}

        def make_task(i, j):
            return TaskDescription(
                fn=surrogate_eval, kwargs={"dim": 16, "hidden": 32,
                                           "seed": i * 131 + j,
                                           "device": dev},
                task_type="agent_tool")

        configs = [AgentConfig(name=f"a{k}", service="llm",
                               n_decisions=n_decisions,
                               tasks_per_decision=2,
                               decision_payload=payload,
                               make_task=make_task)
                   for k in range(n_agents)]
        t0 = time.perf_counter()
        summary = run_agent_population(rh, configs)
        seconds = time.perf_counter() - t0
        dec = rh.events.windowed_rate("DECISION", window=0.5, tag="decision")
        arr = rh.events.windowed_rate("RUNNING", window=0.5)
        lags = rh.events.realization_lag()
        # temporal overlap: fraction of decision windows with nonzero ARR
        overlap = 0
        for t, r in dec:
            if r > 0 and any(abs(t - t2) < 0.5 and r2 > 0
                             for t2, r2 in arr):
                overlap += 1
        return {
            "agents": n_agents,
            "config": cfg.name,
            "max_new_tokens": max_new_tokens,
            "seconds": seconds,
            "decisions": summary["decisions"],
            "tasks": summary["tasks"],
            "decision_errors": summary["decision_errors"],
            "mean_lag_s": float(np.mean(lags)) if lags else 0.0,
            "p50_lag_s": float(np.percentile(lags, 50)) if lags else 0.0,
            "p95_lag_s": float(np.percentile(lags, 95)) if lags else 0.0,
            "overlap_frac": overlap / max(1, len(dec)),
            "peak_decision_rate": max((r for _, r in dec), default=0.0),
            "peak_arr": max((r for _, r in arr), default=0.0),
            "decode_steps": sum(inst.servicer.stats.decode_steps
                                for inst in rs.instances),
            "replica_errors": [repr(inst.error) for inst in rs.instances
                               if inst.error is not None],
            "errors": summary["errors"],
        }
    finally:
        rh.close()


def _p95(xs):
    return float(np.percentile(xs, 95)) if xs else None


def _qos_phase(phase: str, cfg, *, qos_on: bool, with_low: bool,
               n_high=2, n_low=6, high_decisions=24,
               low_decisions=8, device=None) -> dict:
    """One phase of the QoS campaign on a fresh single-replica service, as
    the reference's: one engine seat, six saturating low-class agents
    (four decisions pipelined each) against two high-class ones, and a
    batch of FUNCTION tasks on the same ledger in every phase."""
    dev = resolve_device(device)
    rh = Rhapsody(ResourceDescription(nodes=4, cores_per_node=16),
                  policy=ExecutionPolicy(routing="round_robin"),
                  n_workers=2)
    try:
        rs = rh.add_service(ServiceDescription(
            name="llm", replicas=1,
            factory=llm_service_factory(
                cfg, device=dev, max_num_seqs=1, max_len=80, paged=True,
                block_size=8, num_blocks=26, prefill_buckets=(16, 32),
                qos=qos_on)))
        rng = np.random.RandomState(0)

        def high_payload(i):
            return {"prompt": list(rng.randint(0, 512, size=16)),
                    "max_new_tokens": 24}

        def low_payload(i):
            return {"prompt": list(rng.randint(0, 512, size=24)),
                    "max_new_tokens": 16}

        def make_task(i, j):
            return TaskDescription(
                fn=surrogate_eval, kwargs={"dim": 16, "hidden": 32,
                                           "seed": i * 131 + j,
                                           "device": dev},
                task_type="agent_tool")

        def build(tag, highs, lows):
            cfgs = [AgentConfig(name=f"{tag}hi{k}", service="llm",
                                n_decisions=highs,
                                tasks_per_decision=2,
                                decision_payload=high_payload,
                                make_task=make_task, think_time=0.15,
                                tenant="interactive", priority="high")
                    for k in range(n_high)]
            if with_low:
                cfgs += [AgentConfig(name=f"{tag}lo{k}", service="llm",
                                     n_decisions=lows,
                                     tasks_per_decision=0,
                                     decision_payload=low_payload,
                                     think_time=0.0, pipeline_depth=4,
                                     tenant="batch", priority="low")
                         for k in range(n_low)]
            return cfgs

        # an untimed miniature of the measured workload first, so first
        # calls (allocator growth, every batch shape) are off the clock
        run_agent_population(rh, build("warm-", 2, 2))
        batch_uids = rh.submit([make_task(97, j) for j in range(16)])
        t0 = time.perf_counter()
        summary = run_agent_population(rh, build("", high_decisions,
                                                 low_decisions))
        elapsed = time.perf_counter() - t0
        svc_high = rs.latency_p95(tenant_class="high", started_after=t0)
        svc_low = rs.latency_p95(tenant_class="low", started_after=t0)
        rh.wait(batch_uids)
        batch_done = sum(1 for u in batch_uids
                         if rh.tasks[u].state.name == "DONE")
        by_cls = summary["latencies_by_class"]
        stats = rh.get_service("llm").stats()
        low_done = len(by_cls.get("low", []))
        return {
            "scenario": "qos_campaign",
            "phase": phase,
            "qos": qos_on,
            "elapsed_s": elapsed,
            "high_p95_s": svc_high,
            "low_p95_s": svc_low,
            "agent_high_p95_s": _p95(by_cls.get("high", [])),
            "agent_low_p95_s": _p95(by_cls.get("low", [])),
            "high_decisions": len(by_cls.get("high", [])),
            "low_decisions": low_done,
            "low_throughput_per_s": (low_done / elapsed if with_low
                                     else None),
            "decision_errors": summary["decision_errors"],
            "agent_errors": summary["errors"],
            "batch_tasks": len(batch_uids),
            "batch_completed": batch_done,
            "per_tenant": stats["per_tenant"],
            "qos_counters": stats["qos"],
            "expected_tenants": (["batch", "interactive"] if with_low
                                 else ["interactive"]),
        }
    finally:
        rh.close()


def run_qos_campaign(device=None, **kw) -> list:
    cfg = demo_cfg()
    return [
        _qos_phase("baseline_high", cfg, qos_on=True, with_low=False,
                   device=device, **kw),
        _qos_phase("no_qos", cfg, qos_on=False, with_low=True,
                   device=device, **kw),
        _qos_phase("qos", cfg, qos_on=True, with_low=True, device=device,
                   **kw),
    ]


def main(rep: Reporter, *, populations=(4, 16), device=None) -> dict:
    out = []
    for n in populations:
        r = run_population(n, device=device)
        out.append(r)
        rep.add(f"exp6_agents_{n}", r["mean_lag_s"] * 1e6,
                f"lag_p95={r['p95_lag_s']:.3f}s overlap={r['overlap_frac']:.2f} "
                f"arr_peak={r['peak_arr']:.1f}/s")
    return {"populations": out}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--qos", action="store_true",
                    help="run the multi-tenant QoS isolation campaign")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the service and payloads")
    args = ap.parse_args()
    if args.qos:
        rows = run_qos_campaign(device=args.device)
        if args.json:
            print(json.dumps(rows, indent=2))
        else:
            for r in rows:
                print(f"{r['phase']:>14}: high_p95="
                      f"{(r['high_p95_s'] or 0) * 1e3:.1f}ms "
                      f"low_tp={r['low_throughput_per_s'] or 0:.2f}/s "
                      f"qos={r['qos_counters']}")
    else:
        main(Reporter(), device=args.device)
