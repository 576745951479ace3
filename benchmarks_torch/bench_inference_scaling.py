"""Experiment 3 (Fig. 5a,b): inference-at-scale baseline scalability.

The port's ``benchmarks/bench_inference_scaling.py``: the same scenarios,
traffic and rows, with the port's engines on ``device`` (the CUDA card
unless the caller asks for the CPU).  Every engine-backed function takes
``cfg=`` and ``params=`` (default: the reference's two-layer demo config
and one weight set drawn from seed 0, which every replica and engine of
the scenario shares).

Proportionally grows replicas / clients with homogeneous prompts,
measuring aggregate token throughput (``tokens_per_s``: prompt plus
generated tokens, the reference's definition; ``generated_tokens_per_s``
beside it) and engine utilization (fraction of decode-slot-steps
occupied).  One service name, N replicas: clients all hit the same replica
set and the shared router spreads them.

``--autoscale``: a step load against an autoscaled, admission-controlled
replica set (``step`` converges and holds the p95 SLO; ``saturate`` pins
at the partition's capacity with scale-up denied).  ``--multi-model``: two
model groups behind one name under the ``weighted_capacity`` autoscaler;
load shifts from one to the other and the hot group gains a replica by
retiring one of the idle group's.  Both run synthetic servicers and touch
no device.

``--paged``: a branching-session load against a slot-pool engine and both
paged decode paths (``gather`` round-trip and ``direct`` kernel) at memory
parity, plus a small replicated paged service's block telemetry.
``--disagg``: disaggregated prefill/decode pools against unified chunked
prefill at equal replica count, plus the recompute-fallback scenario.
``--speculative``: vanilla, high-acceptance (identity-padded target) and
low-acceptance (adversarial draft, acceptance floor armed) streams.

``--json`` prints the rows the reference prints; check them with the
reference's checker, ``python benchmarks/check_bench_json.py <mode>
<file>``.  On the card every clock read that follows device work waits
for it first (``common.clock``).
"""
from __future__ import annotations

import argparse
import json
import random
import threading
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core import (ExecutionPolicy, ModelGroup, ResourceDescription,
                              ResourceRequirements, Rhapsody,
                              ServiceDescription)
from repro_torch.core.autoscale import percentile
from repro_torch.core.request import InferenceRequest
from repro_torch.device import resolve_device
from repro_torch.serving.client import llm_model_group, llm_service_factory
from repro_torch.serving.engine import InferenceEngine, SpecDecodeSession

from .common import Reporter, clock, init_params

# the reference's replica engine for exp3 and the paged service
DEMO_ENGINE = dict(max_num_seqs=4, max_len=64, prefill_buckets=(16,))


def engine_cfg():
    return get_config("rhapsody-demo").scaled(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512)


def run_config(n_replicas: int, clients_per_replica: int,
               reqs_per_client: int = 8, prompt_len: int = 12,
               new_tokens: int = 8, *, device=None, cfg=None, params=None,
               **engine_kw) -> dict:
    """``n_replicas`` replicas of one service, ``clients_per_replica``
    client threads each sending ``reqs_per_client`` requests of one
    homogeneous ``prompt_len``-token prompt (``new_tokens`` each).
    ``engine_kw`` replaces the reference's engine settings
    (``DEMO_ENGINE``).  The row is the reference's plus
    ``generated_tokens_per_s``, ``generated_tokens`` and ``decode_steps``
    (summed over the replicas)."""
    dev = resolve_device(device)
    cfg = cfg or engine_cfg()
    params = init_params(cfg, dev) if params is None else params
    rh = Rhapsody(ResourceDescription(nodes=n_replicas, cores_per_node=16),
                  policy=ExecutionPolicy(routing="least_loaded"),
                  n_workers=2)
    try:
        replica_set = rh.add_service(ServiceDescription(
            name="llm", replicas=n_replicas, ready_timeout=600,
            factory=llm_service_factory(cfg, params, device=dev,
                                        **(engine_kw or DEMO_ENGINE))))
        results = []
        lock = threading.Lock()

        def client():
            futs = [replica_set.request({"prompt": [7] * prompt_len,
                                         "max_new_tokens": new_tokens})
                    for _ in range(reqs_per_client)]
            out = [f.result(timeout=600) for f in futs]
            with lock:
                results.extend(out)

        n_clients = n_replicas * clients_per_replica
        t0 = clock(dev)
        threads = [threading.Thread(target=client)
                   for _ in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        dt = clock(dev) - t0
        generated = sum(len(r["tokens"]) for r in results)
        total_tokens = generated + sum(r["n_prompt"] for r in results)
        utils = [inst.servicer.stats.utilization
                 for inst in replica_set.instances]
        stats = replica_set.stats()
        return {
            "replicas": n_replicas,
            "clients": n_clients,
            "requests": len(results),
            "seconds": dt,
            "tokens_per_s": total_tokens / dt,
            "generated_tokens_per_s": generated / dt,
            "generated_tokens": generated,
            "decode_steps": sum(inst.servicer.stats.decode_steps
                                for inst in replica_set.instances),
            "utilization": sum(utils) / len(utils),
            "per_replica_requests": [p["requests"]
                                     for p in stats["per_replica"]],
        }
    finally:
        rh.close()


def main(rep: Reporter, *, configs=((1, 2), (2, 2), (4, 2)), device=None,
         cfg=None, params=None, **kw) -> dict:
    dev = resolve_device(device)
    cfg = cfg or engine_cfg()
    params = init_params(cfg, dev) if params is None else params
    out = []
    for n_replicas, cpc in configs:
        r = run_config(n_replicas, cpc, device=dev, cfg=cfg, params=params,
                       **kw)
        out.append(r)
        rep.add(f"exp3_infer_s{n_replicas}",
                1e6 * r["seconds"] / max(1, r["requests"]),
                f"{r['tokens_per_s']:.0f} tok/s "
                f"gen={r['generated_tokens_per_s']:.0f} tok/s "
                f"util={r['utilization']:.2f} clients={r['clients']}")
    return {"configs": out}


# ---------------------------------------------------------------------------
# Autoscaling under a step load (admission-controlled by the ledger)
# ---------------------------------------------------------------------------


class TimedServicer:
    """Synthetic serial replica: each request occupies it for a fixed
    service time, so end-to-end latency is deterministic (queue wait +
    service) and the autoscaler's control behavior — not engine noise —
    is what the scenario measures.  ``tag`` marks results with the model
    group that served them, so the multi-model scenario can PROVE no
    request landed on a wrong-model replica."""

    def __init__(self, service_time_s: float = 0.02, tag: str = ""):
        self.service_time = service_time_s
        self.tag = tag
        self._q: list = []
        self._uid = 0
        self._cur = None
        self._done_at = 0.0

    def warmup(self):  # the autoscale scenarios run with warmup=True
        time.sleep(self.service_time)

    def submit(self, payload, **kw) -> int:
        self._uid += 1
        self._q.append(self._uid)
        return self._uid

    def step(self):
        now = time.perf_counter()
        out = []
        if self._cur is not None and now >= self._done_at:
            out.append((self._cur, {"ok": True, "served_by": self.tag}))
            self._cur = None
        if self._cur is None and self._q:
            self._cur = self._q.pop(0)
            self._done_at = now + self.service_time
        return out


def run_autoscale(autoscaler: str, scenario: str = "step", *,
                  capacity: int = 4, service_time_s: float = 0.02,
                  warm_s: float = 1.0, heavy_s: float = 5.0,
                  stable_window_s: float = 1.0) -> dict:
    """Step load against an autoscaled, admission-controlled replica set.

    ``step``: demand fits the partition — the policy must converge to a
    stable replica count (no membership change over the last
    ``stable_window_s``, >= 3 sustain windows) that holds the SLO.
    ``saturate``: demand exceeds the partition's ``capacity`` nodes — the
    set must pin at capacity with scale-up denied via event + stat.
    """
    if scenario == "step":
        clients, slo_ms, max_replicas = 8, 120.0, capacity
    elif scenario == "saturate":
        clients, slo_ms, max_replicas = 24, 60.0, 2 * capacity
    else:
        raise ValueError(f"unknown scenario {scenario!r}")
    interval = 0.05
    rh = Rhapsody(ResourceDescription(nodes=capacity, cores_per_node=1),
                  policy=ExecutionPolicy(
                      routing="least_loaded", autoscale=True,
                      autoscaler=autoscaler,
                      autoscale_min_replicas=1,
                      autoscale_max_replicas=max_replicas,
                      autoscale_high_depth=3.0, autoscale_low_depth=0.5,
                      autoscale_interval_s=interval, autoscale_sustain=2,
                      slo_p95_ms=slo_ms, slo_window_s=1.0,
                      warmup=True),
                  n_workers=2)
    try:
        rs = rh.add_service(ServiceDescription(
            name="llm", replicas=1,
            requirements=ResourceRequirements(ranks=1, cores_per_rank=1),
            factory=lambda: TimedServicer(service_time_s)))
        stop = threading.Event()
        served = [0] * clients

        def client(i):
            while not stop.is_set():
                try:
                    rs.request({"prompt": [i] * 8}).result(30.0)
                except (RuntimeError, TimeoutError):
                    break  # shutdown race / stalled runner at scenario end
                served[i] += 1

        trace: list = []  # (perf_counter, n_replicas) samples

        def sampler():
            while not stop.is_set():
                trace.append((time.perf_counter(), rs.n_replicas))
                time.sleep(interval / 2)

        threading.Thread(target=sampler, daemon=True).start()
        # phase 1: light load (one client) — the set should stay small
        light = threading.Thread(target=client, args=(0,), daemon=True)
        light.start()
        time.sleep(warm_s)
        # phase 2: step to full load
        heavy = [threading.Thread(target=client, args=(i,), daemon=True)
                 for i in range(1, clients)]
        for t in heavy:
            t.start()
        time.sleep(heavy_s)
        # measure while the load is still applied — reading any of these
        # after stop() would race the idle scale-down that follows
        p95 = rs.latency_p95(window_s=stable_window_s)
        util = rh.utilization()["default"]
        stats = rs.stats()
        final_replicas = rs.n_replicas
        t_end = time.perf_counter()
        stop.set()
        for t in [light] + heavy:
            t.join(timeout=30)
        tail = [n for t, n in trace
                if t_end - stable_window_s <= t <= t_end]
        return {
            "autoscaler": autoscaler,
            "scenario": scenario,
            "clients": clients,
            "capacity": capacity,
            "slo_p95_ms": slo_ms,
            "p95_ms": None if p95 is None else p95 * 1e3,
            "final_replicas": final_replicas,
            "converged": bool(tail) and len(set(tail)) == 1,
            "replica_trace": [n for _, n in trace],
            "requests": sum(served),
            "admission_denied": stats["admission_denied"],
            "service_cores": util["service_cores"],
            "service_replicas": util["service_replicas"],
            "core_utilization": util["cores"],
        }
    finally:
        rh.close()


def autoscale_sweep(policies=("queue_depth", "latency_slo"),
                    scenarios=("step", "saturate"), **kw) -> list:
    return [run_autoscale(p, s, **kw) for p in policies for s in scenarios]


# ---------------------------------------------------------------------------
# Multi-model replica set under shifting load (weighted_capacity rebalance)
# ---------------------------------------------------------------------------


def run_multi_model(*, capacity: int = 4, service_time_s: float = 0.02,
                    warm_s: float = 1.0, shift_s: float = 5.0,
                    stable_window_s: float = 1.0) -> list:
    """TWO model groups behind ONE service name, inside a partition the
    set fully occupies, governed by the ``weighted_capacity`` autoscaler.

    Phase 1: light, even load on both models.  Phase 2: the load SHIFTS —
    ``beta`` takes a heavy client burst while ``alpha`` goes idle.  With
    no free headroom, holding beta's SLO requires a REBALANCE: the scaler
    retires an alpha replica and admits a beta one on the freed claim.
    One row per model group (the reference's ``check_bench_json.py
    multimodel`` validates them)."""
    interval = 0.05
    slo_ms = 60.0
    rh = Rhapsody(ResourceDescription(nodes=capacity, cores_per_node=1),
                  policy=ExecutionPolicy(
                      routing="least_loaded", autoscale=True,
                      autoscaler="weighted_capacity",
                      autoscale_min_replicas=1,
                      autoscale_max_replicas=capacity,
                      autoscale_low_depth=0.5,
                      autoscale_interval_s=interval, autoscale_sustain=2,
                      slo_p95_ms=slo_ms, slo_window_s=1.0,
                      warmup=True),
                  n_workers=2)
    try:
        rs = rh.add_service(ServiceDescription(
            name="llm", replicas=capacity,
            requirements=ResourceRequirements(ranks=1, cores_per_rank=1),
            models=[
                ModelGroup(name="alpha", weight=1.0,
                           factory=lambda: TimedServicer(service_time_s,
                                                         tag="alpha")),
                ModelGroup(name="beta", weight=1.0,
                           factory=lambda: TimedServicer(service_time_s,
                                                         tag="beta")),
            ]))
        start = rs.group_counts()
        stop = threading.Event()
        served = {"alpha": [0, 0], "beta": [0, 0]}  # [ok, wrong_route]
        lock = threading.Lock()

        def client(model, alive: threading.Event):
            while not stop.is_set() and alive.is_set():
                try:
                    r = rs.request({"prompt": [1] * 8, "model": model}
                                   ).result(30.0)
                except (RuntimeError, TimeoutError):
                    break  # shutdown race at scenario end
                with lock:
                    served[model][0] += 1
                    if r.get("served_by") != model:
                        served[model][1] += 1

        # phase 1: one light client per model
        alpha_alive = threading.Event()
        alpha_alive.set()
        both_alive = threading.Event()
        both_alive.set()
        threads = [threading.Thread(target=client, args=("alpha",
                                                         alpha_alive),
                                    daemon=True),
                   threading.Thread(target=client, args=("beta",
                                                         both_alive),
                                    daemon=True)]
        for t in threads:
            t.start()
        time.sleep(warm_s)
        # phase 2: load shifts — beta goes heavy, alpha goes idle
        alpha_alive.clear()
        heavy = [threading.Thread(target=client, args=("beta", both_alive),
                                  daemon=True) for _ in range(6)]
        for t in heavy:
            t.start()
        time.sleep(shift_s)
        # measure while the shifted load is still applied
        stats = rs.stats()
        util = rh.utilization()["default"]
        p95 = {g: rs.latency_p95(window_s=stable_window_s, group=g)
               for g in ("alpha", "beta")}
        stop.set()
        for t in threads + heavy:
            t.join(timeout=30)
        ledger_cores = util["service_cores"]
        rows = []
        for g in ("alpha", "beta"):
            gs = stats["per_group"][g]
            rows.append({
                "scenario": "multi_model",
                "group": g,
                "weight": gs["weight"],
                "hot": g == "beta",  # the group the load shifted ONTO
                "capacity": capacity,
                "requests": served[g][0],
                "wrong_route": served[g][1],
                "replicas_start": start[g],
                "replicas_final": gs["replicas"],
                "p95_ms": None if p95[g] is None else p95[g] * 1e3,
                "slo_p95_ms": gs["slo_p95_ms"],
                "service_cores": gs["cores"],
                "ledger_service_cores": ledger_cores,
                "ledger_models": util["service_models"],
                "admission_denied": stats["admission_denied"],
            })
        return rows
    finally:
        rh.close()


# ---------------------------------------------------------------------------
# Block-paged vs slot-pool engine on a branching-session load
# ---------------------------------------------------------------------------


def _drive(eng, prompts, new_tokens: int):
    """Submit all prompts at once and drain, tracking peak concurrency."""
    uids = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
    done = {}
    peak = 0
    for _ in range(100000):
        if not eng.has_work():
            break
        eng.step()
        peak = max(peak, len(eng.running))
        for r in eng.collect_finished():
            done[r.uid] = r
    return [done[u].output for u in uids], peak


def _decode_burst(eng, prompts, new_tokens: int, repeats: int = 3) -> float:
    """Decode-phase throughput on a warm engine: admit + prefill run
    UNTIMED, then the pure decode steps are timed and ``decode_tokens/s``
    reported — the number that isolates the gather round-trip vs
    direct-kernel decode cost from prefill.  Best of ``repeats`` bursts."""
    best = 0.0
    for _ in range(repeats):
        for p in prompts:
            eng.submit(p, max_new_tokens=new_tokens)

        def prefilling() -> bool:
            return bool(eng.queue) or any(
                r.pending_tokens and not r.done
                for r in eng.running.values())

        while eng.has_work() and prefilling():
            eng.step()
            eng.collect_finished()
        d0 = eng.stats.decode_tokens
        t0 = clock(eng.device)
        while eng.has_work():
            eng.step()
            eng.collect_finished()
        dt = clock(eng.device) - t0
        best = max(best, (eng.stats.decode_tokens - d0) / max(1e-9, dt))
    return best


PAGED_VARIANTS = (
    ("monolithic", {}),
    ("paged_gather", {"paged": True, "paged_decode_mode": "gather"}),
    ("paged", {"paged": True}),  # the direct kernel
)


def paged_compare(*, max_num_seqs: int = 4, max_len: int = 64,
                  block_size: int = 8, n_branches: int = 12,
                  prompt_len: int = 12, new_tokens: int = 6,
                  burst_tokens: int = 32, device=None, cfg=None,
                  params=None):
    """``run_paged_compare``'s scenario -> (rows, runs), where ``runs``
    maps each engine's name to its engine, prompts (stem first) and
    transcripts, for callers that hold the engines' counters or the
    transcripts themselves."""
    dev = resolve_device(device)
    cfg = cfg or engine_cfg()
    params = init_params(cfg, dev) if params is None else params
    kw = dict(max_num_seqs=max_num_seqs, max_len=max_len,
              prefill_buckets=(16, 32), seed=0)
    rng = random.Random(0)
    stem = [rng.randrange(1, cfg.vocab) for _ in range(prompt_len)]
    branches = [stem + [rng.randrange(1, cfg.vocab) for _ in range(3)]
                for _ in range(n_branches)]
    runs = {}
    # every engine serves the load before any timed burst, so no burst
    # pays a first call
    for name, extra in PAGED_VARIANTS:
        if extra.get("paged"):
            extra = dict(extra, block_size=block_size)
        eng = InferenceEngine(cfg, params, device=dev, **kw, **extra)
        t0 = clock(dev)
        stem_out, _ = _drive(eng, [stem], new_tokens)
        branch_out, peak = _drive(eng, branches, new_tokens)
        runs[name] = {"engine": eng, "seconds": clock(dev) - t0,
                      "peak": peak, "prompts": [stem] + branches,
                      "outs": stem_out + branch_out}
    rows = []
    for name, extra in PAGED_VARIANTS:
        run = runs[name]
        eng = run["engine"]
        decode_tps = _decode_burst(eng, branches, burst_tokens)
        st = eng.stats
        tel = eng.block_telemetry()
        rows.append({
            "scenario": "paged_compare",
            "engine": name,
            "decode_mode": (extra.get("paged_decode_mode", "direct")
                            if extra.get("paged") else None),
            "max_num_seqs": max_num_seqs,
            "max_len": max_len,
            "block_size": block_size if extra.get("paged") else None,
            "num_blocks": eng.num_blocks if extra.get("paged") else None,
            "requests": 1 + n_branches,
            "seconds": run["seconds"],
            "tokens_per_s": st.tokens_per_s,
            "decode_tokens_per_s": decode_tps,
            "peak_concurrent": run["peak"],
            "prefix_reuse_hits": st.prefix_reuse_hits,
            "prefix_cached_tokens": st.prefix_cached_tokens,
            "shared_block_peak": st.shared_block_peak,
            "cow_copies": st.cow_copies,
            # live pool gauges at quiescence (paged rows only)
            "free_blocks": tel["free_blocks"] if tel else None,
            "reserved_blocks": tel["reserved_blocks"] if tel else None,
        })
    outs = [runs[name]["outs"] for name, _ in PAGED_VARIANTS]
    match = outs[0] == outs[1] == outs[2]
    for r in rows:
        r["tokens_match"] = match
    return rows, runs


def run_paged_compare(**kw) -> list:
    """Branching-session load (one stem, many divergent suffixes) on a
    slot-pool engine and BOTH block-paged decode paths at MEMORY PARITY,
    all three over one weight set.  The stem runs first so its KV is
    resident when the branch burst arrives: the slot pool resumes one slot
    and prefills the rest into its ``max_num_seqs`` slots, while the paged
    engines fork the stem's blocks into every branch's table and admit the
    whole burst at once, copy-on-write duplicating only the
    divergence-boundary block.

    Three rows: ``monolithic`` (slot pool), ``paged_gather``
    (``paged_decode_mode="gather"``: a contiguous view through the
    contiguous decode kernel) and ``paged`` (the direct paged kernel).
    Greedy outputs must match token for token across all three; a warm
    decode-only burst measures ``decode_tokens_per_s``.  Keywords as
    ``paged_compare``."""
    return paged_compare(**kw)[0]


def run_paged_service(*, n_replicas: int = 2, requests: int = 8,
                      prompt_len: int = 12, new_tokens: int = 6,
                      device=None, cfg=None, params=None) -> list:
    """Small replicated PAGED service: per-replica engine
    ``block_telemetry()`` aggregated per model group by
    ``ReplicaSet.stats()["per_group"][g]["block_telemetry"]``.  One JSON
    row per group."""
    dev = resolve_device(device)
    cfg = cfg or engine_cfg()
    params = init_params(cfg, dev) if params is None else params
    rh = Rhapsody(ResourceDescription(nodes=n_replicas, cores_per_node=16),
                  policy=ExecutionPolicy(routing="least_loaded"),
                  n_workers=2)
    try:
        rs = rh.add_service(ServiceDescription(
            name="llm", replicas=n_replicas, ready_timeout=600,
            factory=llm_service_factory(
                cfg, params, device=dev, **DEMO_ENGINE, paged=True,
                block_size=8)))
        futs = [rs.request({"prompt": [7] * prompt_len,
                            "max_new_tokens": new_tokens})
                for _ in range(requests)]
        for f in futs:
            f.result(timeout=600)
        stats = rs.stats()
        return [{
            "scenario": "paged_service",
            "group": g,
            "replicas": gs["replicas"],
            "requests": gs["requests"],
            "block_telemetry": gs["block_telemetry"],
        } for g, gs in stats["per_group"].items()]
    finally:
        rh.close()


# ---------------------------------------------------------------------------
# Disaggregated prefill/decode: per-phase SLOs vs unified chunked prefill
# ---------------------------------------------------------------------------


def _disagg_load(cfg, *, n_long: int, n_chat: int, long_len: int,
                 chat_len: int, long_new: int, chat_new: int,
                 seed: int = 0) -> list:
    """Mixed stream: long-prompt (RAG-like) requests whose chunked
    prefill is what steals decode budget in unified serving, interleaved
    with chatty short-prompt/long-decode sessions whose ITL that theft
    inflates.  Deterministically shuffled so both modes see the same
    arrival order."""
    rng = random.Random(seed)
    reqs = ([([rng.randrange(1, cfg.vocab) for _ in range(long_len)],
              long_new, "long") for _ in range(n_long)]
            + [([rng.randrange(1, cfg.vocab) for _ in range(chat_len)],
                chat_new, "chat") for _ in range(n_chat)])
    rng.shuffle(reqs)
    return reqs


def run_disagg(*, n_replicas: int = 4, n_long: int = 8, n_chat: int = 16,
               long_len: int = 96, chat_len: int = 8, long_new: int = 8,
               chat_new: int = 16, block_size: int = 8, max_len: int = 128,
               unified_budget: int = 32, prefill_budget: int = 256,
               device=None, cfg=None, params=None) -> list:
    """Disaggregated prefill/decode vs unified chunked prefill at EQUAL
    replica count, on a mixed long-prompt + chatty stream.

    Unified serving picks ONE ``max_num_batched_tokens``; disaggregation
    runs the prefill pool with big chunks and no decode to stall, and the
    decode pool never sees a prefill chunk.  Greedy outputs must match a
    single reference engine token for token, and every disagg request
    must finish on a decode replica via handoff (``wrong_role`` counts
    violations).  Two ``disagg_compare`` rows (mode unified | disagg)
    with ``ttft_p95_ms`` / ``itl_p95_ms`` measured after a discarded warm
    wave; the disagg row carries the speedups."""
    dev = resolve_device(device)
    cfg = cfg or engine_cfg()
    params = init_params(cfg, dev) if params is None else params
    reqs = _disagg_load(cfg, n_long=n_long, n_chat=n_chat,
                        long_len=long_len, chat_len=chat_len,
                        long_new=long_new, chat_new=chat_new)
    # reference: one engine on the weights every replica serves
    ref = InferenceEngine(
        cfg, params, device=dev, seed=0, max_num_seqs=8, max_len=max_len,
        paged=True, block_size=block_size, num_blocks=160,
        max_num_batched_tokens=prefill_budget,
        prefill_buckets=(16, 32, 64, 128))
    ref_uids = [ref.submit(p, max_new_tokens=n) for p, n, _ in reqs]
    ref_done = ref.run()
    ref_out = [ref_done[u].output for u in ref_uids]

    base_kw = dict(max_num_seqs=8, max_len=max_len, paged=True,
                   block_size=block_size, num_blocks=160,
                   prefill_buckets=(16, 32, 64, 128), device=dev)

    def one_mode(mode: str) -> dict:
        rh = Rhapsody(
            ResourceDescription(nodes=n_replicas, cores_per_node=16),
            policy=ExecutionPolicy(routing="least_loaded", warmup=True),
            n_workers=2)
        try:
            if mode == "disagg":
                n_pre = n_replicas // 2
                models = [
                    llm_model_group(
                        "prefill", cfg, params, role="prefill",
                        paired_with="decode", replicas=n_pre,
                        max_num_batched_tokens=prefill_budget, **base_kw),
                    llm_model_group(
                        "decode", cfg, params, role="decode",
                        replicas=n_replicas - n_pre,
                        max_num_batched_tokens=64, **base_kw),
                ]
                rs = rh.add_service(ServiceDescription(
                    name="llm", replicas=n_replicas, models=models,
                    ready_timeout=600))
                tag = {"model": "prefill"}
            else:
                rs = rh.add_service(ServiceDescription(
                    name="llm", replicas=n_replicas, ready_timeout=600,
                    factory=llm_service_factory(
                        cfg, params, max_num_batched_tokens=unified_budget,
                        **base_kw)))
                tag = {}

            def wave(load):
                futs = [rs.request(dict({"prompt": p, "max_new_tokens": n},
                                        **tag)) for p, n, _ in load]
                return [f.result(timeout=600) for f in futs]

            # warm wave: same shape as the measured load so every first
            # call (big prefill chunks, decode batch sizes, the handoff)
            # runs BEFORE the timed wave; results discarded
            wave(_disagg_load(cfg, n_long=max(2, n_replicas),
                              n_chat=max(4, 2 * n_replicas),
                              long_len=long_len, chat_len=chat_len,
                              long_new=4, chat_new=6, seed=1))
            res = wave(reqs)
            ttfts = [r["ttft_s"] for r in res if r["ttft_s"] is not None]
            itls = [r["itl_s"] for r in res if r["itl_s"] is not None]
            match = all(r["tokens"] == o for r, o in zip(res, ref_out))
            wrong_role = (sum(1 for r in res
                              if not (r.get("handoff")
                                      and r.get("role") == "decode"))
                          if mode == "disagg" else 0)
            stats = rs.stats()
            hand = rs.handoff_totals()
            tp = percentile(ttfts, 0.95)
            ip = percentile(itls, 0.95)
            return {
                "scenario": "disagg_compare",
                "mode": mode,
                "replicas": n_replicas,
                "requests": len(reqs),
                "n_long": n_long, "n_chat": n_chat,
                "long_len": long_len, "chat_len": chat_len,
                "unified_budget": unified_budget,
                "prefill_budget": prefill_budget,
                "ttft_p95_ms": tp and tp * 1e3,
                "itl_p95_ms": ip and ip * 1e3,
                "tokens_match": match,
                "wrong_role": wrong_role,
                "handoffs": hand["imports"] + hand["recomputes"],
                "recomputes": hand["recomputes"],
                "per_group": {
                    g: {k: gs[k] for k in
                        ("role", "replicas", "requests", "ttft_p95_ms",
                         "itl_p95_ms", "handoff_exports",
                         "handoff_imports", "handoff_recomputes")}
                    for g, gs in stats["per_group"].items()},
            }
        finally:
            rh.close()

    rows = [one_mode("unified"), one_mode("disagg")]
    uni, dis = rows
    dis["ttft_speedup"] = (uni["ttft_p95_ms"] or 0.0) \
        / max(1e-9, dis["ttft_p95_ms"] or 0.0)
    dis["itl_speedup"] = (uni["itl_p95_ms"] or 0.0) \
        / max(1e-9, dis["itl_p95_ms"] or 0.0)
    return rows


def run_disagg_fallback(*, n_handoffs: int = 3, prompt_len: int = 24,
                        new_tokens: int = 6, device=None, cfg=None,
                        params=None) -> list:
    """Recompute-on-miss: a decode pool too full to reserve an import's
    blocks must fall back to RECOMPUTING the sequence's prompt locally —
    degraded latency, never a failed request, and still token-identical
    output.  Deterministic servicer-level drive: a 9-block decode pool
    (one max_len=64 sequence needs all 8 usable) is pinned by a live
    long-budget occupant, so every import is denied while it runs.

    The exports are read from the prefill step's ``"handoff_export"`` and
    offered to the decode servicer on an envelope's ``handoff``, the keys
    the servicers use (the reference's version reads ``"_handoff"`` and
    submits ``"_import"`` payload keys, which its servicers stopped
    reading when the request envelope came in, so it hands nothing off)."""
    dev = resolve_device(device)
    cfg = cfg or engine_cfg()
    params = init_params(cfg, dev) if params is None else params
    kw = dict(max_num_seqs=4, max_len=64, prefill_buckets=(16, 32),
              paged=True, block_size=8, device=dev)
    pre = llm_service_factory(cfg, params, phase="prefill",
                              max_num_batched_tokens=256, **kw)()
    dec = llm_service_factory(cfg, params, phase="decode", num_blocks=9,
                              max_num_batched_tokens=64, **kw)()
    rng = random.Random(2)
    prompts = [[rng.randrange(1, cfg.vocab) for _ in range(prompt_len)]
               for _ in range(n_handoffs)]
    ref = InferenceEngine(cfg, params, seed=0, max_num_batched_tokens=256,
                          **kw)
    ref_uids = [ref.submit(p, max_new_tokens=new_tokens) for p in prompts]
    ref_done = ref.run()
    ref_out = {tuple(p): ref_done[u].output
               for p, u in zip(prompts, ref_uids)}

    # occupant: reserves the decode pool dry for its whole decode
    occ = dec.submit({"prompt": [3] * 30, "max_new_tokens": 30})
    dec.step()  # admit it (reserve_left now pins all 8 blocks)
    handoffs = []
    for p in prompts:
        pre.submit({"prompt": p, "max_new_tokens": new_tokens})
    for _ in range(100000):
        if len(handoffs) == n_handoffs:
            break
        for _, r in pre.step():
            if r.get("handoff_export") is not None:
                handoffs.append(r["handoff_export"])
    results = {}
    for pay in handoffs:  # every import denied -> recompute path
        payload = {"prompt": list(pay["prompt"])}
        dec.submit(payload, envelope=InferenceRequest(payload=payload,
                                                      handoff=pay))
    for _ in range(100000):
        if len(results) == n_handoffs + 1:
            break
        for uid, r in dec.step():
            results[uid] = r
    hs = dec.handoff_stats()
    # every recomputed sequence must reproduce the reference greedy
    # output (recompute = full local prefill + decode, same params)
    match = bool(handoffs)
    for pay in handoffs:
        want = ref_out[tuple(pay["prompt"])]
        match = match and any(
            r["tokens"] == want and r.get("recompute")
            for u, r in results.items() if u != occ)
    return [{
        "scenario": "disagg_fallback",
        "exports": n_handoffs,
        "imports": hs["imports"],
        "recomputes": hs["recomputes"],
        "completed": len(results),
        "tokens_match": match,
    }]


# ---------------------------------------------------------------------------
# Cross-group speculative decoding: draft-propose / target-verify pipeline
# ---------------------------------------------------------------------------


def _spec_cfg(n_layers: int):
    """d512 at ``n_layers``: deep enough that a shallow draft is genuinely
    cheaper than the deep target (one target step ~ n_layers draft
    steps)."""
    return get_config("rhapsody-demo").scaled(
        n_layers=n_layers, d_model=512, n_heads=8, n_kv_heads=4,
        head_dim=64, d_ff=2048, vocab=512)


def _identity_padded(draft_params, target_params, n_draft_layers: int):
    """Target params whose first ``n_draft_layers`` layers are the
    draft's and whose remaining layers are EXACT identities: the blocks
    are pre-norm with bias-free projections, so zeroing a layer's
    attention output projection and MLP down projection leaves only the
    residual path (``x + 0``).  Embedding, final norm and unembedding are
    the draft's, so the target computes the draft's function bit for bit
    while paying full-depth cost.  The port's layers are a list of
    per-layer dicts with ``[d_in, d_out]`` linears; the zeros are new
    tensors, so ``target_params`` is left as it was."""
    blocks = list(draft_params["blocks"][:n_draft_layers])
    for bp in target_params["blocks"][n_draft_layers:]:
        attn, mlp = bp["attn"], bp["mlp"]
        blocks.append({
            **bp,
            "attn": {**attn, "o": {**attn["o"],
                                   "w": torch.zeros_like(attn["o"]["w"])}},
            "mlp": {**mlp, "down": {**mlp["down"],
                                    "w": torch.zeros_like(mlp["down"]["w"])}},
        })
    return {**draft_params, "blocks": blocks}


def _drain_timed(driver, prompts, new_tokens: int, repeats: int = 3, *,
                 device):
    """Warm end-to-end drains: one untimed pass pays every first call,
    then the best decode-tokens/s over ``repeats`` timed passes.  Returns
    (tok/s, outputs)."""
    stats = driver.stats  # the target engine's counters for a session
    best, outs = 0.0, None
    for i in range(repeats + 1):
        uids = [driver.submit(p, max_new_tokens=new_tokens)
                for p in prompts]
        d0 = stats.decode_tokens
        t0 = clock(device)
        done = driver.run()
        dt = clock(device) - t0
        outs = [done[u].output for u in uids]
        if i > 0:  # pass 0 is the warm-up
            best = max(best, (stats.decode_tokens - d0) / max(1e-9, dt))
    return best, outs


def run_speculative(*, k: int = 4, target_layers: int = 12,
                    draft_layers: int = 1, new_tokens: int = 40,
                    repeats: int = 3, device=None, draft_params=None,
                    target_params=None, bad_draft_params=None) -> list:
    """Three streams over identical prompts, one row each:

    ``vanilla``            — target-only greedy decode (the baseline).
    ``high_acceptance``    — SpecDecodeSession with a shallow draft the
                             identity-padded target agrees with 100%.
    ``low_acceptance``     — adversarial draft (independent weights) with
                             the acceptance floor armed: the session must
                             disable itself after the probe window.

    All three transcripts must match token for token.  The weights
    default to the reference's draws: the draft from seed 0, the target
    from seed 1, the adversarial draft from seed 7."""
    dev = resolve_device(device)
    tcfg = _spec_cfg(target_layers)
    dcfg = _spec_cfg(draft_layers)
    kw = dict(max_num_seqs=4, max_len=96, prefill_buckets=(16,), device=dev)
    rng = random.Random(0)
    prompts = [[rng.randrange(1, tcfg.vocab) for _ in range(n)]
               for n in (12, 9, 12, 7)]
    draft_params = (init_params(dcfg, dev, 0) if draft_params is None
                    else draft_params)
    target_params = (init_params(tcfg, dev, 1) if target_params is None
                     else target_params)
    bad_draft_params = (init_params(dcfg, dev, 7) if bad_draft_params is None
                        else bad_draft_params)
    padded = _identity_padded(draft_params, target_params, draft_layers)
    drf = InferenceEngine(dcfg, draft_params, **kw)

    def padded_target():
        return InferenceEngine(tcfg, padded, **kw)

    rows = []
    # vanilla: the target alone (identity-padded so all three streams
    # decode the SAME transcript)
    base_tps, ref = _drain_timed(padded_target(), prompts, new_tokens,
                                 repeats, device=dev)
    rows.append({"stream": "vanilla", "decode_tokens_per_s": base_tps,
                 "acceptance_rate": None, "proposed": 0, "accepted": 0,
                 "enabled": None, "outs": ref})
    # high acceptance: the draft IS the target's function
    sess = SpecDecodeSession(padded_target(), drf, k=k)
    tps, outs = _drain_timed(sess, prompts, new_tokens, repeats, device=dev)
    ss = sess.spec_stats()
    rows.append({"stream": "high_acceptance", "decode_tokens_per_s": tps,
                 "acceptance_rate": ss["acceptance_rate"],
                 "proposed": ss["proposed"], "accepted": ss["accepted"],
                 "enabled": ss["enabled"], "outs": outs})
    # low acceptance: an unrelated draft + the adaptive floor — the
    # session must turn itself off and fall back to vanilla stepping
    drf_bad = InferenceEngine(dcfg, bad_draft_params, **kw)
    sess = SpecDecodeSession(padded_target(), drf_bad, k=k,
                             min_acceptance=0.3, probe_proposals=32)
    tps, outs = _drain_timed(sess, prompts, new_tokens, repeats, device=dev)
    ss = sess.spec_stats()
    rows.append({"stream": "low_acceptance", "decode_tokens_per_s": tps,
                 "acceptance_rate": ss["acceptance_rate"],
                 "proposed": ss["proposed"], "accepted": ss["accepted"],
                 "enabled": ss["enabled"], "outs": outs})
    match = all(r.pop("outs") == ref if r["stream"] != "vanilla"
                else bool(r.pop("outs")) for r in rows)
    for r in rows:
        r.update(scenario="speculative", k=k,
                 target_layers=target_layers, draft_layers=draft_layers,
                 new_tokens=new_tokens, tokens_match=match,
                 speedup_vs_vanilla=r["decode_tokens_per_s"]
                 / max(1e-9, base_tps))
    return rows


# ---------------------------------------------------------------------------
# Command line
# ---------------------------------------------------------------------------


def _print_rows(args, rows):
    """The reference's text lines for a ``--json``-capable mode."""
    for r in rows:
        if args.disagg:
            if r["scenario"] == "disagg_fallback":
                print(f"[disagg] fallback exports={r['exports']} "
                      f"imports={r['imports']} "
                      f"recomputes={r['recomputes']} "
                      f"completed={r['completed']} "
                      f"match={r['tokens_match']}")
                continue
            speed = ("" if r["mode"] == "unified" else
                     f" ttft_speedup={r['ttft_speedup']:.2f}x "
                     f"itl_speedup={r['itl_speedup']:.2f}x")
            print(f"[disagg] {r['mode']:>8s} x{r['replicas']} "
                  f"ttft_p95={r['ttft_p95_ms']:.0f}ms "
                  f"itl_p95={r['itl_p95_ms']:.0f}ms "
                  f"handoffs={r['handoffs']} "
                  f"recomputes={r['recomputes']} "
                  f"wrong_role={r['wrong_role']} "
                  f"match={r['tokens_match']}{speed}")
        elif args.speculative:
            acc = r["acceptance_rate"]
            print(f"[spec] {r['stream']:>16s} "
                  f"decode={r['decode_tokens_per_s']:.0f}tok/s "
                  f"({r['speedup_vs_vanilla']:.2f}x) "
                  f"acc={acc if acc is None else round(acc, 2)} "
                  f"proposed={r['proposed']} "
                  f"enabled={r['enabled']} "
                  f"match={r['tokens_match']}")
        elif args.paged:
            if r["scenario"] == "paged_service":
                print(f"[paged] service group={r['group']} "
                      f"x{r['replicas']} "
                      f"telemetry={r['block_telemetry']}")
                continue
            print(f"[paged] {r['engine']:>12s} "
                  f"peak={r['peak_concurrent']} "
                  f"(slots {r['max_num_seqs']}) "
                  f"shared={r['shared_block_peak']} "
                  f"cow={r['cow_copies']} "
                  f"hits={r['prefix_reuse_hits']} "
                  f"decode={r['decode_tokens_per_s']:.0f}tok/s "
                  f"free={r['free_blocks']} "
                  f"match={r['tokens_match']} "
                  f"{r['seconds']:.1f}s")
        elif args.multi_model:
            print(f"[multi-model] {r['group']:>6s} "
                  f"w={r['weight']} {'HOT ' if r['hot'] else 'idle'} "
                  f"replicas {r['replicas_start']}->"
                  f"{r['replicas_final']} "
                  f"p95={r['p95_ms'] and round(r['p95_ms'], 1)}ms "
                  f"(slo {r['slo_p95_ms']}ms) "
                  f"reqs={r['requests']} wrong={r['wrong_route']} "
                  f"cores={r['service_cores']}/"
                  f"{r['ledger_service_cores']}")
        else:
            print(f"[autoscale] {r['autoscaler']:>12s}/{r['scenario']:<8s} "
                  f"replicas={r['final_replicas']} "
                  f"converged={r['converged']} "
                  f"p95={r['p95_ms'] and round(r['p95_ms'], 1)}ms "
                  f"(slo {r['slo_p95_ms']}ms) "
                  f"denied={r['admission_denied']} "
                  f"claims={r['service_cores']}c/"
                  f"{r['service_replicas']}r")


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--autoscale", action="store_true",
                    help="run the autoscaling step-load scenarios instead "
                         "of the fixed-replica throughput sweep")
    ap.add_argument("--multi-model", action="store_true",
                    help="run the two-model shifting-load rebalance "
                         "scenario (weighted_capacity autoscaler)")
    ap.add_argument("--paged", action="store_true",
                    help="run the block-paged vs slot-pool engine "
                         "comparison on a branching-session load")
    ap.add_argument("--speculative", action="store_true",
                    help="run the draft-propose / target-verify "
                         "speculative-decoding comparison (vanilla vs "
                         "high- and low-acceptance streams)")
    ap.add_argument("--disagg", action="store_true",
                    help="run the disaggregated prefill/decode vs unified "
                         "chunked-prefill comparison (mixed long-prompt + "
                         "chatty stream at equal replica count) plus the "
                         "recompute-fallback scenario")
    ap.add_argument("--disagg-replicas", type=int, default=4)
    ap.add_argument("--spec-k", type=int, default=4)
    ap.add_argument("--block-size", type=int, default=8)
    ap.add_argument("--branches", type=int, default=12)
    ap.add_argument("--policies", nargs="*",
                    default=["queue_depth", "latency_slo"])
    ap.add_argument("--scenarios", nargs="*",
                    default=["step", "saturate"])
    ap.add_argument("--capacity", type=int, default=4)
    ap.add_argument("--heavy-s", type=float, default=5.0)
    ap.add_argument("--shift-s", type=float, default=5.0)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engines (cuda | cpu)")
    args = ap.parse_args(argv)
    dev = args.device
    if args.disagg:
        rows = (run_disagg(n_replicas=args.disagg_replicas, device=dev)
                + run_disagg_fallback(device=dev))
    elif args.speculative:
        rows = run_speculative(k=args.spec_k, device=dev)
    elif args.paged:
        rows = (run_paged_compare(block_size=args.block_size,
                                  n_branches=args.branches, device=dev)
                + run_paged_service(device=dev))
    elif args.multi_model:
        rows = run_multi_model(capacity=args.capacity, shift_s=args.shift_s)
    elif args.autoscale:
        rows = autoscale_sweep(args.policies, args.scenarios,
                               capacity=args.capacity, heavy_s=args.heavy_s)
    else:
        main(Reporter(), device=dev)
        return 0
    if args.json:
        print(json.dumps(rows, indent=2))
    else:
        _print_rows(args, rows)
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
