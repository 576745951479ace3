"""Experiment 4 (Fig. 5c,d): batching-parameter sensitivity + routing policy.

The port's ``benchmarks/bench_routing.py``: the same prompts (the same
numpy draws for the same seeds), sweeps and rows, with the port's engines
on ``device`` (the CUDA card unless the caller asks for the CPU) for the
real-engine sweeps, which take ``cfg=`` / ``params=`` (default: the
reference's two-layer demo config and one weight set from seed 0).

(c) throughput vs ``max_num_seqs`` x ``max_num_batched_tokens`` on a fixed
prompt subset.  (d) strong scaling of a fixed heterogeneous prompt set
(lognormal lengths) across 1-4 replicas of ONE service under randomized vs
token-aware balanced routing, all dispatched through the middleware router
(INFERENCE tasks).

``--replicas 1 2 4``: the replica sweep with a synthetic servicer (routing
and replication without model compute): aggregate and per-replica
throughput and p50/p95/p99 latency per replica count.

``--affinity``: sessioned multi-turn streams (``sessioned``), shared-stem
agent streams (``branching``) and unrelated prompts (``uniform``) against a
synthetic servicer whose cost covers only the prompt tokens its replica
has not already served, under ``radix_affinity``, ``prefix_affinity`` and
``least_loaded``.

The synthetic sweeps touch no device.  ``--json`` emits the rows as a JSON
array (check them with ``python benchmarks/check_bench_json.py affinity
<file>``).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import (ExecutionPolicy, ResourceDescription, Rhapsody,
                              ServiceDescription, TaskDescription, TaskKind)
from repro_torch.core.prefix import RadixIndex
from repro_torch.core.router import ROUTERS
from repro_torch.device import resolve_device
from repro_torch.serving.client import llm_service_factory

from .common import Reporter, clock, init_params


def engine_cfg():
    return get_config("rhapsody-demo").scaled(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512)


def hetero_prompts(n: int, seed: int = 0, lo: int = 8, hi: int = 96):
    rng = np.random.RandomState(seed)
    lens = np.clip(np.exp(rng.normal(3.0, 0.8, size=n)).astype(int), lo, hi)
    return [list(rng.randint(0, 512, size=int(L))) for L in lens]


# ---------------------------------------------------------------------------
# (c) batching parameter sensitivity
# ---------------------------------------------------------------------------


def sweep_batching(rep: Reporter, *, n_prompts: int = 24, device=None,
                   cfg=None, params=None) -> list:
    dev = resolve_device(device)
    cfg = cfg or engine_cfg()
    params = init_params(cfg, dev) if params is None else params
    prompts = hetero_prompts(n_prompts, seed=1)
    out = []
    for max_num_seqs in (2, 4, 8):
        for max_tokens in (128, 512):
            rh = Rhapsody(ResourceDescription(nodes=1, cores_per_node=8),
                          n_workers=1)
            try:
                ep = rh.add_service(ServiceDescription(
                    name="llm", ready_timeout=600,
                    factory=llm_service_factory(
                        cfg, params, device=dev, max_num_seqs=max_num_seqs,
                        max_num_batched_tokens=max_tokens,
                        max_len=128, prefill_buckets=(32, 64, 128))))
                t0 = clock(dev)
                futs = [ep.request({"prompt": p, "max_new_tokens": 8})
                        for p in prompts]
                res = [f.result(timeout=600) for f in futs]
                dt = clock(dev) - t0
                tokens = sum(len(r["tokens"]) + r["n_prompt"] for r in res)
                row = {"max_num_seqs": max_num_seqs,
                       "max_num_batched_tokens": max_tokens,
                       "tokens_per_s": tokens / dt, "seconds": dt}
                out.append(row)
                rep.add(f"exp4_batch_s{max_num_seqs}_t{max_tokens}",
                        dt * 1e6 / n_prompts,
                        f"{row['tokens_per_s']:.0f} tok/s")
            finally:
                rh.close()
    return out


# ---------------------------------------------------------------------------
# (d) routing policy strong scaling — one replicated service, middleware
#     router on the dispatch path
# ---------------------------------------------------------------------------


def routed_run(n_replicas: int, policy: str, prompts, *, device=None,
               cfg=None, params=None) -> dict:
    dev = resolve_device(device)
    cfg = cfg or engine_cfg()
    params = init_params(cfg, dev) if params is None else params
    rh = Rhapsody(ResourceDescription(nodes=1,
                                      cores_per_node=max(8, len(prompts))),
                  policy=ExecutionPolicy(routing=policy),
                  n_workers=1)
    try:
        replica_set = rh.add_service(ServiceDescription(
            name="llm", replicas=n_replicas, ready_timeout=600,
            factory=llm_service_factory(
                cfg, params, device=dev, max_num_seqs=4, max_len=128,
                prefill_buckets=(32, 64, 128))))
        descs = [TaskDescription(kind=TaskKind.INFERENCE, service="llm",
                                 payload={"prompt": p, "max_new_tokens": 8},
                                 task_type="inference")
                 for p in prompts]
        t0 = clock(dev)
        uids = rh.submit(descs)
        if not rh.wait(uids, timeout=600):
            raise TimeoutError("inference stream timed out")
        dt = clock(dev) - t0
        results = [rh.result(u) for u in uids]
        tokens = sum(len(r["tokens"]) + r["n_prompt"] for r in results)
        stats = replica_set.stats()
        per = [p["requests"] for p in stats["per_replica"]]
        # Fig 5d compares TOKEN-load spread (balanced routing equalizes
        # cost, not request count — one huge prompt offsets many small)
        loads = [p["cost"] for p in stats["per_replica"]]
        return {"replicas": n_replicas, "policy": policy, "seconds": dt,
                "tokens_per_s": tokens / dt,
                "per_replica_requests": per,
                "load_imbalance": max(loads) / max(1.0, min(loads))}
    finally:
        rh.close()


def main(rep: Reporter, *, n_prompts: int = 24,
         service_counts=(1, 2, 4), device=None, cfg=None,
         params=None) -> dict:
    dev = resolve_device(device)
    cfg = cfg or engine_cfg()
    params = init_params(cfg, dev) if params is None else params
    sens = sweep_batching(rep, n_prompts=min(12, n_prompts), device=dev,
                          cfg=cfg, params=params)
    prompts = hetero_prompts(n_prompts, seed=2)
    scaling = []
    for n in service_counts:
        for policy in ("random", "balanced"):
            r = routed_run(n, policy, prompts, device=dev, cfg=cfg,
                           params=params)
            scaling.append(r)
            rep.add(f"exp4_route_{policy}_s{n}",
                    r["seconds"] * 1e6 / n_prompts,
                    f"{r['tokens_per_s']:.0f} tok/s "
                    f"imbalance={r['load_imbalance']:.2f}")
    return {"sensitivity": sens, "scaling": scaling}


# ---------------------------------------------------------------------------
# Replica scaling sweep with a synthetic servicer (Fig 5d shape without
# model compute): aggregate + per-replica throughput, tail latency
# ---------------------------------------------------------------------------


class SyntheticServicer:
    """Sync servicer that burns wall time proportional to prompt tokens —
    each replica is one serial worker, so N replicas ≈ N-way parallelism."""

    def __init__(self, base_ms: float = 2.0, us_per_token: float = 30.0):
        self.base_ms = base_ms
        self.us_per_token = us_per_token

    def handle(self, payload):
        n = len(payload.get("prompt", ()))
        time.sleep(self.base_ms * 1e-3 + n * self.us_per_token * 1e-6)
        return {"n_prompt": n}


def replica_sweep(replica_counts, *, n_requests: int = 64,
                  routing: str = "balanced", seed: int = 3) -> list:
    prompts = hetero_prompts(n_requests, seed=seed)
    rows = []
    for n in replica_counts:
        n = max(1, n)  # a service always runs at least one replica
        rh = Rhapsody(
            ResourceDescription(nodes=1,
                                cores_per_node=max(8, n_requests)),
            policy=ExecutionPolicy(routing=routing), n_workers=1)
        try:
            replica_set = rh.add_service(ServiceDescription(
                name="synth", replicas=n, factory=SyntheticServicer))
            descs = [TaskDescription(
                kind=TaskKind.INFERENCE, service="synth",
                payload={"prompt": p}, task_type="synthetic_inference")
                for p in prompts]
            t0 = time.perf_counter()
            uids = rh.submit(descs)
            if not rh.wait(uids, timeout=600):
                raise TimeoutError("synthetic stream timed out")
            dt = time.perf_counter() - t0
            lats = sorted(rh.tasks[u].duration for u in uids)
            per = [p["requests"]
                   for p in replica_set.stats()["per_replica"]]
            rows.append({
                "replicas": n, "routing": routing,
                "requests": n_requests, "seconds": dt,
                "req_per_s": n_requests / dt,
                "req_per_s_per_replica": n_requests / dt / n,
                "p50_ms": lats[len(lats) // 2] * 1e3,
                "p95_ms": lats[int(len(lats) * 0.95)] * 1e3,
                "p99_ms": lats[min(len(lats) - 1,
                                   int(len(lats) * 0.99))] * 1e3,
                "per_replica_requests": per,
            })
        finally:
            rh.close()
    return rows


# ---------------------------------------------------------------------------
# Prefix-affinity sweep: sessioned multi-turn streams, KV-reuse cost model
# ---------------------------------------------------------------------------


class SessionedServicer:
    """Synthetic engine with per-replica radix prefix caching: serving a
    prompt costs wall time only for the tokens this replica's cache does
    not already cover — where coverage is the longest common prefix with
    ANY sequence served here, exactly the engine's partial-resume rule (a
    diverging sibling prompt still covers the shared stem).  Exposes
    ``residency_summary`` so the replica set can gossip this replica's
    cache contents to the router."""

    def __init__(self, base_ms: float = 1.0, us_per_token: float = 60.0):
        self.base_ms = base_ms
        self.us_per_token = us_per_token
        self._served = RadixIndex(capacity=512)  # models bounded KV space

    def handle(self, payload):
        p = payload["prompt"]
        cached, _ = self._served.longest_match(p)
        uncached = len(p) - cached
        time.sleep(self.base_ms * 1e-3 + uncached * self.us_per_token * 1e-6)
        self._served.insert(p, 0)  # one anonymous cache: compaction folds
        #                            a session's earlier, shorter turns
        return {"n_prompt": len(p), "uncached": uncached}

    def residency_summary(self, max_len: int = 128):
        return self._served.summary(max_entries=64, max_len=max_len)


def _turn_waves(bases: list, turns: int, turn_len: int, rng) -> list:
    """Grow each base by one heterogeneous-length turn per wave and
    shuffle each wave's arrival order (on a perfectly regular stream a
    load-balancing router stays accidentally sticky).  Returns ``turns``
    lists of ``len(bases)`` prompts (growing transcripts)."""
    grown = [list(b) for b in bases]
    waves = []
    for _ in range(turns):
        for s in range(len(grown)):
            ext = rng.randint(max(1, turn_len // 2), 2 * turn_len)
            grown[s] = grown[s] + list(rng.randint(0, 512, size=ext))
        wave = [list(g) for g in grown]
        rng.shuffle(wave)
        waves.append(wave)
    return waves


def sessioned_prompts(n_sessions: int, turns: int, *, prefix_len: int = 32,
                      turn_len: int = 24, seed: int = 0) -> list:
    """Per-turn waves of prompts: session s's turn t prompt is its UNIQUE
    base prefix plus t accumulated turn extensions."""
    rng = np.random.RandomState(seed)
    bases = [list(rng.randint(0, 512, size=prefix_len))
             for _ in range(n_sessions)]
    return _turn_waves(bases, turns, turn_len, rng)


def branching_prompts(n_agents: int, turns: int, *, stem_len: int = 48,
                      turn_len: int = 24, seed: int = 0) -> list:
    """Branching-session waves (the agentic-campaign pattern, paper
    §Fig. 7): every agent's prompt starts with one SHARED system-prompt
    stem, longer than the hashed affinity window, then diverges with the
    agent's own accumulated turns."""
    rng = np.random.RandomState(seed)
    stem = list(rng.randint(0, 512, size=stem_len))
    return _turn_waves([stem] * n_agents, turns, turn_len, rng)


def affinity_run(n_replicas: int, policy: str, waves, *,
                 uniform=None) -> dict:
    """Drive sessioned turn-waves (and optionally a uniform stream) through
    the middleware under ``policy``; report hit rate + throughput."""
    # spill tuning per policy: hashed-LRU re-homes its whole (coarse) key
    # on every spill, so it needs a lax threshold to avoid thrash; radix
    # spills to the SECOND-longest prefix holder, so an eager threshold
    # spreads a shared-stem stampede without losing reuse
    spill = 2.0 if policy == "radix_affinity" else 4.0
    rh = Rhapsody(
        ResourceDescription(nodes=1, cores_per_node=64),
        policy=ExecutionPolicy(routing=policy, affinity_spill_factor=spill),
        n_workers=1)
    try:
        rs = rh.add_service(ServiceDescription(
            name="sess", replicas=n_replicas, factory=SessionedServicer))
        n_requests = 0
        total_tokens = 0
        t0 = time.perf_counter()
        if uniform is not None:  # uniform stream: one wave, no sessions
            waves = [uniform]
        for wave in waves:
            descs = [TaskDescription(kind=TaskKind.INFERENCE, service="sess",
                                     payload={"prompt": p},
                                     task_type="sessioned_inference")
                     for p in wave]
            uids = rh.submit(descs)
            if not rh.wait(uids, timeout=600):
                raise TimeoutError("sessioned stream timed out")
            n_requests += len(uids)
            total_tokens += sum(len(p) for p in wave)
        dt = time.perf_counter() - t0
        stats = rs.stats()
        hits, misses = stats["prefix_hits"], stats["prefix_misses"]
        per = [p["requests"] for p in stats["per_replica"]]
        return {"replicas": n_replicas, "policy": policy,
                "requests": n_requests, "seconds": dt,
                "req_per_s": n_requests / dt,
                "tok_per_s": total_tokens / dt,
                "hit_rate": hits / max(1, hits + misses),
                "per_replica_requests": per}
    finally:
        rh.close()


def affinity_sweep(replica_counts, *, n_sessions: int = 8, turns: int = 8,
                   n_uniform: int = 192, seed: int = 0, repeats: int = 3,
                   policies=("least_loaded", "prefix_affinity",
                             "radix_affinity")) -> list:
    """Each (stream, policy, replicas) cell reports the best of
    ``repeats`` runs (sleep-calibrated microbenchmarks; the routing
    decisions themselves are deterministic per run)."""
    streams = [
        ("sessioned", sessioned_prompts(n_sessions, turns, seed=seed), None),
        ("branching", branching_prompts(n_sessions, turns, seed=seed + 2),
         None),
        ("uniform", None,
         hetero_prompts(n_uniform, seed=seed + 1, lo=32, hi=224)),
    ]
    rows = []
    for n in replica_counts:
        n = max(1, n)
        for policy in policies:
            for stream, waves, uniform in streams:
                r = max((affinity_run(n, policy, waves, uniform=uniform)
                         for _ in range(repeats)),
                        key=lambda x: x["req_per_s"])
                r["stream"] = stream
                rows.append(r)
    return rows


def _print_affinity(rows):
    print("stream,replicas,policy,requests,req_per_s,tok_per_s,hit_rate,"
          "per_replica_requests")
    for r in rows:
        print(f"{r['stream']},{r['replicas']},{r['policy']},"
              f"{r['requests']},{r['req_per_s']:.0f},{r['tok_per_s']:.0f},"
              f"{r['hit_rate']:.2f},\"{r['per_replica_requests']}\"")


def _print_sweep(rows):
    base = rows[0]["req_per_s"]
    print("replicas,req_per_s,per_replica_req_per_s,speedup,"
          "p50_ms,p95_ms,p99_ms,per_replica_requests")
    for r in rows:
        print(f"{r['replicas']},{r['req_per_s']:.0f},"
              f"{r['req_per_s_per_replica']:.0f},"
              f"{r['req_per_s'] / base:.2f}x,"
              f"{r['p50_ms']:.1f},{r['p95_ms']:.1f},{r['p99_ms']:.1f},"
              f"\"{r['per_replica_requests']}\"")


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--replicas", type=int, nargs="+", default=None,
                    help="replica counts for the synthetic scaling sweep, "
                         "e.g. --replicas 1 2 4")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--routing", default="balanced", choices=tuple(ROUTERS))
    ap.add_argument("--affinity", action="store_true",
                    help="affinity routing sweep (radix longest-match vs "
                         "hashed-LRU vs least-loaded): sessioned, "
                         "branching (shared-stem agents), and uniform "
                         "streams; hit rate and throughput per replica "
                         "count")
    ap.add_argument("--sessions", type=int, default=8)
    ap.add_argument("--turns", type=int, default=8)
    ap.add_argument("--repeats", type=int, default=3,
                    help="best-of-N runs per cell (noise suppression)")
    ap.add_argument("--json", action="store_true",
                    help="emit rows as a JSON array instead of CSV")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the real-engine sweeps (cuda | "
                         "cpu); the synthetic sweeps touch no device")
    args = ap.parse_args(argv)
    if args.affinity:
        rows = affinity_sweep(args.replicas or (1, 2, 4),
                              n_sessions=args.sessions,
                              turns=args.turns,
                              n_uniform=args.requests,
                              repeats=max(1, args.repeats))
        print(json.dumps(rows)) if args.json else _print_affinity(rows)
    elif args.replicas:
        rows = replica_sweep(args.replicas, n_requests=args.requests,
                             routing=args.routing)
        print(json.dumps(rows)) if args.json else _print_sweep(rows)
    else:
        main(Reporter(), device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
