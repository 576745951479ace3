"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

The PyTorch port of the JAX package's launcher: the same flags and output
lines, plus ``--device`` (default ``cuda``; ``cpu`` on request).

Brings up ONE replicated inference service (``--replicas N``) through the
RHAPSODY middleware and drives a synthetic request stream as INFERENCE
tasks, so every request is routed to a replica by the policy router
(``--routing``: random | round_robin | balanced | least_loaded |
prefix_affinity).  With ``prefix_affinity``, requests sharing a prompt
prefix stick to one replica (``--affinity-prefix-len`` tokens hashed into
the session key, spilling to the least-loaded replica past
``--affinity-spill-factor``), and the engines skip prefill for resident
prefixes; per-replica ``prefix_hits``/``prefix_misses`` are reported.
Replicas claim cores from the middleware's resource ledger
(admission-controlled), ``--warmup`` primes each replica before it becomes
routable, and ``--autoscale`` turns on the pluggable autoscaler
(``--autoscaler queue_depth|latency_slo|weighted_capacity``,
``--slo-p95-ms`` target) bounded by the partition's free capacity.

``--models NAME:WEIGHT [NAME:WEIGHT ...]`` launches a MULTI-MODEL set:
several model groups behind the one service name, each replica tagged with
its group, requests addressed by tagging the payload (``{"model": ...}``)
so the router only considers that group's replicas.  ``--replicas`` then
names the TOTAL, split across groups proportionally to weight; a two-model
launch is just::

    python -m repro_torch.launch.serve --smoke --models chat:2 draft:1 \
        --replicas 3 --requests 24

``--disagg`` launches DISAGGREGATED serving instead: ``--replicas`` is
split into a prefill pool (large chunked-prefill budget, no decode
interleave; ``--prefill-replicas`` overrides the half-split) and a decode
pool behind one service name.  Every request is addressed to the prefill
group; on first token the sequence's paged KV blocks are exported and
imported into a decode replica (recompute fallback when its pool is
full), and per-phase TTFT/ITL p95s are reported per group.

Reports aggregate + per-replica (and per-group) throughput, latency, and
utilization — the runnable end of the inference-at-scale path the dry-run
lowers at production shapes.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.core import (ExecutionPolicy, ResourceDescription, Rhapsody,
                              ServiceDescription, TaskDescription, TaskKind)
from repro_torch.core.router import ROUTERS
from repro_torch.device import resolve_device
from repro_torch.serving.client import llm_model_group, llm_service_factory


def main(argv=None) -> dict:
    """Run the launcher; returns the results, each replica's error (None
    when it served cleanly), the decode steps and the handoff counters, so
    a caller can check the run."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rhapsody-demo",
                    choices=list_archs() + ["rhapsody-demo"])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--replicas", "--services", dest="replicas", type=int,
                    default=2, help="service replica count (scaling unit)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--max-num-seqs", type=int, default=4)
    ap.add_argument("--max-num-batched-tokens", type=int, default=512)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--paged", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="block-paged KV cache: admission by free-block "
                         "count, chunked prefill, copy-on-write prefix "
                         "sharing, direct paged decode.  Default: auto "
                         "(ON for dense/moe archs, slot pool otherwise); "
                         "--no-paged forces the slot pool")
    ap.add_argument("--block-size", type=int, default=16,
                    help="KV positions per physical block (--paged)")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="physical KV blocks; default matches the slot "
                         "pool's memory budget (--paged)")
    ap.add_argument("--routing", default="balanced",
                    choices=tuple(ROUTERS))
    ap.add_argument("--affinity-prefix-len", type=int, default=32,
                    help="prompt tokens hashed into the sticky-session key "
                         "(prefix_affinity routing)")
    ap.add_argument("--affinity-spill-factor", type=float, default=2.0,
                    help="sticky replica sheds load when its queue exceeds "
                         "factor * (min depth + 1); <=0 never spills")
    ap.add_argument("--warmup", action="store_true",
                    help="prime each replica (compile + a token of decode) "
                         "before the router may route to it")
    ap.add_argument("--autoscale", action="store_true",
                    help="let the autoscaler grow/shrink the replica set "
                         "within the partition's free capacity")
    ap.add_argument("--autoscaler", default="queue_depth",
                    choices=("queue_depth", "latency_slo",
                             "weighted_capacity"))
    ap.add_argument("--slo-p95-ms", type=float, default=250.0,
                    help="latency_slo autoscaler: p95 end-to-end target")
    ap.add_argument("--models", nargs="*", metavar="NAME:WEIGHT",
                    help="serve SEVERAL model groups from one replica set "
                         "(e.g. --models chat:2 draft:1); --replicas "
                         "becomes the total, split by weight")
    ap.add_argument("--disagg", action="store_true",
                    help="disaggregated serving: split --replicas into a "
                         "prefill pool (large chunked-prefill budget, no "
                         "decode interleave) and a decode pool; sequences "
                         "migrate on first token via a paged-KV handoff. "
                         "Requires the paged cache; incompatible with "
                         "--models")
    ap.add_argument("--prefill-replicas", type=int, default=None,
                    help="--disagg: prefill pool size (default: half of "
                         "--replicas, at least 1)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the replicas run on (cuda | cpu)")
    args = ap.parse_args(argv)
    if args.disagg and args.models:
        ap.error("--disagg and --models are mutually exclusive")
    if args.disagg and args.paged is False:
        ap.error("--disagg requires the paged KV cache (drop --no-paged)")
    device = resolve_device(args.device)

    cfg = (get_smoke_config(args.arch)
           if args.smoke or args.arch != "rhapsody-demo"
           else get_config(args.arch))
    rh = Rhapsody(ResourceDescription(nodes=args.replicas,
                                      cores_per_node=16),
                  policy=ExecutionPolicy(
                      routing=args.routing,
                      affinity_prefix_len=args.affinity_prefix_len,
                      affinity_spill_factor=args.affinity_spill_factor,
                      warmup=args.warmup,
                      autoscale=args.autoscale,
                      autoscaler=args.autoscaler,
                      autoscale_max_replicas=max(4, args.replicas),
                      slo_p95_ms=args.slo_p95_ms),
                  n_workers=2)
    engine_kw = dict(max_num_seqs=args.max_num_seqs,
                     max_num_batched_tokens=args.max_num_batched_tokens,
                     max_len=args.max_len, prefill_buckets=(16, 32, 64),
                     # None = auto: LLMServicer resolves to paged for
                     # dense/moe, slot pool for state-carrying families
                     paged=args.paged, block_size=args.block_size,
                     num_blocks=args.num_blocks, device=device)
    model_names: list = []
    try:
        if args.disagg:
            n_pre = args.prefill_replicas or max(1, args.replicas // 2)
            n_dec = max(1, args.replicas - n_pre)
            disagg_kw = dict(engine_kw, paged=True)
            groups = [
                llm_model_group(
                    "prefill", cfg, role="prefill", paired_with="decode",
                    replicas=n_pre, slo_p95_ms=args.slo_p95_ms,
                    **dict(disagg_kw,
                           # prefill replicas never interleave decode: the
                           # whole prompt in as few chunks as possible
                           max_num_batched_tokens=max(
                               args.max_num_batched_tokens, args.max_len))),
                llm_model_group(
                    "decode", cfg, role="decode", replicas=n_dec,
                    slo_p95_ms=args.slo_p95_ms, **disagg_kw),
            ]
            replica_set = rh.add_service(ServiceDescription(
                name="llm", replicas=args.replicas, models=groups))
            print(f"[serve] {cfg.name} disaggregated "
                  f"{replica_set.group_counts()} ready:",
                  rh.services.list())
        elif args.models:
            groups = []
            for spec in args.models:
                name, _, w = spec.partition(":")
                groups.append(llm_model_group(
                    name, cfg, weight=float(w) if w else 1.0, **engine_kw))
            model_names = [g.name for g in groups]
            replica_set = rh.add_service(ServiceDescription(
                name="llm", replicas=args.replicas, models=groups))
            print(f"[serve] {cfg.name} x {args.replicas} replicas "
                  f"across groups {replica_set.group_counts()} ready:",
                  rh.services.list())
        else:
            replica_set = rh.add_service(ServiceDescription(
                name="llm", replicas=args.replicas,
                factory=llm_service_factory(cfg, **engine_kw)))
            print(f"[serve] {cfg.name} x {args.replicas} replicas ready:",
                  rh.services.list())

        rng = np.random.RandomState(0)
        lens = np.clip(np.exp(rng.normal(3.0, 0.7, args.requests)), 4,
                       args.max_len - args.max_new_tokens - 1).astype(int)
        prompts = [list(rng.randint(0, cfg.vocab, size=int(L)))
                   for L in lens]

        def payload(i, p):
            out = {"prompt": p, "max_new_tokens": args.max_new_tokens}
            if args.disagg:  # clients address the prefill pool; the set
                #              migrates each sequence to a decode replica
                #              on first token
                out["model"] = "prefill"
            elif model_names:  # address models round-robin across stream
                out["model"] = model_names[i % len(model_names)]
            return out

        descs = [TaskDescription(kind=TaskKind.INFERENCE, service="llm",
                                 payload=payload(i, p),
                                 task_type="inference")
                 for i, p in enumerate(prompts)]
        t0 = time.perf_counter()
        uids = rh.submit(descs)
        if not rh.wait(uids, timeout=1200):
            raise TimeoutError("inference stream timed out")
        results = [rh.result(u) for u in uids]
        dt = time.perf_counter() - t0
        tokens = sum(len(r["tokens"]) + r["n_prompt"] for r in results)
        lat = sorted(r["latency_s"] for r in results)
        stats = replica_set.stats()
        utils = [inst.servicer.stats.utilization
                 for inst in replica_set.instances]
        print(f"[serve] {len(results)} requests, {dt:.2f}s, "
              f"{tokens / dt:.0f} tok/s, routing={args.routing}")
        print(f"[serve] latency p50 {lat[len(lat) // 2]:.2f}s "
              f"p95 {lat[int(len(lat) * 0.95)]:.2f}s; "
              f"mean slot-utilization {np.mean(utils):.2f}")
        print("[serve] per-replica requests:",
              [p["requests"] for p in stats["per_replica"]])
        btel = {g: s.get("block_telemetry")
                for g, s in stats["per_group"].items()}
        if any(t is not None for t in btel.values()):
            print("[serve] paged-block telemetry per group:",
                  {g: {"free": t["free_blocks"], "total": t["total_blocks"],
                       "shared": t["shared_blocks"],
                       "cow": t["cow_copies"]}
                   for g, t in btel.items() if t is not None})
        if args.disagg:
            handed = sum(1 for r in results if r.get("handoff"))
            print(f"[serve] disagg: {handed}/{len(results)} sequences "
                  f"migrated prefill->decode; handoff totals:",
                  replica_set.handoff_totals())
            print("[serve] per-phase groups:",
                  {g: {"replicas": s["replicas"],
                       "role": s["role"],
                       "requests": s["requests"],
                       "ttft_p95_ms": s["ttft_p95_ms"]
                       and round(s["ttft_p95_ms"], 1),
                       "itl_p95_ms": s["itl_p95_ms"]
                       and round(s["itl_p95_ms"], 1)}
                   for g, s in stats["per_group"].items()})
        if model_names:
            print("[serve] per-model groups:",
                  {g: {"replicas": s["replicas"],
                       "requests": s["requests"],
                       "cores": s["cores"],
                       "p95_ms": s["latency_p95_ms"]
                       and round(s["latency_p95_ms"], 1)}
                   for g, s in stats["per_group"].items()})
        ledger = rh.utilization()
        print("[serve] shared ledger:",
              {k: {"cores": round(v["cores"], 2),
                   "service_cores": v["service_cores"],
                   "service_replicas": v["service_replicas"]}
               for k, v in ledger.items()},
              f"admission_denied={stats['admission_denied']}")
        if args.routing == "prefix_affinity":
            hits, misses = stats["prefix_hits"], stats["prefix_misses"]
            reuse = [inst.servicer.stats.prefix_cached_tokens
                     for inst in replica_set.instances]
            print(f"[serve] prefix-affinity: {hits} hits / {misses} misses "
                  f"(rate {hits / max(1, hits + misses):.2f}); "
                  f"engine prefill tokens skipped per replica: {reuse}")
        return {"results": results,
                "errors": [inst.error for inst in replica_set.instances],
                "decode_steps": sum(inst.servicer.stats.decode_steps
                                    for inst in replica_set.instances),
                "handoff_totals": replica_set.handoff_totals(),
                "seconds": dt}
    finally:
        rh.close()


if __name__ == "__main__":
    main()
