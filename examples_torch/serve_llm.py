"""Serve a small LM to batched requests through one replicated inference
service with router-driven dispatch, on the PyTorch port.

The counterpart of ``examples/serve_llm.py``: the same flags and printed
lines, plus ``--device`` (the engines run on the CUDA card unless it says
``cpu``).  The service is one name backed by ``--replicas`` engine
replicas; each request is an INFERENCE task that the middleware routes to
a replica by ``--routing`` (``random``, ``round_robin``, ``balanced``,
``least_loaded``, ``prefix_affinity``, ``radix_affinity``).

``--multi-model``: one replica set serves a "chat" model and a smaller
"draft" model; every request names its model and the router only
considers that group's replicas.  ``--speculative`` (implies
``--multi-model``): the draft group proposes ``--spec-k`` tokens a round
and every chat replica verifies them in one extend.  ``--paged`` /
``--no-paged`` (default: paged for the demo's dense config) choose the
block-paged engine or the slot pool; ``--block-size`` / ``--num-blocks``
size the paged pool, whose per-group telemetry is printed after the run.

Run: PYTHONPATH=src python examples_torch/serve_llm.py [--requests 24]
         [--replicas 2] [--device cpu]
     PYTHONPATH=src python examples_torch/serve_llm.py --multi-model
     PYTHONPATH=src python examples_torch/serve_llm.py --speculative --spec-k 4
"""
import argparse
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import (ExecutionPolicy, ResourceDescription, Rhapsody,
                              ServiceDescription, TaskDescription, TaskKind)
from repro_torch.core.router import ROUTERS
from repro_torch.device import resolve_device
from repro_torch.serving.client import llm_model_group, llm_service_factory


def main(argv=None) -> dict:
    """Serve the requests; returns the per-replica request counts, the
    results and the device."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--replicas", "--services", dest="replicas", type=int,
                    default=2)
    ap.add_argument("--routing", default="balanced", choices=tuple(ROUTERS))
    ap.add_argument("--multi-model", action="store_true",
                    help="serve a chat + draft model pair from ONE "
                         "replica set (weights 2:1), requests addressed "
                         "per model")
    ap.add_argument("--speculative", action="store_true",
                    help="arm cross-group speculative decoding on the "
                         "chat group (implies --multi-model): the draft "
                         "group proposes, chat replicas verify")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="draft proposals per speculative round")
    ap.add_argument("--paged", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="block-paged KV engine per replica (default auto: "
                         "ON for dense/moe configs; --no-paged forces the "
                         "slot pool)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="KV positions per physical block (paged)")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="physical KV blocks per replica; default matches "
                         "the slot pool's memory budget (paged)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engines (cuda | cpu)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config("rhapsody-demo")
    rh = Rhapsody(ResourceDescription(nodes=max(2, args.replicas),
                                      cores_per_node=16),
                  policy=ExecutionPolicy(routing=args.routing),
                  n_workers=2)
    model_names = []
    try:
        engine_kw = dict(max_num_seqs=4, max_len=256,
                         prefill_buckets=(32, 64, 128),
                         # None = auto-resolve per config (see LLMServicer)
                         paged=args.paged, block_size=args.block_size,
                         num_blocks=args.num_blocks, device=device)
        if args.multi_model or args.speculative:
            # two model configs, one service: the draft model is the same
            # family scaled down
            draft_cfg = cfg.scaled(n_layers=2, d_model=64, n_heads=4,
                                   n_kv_heads=2, head_dim=16, d_ff=128)
            if args.speculative:
                draft_group = llm_model_group(
                    "draft", draft_cfg, weight=1.0, role="draft",
                    paired_with="chat", min_replicas=0, **engine_kw)
                chat_group = llm_model_group(
                    "chat", cfg, weight=2.0, draft_group=draft_group,
                    spec_k=args.spec_k, **engine_kw)
                model_names = ["chat"]  # drafts propose, they don't serve
            else:
                draft_group = llm_model_group("draft", draft_cfg,
                                              weight=1.0, **engine_kw)
                chat_group = llm_model_group("chat", cfg, weight=2.0,
                                             **engine_kw)
                model_names = ["chat", "draft"]
            replica_set = rh.add_service(ServiceDescription(
                name="llm", replicas=max(2, args.replicas),
                models=[chat_group, draft_group], ready_timeout=600))
            print(f"launched multi-model llm service "
                  f"{replica_set.group_counts()}:", rh.services.list())
        else:
            replica_set = rh.add_service(ServiceDescription(
                name="llm", replicas=args.replicas, ready_timeout=600,
                factory=llm_service_factory(cfg, **engine_kw)))
            print(f"launched llm service x{args.replicas} replicas:",
                  rh.services.list())

        # heterogeneous prompt lengths -> token-aware routing matters
        rng = np.random.RandomState(0)
        lens = np.clip(np.exp(rng.normal(3.2, 0.7, args.requests)), 8,
                       120).astype(int)
        prompts = [list(rng.randint(0, cfg.vocab, size=int(L)))
                   for L in lens]

        def payload(i, p):
            out = {"prompt": p, "max_new_tokens": 16}
            if model_names:
                out["model"] = model_names[i % len(model_names)]
            return out

        descs = [TaskDescription(kind=TaskKind.INFERENCE, service="llm",
                                 payload=payload(i, p),
                                 task_type="inference")
                 for i, p in enumerate(prompts)]
        t0 = time.perf_counter()
        uids = rh.submit(descs)
        if not rh.wait(uids, timeout=600):
            raise TimeoutError("inference stream timed out")
        results = [rh.result(u) for u in uids]
        dt = time.perf_counter() - t0
        tokens = sum(len(r["tokens"]) + r["n_prompt"] for r in results)
        ttfts = [r["ttft_s"] for r in results if r["ttft_s"]]
        stats = replica_set.stats()
        per = [p["requests"] for p in stats["per_replica"]]
        print(f"served {len(results)} requests in {dt:.2f}s "
              f"({tokens / dt:.0f} tok/s, routing={args.routing})")
        print(f"mean TTFT {np.mean(ttfts) * 1e3:.0f} ms; "
              f"p95 latency "
              f"{np.percentile([r['latency_s'] for r in results], 95):.2f}s;"
              f" per-replica requests {per}")
        per_group = stats["per_group"]
        if model_names:
            print("per-model groups:",
                  {g: {"replicas": s["replicas"],
                       "requests": s["requests"], "cores": s["cores"]}
                   for g, s in per_group.items()})
        if args.speculative:
            print("speculative decode per group:",
                  {g: {"role": s.get("role"),
                       "proposed": s.get("proposed"),
                       "accepted": s.get("accepted"),
                       "acceptance": s.get("acceptance_rate")}
                   for g, s in per_group.items()})
        btel = {g: s.get("block_telemetry") for g, s in per_group.items()}
        if any(t is not None for t in btel.values()):
            print("paged-block telemetry per group:",
                  {g: {"free": t["free_blocks"], "total": t["total_blocks"],
                       "shared": t["shared_blocks"], "cow": t["cow_copies"]}
                   for g, t in btel.items() if t is not None})
        if args.routing == "prefix_affinity":
            hits, misses = stats["prefix_hits"], stats["prefix_misses"]
            print(f"prefix-affinity hit rate "
                  f"{hits / max(1, hits + misses):.2f} "
                  f"({hits} hits / {misses} misses)")
        return {"per_replica_requests": per, "results": results,
                "per_group": per_group, "device": str(device)}
    finally:
        rh.close()


if __name__ == "__main__":
    main()
