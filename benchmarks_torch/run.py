"""The port's benchmark runner: the paper's workflow experiments on the
PyTorch port.

    python -m benchmarks_torch.run [--only SUITE ...] [--device cuda|cpu]

Prints ``name,us_per_call,derived`` CSV rows and writes
``results/benchmarks_torch.json``.  The suites are the reference's
(``benchmarks/run.py``) that run workflow payloads:

  exp1_scaling        Fig. 3  scaling of no-op task dispatch (weak/strong)
  exp2_heterogeneity  Fig. 4  heterogeneity width
  exp3_inference      Fig. 5a,b inference-at-scale throughput/utilization
  exp4_routing        Fig. 5c,d batching sensitivity + routing policies
  exp5_coupling       Fig. 6  coupled AI-HPC data exchange
  exp6_agentic        Fig. 7  agent decision rate vs ARR
  kernels             the hand-written kernels at the reference's shapes
                      (on the CPU: their plain versions, ``..._plain``)
  roofline            one H100's roofline per arch x shape, read from
                      the dry-run's records (``results/dryrun_torch.json``,
                      written by ``repro_torch.launch.dryrun``)

Payloads, engines and kernels run on ``--device``: the CUDA card unless
the caller asks for the CPU.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.device import resolve_device

from . import (bench_agentic, bench_coupling, bench_heterogeneity,
               bench_inference_scaling, bench_kernels, bench_roofline,
               bench_routing, bench_scaling)
from .common import Reporter

SUITES = {  # (reporter, device) -> the suite's JSON payload
    "exp1_scaling": lambda rep, device: bench_scaling.main(rep),  # no-ops
    "exp2_heterogeneity": bench_heterogeneity.main,
    "exp3_inference": bench_inference_scaling.main,
    "exp4_routing": bench_routing.main,
    "exp5_coupling": bench_coupling.main,
    "exp6_agentic": bench_agentic.main,
    "kernels": bench_kernels.main,
    "roofline": bench_roofline.main,  # reads records counted on meta
}


def run_suites(rep: Reporter, only=None, device=None):
    """Run the suites named in ``only`` (all when None) -> (payload,
    [(suite, error repr)] of the suites that failed)."""
    dev = resolve_device(device)
    unknown = sorted(set(only or ()) - set(SUITES))
    if unknown:
        raise ValueError(f"unknown suites {unknown}; known: {list(SUITES)}")
    payload, failures = {}, []
    for name, fn in SUITES.items():
        if only and name not in only:
            continue
        try:
            payload[name] = fn(rep, device=dev)
        except Exception as e:  # noqa: BLE001 — keep the suite running
            failures.append((name, repr(e)))
            rep.add(f"{name}_FAILED", 0.0, repr(e)[:120])
    return payload, failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*", default=None,
                    help="subset of suites to run")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the payloads, the LLM services "
                         "and the kernels (cuda | cpu)")
    args = ap.parse_args(argv)
    rep = Reporter()
    print("name,us_per_call,derived")
    payload, failures = run_suites(rep, args.only, args.device)
    rep.save_json(payload)
    if failures:
        print(f"# {len(failures)} suite(s) failed", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
