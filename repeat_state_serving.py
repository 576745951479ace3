#!/usr/bin/env python3
"""Run ``chip_smoke.py`` phases 10-11 (rwkv6-1.6b and zamba2-2.7b at full
width, two slot-pool replicas in one process) several times over.

    python3 repeat_state_serving.py [--runs N]

Each run is the phase itself (``chip_smoke.phase_state_serving``): it fails
on a replica that crashed and was relaunched, printing the traceback, and
on a kernel launch count other than the phase's.  One JSON line a run
(the launch counts, decode steps and pass times); a failed run prints its
message and the script goes on to the next.  Needs a CUDA card.
"""
import argparse
import concurrent.futures
import gc
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("repeat_state_serving: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import configs, core
    from repro_torch.kernels.decode_attention import kernel, ops
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.mamba2 import kernel as ssd_kernel
    from repro_torch.kernels.mamba2 import ops as ssd_ops
    from repro_torch.kernels.rwkv6 import kernel as wkv_kernel
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    from repro_torch.serving import client

    chip_smoke.COUNTERS.update({
        "paged_decode_attention": (ops, "launches"),
        "decode_attention": (ops, "contiguous_launches"),
        "flash_attention": (fa, "launches"),
        "wkv6": (wkv_ops, "launches"),
        "ssd": (ssd_ops, "launches"),
    })
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"device": smi, "torch": torch.__version__}),
          flush=True)
    loaders = (kernel.load, fa_kernel.load, wkv_kernel.load, ssd_kernel.load)
    with concurrent.futures.ThreadPoolExecutor(len(loaders)) as pool:
        for fut in [pool.submit(load) for load in loaders]:
            fut.result()
    failed = 0
    for run in range(args.runs):
        for arch in chip_smoke.STATE_ARCHS:
            try:
                rec = chip_smoke.phase_state_serving(torch, configs, core,
                                                     client, arch)
                print(json.dumps({"run": run, "arch": arch, "ok": True,
                                  "launches": rec["launches"],
                                  "decode_steps": rec["decode_steps"],
                                  "prefills": rec["prefills"],
                                  "cold_s": rec["cold"]["seconds"],
                                  "warm_s": rec["warm"]["seconds"]}),
                      flush=True)
            except SystemExit as e:
                failed += 1
                print(json.dumps({"run": run, "arch": arch, "ok": False,
                                  "error": str(e)}), flush=True)
            gc.collect()
            torch.cuda.empty_cache()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
