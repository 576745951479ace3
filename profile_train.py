#!/usr/bin/env python3
"""Where a training step's time goes on the card: step times and a
``torch.profiler`` split of one llama3.2-3b step.

    python3 profile_train.py [--steps N] [--trace PATH]

Builds the training main path of ``chip_smoke.py`` phase 16 with its
``train_main_path`` (llama3.2-3b
full published config, bf16, remat full, random weights from seed 0,
global batch 2 x seq 2048 from the synthetic corpus, AdamW) and runs
``--steps`` steps, each ending in ``torch.cuda.synchronize()``, so step
times are device-complete.  It then times a step's two halves (loss and
gradient; AdamW), each ending in a synchronize, and profiles one more step:
the device time of the spans (``train/forward_backward``,
``train/optimizer``, ``flash_attention/backward``), the kernel time by
class (the flash kernel, float32 GEMMs, bf16 GEMMs, everything else; the
attention backward's float32 GEMMs are counted both in its span and among
the GEMMs), and the device's busy share of the window.  Prints one JSON
line per part; needs a CUDA card.
"""
import argparse
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from chip_smoke import (TRAIN_BATCH, TRAIN_SEQ,  # noqa: E402
                        train_main_path)

SPANS = ("train/forward_backward", "train/optimizer",
         "flash_attention/backward")
GEMM = re.compile(r"gemm|xmma|nvjet|cutlass|gemv", re.I)
GEMM_F32 = re.compile(r"f32f32|sgemm", re.I)  # float32 operands


def emit(obj):
    print(json.dumps(obj), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3,
                    help="timed steps before the profiled one")
    ap.add_argument("--trace", default=None,
                    help="also write a chrome trace of the profiled step")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.training.optim import (adamw_update, tree_leaves,
                                            tree_unflatten)

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    emit({"device": smi, "torch": torch.__version__})
    cfg, api, tcfg, data, state, step = train_main_path()
    opt = tcfg.optimizer
    times = []
    for _ in range(args.steps):
        batch = data.next_batch()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    warm = sorted(times[1:] or times)
    emit({"steps": args.steps, "step_s": times,
          "warm_step_median_s": warm[len(warm) // 2],
          "tok_per_s": TRAIN_BATCH * TRAIN_SEQ / warm[len(warm) // 2],
          "loss": float(m["loss"]),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})

    # the step's two halves, each ending in a synchronize
    params = state["params"]
    leaves = tree_leaves(params)
    batch = data.next_batch()
    t0 = time.perf_counter()
    loss, _ = api.loss(params, batch, cfg)
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    adamw_update(tree_unflatten(params, grads), state["opt"], params, opt)
    torch.cuda.synchronize()
    emit({"forward_backward_s": t1 - t0,
          "optimizer_s": time.perf_counter() - t1})
    del grads, loss

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    batch = data.next_batch()
    fa.launches = 0
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    ka = prof.key_averages()

    def dev_us(e):
        return getattr(e, "device_time_total",
                       getattr(e, "cuda_time_total", 0.0))

    # device-side events (kernels, copies) carry no CPU time of their own;
    # the spans' device-side rows are not kernels
    kernels = [e for e in ka if dev_us(e) > 0 and e.self_cpu_time_total == 0
               and e.key not in SPANS]
    device_us = sum(dev_us(e) for e in kernels)
    classes = {"flash_fwd": 0.0, "gemm_f32": 0.0, "gemm_bf16": 0.0,
               "other": 0.0}
    for e in kernels:
        if "flash_fwd" in e.key:
            classes["flash_fwd"] += dev_us(e)
        elif GEMM.search(e.key):
            f32 = GEMM_F32.search(e.key)
            classes["gemm_f32" if f32 else "gemm_bf16"] += dev_us(e)
        else:
            classes["other"] += dev_us(e)
    spans = {e.key: dev_us(e) for e in ka if e.key in SPANS}
    emit({"profile_window_s": window, "flash_launches": fa.launches,
          "device_kernel_us": device_us,
          "device_busy_share": device_us / (window * 1e6),
          "span_device_us": spans, "kernel_class_us": classes,
          "top_device": [{"name": e.key[:80], "us": dev_us(e),
                          "calls": e.count}
                         for e in sorted(kernels, key=dev_us,
                                         reverse=True)[:15]]})
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)),
                    exist_ok=True)
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
