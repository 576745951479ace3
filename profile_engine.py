#!/usr/bin/env python3
"""Where a serving replica's time goes on the card: step times and a
``torch.profiler`` breakdown of one of the port's engines.

    python3 profile_engine.py [--arch ARCH] [--engines N] [--trace PATH]

One ``InferenceEngine`` (no middleware) with a full published config and
random weights from seed 0: by default the main path's llama3.2-3b on the
paged engine, with ``chip_smoke.py`` phase 8's settings and prompt
lengths; with ``--arch rwkv6-1.6b`` or ``zamba2-2.7b`` the slot pool with
phases 10-11's settings and prompt lengths; with ``--arch whisper-small``
or ``internvl2-1b`` the slot pool with phase 28's settings and phase 8's
prompt lengths.  Eight requests of 32 new
tokens.  It serves the requests twice: the first pass is cold (first calls of
every kernel and matmul shape), the second warm.  Every step ends in
``torch.cuda.synchronize()``, so step times are device-complete.  The
profiler then records a few warm decode steps and prints the CUDA and CPU
totals by operator, and the device's busy share of the window.  With
``--engines N`` it last serves a warm pass on N engines at once, each
stepping in its own thread as the replicas of one ``Rhapsody`` process
do, to show what they cost each other.  Prints one JSON line per part;
needs a CUDA card.
"""
import argparse
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from chip_smoke import (ENCDEC_VLM_ARCHS, ENCDEC_VLM_ENGINE,  # noqa: E402
                        MAIN_PATH_ARCH, MAIN_PATH_ENGINE,
                        MAIN_PATH_NEW_TOKENS, STATE_ARCHS, STATE_ENGINE,
                        main_path_prompt_lens, state_prompt_lens)

REQUESTS = MAIN_PATH_ENGINE["max_num_seqs"]  # every decode step a full batch


def emit(obj):
    print(json.dumps(obj), flush=True)


def serve_once(torch, eng, prompts, mnt):
    """Submit every prompt, step to completion; per-step wall times split
    by what the step ran."""
    for p in prompts:
        eng.submit(p, max_new_tokens=mnt)
    steps = []
    while eng.has_work():
        d0, p0 = eng.stats.decode_steps, eng.stats.prefill_tokens
        t0 = time.perf_counter()
        eng.step()
        eng.collect_finished()
        torch.cuda.synchronize()
        steps.append({"s": time.perf_counter() - t0,
                      "decode": eng.stats.decode_steps - d0,
                      "prefill_tokens": eng.stats.prefill_tokens - p0})
    decode_only = [s["s"] for s in steps
                   if s["decode"] and not s["prefill_tokens"]]
    return {"steps": len(steps), "seconds": sum(s["s"] for s in steps),
            "decode_only_steps": len(decode_only),
            "decode_step_ms_median": 1e3 * float(np.median(decode_only))
            if decode_only else None,
            "step_ms": [round(1e3 * s["s"], 3) for s in steps]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=MAIN_PATH_ARCH,
                    choices=(MAIN_PATH_ARCH,) + STATE_ARCHS
                    + ENCDEC_VLM_ARCHS)
    ap.add_argument("--engines", type=int, default=1,
                    help="also serve a warm pass on N engines in N threads")
    ap.add_argument("--trace", default=None,
                    help="also write a chrome trace of the profiled window")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_engine: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.serving.engine import make_engine_from_scratch

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    emit({"device": smi, "torch": torch.__version__})
    cfg = get_config(args.arch)
    mnt = MAIN_PATH_NEW_TOKENS
    rng = np.random.RandomState(0)
    if args.arch == MAIN_PATH_ARCH:
        engine_kw = MAIN_PATH_ENGINE
        lens = main_path_prompt_lens(rng, REQUESTS)
    elif args.arch in ENCDEC_VLM_ARCHS:
        engine_kw = ENCDEC_VLM_ENGINE[args.arch]
        lens = main_path_prompt_lens(rng, REQUESTS)
    else:
        engine_kw = STATE_ENGINE
        lens = state_prompt_lens(rng, args.arch, 2 * REQUESTS)[:REQUESTS]
    eng = make_engine_from_scratch(cfg, seed=0, device="cuda", **engine_kw)
    torch.cuda.synchronize()
    prompts = [list(map(int, rng.randint(0, cfg.vocab, size=int(n))))
               for n in lens]
    emit({"pass": "cold", **serve_once(torch, eng, prompts, mnt)})
    # fresh prompts so the warm pass does not resume resident prefixes
    prompts = [list(map(int, rng.randint(0, cfg.vocab, size=int(n))))
               for n in lens]
    emit({"pass": "warm", **serve_once(torch, eng, prompts, mnt)})

    # profile a window of warm decode steps at batch len(prompts)
    for p in prompts:
        eng.submit(p, max_new_tokens=mnt)
    while any(r.pending_tokens for r in eng.running.values()) or eng.queue:
        eng.step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    n_steps = 5
    ops.launches = ops.contiguous_launches = 0
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    ka = prof.key_averages()

    def dev_us(e):
        return getattr(e, "device_time_total",
                       getattr(e, "cuda_time_total", 0.0))

    rows = sorted(ka, key=dev_us, reverse=True)
    # device-side events (kernels, copies) carry no CPU time of their own
    kernel_rows = [e for e in ka
                   if dev_us(e) > 0 and e.self_cpu_time_total == 0]
    device_us = sum(dev_us(e) for e in kernel_rows)
    emit({"arch": args.arch, "profile_window_s": window,
          "decode_steps": n_steps,
          "decode_launches": {"paged": ops.launches,
                              "contiguous": ops.contiguous_launches},
          "device_kernel_us": device_us,
          "device_busy_share": device_us / (window * 1e6),
          "top_device": [{"name": e.key[:80], "us": dev_us(e),
                          "calls": e.count} for e in rows[:15]],
          "top_cpu": [{"name": e.key[:80], "self_cpu_us":
                       e.self_cpu_time_total, "calls": e.count}
                      for e in sorted(ka, key=lambda e: e.self_cpu_time_total,
                                      reverse=True)[:12]]})
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)),
                    exist_ok=True)
        prof.export_chrome_trace(args.trace)

    if args.engines > 1:
        eng.run()  # drain the profiled requests
        engines = [eng] + [make_engine_from_scratch(
            cfg, seed=0, device="cuda", **engine_kw)
            for _ in range(args.engines - 1)]
        for e in engines[1:]:  # warm the new engines one at a time
            serve_once(torch, e, prompts, mnt)
        fresh = [[list(map(int, rng.randint(0, cfg.vocab, size=int(n))))
                  for n in lens] for _ in engines]
        out = [None] * len(engines)

        def work(i):
            out[i] = serve_once(torch, engines[i], fresh[i], mnt)

        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(len(engines))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        emit({"pass": f"warm x {len(engines)} engines in threads",
              "seconds": wall,
              "gen_tok_per_s": len(engines) * len(prompts) * mnt / wall,
              "per_engine_decode_step_ms_median": [
                  o["decode_step_ms_median"] for o in out]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
