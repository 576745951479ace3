#!/usr/bin/env python3
"""Where one traced run of a cell spends its device and idle time, read
from the program's own spans (``repro_torch/spans.py``).

    python3 perfbench/tools/span_breakdown.py --workload <cell> \
        --seed <n> [--seconds 50]

from the root of a checkout, on a CUDA card.  It runs the cell as
``perfbench/run.py --trace 1`` does (``harness.run_cell``: the profiler
over the window's first 6 s, in the engine's thread), keeps the traced
part's events and prints one JSON object as its last line:

* ``correct``, ``metrics``, ``device``, ``breakdown``: the run's own;
* ``window_s``, ``busy_s``, ``idle_pct``;
* ``spans``: for each of ``SPANS``, the ranges recorded, their host
  seconds, the device seconds launched inside them (the union of that
  work's intervals, so that kernels whose stamps overlap count once, as
  in ``busy_s``) and the launches;
* ``unembed_share`` (%): ``model/unembed``'s device time over busy;
* ``extend_us_per_token``: ``engine/extend``'s device microseconds per
  prompt token fed while tracing (``EngineStats.prefill_tokens`` taken
  where the profiler starts and stops);
* ``step_idle_ms``: the mean over ``engine/step`` ranges of each range's
  length less its overlap with the device's busy intervals;
* ``idle_split_s``: the idle time between the first and the last busy
  interval, inside ``engine/step``, inside ``servicer/step`` but outside
  every ``engine/step``, and outside both (the ``ServiceInstance`` loop);
* ``middleware_ms``: means over the window's answered requests of the
  client latency less the servicer's ``latency_s`` (the benchmark's
  ``middleware_ms``), of the results' ``handoff_s`` and ``queue_s``, and
  of ``delivery`` = the first less ``handoff_s`` (finish to the client).

No cell runs it: it reads what a traced run holds and adds no metric.
"""
from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[2]

SPANS = ("servicer/step", "engine/step", "engine/extend", "engine/decode",
         "model/unembed")


def intersect_ns(a, b) -> int:
    """Length of the intersection of two sorted disjoint interval lists."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def overlap_ns(busy, starts, s, e) -> int:
    """Overlap of ``[s, e]`` with sorted disjoint ``busy`` (``starts``
    its interval starts)."""
    i, total = max(0, bisect.bisect_right(starts, s) - 1), 0
    while i < len(busy) and busy[i][0] < e:
        total += max(0, min(e, busy[i][1]) - max(s, busy[i][0]))
        i += 1
    return total


def host_ranges(host, name):
    return sorted((s, e) for n, s, e, _, _, kind in host
                  if n == name and kind == "op")


def launched_inside(device, host, name):
    """The device work launched inside host ranges ``name``, chosen as
    ``trace.range_device_ns`` chooses it: its runtime call lies inside
    such a range on its thread, or the profiler linked it to the range."""
    ranges = sorted((s, e, th, corr) for n, s, e, th, corr, kind in host
                    if n == name and kind == "op")
    starts = [r[0] for r in ranges]
    own = {r[3] for r in ranges}
    launched = set()
    for _, s, _, th, corr, kind in host:
        i = bisect.bisect_right(starts, s) - 1
        if kind == "runtime" and i >= 0 and ranges[i][1] >= s \
                and ranges[i][2] == th:
            launched.add(corr)
    return [d for d in device if d[3] in launched or d[4] in own]


def reduce(device, host, window_s: float, prefill_tokens=None) -> dict:
    """The breakdown's device numbers from ``trace.from_profiler`` tuples;
    ``prefill_tokens`` is the prompt tokens fed while tracing."""
    from perfbench import trace

    busy = trace.merge((d[1], d[2]) for d in device)
    busy_ns = sum(e - s for s, e in busy)
    out = {"window_s": window_s, "busy_s": busy_ns / 1e9,
           "idle_pct": (100.0 * (1 - busy_ns / 1e9 / window_s)
                        if window_s > 0 else None),
           "spans": {}}
    for name in SPANS:
        ranges = host_ranges(host, name)
        work = launched_inside(device, host, name)
        ns = sum(e - s for s, e in trace.merge((d[1], d[2]) for d in work))
        out["spans"][name] = {"ranges": len(ranges),
                              "host_s": sum(e - s for s, e in ranges) / 1e9,
                              "device_s": ns / 1e9, "launches": len(work)}
    sp = out["spans"]
    out["unembed_share"] = (100.0 * sp["model/unembed"]["device_s"]
                            / out["busy_s"] if busy_ns else None)
    out["extend_us_per_token"] = (
        1e6 * sp["engine/extend"]["device_s"] / prefill_tokens
        if prefill_tokens else None)
    steps = host_ranges(host, "engine/step")
    starts = [b[0] for b in busy]
    out["step_idle_ms"] = (
        sum((e - s) - overlap_ns(busy, starts, s, e) for s, e in steps)
        / len(steps) / 1e6 if steps else None)
    gaps = [[a, b] for (_, a), (b, _) in zip(busy, busy[1:])]
    in_step = trace.merge(steps)
    in_any = trace.merge(steps + host_ranges(host, "servicer/step"))
    gap_ns = sum(b - a for a, b in gaps)
    step_ns, any_ns = intersect_ns(gaps, in_step), intersect_ns(gaps, in_any)
    out["idle_split_s"] = {"gaps": gap_ns / 1e9,
                           "engine/step": step_ns / 1e9,
                           "servicer/step only": (any_ns - step_ns) / 1e9,
                           "outside": (gap_ns - any_ns) / 1e9}
    return out


def middleware(completions) -> dict:
    """Means, in ms, over answered requests: ``middleware_ms``'s
    difference and its parts."""
    rows = [(c["latency"] - c["result"]["latency_s"],
             c["result"].get("handoff_s"), c["result"].get("queue_s"))
            for c in completions if c["result"] is not None]
    out = {}
    for key, i in (("middleware", 0), ("handoff", 1), ("queue", 2)):
        vals = [r[i] for r in rows if r[i] is not None]
        out[key] = 1e3 * sum(vals) / len(vals) if vals else None
    pairs = [r[0] - r[1] for r in rows if r[1] is not None]
    out["delivery"] = 1e3 * sum(pairs) / len(pairs) if pairs else None
    return out


def breakdown(root, name: str, seed: int, seconds: float, **kw) -> dict:
    """One traced run of cell ``name`` through ``harness.run_cell``, with
    its span breakdown."""
    from perfbench import harness, trace

    got = {"prefill": [], "windows": []}
    summarize = trace.summarize

    def keep(prof, window_s, ranges=()):
        got["device"], got["host"] = trace.from_profiler(prof)
        got["window_s"] = window_s
        return summarize(prof, window_s, ranges)

    class Snapshots(harness._EngineThread):
        """Takes ``prefill_tokens`` where the profiler starts and stops
        (a start or stop asked for between this read and the harness's
        own goes unseen, and the per-token figure reads nothing)."""

        def wrap(self, servicer):
            super().wrap(servicer)
            traced = servicer.step

            def step():
                want = self.want
                if want == "start" or (want == "stop" and self.tracing):
                    got["prefill"].append(self.engine.stats.prefill_tokens)
                return traced()

            servicer.step = step

    class Kept(harness.Window):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            got["windows"].append(self)

    with mock.patch.object(trace, "summarize", keep), \
            mock.patch.object(harness, "_EngineThread", Snapshots), \
            mock.patch.object(harness, "Window", Kept):
        res = harness.run_cell(root, name, seed, seconds, True, **kw)
    out = {"workload": name, "seed": seed, "correct": res["correct"],
           "metrics": res["metrics"], "device": res["device"],
           "breakdown": res.get("breakdown")}
    if "device" in got:
        fed = got["prefill"]
        out.update(reduce(got["device"], got["host"], got["window_s"],
                          fed[1] - fed[0] if len(fed) == 2 else None))
    if got["windows"]:
        out["middleware_ms"] = middleware(got["windows"][-1].completions)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=50.0)
    args = ap.parse_args(argv)
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch

    if not torch.cuda.is_available():
        print("span_breakdown: needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    print(json.dumps(breakdown(ROOT, args.workload, args.seed,
                               args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
