#!/usr/bin/env python3
"""Readings for the output check's limit, on a CUDA card.

    python3 perfbench/control.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--control-seeds <n> ...]

For each seed, this process serves the cell as a benchmark run does,
with a window of ``--seconds``, and prints the widest gap of the
program's served tokens below the float32 reference's best (the lower
reading) and whether the run is correct.  For each of ``--control-seeds``
it also runs the control, the reference in float8 (e4m3, both operands of
every matrix product), over the same prompts and served tokens, puts its
first-ranked tokens in the program's place and judges them by the same
limits: ``correct`` is then the control's, which has to be false, and
``program_correct`` the program's.  The limit in the configuration file
lies between the largest lower and the smallest upper reading.  One JSON
line a seed; the benchmark's own runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=())
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    seeds = list(dict.fromkeys(list(args.seeds) + list(args.control_seeds)))
    for seed in seeds:
        t = time.perf_counter()
        out = harness.run_cell(ROOT, args.workload, seed, args.seconds, False,
                               control=seed in args.control_seeds)
        program = out.get("program", out)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "wall_s": time.perf_counter() - t,
                          "attempted": out["attempted"],
                          "correct": out["correct"],
                          "program_correct": program["correct"],
                          "check": out["check"],
                          **out["verdict"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
