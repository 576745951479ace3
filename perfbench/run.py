#!/usr/bin/env python3
"""Run one cell of the port's benchmark on a CUDA card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Prints one JSON object as its last line of
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` and, traced, ``breakdown``; its last key, ``check``, gives each
number the output check compared beside its limit, which also close
standard error.  Exits non-zero, printing no result, without a CUDA card,
and when the process holds JAX or the JAX package once the window has
closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list:
    """Modules held whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: ``repro_torch`` is not ``repro``)."""
    names = sys.modules if modules is None else modules
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the program's build and kernel caches stay inside the checkout (its
    # CUDA kernels build into build/ there by themselves)
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch

    from perfbench import harness, spec

    need = next(w["chips"] for w in spec.load_bench(ROOT)["workloads"]
                if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"perfbench: needs {need} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    out = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                           bool(args.trace), t_start=T_START)
    held = forbidden_modules()
    if held:
        print(f"perfbench: the process holds {held}", file=sys.stderr)
        return 3
    print("verdict " + json.dumps(out.pop("verdict")), file=sys.stderr)
    chk = out.pop("check")
    out["check"] = chk
    print(json.dumps(out), flush=True)
    for name, c in chk.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
