"""Roofline report: reads the port's dry-run records.

Re-emits the per-(arch x shape) three-term roofline of one H100 from
``results/dryrun_torch.json`` (written by ``repro_torch.launch.dryrun``;
never the reference's ``results/dryrun_all.json``); it counts nothing
itself.  Run ``PYTHONPATH=src python -m repro_torch.launch.dryrun --out
results/dryrun_torch.json`` to regenerate.
"""
from __future__ import annotations

import json
import os

from . import common
from .common import Reporter

SWEEP = "dryrun_torch.json"


def main(rep: Reporter, device=None) -> dict:
    """The ``roofline_<arch>_<shape>`` rows (µs of the larger term; a mesh
    record's name ends ``_16x16`` or ``_2x16x16``) and a summary row; ``device`` is unused: the records were counted on
    ``meta``."""
    path = os.path.join(common.RESULTS_DIR, SWEEP)
    if not os.path.exists(path):
        rep.add("roofline_missing", 0.0,
                "run repro_torch.launch.dryrun --out "
                "results/dryrun_torch.json first")
        return {}
    with open(path) as f:
        records = json.load(f)
    ok = 0
    for r in records:
        if r["status"] != "ok":
            continue
        ok += 1
        rl = r["roofline"]
        dom = max(rl["t_compute_s"], rl["t_memory_s"], rl["t_collective_s"])
        frac = rl["t_compute_s"] / max(1e-12, dom)
        mesh = {None: "", False: "_16x16", True: "_2x16x16"}[
            r.get("multi_pod")]
        rep.add(
            f"roofline_{r['arch']}_{r['shape']}{mesh}",
            dom * 1e6,
            f"bn={rl['bottleneck']} comp={rl['t_compute_s']:.3e}s "
            f"mem={rl['t_memory_s']:.3e}s coll={rl['t_collective_s']:.3e}s "
            f"frac={frac:.3f} useful={rl['useful_flops_ratio']:.2f}",
        )
    n_err = sum(1 for r in records if r["status"] == "error")
    n_skip = sum(1 for r in records if r["status"] == "skipped")
    rep.add("roofline_summary", 0.0,
            f"cells_ok={ok} errors={n_err} skipped={n_skip} "
            f"(skips = long_500k on full-attention archs; on a mesh, "
            f"serving cells)")
    return {"records": ok}


if __name__ == "__main__":
    main(Reporter())
