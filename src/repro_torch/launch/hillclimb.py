"""The performance hill-climb's cells, baseline against optimized, counted
on the 16 x 16 production mesh.

    python -m repro_torch.launch.hillclimb [--out results/hillclimb_torch.json]

The counterpart of the JAX package's ``launch/hillclimb.py``, whose six
``CELLS`` it keeps: nemotron-4-340b's train_4k (A), llama3.2-3b's
prefill_32k (B) and moonshot-v1-16b-a3b's decode_32k (C), each as a
baseline and with the optimizations its label names.  Each cell is built
by ``dryrun.build_cell`` on the ``fake`` 16 x 16 mesh (this process rank 0
of 256; DTensors on ``meta``) and counted by ``launch/cost.py``; its record
holds the three-term roofline, ``dominant_s`` (the largest term) and
``roofline_fraction`` (the compute term over it).  A cell's microbatch
count goes to ``build_cell`` itself (``dryrun.MICROBATCHES`` stays as it
is).  ``run(cells, extra_overrides)`` counts some cells with overrides
added to each (``{"n_layers": 2}`` cuts depth); the records keep the
cells' own.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.launch import cost, dryrun
from repro_torch.launch.specs import SHAPES

# (label, arch, shape, overrides, microbatches)
CELLS = [
    ("A0-baseline", "nemotron-4-340b", "train_4k", None, 16),
    ("A*-optimized", "nemotron-4-340b", "train_4k",
     {"explicit_tp": True, "fsdp_params": True,
      "seq_shard_activations": True}, 4),
    ("B0-baseline", "llama3.2-3b", "prefill_32k", None, None),
    ("B*-optimized", "llama3.2-3b", "prefill_32k",
     {"pad_heads_to": 32, "explicit_tp": True}, None),
    ("C0-baseline", "moonshot-v1-16b-a3b", "decode_32k", None, None),
    ("C*-optimized", "moonshot-v1-16b-a3b", "decode_32k",
     {"explicit_tp": True}, None),
]
N_CHIPS = 256


def run(cells=CELLS, extra_overrides=None):
    """The records of ``cells`` on the 16 x 16 fake mesh."""
    mesh = dryrun.fake_mesh(False)
    records = []
    for label, arch, shape, ov, micro in cells:
        over = dict(ov or {}, **(extra_overrides or {}))
        fn, args, cfg, extra = dryrun.build_cell(
            arch, shape, overrides=over or None, mesh=mesh,
            microbatches=micro)
        seq, batch, kind = SHAPES[shape]
        tokens = batch * (seq if kind != "decode" else 1)
        counted = cost.analyze(fn, *args)
        rl = dryrun.roofline_from(counted, cfg, tokens=tokens,
                                  n_chips=N_CHIPS, kind=kind, seq=seq)
        dom = max(rl["t_compute_s"], rl["t_memory_s"], rl["t_collective_s"])
        rec = {"label": label, "arch": arch, "shape": shape,
               "overrides": ov, "roofline": rl, "dominant_s": dom,
               "roofline_fraction": rl["t_compute_s"] / dom if dom else 0.0,
               **extra}
        records.append(rec)
        print(f"{label:14s} t=({rl['t_compute_s']:.4f},"
              f"{rl['t_memory_s']:.4f},{rl['t_collective_s']:.4f}) "
              f"frac={rec['roofline_fraction']:.3f}", flush=True)
    return records


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/hillclimb_torch.json")
    args = ap.parse_args(argv)
    records = run()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(records, f, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
