#!/usr/bin/env python3
"""Time the chunked Mamba2 SSD kernel, and the WKV6 kernel beside it, on one
CUDA card.

    python3 bench_ssd.py [--src OTHER_TREE/src] [--serving]

Prints one JSON line for each shape, as ``chip_smoke.py`` phases 4 and 5
take them (each kernel first held against its plain version): the SSD at
zamba2-2.7b's prefill shapes (``SSD_TIMED_SHAPES``: B 1, H 80, P = N = 64,
T 384 in three chunks of 128, T 128, and a 20-token prompt as one chunk of
20; bf16, no initial state), then WKV6 at rwkv6-1.6b's
(``WKV_TIMED_SHAPES``: B 1, H 32, hd 64, T 256 in eight chunks of 32 and a
20-token prompt as one chunk of 20), each over its model's layers' input
sets (54 and 24), so a call's inputs are cold in L2 as a prefill meets
them.  Each line holds the kernel's time
a call eagerly and replayed from a CUDA graph of the layer loop
(``graph_ms``, device time without host dispatch), the host's time to
issue the wrapper (``host_ms``), the plain version's time and the bound;
then the card's name and power limit.

``--serving`` instead times every prefill shape that the slot-pool
serving phases launch (``chip_smoke.py`` phase 11's zamba2-2.7b prompts
for the SSD, phase 10's rwkv6-1.6b prompts for WKV6: each prompt's exact
length, as one chunk up to the chunk size, padded for WKV6 as its wrapper
pads) and prints, for each kernel, the launch-weighted device time of one
phase run (layers x two passes x prompts), one-chunk launches and longer
ones apart, beside the same sums over the bounds.

``--src`` takes the kernels from another tree's ``src`` (for example the
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists), with this script's timing code, so two versions of
the kernels compare on one card in one call, in turns: parent, change,
change, parent.
"""
import argparse
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

import chip_smoke as cs


def serving_totals(torch, kernel, ops, ref, wkv, gen):
    """Launch-weighted device times of the SSD over phase 11's zamba2-2.7b
    prefills and of WKV6 over phase 10's rwkv6-1.6b prefills, each distinct
    prefill shape replayed from a CUDA graph: one record a kernel with its
    shapes and launches, and the sums of launches x graph_ms and launches x
    bound_ms over the one-chunk launches and over the longer ones."""
    from repro_torch.configs import get_config

    wkv_kernel, wkv_ops, wkv_ref = wkv
    records = []
    for arch in cs.STATE_ARCHS:
        cfg = get_config(arch)
        shapes = {}
        for n in map(int, cs.state_prompt_lens(np.random.RandomState(1),
                                               arch, 16)):
            if cfg.family == "hybrid":  # exact length, chunks of ssm_chunk
                shape = (1, n, cfg.ssm_expand * cfg.d_model //
                         cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_state,
                         min(cfg.ssm_chunk, n))
            else:  # padded to a multiple of the chunk, as the wrapper pads
                L = min(cfg.rwkv_chunk, n)
                shape = (1, n + -n % L, cfg.d_model // cfg.rwkv_head_dim,
                         cfg.rwkv_head_dim, L)
            # one launch a layer, for the cold and the warm pass
            shapes[shape] = shapes.get(shape, 0) + 2 * cfg.n_layers
        rows = []
        sums = {"one_chunk": [0, 0.0, 0.0], "chunks": [0, 0.0, 0.0]}
        for shape, launches in sorted(shapes.items()):
            if cfg.family == "hybrid":
                t = cs.ssd_timing(torch, ops, ref, kernel, gen, shape)
            else:
                t = cs.wkv_timing(torch, wkv_ops, wkv_ref, wkv_kernel, gen,
                                  shape)
            rows.append({"shape": list(shape), "launches": launches,
                         "graph_ms": t["graph_ms"], "bound_ms": t["bound_ms"]})
            acc = sums["chunks" if shape[1] > shape[-1] else "one_chunk"]
            acc[0] += launches
            acc[1] += launches * t["graph_ms"]
            acc[2] += launches * t["bound_ms"]
        records.append({
            "kernel": "ssd" if cfg.family == "hybrid" else "wkv6",
            "config": arch, "shapes": rows,
            **{f"{part}_{name}": value for part, acc in sums.items()
               for name, value in zip(("launches", "graph_ms_total",
                                       "bound_ms_total"), acc)}})
    return records


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=None,
                    help="take repro_torch from this directory instead")
    ap.add_argument("--serving", action="store_true",
                    help="launch-weighted times over the serving phases' "
                         "prefill shapes")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("bench_ssd: no CUDA device", file=sys.stderr)
        return 2
    if args.src:
        sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.kernels.mamba2 import kernel, ops, ref
    from repro_torch.kernels.rwkv6 import kernel as wkv_kernel
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    from repro_torch.kernels.rwkv6 import ref as wkv_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    tree = str(Path(ops.__file__).resolve().parents[4])  # the checkout
    gen = torch.Generator(device=cs.DEVICE).manual_seed(6)
    if args.serving:
        for rec in serving_totals(torch, kernel, ops, ref,
                                  (wkv_kernel, wkv_ops, wkv_ref), gen):
            cs.emit({"tree": tree, **rec})
    else:
        for shape in cs.SSD_TIMED_SHAPES:
            cs.emit({"kernel": "ssd", "tree": tree,
                     **cs.ssd_timing(torch, ops, ref, kernel, gen, shape)})
        wgen = torch.Generator(device=cs.DEVICE).manual_seed(5)
        for shape in cs.WKV_TIMED_SHAPES:
            cs.emit({"kernel": "wkv6", "tree": tree, **cs.wkv_timing(
                torch, wkv_ops, wkv_ref, wkv_kernel, wgen, shape)})
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
