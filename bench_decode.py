#!/usr/bin/env python3
"""Time both flash-decode entry points on one CUDA card.

    python3 bench_decode.py [--src OTHER_TREE/src]
    python3 bench_decode.py --host-ab OTHER_TREE/src

Prints one JSON line for each shape, as ``chip_smoke.py`` phases 2 and 3
take them (without their checks): the paged kernel at the llama3.2-3b
decode shape (28 layer stores, B 8, Hkv 8, G 3, D 128, lengths 480-545,
block 16, 64 blocks a sequence) and the contiguous kernel at zamba2-2.7b's
(9 layer caches, B 8, Hkv 32, D 80, S 512) and at llama3.2-3b's heads (S
1024), all bf16.  Each line holds the kernel's time eagerly and replayed
from a CUDA graph of the layer loop, the host's time to issue the
wrapper, the plain version's time, SDPA's (eager and from a graph) and the
bound; then the card's name and power limit.

``--src`` takes the kernels from another tree's ``src`` (for example the
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists), with this script's timing code, so two versions of
the kernel compare on one card in one call, in turns: parent, change,
change, parent.  The host's time drifts between processes more than two
versions of the launch differ, so ``--host-ab`` builds the other tree's
decode source beside this one and times both raw launches in turns
inside one process.
"""
import argparse
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

import chip_smoke as cs


def host_ab(torch, kernel, other_src, rounds=9):
    """The raw paged launch's host time from this tree's library and from
    ``other_src``'s decode source, built side by side and timed in turns
    in this one process (the host's clock drifts between processes more
    than the two differ): per-round times and medians."""
    import ctypes

    from repro_torch.kernels import build

    other = build.load_library(
        "decode_attention_other", Path(other_src).resolve()
        / "repro_torch/kernels/decode_attention/csrc/decode_attention.cu")
    libs = {"this": kernel.load(), "other": other}
    rng = np.random.RandomState(0)
    L, B, Hkv, G, D, bs, mb, N = 28, 8, 8, 3, 128, 16, 64, 513
    lens = [int(x) for x in rng.randint(480, 545, size=B)]
    ks, vs, q, bt, ln = cs.paged_inputs(
        torch, rng, L=L, B=B, Hkv=Hkv, G=G, D=D, bs=bs, mb=mb, num_blocks=N,
        lens=lens, dtype=torch.bfloat16)
    qg = q.reshape(B, Hkv, G, D)
    out = torch.empty_like(qg)
    runs = {}
    for name, lib in libs.items():
        fn = lib.paged_decode_attention
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                       + [ctypes.c_int] * 6 + [ctypes.c_float,
                                               ctypes.c_void_p])

        def run(fn=fn):
            stream = torch.cuda.current_stream().cuda_stream
            for layer in range(L):
                if fn(1, qg.data_ptr(), ks[layer].data_ptr(),
                      vs[layer].data_ptr(), bt.data_ptr(), ln.data_ptr(),
                      out.data_ptr(), B, Hkv, G, D, bs, mb, D ** -0.5,
                      stream):
                    raise RuntimeError("launch failed")
        runs[name] = run
    times = {name: [] for name in runs}
    for _ in range(rounds):
        for name, run in runs.items():
            times[name].append(cs.host_ms(torch, run, 20) / L)
    return {f"{name}_raw_host_ms": sorted(t)[rounds // 2]
            for name, t in times.items()} | {"rounds": times}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=None,
                    help="take repro_torch from this directory instead")
    ap.add_argument("--host-ab", metavar="OTHER_SRC", default=None,
                    help="time the raw paged launch of this tree and of "
                         "OTHER_SRC's source in turns, in this process")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("bench_decode: no CUDA device", file=sys.stderr)
        return 2
    if args.src:
        sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.kernels.decode_attention import kernel, ops, ref

    tree = str(Path(ops.__file__).resolve().parents[4])  # the checkout
    if args.host_ab:
        cs.emit({"entry": "paged", "tree": tree,
                 "other": os.path.abspath(args.host_ab),
                 **host_ab(torch, kernel, args.host_ab)})
        return 0
    rng = np.random.RandomState(0)
    cs.emit({"entry": "paged", "tree": tree,
             **cs.paged_timing(torch, ops, ref, kernel, rng)})
    rng = np.random.RandomState(4)
    zlens = cs.state_prompt_lens(rng, cs.STATE_ARCHS[1], 16)[:8] + \
        rng.randint(1, 33, size=8)  # prompts and generated tokens
    cs.emit({"entry": "contiguous", "tree": tree, **cs.decode_timing(
        torch, ops, ref, kernel, "zamba2-2.7b", cs.ZAMBA_ATTN_LAYERS, 8, 32,
        1, 80, cs.STATE_ENGINE["max_len"], zlens)})
    cs.emit({"entry": "contiguous", "tree": tree, **cs.decode_timing(
        torch, ops, ref, kernel, "llama3.2-3b", 28, 8, 8, 3, 128,
        cs.MAIN_PATH_ENGINE["max_len"], rng.randint(480, 545, size=8))})
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
