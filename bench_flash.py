#!/usr/bin/env python3
"""Time the causal flash-attention kernel on one CUDA card.

    python3 bench_flash.py

Prints one JSON line for each shape, the llama3.2-3b training shape (B 2,
S 2048, Hq 24, Hkv 8, D 128) and zamba2-2.7b's (B 1, S 384, Hq = Hkv = 32,
D 80), both bf16: the kernel's time beside the plain version's, the
library yardstick's (SDPA, causal, GQA) and the bound, as ``chip_smoke.py``
phase 13 takes them (without its checks); then the card's name and power
limit.  To compare two versions of the kernel on one card, run it from
each tree in one call, in turns: parent, change, change, parent.
"""
import subprocess
import sys

import chip_smoke as cs


def main():
    import torch

    if not torch.cuda.is_available():
        print("bench_flash: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.flash_attention import kernel, ops, ref

    for name, B, S, Hq, Hkv, D in (("llama3.2-3b", 2, 2048, 24, 8, 128),
                                   ("zamba2-2.7b", 1, 384, 32, 32, 80)):
        q, k, v = cs.flash_inputs(torch, S, B, S, Hq, Hkv, D, torch.bfloat16)
        out, lse = ops._launch(q, k, v)
        cs.emit({"config": name, **cs.flash_times(torch, kernel, ref, q, k,
                                                  v, out, lse)})
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
