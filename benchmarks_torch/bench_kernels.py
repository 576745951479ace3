"""The hand-written kernels at the reference's micro-benchmark shapes.

The port's ``benchmarks/bench_kernels.py``: the same four kernels at the
same shapes and inputs' dtype (float32), plus the paged decode kernel at
the llama3.2-3b decode shape ``chip_smoke.py`` phase 2 times (bf16):

  flash   B 1, S 256, H 4, D 64, causal
  decode  B 4, S 512, Hq 8, Hkv 2, D 64 (contiguous caches)
  paged   B 8, Hq 24, Hkv 8, D 128, block 16, 513 blocks, lengths 512
  wkv6    B 1, T 128, H 4, hd 32, chunk 32
  ssd     B 1, T 128, H 4, P 16, N 8, chunk 32

On the card each row is the kernel's time a call (CUDA events around
``REPS`` calls after a warm-up), its work in the ``derived`` column (the
reference's flops or bytes) and its largest difference from its plain
version on the same inputs.  On the CPU there is no kernel: the rows are
the plain versions' times and are named ``..._plain``, so a CPU time
never stands as a kernel's.  Every shape here is one the kernels take in
float32 (and the paged shape in bf16); a shape a kernel refused would
raise, never fall back to the plain version.
"""
from __future__ import annotations

import time

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.decode_attention import ref as dec_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.mamba2 import ops as ssd_ops
from repro_torch.kernels.mamba2 import ref as ssd_ref
from repro_torch.kernels.rwkv6 import ops as wkv_ops
from repro_torch.kernels.rwkv6 import ref as wkv_ref

from .common import Reporter

REPS = 20  # calls a timing (the CPU's plain versions: 3, as the reference)


def _time(fn, dev, reps) -> float:
    """Seconds a call of ``fn`` after one warm-up call: CUDA events on the
    card, the host clock on the CPU."""
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps


def _max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def _cases(dev, gen):
    """name -> (kernel call, plain call, derived text)."""

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # flash attention, causal
    B, S, H, D = 1, 256, 4, 64
    q, k, v = randn(B, S, H, D), randn(B, S, H, D), randn(B, S, H, D)
    flops = 2 * B * H * (S * S // 2) * D * 2
    yield ("kernel_flash_attention",
           lambda: fa_ops.flash_attention(q, k, v),
           lambda: fa_ref.attention_fwd_ref(q, k, v)[0],
           f"S={S} D={D} causal flops={flops:.2e}")

    # decode attention over contiguous caches
    B2, S2, Hq, Hkv = 4, 512, 8, 2
    q2 = randn(B2, 1, Hq, D)
    kc, vc = randn(B2, S2, Hkv, D), randn(B2, S2, Hkv, D)
    lens = torch.full((B2,), S2, dtype=torch.int32, device=dev)
    bytes_moved = 2 * B2 * S2 * Hkv * D * 4
    yield ("kernel_decode_attention",
           lambda: dec_ops.decode_attention(q2, kc, vc, lens),
           lambda: dec_ref.decode_ref(q2.reshape(B2, Hkv, Hq // Hkv, D), kc,
                                      vc, lens).reshape(B2, 1, Hq, D),
           f"S={S2} G={Hq // Hkv} bytes={bytes_moved:.2e} AI~{Hq // Hkv}")

    # paged decode at the llama3.2-3b decode shape, bf16
    B3, Hkv3, G3, D3, bs, mb, nb, L3 = 8, 8, 3, 128, 16, 64, 513, 512
    ks = randn(nb, bs, Hkv3, D3, dtype=torch.bfloat16)
    vs = randn(nb, bs, Hkv3, D3, dtype=torch.bfloat16)
    q3 = randn(B3, 1, Hkv3 * G3, D3, dtype=torch.bfloat16)
    perm = torch.randperm(nb - 1, generator=gen, device=dev) + 1
    need = -(-L3 // bs)
    bt = torch.zeros((B3, mb), dtype=torch.int32, device=dev)
    bt[:, :need] = perm[:B3 * need].reshape(B3, need).to(torch.int32)
    lens3 = torch.full((B3,), L3, dtype=torch.int32, device=dev)
    paged_bytes = B3 * L3 * Hkv3 * D3 * 2 * 2
    yield ("kernel_paged_decode_attention",
           lambda: dec_ops.paged_decode_attention(q3, ks, vs, bt, lens3),
           lambda: dec_ref.paged_decode_ref(
               q3.reshape(B3, Hkv3, G3, D3), ks, vs, bt,
               lens3).reshape(B3, 1, Hkv3 * G3, D3),
           f"B={B3} L={L3} G={G3} D={D3} bf16 bytes={paged_bytes:.2e}")

    # rwkv6 wkv
    B4, T4, H4, hd = 1, 128, 4, 32
    r, k4, v4 = randn(B4, T4, H4, hd), randn(B4, T4, H4, hd), randn(
        B4, T4, H4, hd)
    lw = -torch.exp(randn(B4, T4, H4, hd) - 1.0)
    u = randn(H4, hd) * 0.1
    yield ("kernel_rwkv6_wkv",
           lambda: wkv_ops.wkv(r, k4, v4, lw, u, chunk=32)[0],
           lambda: wkv_ref.wkv_chunked_ref(r, k4, v4, lw, u, 32)[0],
           f"T={T4} hd={hd} chunk=32")

    # mamba2 ssd
    B5, T5, H5, P5, N5 = 1, 128, 4, 16, 8
    x = randn(B5, T5, H5, P5)
    dts = torch.nn.functional.softplus(randn(B5, T5, H5))
    A = -torch.exp(randn(H5))
    Bm, Cm = randn(B5, T5, N5), randn(B5, T5, N5)
    yield ("kernel_mamba2_ssd",
           lambda: ssd_ops.ssd(x, dts, A, Bm, Cm, chunk=32)[0],
           lambda: ssd_ref.ssd_chunked_ref(x, dts, A, Bm, Cm, 32)[0],
           f"T={T5} N={N5} P={P5} chunk=32")


def main(rep: Reporter, *, device=None) -> dict:
    """One row a kernel: the kernel on the card, ``..._plain`` on the CPU.
    -> {row name: {"us": us a call, "max_abs_err": kernel vs plain (None
    on the CPU)}}."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for name, kernel, plain, derived in _cases(dev, gen):
        if dev.type == "cuda":
            err = _max_err(kernel(), plain())
            us = _time(kernel, dev, REPS) * 1e6
            derived = f"{derived} max_abs_err={err:.2e}"
        else:
            name, err = f"{name}_plain", None
            us = _time(plain, dev, 3) * 1e6
        rep.add(name, us, derived)
        out[name] = {"us": us, "max_abs_err": err}
    return out


if __name__ == "__main__":
    main(Reporter())
