"""ctypes binding of the hand-written Hopper chunked WKV6 kernel.

The CUDA source is ``csrc/wkv6.cu`` (its header states the design, the TPU
kernel it replaces and its bound).  It is compiled at first use by
``repro_torch.kernels.build``; nothing here runs at import.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import load_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "wkv6.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def load():
    """Build (once) and return the C entry point with its types set."""
    global _fn
    if _fn is None:
        fn = load_library("wkv6", SOURCE).wkv6_forward
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def wkv6_forward(r, k, v, lw, u, s0, y, s_out, chunk: int):
    """Launch on the current stream.  r/k/v/y [B,T,H,hd] in one dtype, lw
    [B,T,H,hd], u [H,hd], s0 (or None) and s_out [B,H,hd,hd] float32; all
    contiguous on one CUDA device, T % chunk == 0 (the caller checks).
    Returns the CUDA error code of the launch (0 on success)."""
    B, T, H, hd = r.shape
    stream = torch.cuda.current_stream(r.device).cuda_stream
    return load()(
        _DTYPE_CODES[r.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(),
        lw.data_ptr(), u.data_ptr(), None if s0 is None else s0.data_ptr(),
        y.data_ptr(), s_out.data_ptr(), B, T, H, hd, chunk, stream)
