"""ctypes binding of the hand-written Hopper chunked Mamba2 SSD kernel.

The CUDA source is ``csrc/ssd.cu`` (its header states the design, the TPU
kernel it replaces and its bound).  It is compiled at first use by
``repro_torch.kernels.build``; nothing here runs at import.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import load_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def load():
    """Build (once) and return the C entry point with its types set."""
    global _fn
    if _fn is None:
        fn = load_library("ssd", SOURCE).ssd_forward
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def ssd_forward(x, dt, A, Bm, Cm, h0, y, h_out, chunk: int):
    """Launch on the current stream.  x/y [B,T,H,P] and Bm/Cm [B,T,N] in
    one dtype; dt [B,T,H], A [H], h0 (or None) and h_out [B,H,N,P]
    float32; all contiguous on one CUDA device, T % chunk == 0 (the caller
    checks).  Returns the CUDA error code of the launch (0 on success)."""
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    return load()(
        _DTYPE_CODES[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(),
        Bm.data_ptr(), Cm.data_ptr(), None if h0 is None else h0.data_ptr(),
        y.data_ptr(), h_out.data_ptr(), B, T, H, P, N, chunk, stream)
