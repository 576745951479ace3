"""ctypes binding of the hand-written Hopper causal flash-attention kernel.

The CUDA source is ``csrc/flash_attention.cu`` (its header states the
design, the TPU kernel it replaces and its bound).  It is compiled at first
use by ``repro_torch.kernels.build``; nothing here runs at import.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import load_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def load():
    """Build (once) and return the C entry point with its types set."""
    global _fn
    if _fn is None:
        fn = load_library("flash_attention", SOURCE).flash_attention_fwd
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 5
                       + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def flash_attention_fwd(q, k, v, out, lse, scale: float):
    """Launch on the current stream.  q/out [B,S,Hq,D], k/v [B,S,Hkv,D]
    (read through their strides, D contiguous), lse [B,Hq,S] float32
    contiguous; all on one CUDA device (the caller checks).  Returns the
    CUDA error code of the launch (0 on success)."""
    B, S, Hq, D = q.shape
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return load()(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), lse.data_ptr(), B, S, Hq, k.shape[2], D,
        ctypes.cast(strides, ctypes.c_void_p), scale, stream)
