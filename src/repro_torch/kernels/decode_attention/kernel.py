"""ctypes binding of the hand-written Hopper paged flash-decode kernel.

The CUDA source is ``csrc/paged_decode_attention.cu`` (its header states
the design, the TPU kernel it replaces and its bound).  It is compiled at
first use by ``repro_torch.kernels.build``; nothing here runs at import.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import load_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_decode_attention.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def load():
    """Build (once) and return the C entry point with its types set."""
    global _fn
    if _fn is None:
        fn = load_library("paged_decode_attention",
                          SOURCE).paged_decode_attention
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                       + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def paged_decode_attention_grouped(q, k_store, v_store, block_tables,
                                   kv_length, out, scale: float):
    """Launch on the current stream.  q/out [B,Hkv,G,D]; stores
    [num_blocks, block_size, Hkv, D]; tables [B, max_blocks] and lengths
    [B] int32; all contiguous on one CUDA device (the caller checks).
    Returns the CUDA error code of the launch (0 on success)."""
    B, Hkv, G, D = q.shape
    bs = k_store.shape[1]
    mb = block_tables.shape[1]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return load()(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k_store.data_ptr(),
        v_store.data_ptr(), block_tables.data_ptr(), kv_length.data_ptr(),
        out.data_ptr(), B, Hkv, G, D, bs, mb, scale, stream)
