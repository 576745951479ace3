"""ctypes binding of the hand-written Hopper flash-decode kernels.

The CUDA source is ``csrc/decode_attention.cu`` (its header states the
design, the TPU kernels it replaces and its bound): one body with two
entry points, over a block-paged store and over contiguous slot caches,
and a third that says how the kernel splits each sequence across blocks
and warps; built twice, once for each bucket of G (``BUCKETS``).
It is compiled at first use by ``repro_torch.kernels.build``; nothing here
runs at import.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import load_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# G's compile-time buckets: one library each, built from the one source
# with -DREPRO_DECODE_MAX_G, so the two build at once (one library of both
# buckets' 56 templates took twice as long to compile as either)
BUCKETS = (8, 16)
_libs: dict = {}  # bucket -> library


def bucket(G: int) -> int:
    """The bucket whose library serves G query heads a kv head."""
    return BUCKETS[0] if G <= BUCKETS[0] else BUCKETS[-1]


def load(G: int = 1):
    """Build (once) and return the library of G's bucket with its entry
    points typed."""
    b = bucket(G)
    lib = _libs.get(b)
    if lib is None:
        name = "decode_attention" if b == BUCKETS[0] else \
            f"decode_attention_g{b}"
        lib = load_library(name, SOURCE, defines=(f"REPRO_DECODE_MAX_G={b}",))
        lib.paged_decode_attention.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_void_p])
        lib.paged_decode_attention.restype = ctypes.c_int
        lib.decode_attention.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
            + [ctypes.c_float, ctypes.c_void_p])
        lib.decode_attention.restype = ctypes.c_int
        lib.decode_attention_shape.argtypes = (
            [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)] * 2)
        lib.decode_attention_shape.restype = ctypes.c_int
        _libs[b] = lib
    return lib


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
    return load(G).paged_decode_attention(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k_store.data_ptr(),
        v_store.data_ptr(), block_tables.data_ptr(), kv_length.data_ptr(),
        out.data_ptr(), B, Hkv, G, D, bs, mb, scale, stream)


def decode_attention_grouped(q, k_cache, v_cache, kv_length, out,
                             scale: float, lse=None):
    """Launch on the current stream.  q/out [B,Hkv,G,D]; caches [B,S,Hkv,D];
    lengths [B] int32 (clamped to S by the kernel); ``lse``, if given, a
    float32 [B,Hkv,G] that receives each head's log-sum-exp; all
    contiguous on one CUDA device (the caller checks).  Returns the CUDA
    error code of the launch (0 on success)."""
    B, Hkv, G, D = q.shape
    S = k_cache.shape[1]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return load(G).decode_attention(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), kv_length.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), B, Hkv, G, D, S, scale,
        stream)


def launch_shape(dtype, B: int, Hkv: int, G: int, D: int, cap: int):
    """(blocks a (sequence, kv head), warps a block) that either entry
    point takes at these shapes; ``cap`` is S or block_size * max_blocks."""
    splits, warps = ctypes.c_int(), ctypes.c_int()
    if load(G).decode_attention_shape(_DTYPE_CODES[dtype], B, Hkv, G, D,
                                      cap, ctypes.byref(splits),
                                      ctypes.byref(warps)):
        raise ValueError(f"no decode launch for {dtype}, B {B}, Hkv {Hkv}, "
                         f"G {G}, D {D}, cap {cap}")
    return splits.value, warps.value
