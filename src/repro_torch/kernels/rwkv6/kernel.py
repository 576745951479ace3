"""ctypes binding of the hand-written Hopper chunked WKV6 kernel.

The CUDA source is ``csrc/wkv6.cu`` (its header states the design, the TPU
kernel it replaces and its bound): a float32 body on the CUDA cores, one
block a (sequence, head), and a bf16 body on the tensor cores, one block a
(sequence, head, 16 value columns).  The source is compiled at first use by
``repro_torch.kernels.build``; nothing here runs at import.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import load_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "wkv6.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on sm_90
BF16_HEAD_DIMS = (16, 32, 64)  # the hd the bf16 body is built for
BF16_MAX_CHUNK = 32  # the bf16 body's largest chunk: two 16-row tiles
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


def smem_bytes(hd: int, L: int) -> int:
    """Shared memory of the float32 body: ``csrc/wkv6.cu``'s
    ``smem_bytes``, the [hd, hd] state, r/k/v/lw rows padded by one float
    and the [L, L] pairwise term."""
    return 4 * (hd * hd + 4 * L * (hd + 1) + L * L)


def check_f32_shape(hd: int, L: int):
    """Raise ``ValueError`` for a shape the float32 body cannot take: a
    chunk that does not fit in shared memory with its state."""
    if smem_bytes(hd, L) > SMEM_LIMIT:
        raise ValueError(
            f"the float32 WKV6 kernel keeps a chunk in shared memory: "
            f"head_dim {hd} and chunk {L} need {smem_bytes(hd, L)} bytes, "
            f"over {SMEM_LIMIT}")


def check_bf16_shape(hd: int, L: int):
    """Raise ``ValueError`` for a shape the bf16 body cannot take: hd not
    one of ``BF16_HEAD_DIMS`` or a chunk over ``BF16_MAX_CHUNK``.  Every
    shape it takes fits in shared memory (``csrc/wkv6.cu``'s
    ``mma_smem_bytes``: at most 135 KB)."""
    if hd not in BF16_HEAD_DIMS or not 0 < L <= BF16_MAX_CHUNK:
        raise ValueError(
            f"the bf16 WKV6 kernel takes head_dim in {BF16_HEAD_DIMS} and a "
            f"chunk of at most {BF16_MAX_CHUNK}, not head_dim {hd}, chunk "
            f"{L}")


def wkv6_forward(r, k, v, lw, u, s0, y, s_out, chunk: int):
    """Launch on the current stream.  r/k/v/y [B,T,H,hd] in one dtype, lw
    [B,T,H,hd], u [H,hd], s0 (or None) and s_out [B,H,hd,hd] float32; all
    contiguous on one CUDA device, T % chunk == 0 (the caller checks).
    Returns the CUDA error code of the launch (0 on success;
    ``cudaErrorInvalidValue``, 1, for a shape the kernel refuses)."""
    B, T, H, hd = r.shape
    stream = torch.cuda.current_stream(r.device).cuda_stream
    return load()(
        _DTYPE_CODES[r.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(),
        lw.data_ptr(), u.data_ptr(), None if s0 is None else s0.data_ptr(),
        y.data_ptr(), s_out.data_ptr(), B, T, H, hd, chunk, stream)
