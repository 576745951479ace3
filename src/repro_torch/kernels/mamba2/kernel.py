"""ctypes binding of the hand-written Hopper chunked Mamba2 SSD kernel.

The CUDA source is ``csrc/ssd.cu`` (its header states the design, the TPU
kernel it replaces and its bound): a float32 body on the CUDA cores and a
bf16 body on the tensor cores, each one block a (sequence, head).  The
source is compiled at first use by ``repro_torch.kernels.build``; nothing
here runs at import.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import load_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK = 128
BF16_HEAD_DIMS = (16, 32, 64)  # the P the bf16 body is built for
BF16_MAX_STATE = 128  # the bf16 body's largest N (a multiple of 16)
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


def check_bf16_shape(P: int, N: int, L: int):
    """Raise ``ValueError`` for a shape the bf16 body cannot take: P not
    one of ``BF16_HEAD_DIMS``, N not a multiple of 16 in 16..128, or a
    chunk over ``MAX_CHUNK``.  Every shape it takes fits in shared memory
    (``csrc/ssd.cu``'s ``mma_smem_bytes``)."""
    if (P not in BF16_HEAD_DIMS or N % 16 or not 16 <= N <= BF16_MAX_STATE
            or not 0 < L <= MAX_CHUNK):
        raise ValueError(
            f"the bf16 SSD kernel takes P in {BF16_HEAD_DIMS}, N a multiple "
            f"of 16 up to {BF16_MAX_STATE} and a chunk of at most "
            f"{MAX_CHUNK}, not P {P}, N {N}, chunk {L}")


def ssd_forward(x, dt, A, Bm, Cm, h0, y, h_out, chunk: int):
    """Launch on the current stream.  x/y [B,T,H,P] and Bm/Cm [B,T,N] in
    one dtype; dt [B,T,H], A [H], h0 (or None) and h_out [B,H,N,P]
    float32; all contiguous on one CUDA device, T % chunk == 0 (the caller
    checks).  Returns the CUDA error code of the launch (0 on success;
    ``cudaErrorInvalidValue``, 1, for a shape the kernel refuses)."""
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    return load()(
        _DTYPE_CODES[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(),
        Bm.data_ptr(), Cm.data_ptr(), None if h0 is None else h0.data_ptr(),
        y.data_ptr(), h_out.data_ptr(), B, T, H, P, N, chunk, stream)
