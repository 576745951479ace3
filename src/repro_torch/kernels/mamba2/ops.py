"""Chunked Mamba2 SSD on model-layout tensors, with its gradient: the CUDA
kernel or its plain version, chosen by where the tensors lie.

``SSD`` is a ``torch.autograd.Function``.  Its forward launches the
hand-written Hopper kernel (``csrc/ssd.cu``, replacing the TPU kernel
``ssd_bthp`` at ``src/repro/kernels/mamba2/kernel.py:61``) on a CUDA
tensor, or raises, and runs ``ref.ssd_chunked_ref`` on a CPU tensor.
There is no fallback from one to the other.  Its backward recomputes
``ref.ssd_chunked_ref`` under autograd from the saved inputs, on both: the
TPU kernel has no backward, and the JAX package takes the gradient through
its jnp ``ssd_chunked``.  ``launches`` counts kernel launches, so a run can
show that its prefill or training forward went through the kernel (a block
recomputed under remat launches again).  A ``meta`` tensor launches
nothing: the forward returns empty outputs of the kernel's shapes and
charges its work (``kernels/cost.py``) to the active cost counter.
"""
from __future__ import annotations

import threading

import torch

from .. import cost
from ..recompute import recompute_grads
from . import ref
from .kernel import MAX_CHUNK, check_bf16_shape, ssd_forward

launches = 0  # kernel launches (CPU calls do not count)
_count_lock = threading.Lock()
# held from the kernel's cudaFuncSetAttribute (its dynamic shared
# memory, which depends on the chunk) to its launch: two replicas'
# threads prefilling different lengths would otherwise lower the
# limit between the other's set and launch, which then fails
# (cudaErrorInvalidValue, read as a refused shape)
_launch_lock = threading.Lock()

KERNEL_DTYPES = (torch.float32, torch.bfloat16)
KERNEL_MAX_CHUNK = MAX_CHUNK
_REFUSED = 1  # cudaErrorInvalidValue: the entry point refused the shapes


def _check(x, dt, A, Bm, Cm, h0):
    tensors = [t for t in (x, dt, A, Bm, Cm, h0) if t is not None]
    if len({t.device for t in tensors}) != 1:
        raise ValueError("ssd: all inputs must be on one device, got "
                         f"{[str(t.device) for t in tensors]}")
    if x.dim() != 4:
        raise ValueError(f"ssd: x must be [B,T,H,P], got {tuple(x.shape)}")
    B, T, H, P = x.shape
    N = Bm.shape[-1] if Bm.dim() == 3 else -1
    if (tuple(dt.shape) != (B, T, H) or tuple(A.shape) != (H,)
            or tuple(Bm.shape) != (B, T, N) or Cm.shape != Bm.shape):
        raise ValueError(
            f"ssd: x {tuple(x.shape)} needs dt [{B},{T},{H}], A [{H}] and "
            f"B/C [{B},{T},N], got {tuple(dt.shape)}, {tuple(A.shape)}, "
            f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    if h0 is not None and tuple(h0.shape) != (B, H, N, P):
        raise ValueError(f"ssd: h0 must be [{B}, {H}, {N}, {P}], got "
                         f"{tuple(h0.shape)}")
    if not x.dtype == Bm.dtype == Cm.dtype:
        raise TypeError(f"ssd: x/B/C dtypes differ: {x.dtype}, {Bm.dtype}, "
                        f"{Cm.dtype}")
    if any(t.dtype != torch.float32 for t in (dt, A, h0) if t is not None):
        raise TypeError("ssd: dt, A and h0 must be float32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd needs contiguous inputs")


def _launch(x, dt, A, Bm, Cm, h0, chunk):
    if x.device.type != "cuda":
        raise ValueError(f"no ssd for device {x.device}")
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"CUDA kernel takes {KERNEL_DTYPES}, not {x.dtype}")
    if chunk > KERNEL_MAX_CHUNK:
        raise ValueError(f"CUDA kernel takes a chunk of at most "
                         f"{KERNEL_MAX_CHUNK} tokens, not {chunk}")
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    if x.dtype == torch.bfloat16:
        check_bf16_shape(P, N, chunk)
    y = torch.empty_like(x)
    h = torch.empty((B, H, N, P), dtype=torch.float32, device=x.device)
    with _launch_lock:
        err = ssd_forward(x, dt, A, Bm, Cm, h0, y, h, chunk)
    if err == _REFUSED:
        raise ValueError(
            f"the SSD kernel refused N {N}, P {P}, chunk {chunk} in "
            f"{x.dtype}: the float32 body keeps a chunk in 227 KB of shared "
            f"memory; the bf16 body copies x, B and C in 16-byte pieces")
    if err:
        raise RuntimeError(f"ssd kernel launch failed: CUDA error {err}")
    return y, h


def _forward(x, dt, A, Bm, Cm, h0, chunk):
    global launches
    if x.device.type == "cpu":
        return ref.ssd_chunked_ref(x, dt, A, Bm, Cm, chunk, h0)
    if x.device.type == "meta":
        B, _, H, P = x.shape
        cost.charge("ssd", *cost.ssd(x, Bm, chunk, h0 is not None))
        return torch.empty_like(x), torch.empty(
            (B, H, Bm.shape[-1], P), dtype=torch.float32, device=x.device)
    y, h = _launch(x, dt, A, Bm, Cm, h0, chunk)
    with _count_lock:
        launches += 1
    return y, h


class SSD(torch.autograd.Function):
    """(x, dt, A, Bm, Cm, h0, chunk) with T % chunk == 0 -> (y, h_final);
    the gradient reaches x, dt, A, Bm, Cm and h0 from both outputs."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, h0, chunk):
        ctx.chunk = chunk
        ctx.save_for_backward(x, dt, A, Bm, Cm, h0)
        return _forward(x, dt, A, Bm, Cm, h0, chunk)

    @staticmethod
    def backward(ctx, dy, dh):
        saved = ctx.saved_tensors
        with torch.profiler.record_function("ssd/backward"):
            return recompute_grads(
                lambda *a: ref.ssd_chunked_ref(*a[:5], ctx.chunk, a[5]),
                saved, ctx.needs_input_grad[:6], (dy, dh)) + (None,)


def ssd(x, dt, A, Bm, Cm, *, chunk: int, h0=None):
    """Chunked SSD: x [B,T,H,P]; dt [B,T,H] float32; A [H] float32
    (negative); Bm/Cm [B,T,N] in x's dtype; h0 [B,H,N,P] float32 or None
    (zeros) -> (y [B,T,H,P] in x's dtype, h_final [B,H,N,P] float32).

    The chunk is ``min(chunk, T)``; a T that is not a multiple of it raises
    ``ValueError``, as the reference's ``ssd_chunked`` does, before the
    autograd Function runs."""
    _check(x, dt, A, Bm, Cm, h0)
    T = x.shape[1]
    L = min(chunk, T)
    if T % L:
        raise ValueError(f"T={T} not divisible by chunk={L}")
    return SSD.apply(x, dt, A, Bm, Cm, h0, L)
