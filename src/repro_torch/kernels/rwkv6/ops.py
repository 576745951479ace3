"""Chunked WKV6 on model-layout tensors, with its gradient: the CUDA
kernel or its plain version, chosen by where the tensors lie.

``WKV`` is a ``torch.autograd.Function``.  Its forward launches the
hand-written Hopper kernel (``csrc/wkv6.cu``, replacing the TPU kernel
``wkv_bhtc`` at ``src/repro/kernels/rwkv6/kernel.py:60``) on a CUDA
tensor, or raises, and runs ``ref.wkv_chunked_ref`` on a CPU tensor.
There is no fallback from one to the other.  Its backward recomputes
``ref.wkv_chunked_ref`` under autograd from the saved inputs, on both: the
TPU kernel has no backward, and the JAX package takes the gradient through
its jnp ``wkv_chunked``.  ``launches`` counts kernel launches, so a run can
show that its prefill or training forward went through the kernel (a block
recomputed under remat launches again).  A ``meta`` tensor launches
nothing: the forward returns empty outputs of the kernel's shapes and
charges its work (``kernels/cost.py``) to the active cost counter.
"""
from __future__ import annotations

import threading

import torch
import torch.nn.functional as F

from .. import cost
from ..recompute import recompute_grads
from . import ref
from .kernel import check_bf16_shape, check_f32_shape, wkv6_forward

launches = 0  # kernel launches (CPU calls do not count)
_count_lock = threading.Lock()

KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_REFUSED = 1  # cudaErrorInvalidValue: the entry point refused the shapes


def _check(r, k, v, lw, u, s0):
    tensors = [t for t in (r, k, v, lw, u, s0) if t is not None]
    if len({t.device for t in tensors}) != 1:
        raise ValueError("wkv: all inputs must be on one device, got "
                         f"{[str(t.device) for t in tensors]}")
    if r.dim() != 4 or not r.shape == k.shape == v.shape == lw.shape:
        raise ValueError("wkv: r/k/v/lw must all be [B,T,H,hd], got "
                         f"{[tuple(t.shape) for t in (r, k, v, lw)]}")
    B, _, H, hd = r.shape
    if tuple(u.shape) != (H, hd):
        raise ValueError(f"wkv: u must be [{H}, {hd}], got {tuple(u.shape)}")
    if s0 is not None and tuple(s0.shape) != (B, H, hd, hd):
        raise ValueError(f"wkv: s0 must be [{B}, {H}, {hd}, {hd}], got "
                         f"{tuple(s0.shape)}")
    if not r.dtype == k.dtype == v.dtype:
        raise TypeError(f"wkv: r/k/v dtypes differ: {r.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if any(t.dtype != torch.float32 for t in (lw, u, s0) if t is not None):
        raise TypeError("wkv: lw, u and s0 must be float32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("wkv needs contiguous inputs")


def _launch(r, k, v, lw, u, s0, chunk):
    if r.device.type != "cuda":
        raise ValueError(f"no wkv for device {r.device}")
    if r.dtype not in KERNEL_DTYPES:
        raise TypeError(f"CUDA kernel takes {KERNEL_DTYPES}, not {r.dtype}")
    B, T, H, hd = r.shape
    if r.dtype == torch.bfloat16:
        check_bf16_shape(hd, chunk)
    else:
        check_f32_shape(hd, chunk)
    y = torch.empty_like(r)
    s = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    err = wkv6_forward(r, k, v, lw, u, s0, y, s, chunk)
    if err == _REFUSED:
        raise ValueError(
            f"the WKV6 kernel refused B {B}, head_dim {hd}, chunk {chunk} "
            f"in {r.dtype}: B is at most 65535, and the bf16 body copies "
            f"r, k, v and lw in 16-byte pieces, so each must start on a "
            f"16-byte boundary")
    if err:
        raise RuntimeError(f"wkv kernel launch failed: CUDA error {err}")
    return y, s


def _forward(r, k, v, lw, u, s0, chunk):
    global launches
    if r.device.type == "cpu":
        return ref.wkv_chunked_ref(r, k, v, lw, u, chunk, s0)
    if r.device.type == "meta":
        B, _, H, hd = r.shape
        cost.charge("wkv6", *cost.wkv(r, chunk, s0 is not None))
        return torch.empty_like(r), torch.empty(
            (B, H, hd, hd), dtype=torch.float32, device=r.device)
    y, s = _launch(r, k, v, lw, u, s0, chunk)
    with _count_lock:
        launches += 1
    return y, s


class WKV(torch.autograd.Function):
    """(r, k, v, lw, u, s0, chunk) with T % chunk == 0 -> (y, s_final);
    the gradient reaches r, k, v, lw, u and s0 from both outputs."""

    @staticmethod
    def forward(ctx, r, k, v, lw, u, s0, chunk):
        ctx.chunk = chunk
        ctx.save_for_backward(r, k, v, lw, u, s0)
        return _forward(r, k, v, lw, u, s0, chunk)

    @staticmethod
    def backward(ctx, dy, ds):
        saved = ctx.saved_tensors
        with torch.profiler.record_function("wkv6/backward"):
            return recompute_grads(
                lambda *a: ref.wkv_chunked_ref(*a[:5], ctx.chunk, a[5]),
                saved, ctx.needs_input_grad[:6], (dy, ds)) + (None,)


def wkv(r, k, v, lw, u, *, chunk: int, s0=None):
    """Chunked WKV6: r/k/v [B,T,H,hd] in one dtype; lw [B,T,H,hd] float32
    log-decay (<= 0); u [H,hd] float32; s0 [B,H,hd,hd] float32 or None
    (zeros) -> (y [B,T,H,hd] in r's dtype, s_final [B,H,hd,hd] float32).

    The chunk is ``min(chunk, T)``; T is padded to a multiple of it as the
    reference's ``wkv_chunked`` pads (r/k/v = 0 and lw = 0, which leaves
    the state as it is), and y is cut back to T, outside the autograd
    Function, so the gradient passes through the padding."""
    _check(r, k, v, lw, u, s0)
    T = r.shape[1]
    L = min(chunk, T)
    pad = -T % L
    if pad:
        r, k, v, lw = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v, lw))
    y, s = WKV.apply(r, k, v, lw, u, s0, L)
    return y[:, :T], s
