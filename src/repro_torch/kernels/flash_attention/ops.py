"""Causal flash attention on model-layout tensors, with its gradient.

``FlashAttention`` is a ``torch.autograd.Function``.  Its forward launches
the hand-written Hopper kernel (``csrc/flash_attention.cu``, replacing the
TPU kernel ``flash_attention_bhsd`` at
``src/repro/kernels/flash_attention/kernel.py:70``) on a CUDA tensor, or
raises, and runs ``ref.attention_fwd_ref`` on a CPU tensor.  There is no
fallback from one to the other.  Its backward is ``ref.attention_bwd`` in
PyTorch ops on both: the TPU kernel has no backward, and the JAX step
takes its gradient from the jnp attention, outside any kernel.
``launches`` counts kernel launches, so a run can show that its forward
went through the kernel (a block recomputed under remat launches again).
On a ``meta`` tensor the forward launches nothing: it returns empty
outputs of the kernel's shapes and charges the kernel's work
(``kernels/cost.py``) to the active cost counter.
"""
from __future__ import annotations

import math
import threading

import torch

from .. import cost
from . import ref
from .kernel import flash_attention_fwd

launches = 0  # kernel launches (CPU calls do not count)
_count_lock = threading.Lock()

KERNEL_DTYPES = (torch.float32, torch.bfloat16)
KERNEL_HEAD_DIMS = (8, 16, 32, 64, 80, 128, 192)


def _check(q, k, v):
    if len({t.device for t in (q, k, v)}) != 1:
        raise ValueError("flash_attention: all inputs must be on one device, "
                         f"got {[str(t.device) for t in (q, k, v)]}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_attention: q must be [B,S,Hq,D] and k/v "
                         f"both [B,S,Hkv,D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, Hq, D = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != D \
            or Hq % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not fit k/v "
                         f"{tuple(k.shape)} (self-attention, Hq % Hkv == 0)")
    if q.dtype != k.dtype or k.dtype != v.dtype:
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")


def _check_kernel_limits(q, k, v):
    D = q.shape[3]
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"CUDA kernel takes {KERNEL_DTYPES}, not {q.dtype}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"CUDA kernel takes head_dim {KERNEL_HEAD_DIMS}, "
                         f"not {D}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"CUDA kernel needs {name}'s head dim "
                             "contiguous")
        if t.data_ptr() % 16 or any(s * t.element_size() % 16
                                    for s in t.stride()[:3]):
            raise ValueError(f"CUDA kernel reads tiles through TMA: {name}'s "
                             "base address and its batch, sequence and head "
                             "strides must be multiples of 16 bytes")


def _launch(q, k, v):
    global launches
    _check_kernel_limits(q, k, v)
    B, S, Hq, D = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    if out.numel():
        err = flash_attention_fwd(q, k, v, out, lse, 1.0 / math.sqrt(D))
        if err:
            raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                               f"error {err}")
        with _count_lock:
            launches += 1
    return out, lse


class FlashAttention(torch.autograd.Function):
    """Causal GQA attention: q [B,S,Hq,D], k/v [B,S,Hkv,D] -> [B,S,Hq,D]."""

    @staticmethod
    def forward(ctx, q, k, v):
        _check(q, k, v)
        if q.device.type == "cpu":
            out, lse = ref.attention_fwd_ref(q, k, v)
        elif q.device.type == "cuda":
            out, lse = _launch(q, k, v)
        elif q.device.type == "meta":
            out = torch.empty_like(q, memory_format=torch.contiguous_format)
            lse = torch.empty(q.shape[0], q.shape[2], q.shape[1],
                              dtype=torch.float32, device=q.device)
            cost.charge("flash_attention", *cost.flash_attention(q, k, v))
        else:
            raise ValueError(f"no flash_attention for device {q.device}")
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        with torch.profiler.record_function("flash_attention/backward"):
            return ref.attention_bwd(q, k, v, out, lse, dout)


def flash_attention(q, k, v):
    """Causal self-attention on the model layout: q [B,S,Hq,D], k/v
    [B,S,Hkv,D] (Hq % Hkv == 0) -> [B,S,Hq,D] in q's dtype."""
    return FlashAttention.apply(q, k, v)
