"""Paged flash-decode on model-layout tensors: the CUDA kernel or its plain
version, chosen by where the tensors lie.

A CUDA tensor launches the hand-written Hopper kernel
(``csrc/paged_decode_attention.cu``, replacing the TPU kernel
``paged_decode_attention_grouped`` at
``src/repro/kernels/decode_attention/kernel.py:147``) or raises; a CPU
tensor runs ``ref.paged_decode_ref``.  There is no fallback from one to
the other.  ``launches`` counts kernel launches, so a run can show that
its decode went through the kernel.
"""
from __future__ import annotations

import math
import threading

import torch

from . import ref
from .kernel import paged_decode_attention_grouped

launches = 0  # kernel launches (CPU calls do not count)
_count_lock = threading.Lock()

KERNEL_DTYPES = (torch.float32, torch.bfloat16)
KERNEL_HEAD_DIMS = (32, 64, 128)
KERNEL_MAX_GROUP = 8
KERNEL_MAX_BLOCK_SIZE = 64


def _check(q, k_store, v_store, block_tables, kv_length):
    tensors = (q, k_store, v_store, block_tables, kv_length)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("paged_decode_attention: all inputs must be on one "
                         f"device, got {[str(t.device) for t in tensors]}")
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be [B, 1, Hq, D], got {tuple(q.shape)}")
    B, _, Hq, D = q.shape
    if k_store.dim() != 4 or k_store.shape != v_store.shape:
        raise ValueError("k/v stores must both be [num_blocks, block_size, "
                         f"Hkv, D], got {tuple(k_store.shape)} and "
                         f"{tuple(v_store.shape)}")
    Hkv = k_store.shape[2]
    if k_store.shape[3] != D or Hq % Hkv:
        raise ValueError(f"q heads/dim {Hq}/{D} do not fit store heads/dim "
                         f"{Hkv}/{k_store.shape[3]}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B or \
            tuple(kv_length.shape) != (B,):
        raise ValueError(f"block_tables must be [{B}, max_blocks] and "
                         f"kv_length [{B}], got {tuple(block_tables.shape)} "
                         f"and {tuple(kv_length.shape)}")
    if q.dtype != k_store.dtype or k_store.dtype != v_store.dtype:
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k_store.dtype}, "
                        f"{v_store.dtype}")
    if block_tables.dtype != torch.int32 or kv_length.dtype != torch.int32:
        raise TypeError("block_tables and kv_length must be int32, got "
                        f"{block_tables.dtype} and {kv_length.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_decode_attention needs contiguous inputs")


def _check_kernel_limits(q, k_store, v_store):
    _, _, Hq, D = q.shape
    Hkv, bs = k_store.shape[2], k_store.shape[1]
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"CUDA kernel takes {KERNEL_DTYPES}, not {q.dtype}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"CUDA kernel takes head_dim {KERNEL_HEAD_DIMS}, "
                         f"not {D}")
    if Hq // Hkv > KERNEL_MAX_GROUP:
        raise ValueError(f"CUDA kernel takes at most {KERNEL_MAX_GROUP} query "
                         f"heads per kv head, not {Hq // Hkv}")
    if bs > KERNEL_MAX_BLOCK_SIZE:
        raise ValueError(f"CUDA kernel takes block_size <= "
                         f"{KERNEL_MAX_BLOCK_SIZE}, not {bs}")
    if k_store.data_ptr() % 16 or v_store.data_ptr() % 16:
        raise ValueError("CUDA kernel stages K/V with 16-byte loads: the "
                         "stores must be 16-byte aligned")


def paged_decode_attention(q, k_store, v_store, block_tables, kv_length):
    """q [B,1,Hq,D]; stores [num_blocks, block_size, Hkv, D]; block_tables
    [B, max_blocks] int32; kv_length [B] int32 (valid positions, >= 1,
    including the current token) -> [B,1,Hq,D]."""
    global launches
    _check(q, k_store, v_store, block_tables, kv_length)
    B, _, Hq, D = q.shape
    Hkv = k_store.shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, D)
    if q.device.type == "cpu":
        out = ref.paged_decode_ref(qg, k_store, v_store, block_tables,
                                   kv_length)
        return out.reshape(B, 1, Hq, D)
    if q.device.type != "cuda":
        raise ValueError(f"no paged_decode_attention for device {q.device}")
    _check_kernel_limits(q, k_store, v_store)
    out = torch.empty_like(qg)
    if B:
        err = paged_decode_attention_grouped(qg, k_store, v_store,
                                             block_tables, kv_length, out,
                                             1.0 / math.sqrt(D))
        if err:
            raise RuntimeError(
                f"paged_decode_attention kernel launch failed: CUDA error "
                f"{err}")
        with _count_lock:
            launches += 1
    return out.reshape(B, 1, Hq, D)
