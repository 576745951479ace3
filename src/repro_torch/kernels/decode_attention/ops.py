"""Flash-decode on model-layout tensors: the CUDA kernel or its plain
version, chosen by where the tensors lie.

Two wrappers over one hand-written Hopper kernel
(``csrc/decode_attention.cu``): ``paged_decode_attention`` reads K/V
through block tables (replacing the TPU kernel
``paged_decode_attention_grouped`` at
``src/repro/kernels/decode_attention/kernel.py:147``) and
``decode_attention`` reads contiguous slot caches (replacing
``decode_attention_grouped`` at ``kernel.py:74``).  A CUDA tensor launches
the kernel or raises; a CPU tensor runs ``ref.paged_decode_ref`` /
``ref.decode_ref``.  There is no fallback from one to the other.
``launches`` and ``contiguous_launches`` count kernel launches, so a run
can show that its decode went through the kernel.  A ``meta`` tensor
launches nothing: the wrapper returns an empty output and charges the
kernel's work over every cached position (``kernels/cost.py``) to the
active cost counter.
"""
from __future__ import annotations

import math
import threading

import torch

from .. import cost
from . import ref
from .kernel import decode_attention_grouped, paged_decode_attention_grouped

launches = 0  # paged kernel launches (CPU calls do not count)
contiguous_launches = 0  # contiguous kernel launches
_count_lock = threading.Lock()

KERNEL_DTYPES = (torch.float32, torch.bfloat16)
KERNEL_HEAD_DIMS = (8, 16, 32, 64, 80, 128, 192)
KERNEL_MAX_GROUP = 16
KERNEL_MAX_BLOCK_SIZE = 64


def _check(name, q, k, v, kv_length, *extra):
    """Checks both wrappers share: q [B,1,Hq,D]; k/v 4-D of one shape whose
    last two dims are (Hkv, D), Hq % Hkv == 0; kv_length [B] int32; one
    device, one dtype, contiguous."""
    tensors = (q, k, v, kv_length, *extra)
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: all inputs must be on one device, got "
                         f"{[str(t.device) for t in tensors]}")
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be [B, 1, Hq, D], got {tuple(q.shape)}")
    B, _, Hq, D = q.shape
    if k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: k/v must both be 4-D [..., Hkv, D] of one "
                         f"shape, got {tuple(k.shape)} and {tuple(v.shape)}")
    Hkv = k.shape[2]
    if k.shape[3] != D or Hq % Hkv:
        raise ValueError(f"q heads/dim {Hq}/{D} do not fit k/v heads/dim "
                         f"{Hkv}/{k.shape[3]}")
    if tuple(kv_length.shape) != (B,):
        raise ValueError(f"kv_length must be [{B}], got "
                         f"{tuple(kv_length.shape)}")
    if q.dtype != k.dtype or k.dtype != v.dtype:
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if kv_length.dtype != torch.int32:
        raise TypeError(f"kv_length must be int32, got {kv_length.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous inputs")


def _check_kernel_limits(q, k, v):
    _, _, Hq, D = q.shape
    Hkv = k.shape[2]
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"CUDA kernel takes {KERNEL_DTYPES}, not {q.dtype}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"CUDA kernel takes head_dim {KERNEL_HEAD_DIMS}, "
                         f"not {D}")
    if Hq // Hkv > KERNEL_MAX_GROUP:
        raise ValueError(f"CUDA kernel takes at most {KERNEL_MAX_GROUP} query "
                         f"heads per kv head, not {Hq // Hkv}")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("CUDA kernel stages K/V with 16-byte loads: k and v "
                         "must be 16-byte aligned")


def _launch(name, launch, q, k, v, *args, lse=None):
    """Check the kernel's limits, launch on a CUDA tensor, count it."""
    if q.device.type != "cuda":
        raise ValueError(f"no {name} for device {q.device}")
    _check_kernel_limits(q, k, v)
    B, _, Hq, D = q.shape
    qg = q.reshape(B, k.shape[2], Hq // k.shape[2], D)
    out = torch.empty_like(qg)
    if B:
        extra = {} if lse is None else {"lse": lse}
        err = launch(qg, k, v, *args, out, 1.0 / math.sqrt(D), **extra)
        if err:
            raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                               f"{err}")
    return out.reshape(B, 1, Hq, D)


def paged_decode_attention(q, k_store, v_store, block_tables, kv_length):
    """q [B,1,Hq,D]; stores [num_blocks, block_size, Hkv, D]; block_tables
    [B, max_blocks] int32; kv_length [B] int32 (valid positions, >= 1,
    including the current token) -> [B,1,Hq,D]."""
    global launches
    _check("paged_decode_attention", q, k_store, v_store, kv_length,
           block_tables)
    B, _, Hq, D = q.shape
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError(f"block_tables must be [{B}, max_blocks], got "
                         f"{tuple(block_tables.shape)}")
    if block_tables.dtype != torch.int32:
        raise TypeError(f"block_tables must be int32, got "
                        f"{block_tables.dtype}")
    if q.device.type == "meta":
        cost.charge("paged_decode_attention",
                    *cost.paged_decode_attention(q, k_store, block_tables))
        return torch.empty_like(q)
    if q.device.type == "cpu":
        qg = q.reshape(B, k_store.shape[2], Hq // k_store.shape[2], D)
        out = ref.paged_decode_ref(qg, k_store, v_store, block_tables,
                                   kv_length)
        return out.reshape(B, 1, Hq, D)
    if k_store.shape[1] > KERNEL_MAX_BLOCK_SIZE:
        raise ValueError(f"CUDA kernel takes block_size <= "
                         f"{KERNEL_MAX_BLOCK_SIZE}, not {k_store.shape[1]}")
    out = _launch("paged_decode_attention", paged_decode_attention_grouped,
                  q, k_store, v_store, block_tables, kv_length)
    if B:
        with _count_lock:
            launches += 1
    return out


def decode_attention(q, k_cache, v_cache, kv_length, return_lse=False):
    """q [B,1,Hq,D]; caches [B,S,Hkv,D]; kv_length [B] int32 (valid
    positions including the current token; a length past S attends all S
    positions, as the reference's mask does; a length of 0 gives 0)
    -> [B,1,Hq,D].  With ``return_lse`` -> (out, lse [B,Hq] float32, each
    head's log-sum-exp of its scaled scores, -inf at length 0): the
    partial result of one sequence shard, which the caller combines with
    the others' (``models.attention._combine_model``)."""
    global contiguous_launches
    _check("decode_attention", q, k_cache, v_cache, kv_length)
    B, _, Hq, D = q.shape
    if k_cache.shape[0] != B:
        raise ValueError(f"caches must be [{B}, S, Hkv, D], got "
                         f"{tuple(k_cache.shape)}")
    lse = (torch.empty((B, Hq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if q.device.type == "meta":
        cost.charge("decode_attention", *cost.decode_attention(q, k_cache))
        out = torch.empty_like(q)
    elif q.device.type == "cpu":
        qg = q.reshape(B, k_cache.shape[2], Hq // k_cache.shape[2], D)
        got = ref.decode_ref(qg, k_cache, v_cache, kv_length,
                             return_lse=return_lse)
        out, lse = got if return_lse else (got, None)
        out = out.reshape(B, 1, Hq, D)
        lse = None if lse is None else lse.reshape(B, Hq)
    else:
        out = _launch("decode_attention", decode_attention_grouped, q,
                      k_cache, v_cache, kv_length, lse=lse)
        if B:
            with _count_lock:
                contiguous_launches += 1
    return (out, lse) if return_lse else out
