"""The work of each hand-written kernel: its FLOPs and HBM bytes.

One function a kernel, from the shapes and dtypes of the tensors its
wrapper is given (real or ``meta``).  The bytes are what the kernel must
move at least: each input read once, each output written once.  The FLOPs
count a multiply-add as two; the scans count the operations of their
chunked algorithm (WKV6 ``T·H·(7·L·hd + 4·hd²)``, SSD ``2·T·H·(L·N + L·P +
2·N·P)`` a sequence).  Where the work depends on the data (the decode
kernels stop at each sequence's length), the caller passes the positions
this run attends; without them every cached position counts.

``chip_smoke.py`` reads a kernel's bound from here, and the wrappers charge
the same numbers to the cost counter (``launch/cost.py``) when they are
given ``meta`` tensors, so a kernel's bound and the dry-run read one count
of its work.

``charge`` hands a kernel's work to every active counter; a counter
registers itself with ``push`` / ``pop``, and ``active`` finds the
innermost.  The module imports nothing, so a script can load it from its
own checkout by path while it times another tree's kernels.
"""
from __future__ import annotations

# The H100 SXM data sheet's figures, not measurements: a bound divides by
# them.  The bf16 dense tensor-core peak is the highest rate the card has,
# so a compute time against it is a lower bound for float32 work too.
PEAK_FLOPS = 989e12  # dense bf16 FLOP/s
HBM_BW = 3.35e12  # HBM3 bytes/s
HBM_BYTES = 80e9  # device memory
NVLINK_BW = 450e9  # NVLink 4 bytes/s, one direction (900 GB/s both)

_counters: list = []  # the active cost counters, innermost last


def push(counter):
    _counters.append(counter)


def pop(counter):
    _counters.remove(counter)


def active():
    """The innermost active counter, or None."""
    return _counters[-1] if _counters else None


def charge(name: str, flops: float, nbytes: float):
    """Charge one call of kernel ``name`` to the active counters."""
    for c in _counters:
        c.charge_kernel(name, flops, nbytes)


def flash_attention(q, k, v):
    """Causal attention q [B,S,Hq,D], k/v [B,S,Hkv,D]: q, k, v read, out
    and the float32 lse [B,Hq,S] written; q.k and p.v over the causal
    triangle, ``4·B·Hq·D·S(S+1)/2``."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    nbytes = ((2 * B * S * Hq * D + 2 * B * S * Hkv * D) * q.element_size()
              + B * Hq * S * 4)
    flops = 4 * B * Hq * D * S * (S + 1) // 2
    return flops, nbytes


def decode_attention(q, k_cache, attended=None):
    """One query token q [B,1,Hq,D] against contiguous caches [B,S,Hkv,D]:
    the K and V rows of the ``attended`` positions (summed over the batch;
    all B·S when None), q, out and the int32 lengths."""
    B, _, Hq, D = q.shape
    Hkv = k_cache.shape[2]
    if attended is None:
        attended = B * k_cache.shape[1]
    isz = q.element_size()
    nbytes = (attended * Hkv * D * 2 * isz + 2 * B * Hq * D * isz + B * 4)
    return 4 * attended * Hq * D, nbytes


def paged_decode_attention(q, k_store, block_tables, attended=None):
    """One query token q [B,1,Hq,D] against block-paged stores [num_blocks,
    block_size, Hkv, D]: as ``decode_attention`` plus the int32 block
    tables; all B·max_blocks·block_size positions when ``attended`` is
    None."""
    B, _, Hq, D = q.shape
    Hkv = k_store.shape[2]
    if attended is None:
        attended = B * block_tables.shape[1] * k_store.shape[1]
    isz = q.element_size()
    nbytes = (attended * Hkv * D * 2 * isz + 2 * B * Hq * D * isz
              + block_tables.numel() * 4 + B * 4)
    return 4 * attended * Hq * D, nbytes


def wkv(r, chunk: int, has_s0: bool = True):
    """Chunked WKV6 over r/k/v [B,T,H,hd] (r's dtype) and the float32
    log-decay: r, k, v, lw, u and s0 read, y and the float32 final state
    written."""
    B, T, H, hd = r.shape
    n = B * T * H * hd
    isz = r.element_size()
    state = B * H * hd * hd * 4
    nbytes = (3 * n * isz + n * 4 + H * hd * 4 + n * isz + state
              + (state if has_s0 else 0))
    return B * T * H * (7 * chunk * hd + 4 * hd * hd), nbytes


def ssd(x, Bm, chunk: int, has_h0: bool = True):
    """Chunked Mamba2 SSD over x [B,T,H,P] and B/C [B,T,N] (x's dtype):
    x, the float32 dt and A, B, C and h0 read, y and the float32 final
    state written."""
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    isz = x.element_size()
    state = B * H * N * P * 4
    nbytes = (2 * B * T * H * P * isz + B * T * H * 4 + H * 4
              + 2 * B * T * N * isz + state + (state if has_h0 else 0))
    return 2 * B * T * H * (chunk * N + chunk * P + 2 * N * P), nbytes
