"""Block-paged KV cache for the serving engine.

The counterpart of the JAX package's ``PagedCachePool`` and its helpers:
each of the K and V stores is allocated once as ``[L, num_blocks,
block_size, Hkv, D]`` in the compute dtype on the engine's device; a
sequence is a *block table* (list of physical block ids) and
``BlockAllocator`` hands out blocks with per-block refcounts, so
sequences sharing a prompt prefix point at the same physical blocks and
the first divergent write copies only the boundary block.  Block 0 is the
null block: padded batch rows and padded chunk positions write there.

Decode writes straight into the store (``attention_decode_paged``); only
chunked prefill reassembles a contiguous view (``gather_block_view``) and
scatters the newly produced positions back (``scatter_block_writes``).
Stores are updated in place.
"""
from __future__ import annotations

from collections import deque
from typing import Optional

import torch

from repro_torch.models.config import ModelConfig

NULL_BLOCK = 0  # physical block 0 is never allocated: padded rows write here


class BlockAllocator:
    """Refcounted free-block allocator over ``num_blocks`` physical blocks.

    Block 0 is reserved as the null block, so ``capacity`` is
    ``num_blocks - 1``.  ``allocate()`` and ``free()`` are O(1);
    ``fork()`` adds a reference so several block tables (or residency
    entries) can share one physical block, and the last ``free()``
    returns it to the free list.  Double frees and forks of unallocated
    blocks raise — a block table pointing at a recycled block silently
    corrupts another sequence's KV, so the invariant is enforced here."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is the null block)")
        self.num_blocks = num_blocks
        self._free: deque[int] = deque(range(1, num_blocks))
        self._ref = [0] * num_blocks

    @property
    def capacity(self) -> int:
        return self.num_blocks - 1

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_live(self) -> int:
        return self.capacity - len(self._free)

    def refcount(self, block: int) -> int:
        return self._ref[block]

    def allocate(self) -> Optional[int]:
        """Pop a free block with refcount 1, or None when exhausted."""
        if not self._free:
            return None
        b = self._free.popleft()
        self._ref[b] = 1
        return b

    def fork(self, block: int):
        """Add a reference: a second block table now points at ``block``."""
        if block <= NULL_BLOCK or block >= self.num_blocks:
            raise ValueError(f"fork of invalid block {block}")
        if self._ref[block] <= 0:
            raise ValueError(f"fork of unallocated block {block}")
        self._ref[block] += 1

    def free(self, block: int) -> bool:
        """Drop one reference; returns True when the block became free."""
        if block <= NULL_BLOCK or block >= self.num_blocks:
            raise ValueError(f"free of invalid block {block}")
        if self._ref[block] <= 0:
            raise ValueError(f"double free of block {block}")
        self._ref[block] -= 1
        if self._ref[block] == 0:
            self._free.append(block)
            return True
        return False

    def block_savings(self) -> int:
        """Physical blocks saved by sharing: sum of (refcount - 1) over
        live blocks."""
        return sum(r - 1 for r in self._ref if r > 1)


def gather_block_view(store, block_tables, lens):
    """Reassemble a contiguous cache view from a blocked store.

    ``store``: ``{"k", "v"}`` of ``[L, num_blocks, block_size, Hkv, D]``;
    ``block_tables``: ``[B, max_blocks]`` physical block ids; ``lens``:
    ``[B]`` int32 valid lengths.  Returns a contiguous cache
    ``{"k", "v": [L, B, max_blocks * block_size, Hkv, D], "len": [B]}`` —
    a copy, which ``extend_step`` then writes in place."""
    B, mb = block_tables.shape
    idx = block_tables.long()
    view = {}
    for name in ("k", "v"):
        s = store[name]
        L, _, bs = s.shape[:3]
        view[name] = s[:, idx].reshape((L, B, mb * bs) + tuple(s.shape[3:]))
    view["len"] = lens.to(torch.int32)
    return view


def scatter_block_writes(store, view, write_phys, write_off, write_pos):
    """Write the view rows at ``write_pos[b, t]`` into store cells
    ``(write_phys[b, t], write_off[b, t])``, in place.  Padded (b, t)
    entries are redirected to the null block by the caller (phys 0)."""
    B = write_pos.shape[0]
    bidx = torch.arange(B, device=write_pos.device)[:, None]
    for name in ("k", "v"):
        written = view[name][:, bidx, write_pos.long()]  # [L, B, T, ...]
        store[name][:, write_phys.long(), write_off.long()] = written.to(
            store[name].dtype)
    return store


def copy_block(store, src: int, dst: int):
    """Copy-on-write: duplicate physical block ``src`` into ``dst`` in every
    layer's K and V store."""
    for name in ("k", "v"):
        store[name][:, dst] = store[name][:, src]


class PagedCachePool:
    """Block-paged physical KV store + allocator.

    The pool only moves data: the engine owns tables, refcount policy (via
    ``alloc``) and scheduling."""

    def __init__(self, cfg: ModelConfig, num_blocks: int, block_size: int,
                 max_len: int, *, device="cpu"):
        if cfg.family not in ("dense", "moe"):
            raise ValueError(
                f"paged KV cache requires per-position KV (dense/moe), "
                f"not family {cfg.family!r}")
        self.cfg = cfg
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.max_len = max_len
        self.max_blocks = -(-max_len // block_size)  # blocks per sequence
        if self.max_blocks > num_blocks - 1:
            raise ValueError(
                f"num_blocks={num_blocks} cannot hold one max_len={max_len} "
                f"sequence ({self.max_blocks} blocks of {block_size})")
        shape = (cfg.n_layers, num_blocks, block_size, cfg.n_kv_heads,
                 cfg.head_dim)
        self.cache = {name: torch.zeros(shape, dtype=cfg.cdtype,
                                        device=device)
                      for name in ("k", "v")}
        self.alloc = BlockAllocator(num_blocks)

    def copy_block(self, src: int, dst: int):
        """Copy-on-write: duplicate physical block ``src`` into ``dst``."""
        copy_block(self.cache, src, dst)

    @property
    def n_free(self) -> int:
        return self.alloc.n_free

    def block_savings(self) -> int:
        return self.alloc.block_savings()
