"""KV-cache pools for the serving engine: slot-granular and block-paged.

``CachePool`` is the counterpart of the JAX package's slot pool: one
``[..., max_seqs, ...]`` region per cache leaf, laid out by
``cache_template`` for the transformer (with an encoder-decoder's cross
K/V), ``ssm`` (rwkv6) and ``hybrid`` (zamba2) families, allocated once on
the engine's device and updated in place; admit/evict at whole-slot
granularity, blank slots first.  It is the pool of every state-carrying
family, which has no per-position KV to page, and of the encoder-decoder
and vision-prefix families.

The block-paged pool is the counterpart of the JAX package's
``PagedCachePool`` and its helpers: each of the K and V stores is allocated once as ``[L, num_blocks,
block_size, Hkv, D]`` in the compute dtype on the engine's device; a
sequence is a *block table* (list of physical block ids) and
``BlockAllocator`` hands out blocks with per-block refcounts, so
sequences sharing a prompt prefix point at the same physical blocks and
the first divergent write copies only the boundary block.  Block 0 is the
null block: padded batch rows and padded chunk positions write there.

Decode writes straight into the store (``attention_decode_paged``); only
chunked prefill reassembles a contiguous view (``gather_block_view``) and
scatters the newly produced positions back (``scatter_block_writes``).
Stores are updated in place.  A sequence migrating between engines (the
disaggregated prefill->decode handoff) carries its blocks' rows on the host
in the reference's payload format (``extract_blocks`` / ``insert_blocks``).

Under a device mesh (``mesh=``) the slot pool is laid out by
``launch.specs.cache_specs`` (slots over the batch axes, the KV sequence
and the state's heads over "model") and the paged store by
``store_spec`` (kv heads over "model" where they divide it, never a split
of a block or by batch); each pool operation then touches each rank's own
shard, so the pool moves the same data as on one device.
"""
from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import nn
from repro_torch.models.config import ModelConfig
from repro_torch.models.mamba2 import ssm_dims


# ---------------------------------------------------------------------------
# Slot pool
# ---------------------------------------------------------------------------

# an encoder-decoder slot's cross K/V positions: Whisper's fixed audio
# context (the reference's ``launch/specs.py`` ``WHISPER_FRAMES``).  A
# shorter prefill's frames are zero-padded to it, and decode attends all of
# them, as the reference does
WHISPER_FRAMES = 1500


def cache_template(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """The slot cache's leaves as nested dicts of ``(shape, dtype)``: the
    layout each family's ``prefill`` returns at batch 1 and its ``decode``
    reads (the part of the reference's ``launch/specs.py:cache_template``
    that the slot pool uses)."""
    cd = cfg.cdtype
    f32, i32 = torch.float32, torch.int32
    if cfg.family == "hybrid":
        G = cfg.n_layers // cfg.attn_every
        K = cfg.attn_every
        d_in, H, N, _ = ssm_dims(cfg)
        W = cfg.ssm_conv
        kv = (G, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        return {
            "ssm": {"conv": {"x": ((G, K, batch, W - 1, d_in), cd),
                             "B": ((G, K, batch, W - 1, N), cd),
                             "C": ((G, K, batch, W - 1, N), cd)},
                    "ssm": ((G, K, batch, H, N, cfg.ssm_head_dim), f32)},
            "attn": {"k": (kv, cd), "v": (kv, cd), "len": ((G, batch), i32)},
        }
    if cfg.family == "ssm":
        L, d, hd = cfg.n_layers, cfg.d_model, cfg.rwkv_head_dim
        return {
            "att": {"shift": ((L, batch, d), cd),
                    "wkv": ((L, batch, d // hd, hd, hd), f32)},
            "ffn": {"shift": ((L, batch, d), cd)},
        }
    L = cfg.dec_layers or cfg.n_layers
    kv = (L, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    out = {"k": (kv, cd), "v": (kv, cd), "len": ((batch,), i32)}
    if cfg.family == "encdec":
        cross = (L, batch, WHISPER_FRAMES, cfg.n_kv_heads, cfg.head_dim)
        out["cross_k"] = (cross, cd)
        out["cross_v"] = (cross, cd)
    return out


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _shard_for(new, leaf, bdim: int):
    """(``new``'s local tensor, its global offsets) with ``new`` (a prefill
    leaf: batch 1, a tensor or DTensor) split as the pool's ``leaf`` is on
    each dim of the same size other than the batch, and whole elsewhere:
    a collective every rank calls, whether or not it holds the slot."""
    if not hasattr(new, "device_mesh"):
        return new, (0,) * new.dim()
    from torch.distributed.tensor import Replicate, Shard

    pl = [p if isinstance(p, Shard) and p.dim != bdim
          and new.shape[p.dim] == leaf.shape[p.dim] else Replicate()
          for p in leaf.placements]
    new = new.redistribute(new.device_mesh, pl)
    return new.to_local(), nn.local_offsets(new)


def _build(tree, fn):
    if isinstance(tree, dict):
        return {k: _build(v, fn) for k, v in tree.items()}
    return fn(tree)


class CachePool:
    """Zero-initialized cache for ``max_seqs`` slots + residency-aware
    slot allocator.

    A freed slot may stay *resident*: its KV still covers a token sequence
    the engine's radix residency index remembers, so a later prompt can
    resume it.  ``allocate()`` prefers blank free slots (FIFO) and only
    recycles a resident one when no blank slot is left; among resident
    slots, free order approximates least-recent retirement, so the coldest
    cache is evicted first.  The free list is two deques, so
    ``allocate()`` is O(1)."""

    def __init__(self, cfg: ModelConfig, max_seqs: int, max_len: int, *,
                 device=None, mesh=None):
        device = resolve_device(device)  # None: the card, or raise
        self.cfg = cfg
        self.max_seqs = max_seqs
        self.max_len = max_len
        self.cache = _build(cache_template(cfg, max_seqs, max_len),
                            lambda sd: torch.zeros(sd[0], dtype=sd[1],
                                                   device=device))
        if mesh is not None:
            self.cache = nn.lay_out_cache(self.cache, mesh)
        self._free_blank: deque[int] = deque(range(max_seqs))
        self._free_resident: deque[int] = deque()
        self._resident: set[int] = set()

    # -- slot allocation ------------------------------------------------
    def allocate(self) -> Optional[int]:
        """Pop a free slot, blank ones first; the caller must drop any
        residency bookkeeping for the returned slot (its cache is about
        to be replaced)."""
        if self._free_blank:
            return self._free_blank.popleft()
        if self._free_resident:  # no blank slot left: evict the coldest
            slot = self._free_resident.popleft()
            self._resident.discard(slot)
            return slot
        return None

    def free(self, slot: int, resident: bool = False):
        """Return a slot to the pool; ``resident=True`` marks its KV as
        still covering a resumable sequence (prefix reuse)."""
        if resident:
            self._resident.add(slot)
            self._free_resident.append(slot)
        else:
            self._resident.discard(slot)
            self._free_blank.append(slot)

    def take(self, slot: int) -> bool:
        """Claim a SPECIFIC free slot (prefix-reuse admission).  Returns
        False if it is not free."""
        for q in (self._free_resident, self._free_blank):
            try:
                q.remove(slot)
            except ValueError:
                continue
            self._resident.discard(slot)
            return True
        return False

    @property
    def n_free(self) -> int:
        return len(self._free_blank) + len(self._free_resident)

    @property
    def n_free_blank(self) -> int:
        """Free slots with no resident cache (allocate() serves these
        first)."""
        return len(self._free_blank)

    # -- data movement ----------------------------------------------------
    def _slot_rows(self, path, leaf, slot: int):
        """(slot's part of this rank's shard of ``leaf``, the global offsets
        of that part's dims), or None where the shard holds no row of
        ``slot``."""
        bdim = nn.batch_dim_for(path, leaf.dim())
        loc, off = nn.local(leaf), nn.local_offsets(leaf)
        if not off[bdim] <= slot < off[bdim] + loc.shape[bdim]:
            return None
        return (loc.select(bdim, slot - off[bdim]),
                off[:bdim] + off[bdim + 1:])

    def insert(self, slot: int, prefill_cache):
        """Write a single-request prefill cache (batch 1) into ``slot``, in
        place; a leaf covering fewer positions than the pool is
        zero-padded.  Under a mesh each rank writes its shard of the slot
        from the prefill's leaf as it was computed, redistributed once to
        the pool's split where the sizes match (``_shard_for``)."""
        for path, leaf in _leaves(self.cache):
            bdim = nn.batch_dim_for(path, leaf.dim())
            new, new_off = _shard_for(_leaf(prefill_cache, path), leaf, bdim)
            rows = self._slot_rows(path, leaf, slot)
            if rows is None:
                continue
            dst, off = rows
            src = new.select(bdim, 0)
            new_off = new_off[:bdim] + new_off[bdim + 1:]
            src = src[tuple(slice(o - lo, o - lo + n) for o, lo, n
                            in zip(off, new_off, dst.shape))]
            if src.shape != dst.shape:
                dst.zero_()
                dst = dst[tuple(slice(0, n) for n in src.shape)]
            dst.copy_(src)

    def set_len(self, slot: int, n: int):
        """Fix the true sequence length of a right-padded bucketed
        prefill."""
        self.set_lens({slot: n})

    def set_lens(self, updates: dict):
        """Set many slots' lengths (``{slot: n}``) at once, in place.  The
        speculative-decode rewind uses this: a verify forward advances
        EVERY slot's length by the chunk width, so all tracked slots
        rewind together."""
        for path, leaf in _leaves(self.cache):
            if path[-1] == "len":
                for slot, n in updates.items():
                    rows = self._slot_rows(path, leaf, slot)
                    if rows is not None:
                        rows[0].fill_(n)

    def reset_slot(self, slot: int):
        """Zero every cache leaf of ``slot``, in place."""
        for path, leaf in _leaves(self.cache):
            rows = self._slot_rows(path, leaf, slot)
            if rows is not None:
                rows[0].zero_()


# ---------------------------------------------------------------------------
# Block-paged pool
# ---------------------------------------------------------------------------


NULL_BLOCK = 0  # physical block 0 is never allocated: padded rows write here


def store_spec(shape, mesh) -> tuple:
    """The paged store's layout [L, num_blocks, block_size, Hkv, D] on
    ``mesh``: the kv heads over "model" where they divide it, else
    replicated.  Its blocks are shared by every sequence, so neither the
    batch nor a block is ever split."""
    m = nn.mesh_shape(mesh).get("model", 1)
    return (None, None, None, "model" if shape[3] % m == 0 else None, None)


def place_store(store, mesh):
    """A paged store ({"k", "v"}) laid out by ``store_spec``."""
    return {name: nn.constrain(t, mesh, store_spec(t.shape, mesh))
            for name, t in store.items()}


def _like_store(local, s):
    """``local`` (a tensor computed from ``s``'s local shard, the same
    dims sharded) as ``s`` is: a DTensor on its mesh, or as it is."""
    if not hasattr(s, "device_mesh"):
        return local
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, s.device_mesh, s.placements,
                              run_check=False)


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
        loc = nn.local(s)
        L, _, bs = loc.shape[:3]
        view[name] = _like_store(loc[:, idx].reshape(
            (L, B, mb * bs) + tuple(loc.shape[3:])), s)
    view["len"] = lens.to(torch.int32)
    return view


def scatter_block_writes(store, view, write_phys, write_off, write_pos):
    """Write the view rows at ``write_pos[b, t]`` into store cells
    ``(write_phys[b, t], write_off[b, t])``, in place.  Padded (b, t)
    entries are redirected to the null block by the caller (phys 0); a
    padded position past the view reads its last row, as the reference's
    gather clamps it."""
    B = write_pos.shape[0]
    bidx = torch.arange(B, device=write_pos.device)[:, None]
    for name in ("k", "v"):
        loc = nn.local(store[name])
        rows = write_pos.long().clamp(max=view[name].shape[2] - 1)
        written = nn.local(view[name])[:, bidx, rows]  # [L, B, T, ...]
        loc[:, write_phys.long(), write_off.long()] = written.to(loc.dtype)
    return store


def copy_block(store, src: int, dst: int):
    """Copy-on-write: duplicate physical block ``src`` into ``dst`` in every
    layer's K and V store."""
    for name in ("k", "v"):
        loc = nn.local(store[name])
        loc[:, dst] = loc[:, src]


def extract_blocks(store, blocks, n_pre: int = 0):
    """Serialize physical blocks out of a paged store for migration.

    Returns the reference's payload: ``{leaf_path: host tensor}`` with the
    block dim in front, keyed as the reference's store is laid out (an MoE
    model's first ``n_pre`` dense layers apart from the scanned stack):
    ``("scan", "k")`` -> ``[n_blocks, L - n_pre, block_size, Hkv, D]`` and
    ``("pre", "layer_i", "k")`` -> ``[n_blocks, block_size, Hkv, D]``, the
    same for ``"v"``.  The tensors are copied to the host (a bf16 tensor
    has no numpy dtype), which is what ``insert_blocks`` writes back on the
    receiving engine."""
    idx = torch.as_tensor(list(blocks), dtype=torch.long,
                          device=store["k"].device)
    out = {}
    for name in ("k", "v"):
        s = store[name]
        rows = nn.gathered(_like_store(nn.local(s).index_select(1, idx), s))
        rows = rows.movedim(1, 0).cpu()
        for i in range(n_pre):
            out[("pre", f"layer_{i}", name)] = rows[:, i]
        out[("scan", name)] = rows[:, n_pre:]
    return out


def insert_blocks(store, leaves, dst_blocks):
    """Write serialized block rows (``extract_blocks``' payload, from this
    package or a numpy payload from the reference's, possibly of another
    engine) into this store at ``dst_blocks``, in place, cast to the
    store's dtype and device.  The scanned stack fills the last layers, so
    the number of ``pre`` layers follows from its depth.  Block 0 is the
    null block and is never a destination."""
    if NULL_BLOCK in dst_blocks:
        raise ValueError("insert_blocks never writes the null block 0")
    idx = torch.as_tensor(list(dst_blocks), dtype=torch.long,
                          device=store["k"].device)
    for path, src in leaves.items():
        name = path[-1]
        if name not in ("k", "v"):
            continue
        h0 = nn.local_offsets(store[name])[3]
        s = nn.local(store[name])
        if isinstance(src, np.ndarray):
            if src.dtype.kind not in "fiu":  # a numpy bfloat16 extension
                src = src.astype(np.float32)
            src = torch.tensor(src)
        # (this rank's kv heads of a store laid out on a mesh)
        src = src.to(device=s.device, dtype=s.dtype).narrow(
            -2, h0, s.shape[3])
        if path[0] == "scan":
            dst, src = s[s.shape[0] - src.shape[1]:], src.movedim(0, 1)
        else:
            dst = s[int(path[1].removeprefix("layer_"))]
        dst.index_copy_(dst.dim() - 4, idx, src)
    return store


class PagedCachePool:
    """Block-paged physical KV store + allocator.

    The pool only moves data: the engine owns tables, refcount policy (via
    ``alloc``) and scheduling."""

    def __init__(self, cfg: ModelConfig, num_blocks: int, block_size: int,
                 max_len: int, *, device=None, mesh=None):
        device = resolve_device(device)  # None: the card, or raise
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
        if mesh is not None:
            self.cache = place_store(self.cache, mesh)
        self.alloc = BlockAllocator(num_blocks)

    def copy_block(self, src: int, dst: int):
        """Copy-on-write: duplicate physical block ``src`` into ``dst``."""
        copy_block(self.cache, src, dst)

    @property
    def n_free(self) -> int:
        return self.alloc.n_free

    def block_savings(self) -> int:
        return self.alloc.block_savings()
