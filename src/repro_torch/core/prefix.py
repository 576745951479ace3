"""Unified radix-tree prefix residency (SGLang RadixAttention insight).

One data structure — ``RadixIndex``, a compressed token-sequence trie with
LRU-bounded entries — backs every layer that reasons about "who already
holds this prefix":

  * **Engine** (``repro.serving.engine``): the per-engine index maps each
    freed slot's resident token sequence (value = slot id).  Admission asks
    ``match_lengths(prompt)`` once — O(len(prompt)) — and resumes the slot
    with the deepest usable common prefix, including *partial* matches
    where a branching turn shares a stem but diverges mid-sequence (the
    slot rewinds to the divergence point instead of missing entirely).
    ``summary()`` exports the resident sequences as the replica's
    residency summary.

  * **ReplicaSet** (``repro.core.service``): on its stats tick it collects
    each replica's residency summary from the servicer and feeds it to the
    shared router via ``Router.update_residency`` — the cross-replica
    prefix-map gossip that keeps routing decisions grounded in what each
    replica's KV cache actually holds.

  * **Router** (``repro.core.router.RadixAffinityRouter``): two indices per
    replica set — session assignments (prompt prefix -> replica id,
    replacing the hashed-LRU sticky map) and gossiped residency — answer
    longest-prefix-match routing.  Sessions whose turns diverge after a
    fixed hash window still route to their warmest replica, and an
    overloaded sticky replica sheds to the replica holding the
    *second-longest* matching prefix rather than blindly to least-loaded.

Data flow: engine residency -> replica-set stats tick -> router residency
index -> routing decision -> engine partial resume.  Values are opaque
identifiers (slot ids in the engine, stable replica ids in the router)
that survive replica-set membership churn, so only sessions homed on a
dead replica re-home after an autoscale or crash.

The structure is a classic compressed radix tree: edges carry token-tuple
labels, terminal nodes carry (value -> entry) sets, and every node keeps a
refcount of the values present in its subtree so longest-match queries can
report the best common-prefix length *per value* in a single O(len(seq))
descent.  Entries are LRU-tracked globally; inserting a sequence that
extends an existing same-value entry on its path replaces (compacts) the
shorter one.
"""
from __future__ import annotations

import itertools
import threading
from collections import OrderedDict
from typing import Any, Iterable, Optional


def _lcp_len(label: tuple, seq: tuple, offset: int) -> int:
    """Length of the common prefix of ``label`` and ``seq[offset:]``."""
    n = min(len(label), len(seq) - offset)
    k = 0
    while k < n and label[k] == seq[offset + k]:
        k += 1
    return k


class _Node:
    __slots__ = ("edges", "entries", "vals")

    def __init__(self):
        self.edges: dict = {}  # first token -> (label tuple, child _Node)
        self.entries: dict = {}  # value -> None (ordered set of terminals)
        self.vals: dict = {}  # value -> entry refcount within this subtree


class RadixIndex:
    """LRU-bounded radix tree over token sequences with per-value queries.

    Thread-safe: every public operation takes an internal lock, so a
    replica set may snapshot an engine's residency summary while the
    engine thread keeps inserting (and a shared router may serve picks
    while residency gossip lands).
    """

    def __init__(self, capacity: int = 0):
        self.capacity = capacity  # max entries; 0 -> unbounded
        self.root = _Node()
        self._lock = threading.Lock()
        # (value, id(terminal node)) -> (seq, value, node); insertion order
        # is recency order (refreshed on re-insert)
        self._entries: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._by_value: dict = {}  # value -> set of entry keys
        self._touch: dict = {}  # value -> last-insert tick (recency)
        self._clock = itertools.count()

    # -- mutation -----------------------------------------------------------
    def insert(self, seq: Iterable, value: Any) -> bool:
        """Associate ``value`` with token sequence ``seq``.

        A same-value entry that is a strict prefix of ``seq`` is removed
        (compaction: the longer sequence subsumes it — the growing-session
        pattern).  Returns False for empty sequences.
        """
        seq = tuple(seq)
        if not seq:
            return False
        with self._lock:
            node, depth = self.root, 0
            path = [self.root]
            subsumed = []
            while depth < len(seq):
                if value in node.entries:
                    subsumed.append((value, id(node)))
                edge = node.edges.get(seq[depth])
                if edge is None:
                    child = _Node()
                    node.edges[seq[depth]] = (seq[depth:], child)
                    node, depth = child, len(seq)
                    path.append(node)
                    break
                label, child = edge
                k = _lcp_len(label, seq, depth)
                if k == len(label):
                    node, depth = child, depth + k
                    path.append(node)
                    continue
                # split the edge at k
                mid = _Node()
                mid.vals = dict(child.vals)
                mid.edges[label[k]] = (label[k:], child)
                node.edges[seq[depth]] = (label[:k], mid)
                depth += k
                path.append(mid)
                if depth == len(seq):
                    node = mid
                    break
                leaf = _Node()
                mid.edges[seq[depth]] = (seq[depth:], leaf)
                node, depth = leaf, len(seq)
                path.append(node)
                break
            key = (value, id(node))
            if value in node.entries:
                self._entries.move_to_end(key)
            else:
                node.entries[value] = None
                for nd in path:
                    nd.vals[value] = nd.vals.get(value, 0) + 1
                self._entries[key] = (seq, value, node)
                self._by_value.setdefault(value, set()).add(key)
            self._touch[value] = next(self._clock)
            for old in subsumed:
                if old != key and old in self._entries:
                    self._remove_entry(old)
            while self.capacity and len(self._entries) > self.capacity:
                oldest = next(iter(self._entries))
                if oldest == key:  # never evict what was just inserted
                    break
                self._remove_entry(oldest)
            return True

    def remove(self, seq: Iterable, value: Any) -> bool:
        """Remove the exact (seq, value) entry; True if it existed."""
        seq = tuple(seq)
        with self._lock:
            for key in self._by_value.get(value, set()):
                if self._entries[key][0] == seq:
                    self._remove_entry(key)
                    return True
        return False

    def remove_value(self, value: Any) -> int:
        """Drop every entry carrying ``value`` (slot recycled / replica
        left the set).  Returns how many entries were removed."""
        with self._lock:
            keys = list(self._by_value.get(value, ()))
            for key in keys:
                self._remove_entry(key)
            self._touch.pop(value, None)
            return len(keys)

    def evict_lru(self) -> Optional[tuple]:
        """Remove the least-recently-inserted entry; returns (seq, value)."""
        with self._lock:
            if not self._entries:
                return None
            key = next(iter(self._entries))
            seq, value, _ = self._entries[key]
            self._remove_entry(key)
            return seq, value

    def clear(self):
        with self._lock:
            self.root = _Node()
            self._entries.clear()
            self._by_value.clear()
            self._touch.clear()

    # -- queries ------------------------------------------------------------
    def longest_match(self, seq: Iterable) -> tuple:
        """(length, value) of the longest common prefix between ``seq`` and
        any stored sequence; (0, None) when nothing shares a first token.
        Ties prefer the most recently inserted value."""
        seq = tuple(seq)
        with self._lock:
            node, depth = self.root, 0
            while depth < len(seq):
                edge = node.edges.get(seq[depth])
                if edge is None:
                    break
                label, child = edge
                k = _lcp_len(label, seq, depth)
                node, depth = child, depth + k
                if k < len(label):
                    break
            if depth == 0 or not node.vals:
                return 0, None
            best = max(node.vals, key=lambda v: self._touch.get(v, -1))
            return depth, best

    def match_lengths(self, seq: Iterable) -> dict:
        """Best common-prefix length per stored value, in one descent:
        ``{value: lcp}`` covering every value in the index (0 when the
        value shares nothing with ``seq``)."""
        seq = tuple(seq)
        out: dict = {}
        with self._lock:
            for v in self.root.vals:
                out[v] = 0
            node, depth = self.root, 0
            while depth < len(seq):
                edge = node.edges.get(seq[depth])
                if edge is None:
                    break
                label, child = edge
                k = _lcp_len(label, seq, depth)
                d = depth + k
                for v in child.vals:
                    out[v] = d
                if k < len(label):
                    break
                node, depth = child, d
        return out

    def summary(self, max_entries: int = 64, max_len: int = 128) -> list:
        """Compact residency summary: the most recently inserted sequences
        (newest first), each truncated to ``max_len`` tokens — the payload
        a replica gossips to the router."""
        with self._lock:
            out = []
            for seq, _value, _node in reversed(self._entries.values()):
                out.append(list(seq[:max_len]))
                if len(out) >= max_entries:
                    break
            return out

    def values(self) -> set:
        with self._lock:
            return set(self._by_value)

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, value) -> bool:
        return value in self._by_value

    # -- internals ----------------------------------------------------------
    def _remove_entry(self, key):
        """Remove one entry and restore the tree invariants (refcounts,
        empty-node pruning, single-edge merge).  Caller holds the lock."""
        seq, value, node = self._entries.pop(key)
        keys = self._by_value.get(value)
        if keys is not None:
            keys.discard(key)
            if not keys:
                del self._by_value[value]
        # re-walk the exact path (splits preserve token boundaries)
        path = [(self.root, 0)]
        cur, depth = self.root, 0
        while depth < len(seq):
            label, child = cur.edges[seq[depth]]
            depth += len(label)
            cur = child
            path.append((cur, depth))
        del node.entries[value]
        for nd, _ in path:
            c = nd.vals.get(value, 0) - 1
            if c <= 0:
                nd.vals.pop(value, None)
            else:
                nd.vals[value] = c
        # prune empties / merge pass-through nodes bottom-up
        for i in range(len(path) - 1, 0, -1):
            nd, _ = path[i]
            parent, pdepth = path[i - 1]
            if nd.entries:
                break
            tok = seq[pdepth]
            plabel = parent.edges[tok][0]
            if not nd.edges:
                del parent.edges[tok]
                continue  # parent may now be prunable too
            if len(nd.edges) == 1:
                (clabel, gchild), = nd.edges.values()
                parent.edges[tok] = (plabel + clabel, gchild)
            break
