"""Continuous-batching inference engine on a slot pool or a block-paged KV
cache.

The counterpart of the JAX package's ``InferenceEngine``.

``paged=False`` (the default, as in the reference) runs the slot pool
(``CachePool``), the engine of every family: dense, ``ssm`` (rwkv6),
``hybrid`` (zamba2), and the encoder-decoder and vision-prefix families,
whose prefill takes zero frames or patches from the stubbed frontends.
Each ``step()`` admits queued requests while a slot is free and the
prefill-token budget allows (transformer prompts right-padded into
buckets; state-carrying families prefilled at the prompt's exact
length, since their state depends on every token; over-long prompts keep
their last ``max_len - 1`` tokens), then runs one batched decode over
EVERY slot, free ones included, as the reference does.  Dense slots keep
their KV resident after retirement, and a later prompt extending a
resident sequence resumes it: the slot's length is rewound to the shared
prefix and the rest of the prompt is fed through decode.

``paged=True`` runs the block-paged pool (dense and MoE).  Each
``step()``:

  1. admits queued requests while the pool's free + reclaimable blocks can
     cover their whole generation (admission by block reservation, so a
     running sequence can always grow), resuming from resident prefix KV
     when the radix index finds one (the resident blocks are forked, and
     the first divergent write copies the boundary block);
  2. feeds one prompt chunk per prefilling sequence through
     ``api.extend`` under the ``max_num_batched_tokens`` budget, charged
     at the padded bucket that actually runs;
  3. runs one batched decode over every sequence past prefill.  With
     ``paged_decode_mode="direct"`` (the default) it runs directly on the
     physical store: the token's K/V is written into its tail block and
     attention reads K/V through the block table (the hand-written paged
     CUDA kernel on the card).  ``"gather"`` (the reference's A/B path)
     reassembles a contiguous view, runs the slot-pool ``decode`` (the
     contiguous CUDA kernel on the card) and scatters the one new row back.

``SpecDecodeSession`` couples a target engine and a draft engine (any mix
of slot pool and paged pool) behind the same surface: the draft proposes
k tokens, the target verifies them in one ``extend``.

Disaggregated serving splits the paged steps across two engines: a prefill
engine only chunk-prefills (``step_prefill_only``) and exports each
sequence once its first token is out (``export_sequence``: its blocks'
rows on the host plus what decode needs to resume); a decode engine adopts
it into blocks of its own (``import_sequence``, admission-gated) and
decodes it with the paged kernel.  ``preempt_sequence`` retires a decoding
sequence's blocks to residency and requeues it; its readmission forks them
back and catches up through ``extend``, so the transcript is unchanged.

``mesh=`` serves under a device mesh, as the reference's
``InferenceEngine(mesh=)``: the caller places the parameters by
``SERVE_RULES`` (``launch.sharding.place_params``), every model call
takes the mesh, and the pools are laid out on it (``kvcache``).  Every
rank runs this same host-side schedule: the logits are gathered whole
before sampling and each rank's sampler draws from the same seeded
generator, so every rank emits the same tokens and keeps the same books.

Greedy output is token-for-token the reference engine's.  Caches and
stores are updated in place where the reference donates them to jitted
functions, and there is one host sync per prefill and per decode step.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from collections import OrderedDict
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.prefix import RadixIndex
from repro_torch.device import resolve_device
from repro_torch.models import ModelApi, get_model, nn
from repro_torch.models.config import ModelConfig
from repro_torch.spans import spanned
from .kvcache import (CachePool, PagedCachePool, extract_blocks,
                      gather_block_view, insert_blocks, scatter_block_writes)
from .sampling import sample


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list
    max_new_tokens: int = 16
    temperature: float = 0.0
    eos_id: Optional[int] = None
    tenant: Optional[str] = None
    qos_class: str = "normal"
    # filled by the engine
    output: list = dataclasses.field(default_factory=list)
    submitted_at: float = 0.0
    # the envelope's stamp where the request came through the middleware
    # (``LLMServicer.submit``): it less ``submitted_at`` is the hand-off
    envelope_at: Optional[float] = None
    # the first admission, into ``running`` or by a prefix resume; a
    # preempted request keeps it, as it keeps its first-token stamp (None
    # for a sequence imported from another engine)
    admitted_at: Optional[float] = None
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    slot: Optional[int] = None
    # slot-pool prefix resume: prompt suffix still to be fed through decode
    # (one token per step); no output is emitted while any remain
    pending_prefix: list = dataclasses.field(default_factory=list)
    cached_prefix: int = 0  # prompt tokens whose prefill was skipped
    truncated: bool = False  # prompt exceeded max_len: the cache does not
    #                          cover the full prompt
    table: list = dataclasses.field(default_factory=list)  # physical blocks
    pos: int = 0  # cache positions holding valid KV
    pending_tokens: list = dataclasses.field(default_factory=list)  # unfed
    reserve_left: int = 0  # admission-reserved blocks not yet allocated
    last_token: Optional[int] = None  # next decode feed

    @property
    def done(self) -> bool:
        return self.finished_at is not None

    @property
    def n_prompt(self) -> int:
        return len(self.prompt)


# zero audio frames an encoder-decoder's prefill encodes (the reference
# engine's stub; the slot's cross K/V is zero-padded to
# ``kvcache.WHISPER_FRAMES``)
ENC_STUB_FRAMES = 64


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _pow2(n: int) -> int:
    """The padded decode batch: the least power of two >= n."""
    B = 1
    while B < n:
        B *= 2
    return B


@dataclasses.dataclass
class _Residency:
    """A retired sequence whose blocks stay allocated for prefix resume."""

    blocks: tuple
    length: int  # tokens of the sequence (KV covers length - 1)


@dataclasses.dataclass
class EngineStats:
    steps: int = 0
    decode_tokens: int = 0
    prefill_tokens: int = 0
    decode_steps: int = 0  # batched decode forwards (one decode-kernel
    #                        launch per attention layer each on the card)
    active_slot_steps: int = 0
    slot_steps: int = 0
    prefix_reuse_hits: int = 0  # admissions that resumed resident KV
    prefix_partial_hits: int = 0  # resumes that rewound PAST a divergence
    prefix_cached_tokens: int = 0  # prompt tokens whose prefill was skipped
    cow_copies: int = 0  # shared blocks duplicated on first divergent write
    peak_running: int = 0  # high-water concurrent admitted sequences
    shared_block_peak: int = 0  # max physical blocks saved by sharing
    evicted_residencies: int = 0  # resident sequences dropped for space
    preemptions: int = 0  # decoding sequences requeued by the WFQ
    #                       scheduler (KV retired to residency)
    preempt_resumes: int = 0  # preempted sequences re-admitted
    free_blocks: int = 0  # live gauges, refreshed every step
    reserved_blocks: int = 0
    started: float = dataclasses.field(default_factory=time.perf_counter)

    @property
    def utilization(self) -> float:
        return self.active_slot_steps / max(1, self.slot_steps)

    @property
    def tokens_per_s(self) -> float:
        dt = time.perf_counter() - self.started
        return (self.decode_tokens + self.prefill_tokens) / max(1e-9, dt)


class InferenceEngine:
    """Single-model continuous-batching engine over a slot pool
    (``paged=False``) or a block-paged KV pool (``paged=True``).

    ``device`` defaults to the CUDA card (``repro_torch.device``); the
    params must already live there."""

    def __init__(self, cfg: ModelConfig, params, *, max_num_seqs: int = 8,
                 max_num_batched_tokens: int = 2048, max_len: int = 512,
                 prefill_buckets=(32, 64, 128, 256, 512), seed: int = 0,
                 enable_prefix_reuse: bool = True, paged: bool = False,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 max_running: Optional[int] = None,
                 paged_decode_mode: str = "direct", device=None, mesh=None):
        if paged_decode_mode not in ("direct", "gather"):
            raise ValueError(
                f"paged_decode_mode must be 'direct' or 'gather', "
                f"not {paged_decode_mode!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.api: ModelApi = get_model(cfg)
        self.mesh = mesh
        # the model calls, under the mesh when there is one
        self._prefill_fn = self._meshed(self.api.prefill)
        self._decode_fn = self._meshed(self.api.decode)
        self._extend_fn = self._meshed(self.api.extend)
        self._decode_paged_fn = self._meshed(self.api.decode_paged)
        self.params = params
        self.max_num_seqs = max_num_seqs
        self.max_num_batched_tokens = max_num_batched_tokens
        self.max_len = max_len
        self.buckets = tuple(b for b in prefill_buckets if b <= max_len) or (max_len,)
        self.queue: list[Request] = []
        self.running: dict[int, Request] = {}  # slot (or uid) -> request
        # radix index over token sequences whose KV is still resident
        # (value = slot id, or a residency id in paged mode); admission
        # finds the deepest resident common prefix in one O(len(prompt))
        # descent
        self._prefix_index = RadixIndex()
        # residency gossip PUSH channel: called (no args) whenever resident
        # KV is dropped, so the replica set can refresh the router's view
        self.on_residency_drop: Optional[Callable[[], None]] = None
        self.stats = EngineStats()
        self._uid = itertools.count()
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        # state-carrying families prefill at the exact prompt length; prefix
        # reuse needs prompt token i <-> cache position i (dense only: the
        # recurrent state has nothing to rewind)
        self._exact_prefill = cfg.family in ("ssm", "hybrid")
        self._prefix_reuse = (enable_prefix_reuse
                              and cfg.family in ("dense", "moe"))
        self.paged = paged
        if not paged:
            self.pool = CachePool(cfg, max_num_seqs, max_len,
                                  device=self.device, mesh=mesh)
            self._resident_len: dict[int, int] = {}  # slot -> covered len
            self._last_tokens = torch.zeros((max_num_seqs,),
                                            dtype=torch.int64,
                                            device=self.device)
            return

        if cfg.family not in ("dense", "moe") or self.api.extend is None:
            raise ValueError(
                f"paged=True requires a pure text-decoder family with "
                f"chunked extend (dense/moe), not {cfg.family!r}")
        self.paged_decode_mode = paged_decode_mode
        self.block_size = block_size
        # memory parity by default: same KV cells as a slot pool of
        # max_num_seqs x max_len (+1 for the reserved null block)
        if num_blocks is None:
            num_blocks = max_num_seqs * (-(-max_len // block_size)) + 1
        self.num_blocks = num_blocks
        self.pool = PagedCachePool(cfg, num_blocks, block_size, max_len,
                                   device=self.device, mesh=mesh)
        self.prefill_chunk = min(prefill_chunk or max(self.buckets),
                                 max_num_batched_tokens)
        self._chunk_buckets = tuple(
            b for b in self.buckets if b <= self.prefill_chunk) \
            or (self.prefill_chunk,)
        # concurrency is block-bounded; max_running only caps the decode
        # batch
        self.max_running = max_running or self.pool.alloc.capacity
        self._prefill_order: list[Request] = []  # FIFO chunk scheduling
        self._residency: "OrderedDict[int, _Residency]" = OrderedDict()
        self._res_holds: dict[int, int] = {}  # block -> residency refs
        self._res_counter = itertools.count()
        self._reserved = 0  # admission-reserved, not-yet-allocated
        self.stats.free_blocks = self.pool.n_free

    # ------------------------------------------------------------------
    # Model calls (in place on the physical store)
    # ------------------------------------------------------------------
    def _meshed(self, fn):
        """``fn`` (a ``ModelApi`` call), or under the mesh: called with it,
        its logits gathered whole on every rank."""
        if self.mesh is None or fn is None:
            return fn

        def call(*args, **kw):
            state, logits = fn(*args, mesh=self.mesh, **kw)
            return state, nn.gathered(logits)

        return call

    def _paged_extend(self, params, store, bt, lens, tokens, wphys, woff):
        view = gather_block_view(store, bt, lens)
        view, logits = self._extend_fn(params, view, tokens, self.cfg)
        T = tokens.shape[1]
        wpos = lens[:, None] + torch.arange(T, device=lens.device)[None, :]
        store = scatter_block_writes(store, view, wphys, woff, wpos)
        return store, logits

    def _paged_decode(self, params, store, bt, lens, tokens, wphys, woff):
        if self.paged_decode_mode == "direct":
            return self._decode_paged_fn(params, store, bt, lens, tokens,
                                         wphys, woff, self.cfg)
        # gather: a contiguous view through the slot-pool decode, then the
        # one new row scattered back
        view = gather_block_view(store, bt, lens)
        view, logits = self._decode_fn(params, view, tokens, self.cfg)
        store = scatter_block_writes(store, view, wphys[:, None],
                                     woff[:, None], lens[:, None])
        return store, logits

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # ------------------------------------------------------------------
    # Public API
    # ------------------------------------------------------------------
    def submit(self, prompt, *, max_new_tokens=16, temperature=0.0,
               eos_id=None, tenant=None, qos_class="normal") -> int:
        req = Request(uid=next(self._uid), prompt=list(prompt),
                      max_new_tokens=max_new_tokens, temperature=temperature,
                      eos_id=eos_id, submitted_at=time.perf_counter(),
                      tenant=tenant, qos_class=qos_class or "normal")
        self.queue.append(req)
        return req.uid

    def has_work(self) -> bool:
        return bool(self.queue or self.running)

    @spanned("engine/step")
    def step(self) -> list:
        """One engine iteration. Returns [(uid, token), ...] emitted."""
        if self.paged:
            return self._step_paged()
        self._admit()
        events = []
        if self.running:
            events = self._decode_step()
        self.stats.steps += 1
        self.stats.active_slot_steps += len(self.running)
        self.stats.slot_steps += self.max_num_seqs
        return events

    def collect_finished(self) -> list:
        """Retire finished requests, freeing their slots.  With prefix
        reuse on, a freed slot's KV stays resident and the sequence it
        covers is remembered, so a later prompt extending it can skip that
        prefill."""
        if self.paged:
            return self._collect_finished_paged()
        done = []
        for slot, req in list(self.running.items()):
            if req.done:
                del self.running[slot]
                if self._prefix_reuse and not req.truncated:
                    seq = tuple(req.prompt) + tuple(req.output)
                    self._drop_residency(slot)  # stale entry, if any
                    self._prefix_index.insert(seq, slot)
                    self._resident_len[slot] = len(seq)
                    self.pool.free(slot, resident=True)
                else:
                    self.pool.free(slot)
                done.append(req)
        return done

    def block_telemetry(self) -> Optional[dict]:
        """Live physical-block telemetry the replica set aggregates per
        model group and gossips to headroom-aware routers (None for the
        slot pool)."""
        if not self.paged:
            return None
        return {
            "free_blocks": self.pool.n_free,
            "total_blocks": self.pool.alloc.capacity,
            "reserved_blocks": self._reserved,
            "shared_blocks": self.pool.block_savings(),
            "cow_copies": self.stats.cow_copies,
            "evicted_residencies": self.stats.evicted_residencies,
            "preemptions": self.stats.preemptions,
            "preempt_resumes": self.stats.preempt_resumes,
        }

    def residency_summary(self, max_entries: Optional[int] = None,
                          max_len: int = 128) -> list:
        """Resident token sequences (newest first, truncated), the payload
        the replica set gossips to the router's residency index."""
        return self._prefix_index.summary(
            max_entries=max_entries or self.max_num_seqs, max_len=max_len)

    def run(self, *, max_steps: int = 100000) -> dict:
        """Drain the queue; returns completed requests keyed by uid."""
        done: dict[int, Request] = {}
        for _ in range(max_steps):
            if not self.has_work():
                break
            self.step()
            for req in self.collect_finished():
                done[req.uid] = req
        return done

    @spanned("engine/step")
    def step_prefill_only(self) -> list:
        """One prefill-role iteration (disaggregated serving): admit and
        chunk-prefill, never decode, so the step's whole token budget goes
        to prompt chunks.  Sequences whose first token is out (and that are
        not done) wait in ``running`` for ``export_sequence()``."""
        if not self.paged:
            raise ValueError("step_prefill_only requires a paged engine")
        return self._step_paged(decode=False)

    def exportable(self) -> list:
        """Uids of running sequences ready for a prefill->decode handoff:
        past prefill (first token emitted), not finished."""
        if not self.paged:
            return []
        return [r.uid for r in self.running.values()
                if r.output and not r.pending_tokens and not r.done]

    def export_sequence(self, uid: int) -> dict:
        """Export a running sequence past prefill for migration to another
        paged engine: its blocks' K/V rows on the host (``extract_blocks``)
        and what ``import_sequence`` needs to resume decode exactly.  The
        request then retires here as a finished one does: its reserve is
        released and its blocks move to a residency entry (prefix reuse
        on, so a follow-up turn on this engine skips the prefill) or
        free."""
        if not self.paged:
            raise ValueError("export_sequence requires a paged engine")
        req = self.running.get(uid)
        if req is None:
            raise KeyError(f"no running request {uid}")
        if not req.output or req.pending_tokens:
            raise ValueError(f"request {uid} has not finished prefill")
        n_pre = self.cfg.first_dense_layers if self.cfg.is_moe else 0
        payload = {
            "leaves": extract_blocks(self.pool.cache, req.table, n_pre),
            "block_size": self.block_size,
            "n_blocks": len(req.table),
            "pos": req.pos,
            "prompt": list(req.prompt),
            "output": list(req.output),
            "last_token": req.last_token,
            "max_new_tokens": req.max_new_tokens,
            "temperature": req.temperature,
            "eos_id": req.eos_id,
            "cached_prefix": req.cached_prefix,
            "truncated": req.truncated,
            "submitted_at": req.submitted_at,
            "first_token_at": req.first_token_at,
        }
        self._retire_paged(req)
        self._refresh_gauges()
        return payload

    def import_sequence(self, payload: dict) -> Optional[int]:
        """Adopt an exported sequence into freshly reserved blocks and
        resume its decode here (the receiving half of the handoff).  Gated
        as ``_admit_paged``: the remaining generation must be covered by
        free + reclaimable blocks net of reservations, and a sequence slot
        must be free; otherwise (or on a block-size mismatch) it returns
        None and the caller recomputes the prompt.  The submit and
        first-token stamps travel with the sequence; it has no admission
        stamp here (it was admitted where it was prefilled)."""
        if not self.paged:
            raise ValueError("import_sequence requires a paged engine")
        if payload["block_size"] != self.block_size:
            return None
        pos = int(payload["pos"])
        out = list(payload["output"])
        if pos >= self.max_len:
            return None
        if len(self.running) >= self.max_running:
            return None
        remaining = max(0, int(payload["max_new_tokens"]) - len(out))
        need = self._blocks_needed(pos + remaining, 0)
        if not self._reserve(need):
            return None
        req = Request(uid=next(self._uid), prompt=list(payload["prompt"]),
                      max_new_tokens=int(payload["max_new_tokens"]),
                      temperature=float(payload["temperature"]),
                      eos_id=payload["eos_id"], output=out,
                      submitted_at=payload["submitted_at"],
                      first_token_at=payload["first_token_at"],
                      cached_prefix=int(payload.get("cached_prefix", 0)),
                      truncated=bool(payload.get("truncated", False)),
                      pos=pos, last_token=payload["last_token"])
        req.reserve_left = need
        req.table = [self._alloc_block(req)
                     for _ in range(int(payload["n_blocks"]))]
        insert_blocks(self.pool.cache, payload["leaves"], req.table)
        self.running[req.uid] = req
        self._check_done(req)
        self._refresh_gauges()
        return req.uid

    def preempt_sequence(self, uid: int) -> bool:
        """Preempt a DECODING sequence: retire its blocks to a residency
        entry, as at finish, and requeue the request, where the WFQ
        scheduler orders it.  Its readmission (``_readmit_preempted``)
        forks the blocks back and catches up from the last covered
        position, so the transcript equals uninterrupted decode.  Queued,
        prefilling, finished and truncated sequences are not preemptable:
        returns False."""
        if not self.paged:
            return False
        req = self.running.get(uid)
        if (req is None or req.done or req.pending_tokens
                or not req.output or req.truncated or not req.table):
            return False
        self._retire_paged(req)
        req.pos = 0
        req.last_token = None
        self.queue.append(req)
        self.stats.preemptions += 1
        self._refresh_gauges()
        return True

    # ------------------------------------------------------------------
    # Internals
    # ------------------------------------------------------------------
    def _check_done(self, req: Request):
        if req.done:
            return
        hit_eos = req.eos_id is not None and req.output and \
            req.output[-1] == req.eos_id
        if len(req.output) >= req.max_new_tokens or hit_eos:
            req.finished_at = time.perf_counter()

    def _first_token(self, req: Request, logits_last) -> int:
        if req.temperature > 0:
            return int(sample(logits_last[None, :], self._gen,
                              temperature=req.temperature)[0])
        return int(torch.argmax(logits_last))

    # ------------------------------------------------------------------
    # Internals (slot pool)
    # ------------------------------------------------------------------
    def _prefill(self, tokens: np.ndarray):
        """Prefill one right-padded prompt.  An encoder-decoder encodes
        ``ENC_STUB_FRAMES`` zero frames and a vision-prefix model takes
        ``vision_tokens or 16`` zero patches (the frontends are stubs, as
        in the reference's ``_admit``)."""
        kw = {"max_len": self.max_len}
        if not self._exact_prefill:
            kw["last_only"] = False
        batch = {"tokens": self._tensor(tokens)}
        stub = {"encdec": ("frame_embeds", ENC_STUB_FRAMES),
                "vlm": ("patch_embeds", self.cfg.vision_tokens or 16)}
        if self.cfg.family in stub:
            name, n = stub[self.cfg.family]
            batch[name] = torch.zeros((1, n, self.cfg.d_model),
                                      dtype=torch.float32, device=self.device)
        return self._prefill_fn(self.params, batch, self.cfg, **kw)

    def _admit(self):
        budget = self.max_num_batched_tokens
        while self.queue and self.pool.n_free > 0:
            req = self.queue[0]
            if self._prefix_reuse and self._try_resume(req):
                self.queue.pop(0)  # resumed: no prefill, no budget charge
                req.admitted_at = time.perf_counter()
                continue
            n = min(req.n_prompt, self.max_len - 1)
            bucket = n if self._exact_prefill else _bucket(n, self.buckets)
            n = min(n, bucket)  # over-long prompts keep their last n tokens
            if bucket > budget:
                break
            self.queue.pop(0)
            req.admitted_at = time.perf_counter()
            slot = self.pool.allocate()  # blank-preferring: resident KV is
            self._drop_residency(slot)  # only evicted when no blank is left
            req.truncated = n < req.n_prompt
            budget -= bucket
            tokens = np.zeros((1, bucket), np.int64)
            tokens[0, :n] = req.prompt[-n:]  # right-pad into the bucket
            cache, logits = self._prefill(tokens)
            self.pool.insert(slot, cache)
            if not self._exact_prefill:
                self.pool.set_len(slot, n)
                logits_last = logits[0, n - 1]
            else:
                logits_last = logits[0]
            self.stats.prefill_tokens += bucket
            tok = self._first_token(req, logits_last)
            req.slot = slot
            req.output.append(tok)
            req.first_token_at = time.perf_counter()
            self._last_tokens[slot] = tok
            self.running[slot] = req
            self._check_done(req)

    def _drop_residency(self, slot: Optional[int], notify: bool = True):
        """Forget a slot's resident sequence (its cache is being replaced
        or re-claimed), notifying the push listener when coverage the
        router may rely on disappeared.  A take-for-resume passes
        ``notify=False``: it is a hit, not an eviction."""
        if slot is None:
            return
        had = self._resident_len.pop(slot, None) is not None
        self._prefix_index.remove_value(slot)
        if notify and had and self.on_residency_drop is not None:
            try:
                self.on_residency_drop()
            except Exception:
                pass  # gossip is best-effort; serving must not care

    def _try_resume(self, req: Request) -> bool:
        """Prefix-reuse fast path: claim the freed slot whose resident KV
        shares the deepest usable prefix with ``req.prompt``, rewind its
        length to that prefix and feed the rest of the prompt through the
        batched decode.  A resident sequence of length L has KV for its
        first L - 1 tokens; the resume must cover at least half the
        prompt (the uncovered suffix is fed one token per step)."""
        m = req.n_prompt
        if m >= self.max_len:  # would be truncated: prefix math breaks
            return False
        threshold = max(1, (m + 1) // 2)
        candidates = []
        for slot, d in self._prefix_index.match_lengths(req.prompt).items():
            L = self._resident_len.get(slot)
            if L is None:
                continue
            covered = min(d, L - 1, m - 1)
            if covered >= threshold:
                candidates.append((covered, slot, L, d))
        candidates.sort(reverse=True)  # deepest usable rewind first
        for covered, slot, L, d in candidates:
            if not self.pool.take(slot):
                continue
            self._drop_residency(slot, notify=False)
            self.pool.set_len(slot, covered)
            self._last_tokens[slot] = req.prompt[covered]
            req.pending_prefix = list(req.prompt[covered + 1:])
            req.cached_prefix = covered
            req.slot = slot
            self.running[slot] = req
            self.stats.prefix_reuse_hits += 1
            if d < L and d < m:  # a true divergence, not a replay
                self.stats.prefix_partial_hits += 1
            self.stats.prefix_cached_tokens += covered
            self.stats.prefill_tokens += 1  # the feed queued into
            #                  _last_tokens; the rest count as they are fed
            return True
        return False

    @spanned("engine/decode")
    def _decode_step(self) -> list:
        """One batched decode over every slot (free ones too, on stale
        tokens, as the reference does)."""
        self.pool.cache, logits = self._decode_fn(
            self.params, self.pool.cache, self._last_tokens, self.cfg)
        self.stats.decode_steps += 1
        temps = np.zeros((self.max_num_seqs,), np.float32)
        for slot, req in self.running.items():
            temps[slot] = req.temperature
        # all-greedy batches skip the sampled path
        tokens = torch.argmax(logits, dim=-1)
        if np.any(temps > 0):
            sampled = sample(logits, self._gen, temperature=1.0)
            tokens = torch.where(self._tensor(temps) > 0, sampled, tokens)
        tokens_np = tokens.cpu().numpy()
        # only a resumed request forces the host-side token rewrite (and
        # the re-upload below)
        has_pending = any(req.pending_prefix
                          for req in self.running.values())
        if has_pending:
            tokens_np = tokens_np.copy()
        events = []
        for slot, req in list(self.running.items()):
            if req.done:
                continue
            if req.pending_prefix:
                # a resumed request still feeding its prompt suffix: feed
                # the next prompt token instead of the model's prediction
                tokens_np[slot] = req.pending_prefix.pop(0)
                self.stats.prefill_tokens += 1
                continue
            tok = int(tokens_np[slot])
            req.output.append(tok)
            if req.first_token_at is None:  # resumed: first real token
                req.first_token_at = time.perf_counter()
            events.append((req.uid, tok))
            self.stats.decode_tokens += 1
            self._check_done(req)
        self._last_tokens = self._tensor(tokens_np) if has_pending else tokens
        return events

    # ------------------------------------------------------------------
    # Internals (paged pool)
    # ------------------------------------------------------------------

    def _step_paged(self, decode: bool = True) -> list:
        self._admit_paged()
        self.stats.peak_running = max(self.stats.peak_running,
                                      len(self.running))
        self._prefill_step_paged()
        events = self._decode_step_paged() if decode else []
        self.stats.steps += 1
        self.stats.active_slot_steps += len(self.running)
        self.stats.slot_steps += max(self.max_num_seqs, len(self.running))
        self.stats.shared_block_peak = max(self.stats.shared_block_peak,
                                           self.pool.block_savings())
        self._refresh_gauges()
        return events

    def _refresh_gauges(self):
        self.stats.free_blocks = self.pool.n_free
        self.stats.reserved_blocks = self._reserved

    def _collect_finished_paged(self) -> list:
        """Retire finished requests (``_retire_paged``)."""
        done = [req for req in self.running.values() if req.done]
        for req in done:
            self._retire_paged(req)
        self._refresh_gauges()
        return done

    def _retire_paged(self, req: Request):
        """Take ``req`` out of the running set and release its unconsumed
        reserve.  With prefix reuse on (and a prompt the KV covers), the
        block table transfers to a residency entry (the references move,
        they are not duplicated), so the blocks stay shareable until
        block-granular eviction reclaims them; otherwise they free."""
        del self.running[req.uid]
        if req in self._prefill_order:
            self._prefill_order.remove(req)
        self._reserved -= req.reserve_left
        req.reserve_left = 0
        if self._prefix_reuse and not req.truncated and req.table:
            seq = tuple(req.prompt) + tuple(req.output)
            res_id = next(self._res_counter)
            self._residency[res_id] = _Residency(tuple(req.table), len(seq))
            for b in req.table:
                self._res_holds[b] = self._res_holds.get(b, 0) + 1
            self._prefix_index.insert(seq, res_id)
        else:
            for b in req.table:
                self.pool.alloc.free(b)
        req.table = []

    def _blocks_needed(self, total_len: int, covered: int) -> int:
        """Blocks a sequence of ``total_len`` tokens must be able to
        allocate, given ``covered`` resumed positions: blocks strictly
        before ``covered // block_size`` are shared read-only and never
        written; a partial boundary block still counts (its first write
        may need a copy-on-write replacement)."""
        bs = self.block_size
        total = min(total_len, self.pool.max_blocks * bs)
        return max(1, -(-total // bs) - covered // bs)

    def _reclaimable_blocks(self) -> int:
        """Blocks whose every reference is a residency hold."""
        alloc = self.pool.alloc
        return sum(1 for b, h in self._res_holds.items()
                   if h > 0 and alloc.refcount(b) == h)

    def _reserve(self, need: int, pinned: int = 0) -> bool:
        """Admission control: admit only when ``need`` blocks are covered
        by free + reclaimable capacity net of earlier reservations (and of
        ``pinned`` reclaimable blocks this admission is about to share)."""
        avail = (self.pool.n_free + self._reclaimable_blocks()
                 - pinned - self._reserved)
        if avail < need:
            return False
        self._reserved += need
        return True

    def _admit_paged(self):
        while self.queue and len(self.running) < self.max_running:
            req = self.queue[0]
            if req.output:  # preempted mid-generation: its own resume
                if not self._readmit_preempted(req):
                    break
                self.queue.pop(0)
                continue
            if self._prefix_reuse and self._try_resume_paged(req):
                self.queue.pop(0)
                req.admitted_at = time.perf_counter()
                continue
            m = min(req.n_prompt, self.max_len - 1)
            need = self._blocks_needed(m + req.max_new_tokens, 0)
            if not self._reserve(need):
                break
            self.queue.pop(0)
            req.admitted_at = time.perf_counter()
            req.truncated = m < req.n_prompt
            req.pending_tokens = list(req.prompt[-m:])
            req.reserve_left = need
            self.running[req.uid] = req
            self._prefill_order.append(req)

    def _try_resume_paged(self, req: Request) -> bool:
        """Prefix resume by block sharing: fork the resident blocks covering
        the prompt's deepest resident prefix.  At least one full block must
        be covered."""
        m = req.n_prompt
        if m >= self.max_len:
            return False
        bs = self.block_size
        best = None
        for res_id, d in self._prefix_index.match_lengths(req.prompt).items():
            ent = self._residency.get(res_id)
            if ent is None:
                continue
            covered = min(d, ent.length - 1, m - 1)
            if covered >= bs and (best is None or covered > best[0]):
                best = (covered, res_id, ent, d)
        if best is None:
            return False
        covered, res_id, ent, d = best
        shared = ent.blocks[:-(-covered // bs)]
        need = self._blocks_needed(m + req.max_new_tokens, covered)
        # the shared blocks stop being reclaimable the moment this
        # sequence pins them: account for that in the reservation check
        alloc = self.pool.alloc
        pinned = sum(1 for b in set(shared)
                     if self._res_holds.get(b, 0) > 0
                     and alloc.refcount(b) == self._res_holds[b])
        if not self._reserve(need, pinned=pinned):
            return False
        for b in shared:
            alloc.fork(b)
        req.table = list(shared)
        req.pos = covered
        req.pending_tokens = list(req.prompt[covered:])
        req.reserve_left = need
        req.cached_prefix = covered
        self.running[req.uid] = req
        self._prefill_order.append(req)
        self._residency.move_to_end(res_id)  # hit: refresh retirement order
        self.stats.prefix_reuse_hits += 1
        if d < ent.length and d < m:
            self.stats.prefix_partial_hits += 1
        self.stats.prefix_cached_tokens += covered
        return True

    def _readmit_preempted(self, req: Request) -> bool:
        """Re-admit a preempted request: its catch-up prompt is the whole
        transcript so far (prompt + output, ending with the last emitted
        token).  The deepest resident prefix (normally its own retired
        blocks, unless eviction claimed them) is forked back and only the
        tail is fed through ``extend``, whose last logits row gives the
        token uninterrupted decode would have given next."""
        seq = list(req.prompt) + list(req.output)
        L = len(seq)
        remaining = req.max_new_tokens - len(req.output)
        bs = self.block_size
        best = None
        if self._prefix_reuse:
            for res_id, d in self._prefix_index.match_lengths(seq).items():
                ent = self._residency.get(res_id)
                if ent is None:
                    continue
                covered = min(d, ent.length - 1, L - 1)
                if covered >= bs and (best is None or covered > best[0]):
                    best = (covered, res_id, ent)
        covered, shared, pinned = 0, (), 0
        if best is not None:
            covered, res_id, ent = best
            shared = ent.blocks[:-(-covered // bs)]
            alloc = self.pool.alloc
            pinned = sum(1 for b in set(shared)
                         if self._res_holds.get(b, 0) > 0
                         and alloc.refcount(b) == self._res_holds[b])
        need = self._blocks_needed(L + remaining, covered)
        if not self._reserve(need, pinned=pinned):
            return False
        for b in shared:
            self.pool.alloc.fork(b)
        if best is not None:
            self._residency.move_to_end(res_id)
            self.stats.prefix_cached_tokens += covered
        req.table = list(shared)
        req.pos = covered
        req.pending_tokens = list(seq[covered:])
        req.reserve_left = need
        self.running[req.uid] = req
        self._prefill_order.append(req)
        self.stats.preempt_resumes += 1
        return True

    def _alloc_block(self, req: Request) -> int:
        """Allocate one physical block for ``req``, evicting resident
        sequences (coldest first) as needed; consumes the request's
        admission reserve."""
        b = self.pool.alloc.allocate()
        while b is None and self._residency:
            self._evict_residency()
            b = self.pool.alloc.allocate()
        if b is None:
            raise RuntimeError(
                "paged KV pool exhausted despite admission reservation")
        if req.reserve_left > 0:
            req.reserve_left -= 1
            self._reserved -= 1
        return b

    def _evict_residency(self):
        """Drop the coldest resident sequence and notify the listener."""
        res_id, ent = self._residency.popitem(last=False)
        for b in ent.blocks:
            self._res_holds[b] -= 1
            if self._res_holds[b] == 0:
                del self._res_holds[b]
            self.pool.alloc.free(b)
        self._prefix_index.remove_value(res_id)
        self.stats.evicted_residencies += 1
        if self.on_residency_drop is not None:
            try:
                self.on_residency_drop()
            except Exception:
                pass  # gossip is best-effort; serving must not care

    def _ensure_writable(self, req: Request, start: int, n: int):
        """Make positions [start, start+n) writable: grow the block table
        and copy-on-write any shared block about to be written."""
        bs = self.block_size
        alloc = self.pool.alloc
        # past-capacity writes clamp to the final position
        cap = self.pool.max_blocks * bs - 1
        start = min(start, cap)
        for lb in range(start // bs, (min(start + n - 1, cap)) // bs + 1):
            if lb < len(req.table):
                b = req.table[lb]
                if alloc.refcount(b) > 1:  # shared: copy before write
                    nb = self._alloc_block(req)
                    self.pool.copy_block(b, nb)
                    alloc.free(b)  # drop only OUR reference
                    req.table[lb] = nb
                    self.stats.cow_copies += 1
            else:
                assert lb == len(req.table), "non-contiguous block write"
                req.table.append(self._alloc_block(req))

    def _prefill_step_paged(self):
        """Feed one prompt chunk per prefilling sequence (admission FIFO)
        until the per-step token budget runs out, charging the PADDED
        bucket that actually runs.  The final chunk's last real logits row
        produces the first generated token."""
        budget = self.max_num_batched_tokens
        for req in list(self._prefill_order):
            if req.done or not req.pending_tokens:
                self._prefill_order.remove(req)
                continue
            fitting = [b for b in self._chunk_buckets if b <= budget]
            if not fitting:
                break
            T = min(len(req.pending_tokens), self.prefill_chunk, fitting[-1])
            bucket = _bucket(T, self._chunk_buckets)
            self._extend_chunk(req, min(T, bucket), bucket)
            budget -= bucket  # charge the padded size that actually ran

    @spanned("engine/extend")
    def _extend_chunk(self, req: Request, T: int, bucket: int):
        """Feed ``req``'s next ``T`` prompt tokens, padded to ``bucket``,
        through ``extend``; the prompt's last chunk gives its first
        token."""
        mb = self.pool.max_blocks
        bs = self.block_size
        self._ensure_writable(req, req.pos, T)
        bt = np.zeros((1, mb), np.int32)
        bt[0, :len(req.table)] = req.table
        tokens = np.zeros((1, bucket), np.int64)
        tokens[0, :T] = req.pending_tokens[:T]
        # padded chunk positions scatter into the null block
        wphys = np.zeros((1, bucket), np.int64)
        woff = np.zeros((1, bucket), np.int64)
        for t in range(T):
            p = req.pos + t
            wphys[0, t] = req.table[p // bs]
            woff[0, t] = p % bs
        self.pool.cache, logits = self._paged_extend(
            self.params, self.pool.cache, self._tensor(bt),
            self._tensor(np.asarray([req.pos], np.int32)),
            self._tensor(tokens), self._tensor(wphys),
            self._tensor(woff))
        req.pending_tokens = req.pending_tokens[T:]
        req.pos += T
        self.stats.prefill_tokens += T
        if not req.pending_tokens:  # prompt complete: first token
            self._prefill_order.remove(req)
            tok = self._first_token(req, logits[0, T - 1])
            req.output.append(tok)
            req.last_token = tok
            if req.first_token_at is None:  # a resumed preemption
                #                 keeps its original first-token stamp
                req.first_token_at = time.perf_counter()
            self._check_done(req)

    @spanned("engine/decode")
    def _decode_step_paged(self) -> list:
        """One batched decode over every sequence past prefill.  The batch
        is padded to a power of two (padding rows carry the null block
        table and length 0, so their writes land in the null block)."""
        active = [r for r in self.running.values()
                  if not r.pending_tokens and not r.done and r.output]
        if not active:
            return []
        for r in active:
            self._ensure_writable(r, r.pos, 1)
        B = _pow2(len(active))
        mb = self.pool.max_blocks
        bs = self.block_size
        bt = np.zeros((B, mb), np.int32)
        lens = np.zeros((B,), np.int32)
        tokens = np.zeros((B,), np.int64)
        # padding rows write to the null block's cell (0, 0)
        wphys = np.zeros((B,), np.int64)
        woff = np.zeros((B,), np.int64)
        temps = np.zeros((B,), np.float32)
        for i, r in enumerate(active):
            bt[i, :len(r.table)] = r.table
            lens[i] = r.pos
            tokens[i] = r.last_token
            p = min(r.pos, mb * bs - 1)  # clamp like the slot pool
            wphys[i] = r.table[p // bs]
            woff[i] = p % bs
            temps[i] = r.temperature
        self.pool.cache, logits = self._paged_decode(
            self.params, self.pool.cache, self._tensor(bt),
            self._tensor(lens), self._tensor(tokens), self._tensor(wphys),
            self._tensor(woff))
        self.stats.decode_steps += 1
        # all-greedy batches skip the sampled path
        greedy = torch.argmax(logits, dim=-1)
        if np.any(temps > 0):
            sampled = sample(logits, self._gen, temperature=1.0)
            hot = self._tensor(temps) > 0
            toks = torch.where(hot, sampled, greedy).cpu().numpy()
        else:
            toks = greedy.cpu().numpy()
        events = []
        for i, r in enumerate(active):
            tok = int(toks[i])
            r.output.append(tok)
            r.last_token = tok
            r.pos += 1
            events.append((r.uid, tok))
            self.stats.decode_tokens += 1
            self._check_done(r)
        return events


@dataclasses.dataclass
class _SpecSeq:
    """One sequence's coupled state across the draft and target engines."""

    treq: Request  # target-engine request (owns the emitted transcript)
    dreq: Optional[Request]  # draft-engine request (proposal KV)
    max_new: int  # real token budget (treq's is inflated until pairing)
    ready: bool = False  # both engines prefilled; in the propose rotation
    t_cov: int = 0  # target cache positions holding valid KV
    d_cov: int = 0  # draft cache positions holding valid KV
    last_tok: int = 0  # last emitted token (target's next verify feed)
    # sequence tokens the draft has not fed yet (ends with last_tok);
    # normally one token, two after a fully-accepted round
    draft_pending: list = dataclasses.field(default_factory=list)


class SpecDecodeSession:
    """Cross-engine speculative decoding: DRAFT proposes, TARGET verifies.

    The counterpart of the JAX package's ``SpecDecodeSession``.  Wraps two
    ``InferenceEngine``s (any mix of slot pool and paged pool) behind the
    engine's own submit/step/collect_finished surface.  Per round the
    draft runs ``k`` batched greedy decode steps to propose ``k`` tokens
    per active sequence, then the target verifies all ``k+1`` positions in
    ONE ``extend`` forward; the leftover-token rule emits the longest
    matching proposal prefix plus the target's pick at the first
    divergence (so greedy output is token-for-token identical to
    target-only decode), and both caches rewind past the rejected suffix
    (paged: block-table truncation, tail blocks return to the admission
    reserve; slot: one ``set_lens``).

    Greedy only: sampled requests need the rejection-sampling acceptance
    rule and are refused at ``submit``.  ``min_acceptance`` > 0 arms the
    graceful-off path: once ``probe_proposals`` proposals have been
    measured, a session whose acceptance rate sits below the floor stops
    speculating for good and every later ``step()`` is a plain
    target-engine step.  ``proposed``/``accepted`` feed the per-group
    stats the ``weighted_capacity`` autoscaler reads.

    The reference jits one slot ``extend`` per engine; here ``api.extend``
    is called in place."""

    def __init__(self, target: InferenceEngine, draft: InferenceEngine, *,
                 k: int = 4, min_acceptance: float = 0.0,
                 probe_proposals: int = 64):
        if target.api.extend is None or \
                target.cfg.family not in ("dense", "moe"):
            raise ValueError(
                "speculative decoding needs a target family with chunked "
                f"extend (dense/moe), not {target.cfg.family!r}")
        if draft.cfg.family not in ("dense", "moe"):
            raise ValueError(
                "speculative decoding needs a positional-KV draft family "
                f"(dense/moe), not {draft.cfg.family!r}")
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.target = target
        self.draft = draft
        self.k = k
        self.min_acceptance = float(min_acceptance)
        self.probe_proposals = int(probe_proposals)
        self.spec_enabled = True
        self.proposed = 0
        self.accepted = 0
        self.rounds = 0
        self._seqs: "OrderedDict[int, _SpecSeq]" = OrderedDict()

    # ------------------------------------------------------------------
    # Engine-compatible surface
    # ------------------------------------------------------------------
    @property
    def stats(self) -> EngineStats:
        return self.target.stats

    def spec_stats(self) -> dict:
        return {
            "k": self.k,
            "proposed": self.proposed,
            "accepted": self.accepted,
            "acceptance_rate": (self.accepted / self.proposed
                                if self.proposed else None),
            "rounds": self.rounds,
            "enabled": self.spec_enabled,
        }

    def submit(self, prompt, *, max_new_tokens=16, temperature=0.0,
               eos_id=None, tenant=None, qos_class="normal") -> int:
        if temperature and temperature > 0:
            raise ValueError(
                "SpecDecodeSession serves greedy (temperature=0) requests "
                "only; the leftover-token rule does not cover sampling")
        prompt = list(prompt)
        m = len(prompt)
        # the verify forward writes up to k+1 positions past the accepted
        # prefix, so the full budget must fit both caches with that slack
        need = m + max_new_tokens + self.k + 1
        for eng, who in ((self.target, "target"), (self.draft, "draft")):
            if need >= eng.max_len:
                raise ValueError(
                    f"prompt ({m}) + max_new_tokens ({max_new_tokens}) + "
                    f"k+1 must fit the {who} engine max_len ({eng.max_len})")
            if not eng.paged and m > max(eng.buckets):
                raise ValueError(
                    f"prompt ({m}) exceeds the {who} engine's largest "
                    f"prefill bucket ({max(eng.buckets)}): the truncated "
                    f"prefill would break the verify position math")
        if not self.spec_enabled:
            # speculation is off for good: a plain target submit
            return self.target.submit(prompt,
                                      max_new_tokens=max_new_tokens,
                                      eos_id=eos_id, tenant=tenant,
                                      qos_class=qos_class)
        # inflate the target budget so admission (paged: the block
        # reservation; both: _check_done) covers the speculative
        # overshoot; restored to the real budget when the pair activates
        uid = self.target.submit(prompt,
                                 max_new_tokens=max_new_tokens + self.k + 1,
                                 eos_id=eos_id, tenant=tenant,
                                 qos_class=qos_class)
        treq = self.target.queue[-1]
        self.draft.submit(prompt, max_new_tokens=max_new_tokens + self.k + 2,
                          eos_id=None)  # the draft never self-finishes
        self._seqs[uid] = _SpecSeq(treq=treq, dreq=self.draft.queue[-1],
                                   max_new=max_new_tokens)
        return uid

    def has_work(self) -> bool:
        return self.target.has_work()

    def step(self) -> list:
        t = self.target
        if not self.spec_enabled:
            # speculation off: exactly a plain engine step
            return t.step()
        if t.paged:
            t._admit_paged()
            t.stats.peak_running = max(t.stats.peak_running, len(t.running))
            t._prefill_step_paged()
        else:
            t._admit()
            self._complete_slot_resumes(t)
        d = self.draft
        if d.paged:
            d._admit_paged()
            d._prefill_step_paged()
        else:
            d._admit()
            self._complete_slot_resumes(d)
        self._pair_ready()
        active = [s for s in self._seqs.values()
                  if s.ready and not s.treq.done]
        events = self._spec_round(active) if active else []
        t.stats.steps += 1
        t.stats.active_slot_steps += len(t.running)
        t.stats.slot_steps += max(t.max_num_seqs, len(t.running))
        if t.paged:
            t.stats.shared_block_peak = max(t.stats.shared_block_peak,
                                            t.pool.block_savings())
            t._refresh_gauges()
        if self.min_acceptance > 0 and self.proposed >= self.probe_proposals \
                and self.accepted < self.min_acceptance * self.proposed:
            self._disable_spec()
        return events

    def collect_finished(self) -> list:
        done = self.target.collect_finished()
        for req in done:
            seq = self._seqs.pop(req.uid, None)
            if seq is not None and seq.dreq is not None:
                self._retire_draft(seq)
        if self.spec_enabled:
            self.draft.collect_finished()
        return done

    def run(self, *, max_steps: int = 100000) -> dict:
        done: dict[int, Request] = {}
        for _ in range(max_steps):
            if not self.has_work():
                break
            self.step()
            for req in self.collect_finished():
                done[req.uid] = req
        return done

    # ------------------------------------------------------------------
    # Pairing and teardown
    # ------------------------------------------------------------------
    @staticmethod
    def _prefilled(eng: InferenceEngine, req: Request) -> bool:
        if not req.output:
            return False
        if eng.paged:
            return not req.pending_tokens
        return req.slot is not None and not req.pending_prefix

    def _pair_ready(self):
        for s in self._seqs.values():
            if s.ready or s.treq.done:
                continue
            if not self._prefilled(self.target, s.treq):
                continue
            if s.dreq is None or not self._prefilled(self.draft, s.dreq):
                continue
            m = s.treq.n_prompt
            s.t_cov = s.treq.pos if self.target.paged else m
            s.d_cov = s.dreq.pos if self.draft.paged else m
            s.last_tok = s.treq.output[-1]
            s.draft_pending = [s.last_tok]
            s.treq.max_new_tokens = s.max_new  # restore the real budget
            self.target._check_done(s.treq)
            s.ready = True

    def _retire_draft(self, seq: _SpecSeq):
        """Finish the draft-side request so its engine frees (or retains
        as residency) the proposal KV.  The residency transcript is cut to
        what the draft cache covers: claiming the whole emitted sequence
        would let a later resume attend garbage."""
        d = self.draft
        dreq = seq.dreq
        for i, r in enumerate(d.queue):  # identity, not dataclass ==
            if r is dreq:
                del d.queue[i]
                return
        if not self._prefilled(d, dreq):
            dreq.truncated = True  # mid-prefill: no residency claim
        else:
            transcript = list(seq.treq.prompt) + list(seq.treq.output)
            d_cov = seq.d_cov if seq.ready else dreq.n_prompt
            dreq.output = transcript[dreq.n_prompt:d_cov + 1]
            if not dreq.output:
                dreq.truncated = True
        dreq.finished_at = time.perf_counter()

    def _disable_spec(self):
        """Acceptance collapsed: stop speculating for good.  Draft-side
        requests retire (their KV frees), inflated target budgets are
        restored, and every later step() is a plain target-engine step."""
        self.spec_enabled = False
        slot_tokens = {}
        for s in self._seqs.values():
            if not s.ready:
                s.treq.max_new_tokens = s.max_new
                self.target._check_done(s.treq)
            elif not self.target.paged and s.treq.slot is not None:
                slot_tokens[s.treq.slot] = s.last_tok
            if s.dreq is not None:
                self._retire_draft(s)
                s.dreq = None
        if slot_tokens:  # hand the feeds to the plain decode loop
            lt = self.target._last_tokens.clone()
            for slot, tok in slot_tokens.items():
                lt[slot] = tok
            self.target._last_tokens = lt
        self.draft.collect_finished()

    # ------------------------------------------------------------------
    # Slot-pool prefix-resume completion (chunked, via extend)
    # ------------------------------------------------------------------
    def _complete_slot_resumes(self, eng: InferenceEngine):
        """A slot-pool prefix resume leaves the prompt suffix to drip in
        one token per decode step; the session instead feeds the whole
        suffix through ONE bucketed extend, so a resumed sequence joins
        the propose rotation at once.  A running request with no output
        yet is a resume (a fresh admission emits its first token inside
        ``_admit``), the fully covered case included, where only the last
        prompt token is left to feed.  All resumes admitted this step
        share one extend, each slot's suffix in its own row."""
        todo = [req for req in eng.running.values()
                if not req.output and req.slot is not None]
        if not todo:
            return
        chunks = {req.slot: list(req.prompt[req.cached_prefix:])
                  for req in todo}
        bucket = _bucket(max(len(c) for c in chunks.values()), eng.buckets)
        tokens = np.zeros((eng.max_num_seqs, bucket), np.int64)
        for slot, chunk in chunks.items():
            tokens[slot, :len(chunk)] = chunk
        eng.pool.cache, logits = eng._extend_fn(
            eng.params, eng.pool.cache, eng._tensor(tokens), eng.cfg)
        gtok = torch.argmax(logits, dim=-1).cpu().numpy()
        extra = {}
        for req in todo:
            T0 = len(chunks[req.slot])
            tok = int(gtok[req.slot, T0 - 1])
            req.pending_prefix = []
            req.output.append(tok)
            req.last_token = tok
            req.first_token_at = time.perf_counter()
            eng.stats.prefill_tokens += T0 - 1
            extra[req.slot] = req.cached_prefix + T0
            if eng is self.target:
                eng._last_tokens[req.slot] = tok
                eng._check_done(req)
        self._rewind_slots(eng, extra=extra)

    def _rewind_slots(self, eng: InferenceEngine, extra=None):
        """Reset slot lengths after an extend or decode advanced EVERY
        slot: each running sequence returns to its true coverage (stale KV
        past it is never attended and is overwritten later).  Requests
        admitted but not yet paired are covered too: their lengths moved
        just the same."""
        updates = dict(extra or {})
        cov_by_req = {}
        for s in self._seqs.values():
            if not s.ready or s.treq.done:
                continue
            if eng is self.target:
                cov_by_req[id(s.treq)] = s.t_cov
            elif s.dreq is not None:
                cov_by_req[id(s.dreq)] = s.d_cov
        for slot, req in eng.running.items():
            if slot in updates or req.done:
                continue
            cov = cov_by_req.get(id(req))
            if cov is None:
                if not req.output:  # a resume whose catch-up extend has
                    cov = req.cached_prefix  # not run yet
                else:  # freshly prefilled, waiting to pair
                    n = min(req.n_prompt, eng.max_len - 1)
                    cov = min(n, _bucket(n, eng.buckets))
            updates[slot] = cov
        eng.pool.set_lens(updates)

    # ------------------------------------------------------------------
    # The propose / verify / rewind round
    # ------------------------------------------------------------------
    def _spec_round(self, active) -> list:
        k = self.k
        props = {id(s): [] for s in active}
        pend = {id(s): list(s.draft_pending) for s in active}
        steps = max(len(s.draft_pending) for s in active) - 1 + k
        # propose: k batched greedy draft decodes (catch-up feeds first);
        # a sequence whose proposals are complete re-feeds its last token,
        # which the rewind below discards
        for j in range(steps):
            feed = []
            for s in active:
                fl = pend[id(s)]
                feed.append(fl[j] if j < len(fl) else fl[-1])
            toks = self._draft_step(active, feed)
            for i, s in enumerate(active):
                fl = pend[id(s)]
                if len(fl) - 1 <= j and len(props[id(s)]) < k:
                    t = int(toks[i])
                    props[id(s)].append(t)
                    fl.append(t)
        # verify: ONE extend forward over [last_tok, d_1..d_k]
        chunks = np.zeros((len(active), k + 1), np.int64)
        for i, s in enumerate(active):
            chunks[i, 0] = s.last_tok
            chunks[i, 1:] = props[id(s)]
        g = self._verify(active, chunks)  # target greedy picks [B, k+1]
        # accept, emit, rewind
        events = []
        t_slot_updates = {}
        d_slot_updates = {}
        for i, s in enumerate(active):
            prop = props[id(s)]
            row = g[i]
            a = 0
            while a < k and prop[a] == int(row[a]):
                a += 1
            self.proposed += k
            self.accepted += a
            treq = s.treq
            n = s.t_cov + 1  # emitted sequence length before this round
            for j in range(a + 1):
                if treq.done:
                    break
                tok = int(row[j])
                treq.output.append(tok)
                events.append((treq.uid, tok))
                self.target.stats.decode_tokens += 1
                self.target._check_done(treq)
            seq_len = treq.n_prompt + len(treq.output)
            # valid coverage: the verified feeds matching the true sequence
            # (capped by what was actually emitted)
            t_new = min(n + a, seq_len - 1)
            d_new = min(n + a if a < k else n + k - 1, seq_len - 1)
            if treq.done:
                continue  # retirement keeps the written KV; no rewind
            s.t_cov = t_new
            s.d_cov = d_new
            s.last_tok = treq.output[-1]
            transcript = list(treq.prompt) + list(treq.output)
            s.draft_pending = transcript[d_new:]
            if self.target.paged:
                self._rewind_paged(self.target, treq, t_new)
                treq.last_token = s.last_tok
            else:
                t_slot_updates[treq.slot] = t_new
            if self.draft.paged:
                self._rewind_paged(self.draft, s.dreq, d_new)
            else:
                d_slot_updates[s.dreq.slot] = d_new
        if not self.target.paged:
            self._rewind_slots(self.target, extra=t_slot_updates)
        if not self.draft.paged:
            self._rewind_slots(self.draft, extra=d_slot_updates)
        self.rounds += 1
        return events

    def _draft_step(self, active, feed):
        """One batched greedy decode on the draft engine; returns the
        proposal token per active sequence."""
        eng = self.draft
        eng.stats.steps += 1
        if not eng.paged:
            feeds = np.zeros((eng.max_num_seqs,), np.int64)
            for s, f in zip(active, feed):
                feeds[s.dreq.slot] = f
            eng.pool.cache, logits = eng._decode_fn(
                eng.params, eng.pool.cache, eng._tensor(feeds), eng.cfg)
            gtok = torch.argmax(logits, dim=-1).cpu().numpy()
            return [int(gtok[s.dreq.slot]) for s in active]
        B = _pow2(len(active))
        mb, bs = eng.pool.max_blocks, eng.block_size
        bt = np.zeros((B, mb), np.int32)
        lens = np.zeros((B,), np.int32)
        tokens = np.zeros((B,), np.int64)
        wphys = np.zeros((B,), np.int64)
        woff = np.zeros((B,), np.int64)
        for i, s in enumerate(active):
            r = s.dreq
            eng._ensure_writable(r, r.pos, 1)
            bt[i, :len(r.table)] = r.table
            lens[i] = r.pos
            tokens[i] = feed[i]
            p = min(r.pos, mb * bs - 1)
            wphys[i] = r.table[p // bs]
            woff[i] = p % bs
        eng.pool.cache, logits = eng._paged_decode(
            eng.params, eng.pool.cache, eng._tensor(bt), eng._tensor(lens),
            eng._tensor(tokens), eng._tensor(wphys), eng._tensor(woff))
        for s in active:
            s.dreq.pos += 1
        gtok = torch.argmax(logits, dim=-1).cpu().numpy()
        return [int(gtok[i]) for i in range(len(active))]

    def _verify(self, active, chunks):
        """ONE extend forward verifying all k+1 positions per sequence;
        returns the target's greedy pick at each position [B, k+1]."""
        eng = self.target
        T = chunks.shape[1]
        if not eng.paged:
            tokens = np.zeros((eng.max_num_seqs, T), np.int64)
            for i, s in enumerate(active):
                tokens[s.treq.slot] = chunks[i]
            eng.pool.cache, logits = eng._extend_fn(
                eng.params, eng.pool.cache, eng._tensor(tokens), eng.cfg)
            gtok = torch.argmax(logits, dim=-1).cpu().numpy()
            return gtok[[s.treq.slot for s in active]]
        B = _pow2(len(active))
        mb, bs = eng.pool.max_blocks, eng.block_size
        bt = np.zeros((B, mb), np.int32)
        lens = np.zeros((B,), np.int32)
        tokens = np.zeros((B, T), np.int64)
        wphys = np.zeros((B, T), np.int64)
        woff = np.zeros((B, T), np.int64)
        for i, s in enumerate(active):
            r = s.treq
            eng._ensure_writable(r, s.t_cov, T)
            bt[i, :len(r.table)] = r.table
            lens[i] = s.t_cov
            tokens[i] = chunks[i]
            for t in range(T):
                p = min(s.t_cov + t, mb * bs - 1)
                wphys[i, t] = r.table[p // bs]
                woff[i, t] = p % bs
        eng.pool.cache, logits = eng._paged_extend(
            eng.params, eng.pool.cache, eng._tensor(bt), eng._tensor(lens),
            eng._tensor(tokens), eng._tensor(wphys), eng._tensor(woff))
        gtok = torch.argmax(logits, dim=-1).cpu().numpy()
        return gtok[:len(active)]

    @staticmethod
    def _rewind_paged(eng: InferenceEngine, req: Request, new_pos: int):
        """Truncate the block table past the accepted prefix: tail blocks
        holding only rejected K/V free back to the pool AND to the
        request's admission reserve (symmetric with ``_alloc_block``), so
        the reservation accounting stays exact across rounds."""
        keep = max(1, -(-new_pos // eng.block_size))
        while len(req.table) > keep:
            eng.pool.alloc.free(req.table.pop())
            req.reserve_left += 1
            eng._reserved += 1
        req.pos = new_pos


def make_engine_from_scratch(cfg: ModelConfig, *, seed=0, device=None, **kw):
    """Init params on ``device`` from ``seed`` and build an engine."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = get_model(cfg).init(gen, cfg, device=dev)
    return InferenceEngine(cfg, params, device=dev, **kw)
