"""LLM servicer + client helpers: the glue between the middleware service
abstraction and the continuous-batching engine (Figs. 1-2: AI workers).

The counterpart of the JAX package's ``serving/client.py``: dense and MoE
configs get the block-paged engine by default, state-carrying ones (rwkv6,
zamba2) the slot pool; ``draft_group`` arms speculative decoding
(``SpecDecodeSession``), ``phase="prefill"|"decode"`` the two halves of
disaggregated serving (the paged-KV handoff), ``qos=True`` weighted-fair
admission with decode preemption (``WFQScheduler``), and
``generate_stream`` streams one request's tokens.
"""
from __future__ import annotations

import time
from typing import Optional

from repro_torch.core.service import ModelGroup
from repro_torch.models.config import ModelConfig
from repro_torch.spans import spanned
from .engine import (InferenceEngine, SpecDecodeSession,
                     make_engine_from_scratch)
from .qos import WFQScheduler


def _resolve_paged(cfg: ModelConfig, engine_kw: dict) -> dict:
    """Paged-by-default policy for replicas: dense/moe engines get the
    block-paged pool unless the caller opts out (``paged=False``);
    state-carrying and prefix-offset families (ssm/hybrid/vlm/encdec)
    keep the slot pool.  ``paged=None`` (or absent) means "auto"."""
    kw = dict(engine_kw)
    if kw.get("paged") is None:
        kw["paged"] = cfg.family in ("dense", "moe")
    if not kw["paged"]:
        # the slot-pool engine does not take paged-only tuning knobs
        for k in ("block_size", "num_blocks", "prefill_chunk",
                  "max_running", "paged_decode_mode"):
            kw.pop(k, None)
    return kw


def _resolve_draft_engine(spec, *, seed: int = 0,
                          device=None) -> InferenceEngine:
    """``draft_group`` resolution: the co-located draft as an
    ``InferenceEngine``, a built ``LLMServicer``, a ``ModelGroup`` (whose
    factory builds one) or a bare ``ModelConfig`` (a fresh engine from
    ``seed`` on ``device``, the target's, with the pool resolved as for
    a replica)."""
    if isinstance(spec, InferenceEngine):
        return spec
    if isinstance(spec, LLMServicer):
        return spec.engine
    if isinstance(spec, ModelGroup):
        if spec.factory is None:
            raise ValueError(
                f"draft_group {spec.name!r} has no factory to build a "
                f"draft servicer from")
        servicer = spec.factory()
        engine = getattr(servicer, "engine", None)
        if engine is None:
            raise TypeError(
                f"draft_group {spec.name!r} factory built "
                f"{type(servicer).__name__}, which exposes no .engine")
        return engine
    if isinstance(spec, ModelConfig):
        return make_engine_from_scratch(spec, seed=seed, device=device,
                                        **_resolve_paged(spec, {}))
    raise TypeError(f"cannot resolve a draft engine from {type(spec)}")


class LLMServicer:
    """Servicer protocol (submit/step) around an InferenceEngine.

    Request payload: {"prompt": [ids...], "max_new_tokens": int,
                      "temperature": float}.
    Result: {"tokens": [...], "n_prompt": int, "ttft_s": float,
             "itl_s": float, "latency_s": float, "handoff_s": float,
             "queue_s": float}.
    ``handoff_s`` is the envelope's stamp to the engine's submit (the
    middleware's queue and hand-off), None where no envelope came or the
    request came as a handoff; ``queue_s`` is the engine's submit to its
    first admission of the request (the engine's queue), None for a
    sequence imported from a prefill replica.  A prefill role's handoff
    export carries both as None; ``generate_stream``'s final event for a
    ``max_new_tokens <= 0`` payload carries neither, as nothing was
    submitted.

    ``device`` (default: the CUDA card) is where the engine and, for
    ``params=None``, the freshly drawn weights live.

    ``draft_group`` arms cross-group speculative decoding: a co-located
    draft engine (``_resolve_draft_engine``) proposes ``spec_k`` tokens a
    round and this replica's engine verifies them in one extend forward
    (``SpecDecodeSession``); greedy output stays token-for-token the
    target's, sampled requests are refused, and ``spec_stats()`` exposes
    the counters the replica set sums per group.

    ``phase`` selects the replica's disaggregated-serving role:

    * ``"serve"`` (default): unified prefill + decode.
    * ``"prefill"``: the replica only chunk-prefills
      (``engine.step_prefill_only``); once a sequence's first token is out
      it is exported (``engine.export_sequence``) and the step result
      carries it under ``"handoff_export"`` for the replica set to
      re-dispatch to the paired decode group.
    * ``"decode"``: ``submit`` takes envelopes whose ``handoff`` carries
      an exported sequence and adopts its KV (``engine.import_sequence``);
      a refused import recomputes the prompt here (counted in
      ``handoff_stats()``), never fails.

    Both disaggregated phases need the paged engine (the handoff moves
    physical KV blocks) and exclude ``draft_group``.

    ``qos=True`` (or an explicit ``qos_class_weights`` dict) arms a
    per-replica ``WFQScheduler``: admission in weighted-fair virtual
    finish order over (tenant, priority-class) flows, and, on paged
    engines with ``qos_preempt``, a blocked heavier-class head preempts
    lighter decoding sequences (their KV retires to residency and they
    resume token-identically).  Tenant and class arrive on the
    ``InferenceRequest`` envelope (``accepts_envelope``)."""

    accepts_envelope = True  # submit() takes the envelope keyword

    def __init__(self, cfg: ModelConfig, params=None, *, seed: int = 0,
                 draft_group=None, spec_k: int = 4,
                 spec_min_acceptance: float = 0.0,
                 spec_probe_proposals: int = 64, phase: str = "serve",
                 qos: bool = False, qos_class_weights=None,
                 qos_preempt: bool = True, device=None, **engine_kw):
        if phase not in ("serve", "prefill", "decode"):
            raise ValueError(
                f"phase must be 'serve', 'prefill' or 'decode', "
                f"not {phase!r}")
        if phase != "serve" and draft_group is not None:
            raise ValueError(
                "speculative decoding and disaggregated phases do not "
                "compose: a prefill/decode replica cannot host a draft")
        self.phase = phase
        engine_kw = _resolve_paged(cfg, engine_kw)
        if params is None:
            self.engine = make_engine_from_scratch(cfg, seed=seed,
                                                   device=device, **engine_kw)
        else:
            self.engine = InferenceEngine(cfg, params, device=device,
                                          **engine_kw)
        if phase != "serve" and not self.engine.paged:
            raise ValueError(
                f"phase={phase!r} requires the block-paged engine (the "
                f"KV handoff moves physical blocks)")
        self.session = None
        if draft_group is not None:
            draft = _resolve_draft_engine(draft_group, seed=seed,
                                          device=self.engine.device)
            self.session = SpecDecodeSession(
                self.engine, draft, k=spec_k,
                min_acceptance=spec_min_acceptance,
                probe_proposals=spec_probe_proposals)
        # the session when speculating, the bare engine otherwise (the
        # same protocol)
        self._stepper = self.session or self.engine
        self._handoff_exports = 0
        self._handoff_imports = 0
        self._handoff_recomputes = 0
        self._imported: set = set()
        self._recomputed: set = set()
        self._stream_leftovers: list = []
        self._qos = None
        if qos or qos_class_weights is not None:
            self._qos = WFQScheduler(class_weights=qos_class_weights,
                                     preempt=qos_preempt)

    def submit(self, payload, *, envelope=None, **meta) -> int:
        tenant = envelope.tenant if envelope is not None else None
        qos_class = envelope.priority if envelope is not None else "normal"
        handoff = envelope.handoff if envelope is not None else None
        if handoff is not None and self.phase != "prefill":
            uid = self.engine.import_sequence(handoff)
            if uid is not None:
                self._handoff_imports += 1
                self._imported.add(uid)
            else:
                # the pool cannot take it: recompute the prompt here
                # instead of failing the request, keeping the original
                # submit stamp so the latency spans the migration
                self._handoff_recomputes += 1
                uid = self.engine.submit(
                    handoff["prompt"],
                    max_new_tokens=handoff["max_new_tokens"],
                    temperature=handoff["temperature"],
                    eos_id=handoff["eos_id"],
                    tenant=tenant, qos_class=qos_class)
                self.engine.queue[-1].submitted_at = handoff["submitted_at"]
                self._recomputed.add(uid)
        else:
            uid = self._stepper.submit(
                payload["prompt"],
                max_new_tokens=payload.get("max_new_tokens", 16),
                temperature=payload.get("temperature", 0.0),
                eos_id=payload.get("eos_id"),
                tenant=tenant, qos_class=qos_class,
            )
            if envelope is not None:
                req = self._find_request(uid)
                if req is not None:
                    req.envelope_at = envelope.submitted_at
        if self._qos is not None:
            req = self._find_request(uid)
            if req is not None:
                self._qos.on_submit(req)
        return uid

    def _result(self, req) -> dict:
        itl = None
        if (req.first_token_at is not None and req.finished_at is not None
                and len(req.output) > 1):
            itl = ((req.finished_at - req.first_token_at)
                   / (len(req.output) - 1))
        res = {
            "tokens": req.output,
            "n_prompt": req.n_prompt,
            "ttft_s": (req.first_token_at - req.submitted_at
                       if req.first_token_at else None),
            "itl_s": itl,
            "latency_s": req.finished_at - req.submitted_at,
            "handoff_s": (req.submitted_at - req.envelope_at
                          if req.envelope_at is not None else None),
            "queue_s": (req.admitted_at - req.submitted_at
                        if req.admitted_at is not None else None),
        }
        if req.uid in self._imported:
            self._imported.discard(req.uid)
            res["handoff"] = True
            res["role"] = "decode"
        elif req.uid in self._recomputed:
            self._recomputed.discard(req.uid)
            res["handoff"] = True
            res["recompute"] = True
            res["role"] = "decode"
        elif self.phase != "serve":
            res["role"] = self.phase
        return res

    @spanned("servicer/step")
    def step(self):
        out = []
        if self._stream_leftovers:
            out, self._stream_leftovers = self._stream_leftovers, []
        if not self._stepper.has_work():
            if not out:
                time.sleep(1e-4)
            return out
        if self.phase == "prefill":
            return out + self._step_prefill()
        if self._qos is not None:
            self._qos.schedule(self.engine)
        self._stepper.step()
        for req in self._stepper.collect_finished():
            if self._qos is not None:
                self._qos.on_finish(req.uid)
            out.append((req.uid, self._result(req)))
        return out

    def _step_prefill(self):
        """Prefill-role step: chunk-prefill only, then export every
        sequence whose first token is out.  A handoff result keeps the
        normal result's keys (so a crash replay or a drain still resolves
        the future) plus the exported sequence under ``"handoff_export"``
        for the replica set's re-dispatch hook."""
        eng = self.engine
        if self._qos is not None:
            self._qos.schedule(eng)
        eng.step_prefill_only()
        out = []
        # sequences already done at their first token (max_new_tokens=1)
        for req in eng.collect_finished():
            if self._qos is not None:
                self._qos.on_finish(req.uid)
            out.append((req.uid, self._result(req)))
        for uid in eng.exportable():
            pay = eng.export_sequence(uid)
            self._handoff_exports += 1
            if self._qos is not None:
                self._qos.on_finish(uid)
            out.append((uid, {
                "handoff_export": pay,
                "tokens": list(pay["output"]),
                "n_prompt": len(pay["prompt"]),
                "ttft_s": (pay["first_token_at"] - pay["submitted_at"]
                           if pay["first_token_at"] else None),
                "itl_s": None,
                "latency_s": time.perf_counter() - pay["submitted_at"],
                "handoff_s": None,
                "queue_s": None,
                "role": "prefill",
            }))
        return out

    def generate_stream(self, payload, *, max_steps: int = 100000, **meta):
        """Drive ONE request to completion, yielding ``{"token": t}`` per
        generated token and then ``{"done": True, **result}`` with the
        keys ``step()`` reports.  A ``max_new_tokens <= 0`` payload yields
        only the final event, with ``ttft_s`` None (no first token).

        It steps the WHOLE engine (for tests, examples and single-tenant
        tools, not the replica-set path); other requests finishing
        meanwhile are kept and returned by the next ``step()``."""
        if self.phase == "prefill":
            raise ValueError(
                "generate_stream runs prefill+decode; a prefill-role "
                "replica hands sequences off instead of decoding them")
        n_prompt = len(payload.get("prompt", ()))
        if payload.get("max_new_tokens", 16) <= 0:
            yield {"done": True, "tokens": [], "n_prompt": n_prompt,
                   "ttft_s": None, "itl_s": None, "latency_s": 0.0}
            return
        uid = self.submit(payload, **meta)
        req = self._find_request(uid)
        sent = 0
        final = None
        for _ in range(max_steps):
            self._stepper.step()
            for r in self._stepper.collect_finished():
                res = self._result(r)
                if r.uid == uid:
                    final = res
                else:
                    self._stream_leftovers.append((r.uid, res))
            if req is not None:
                while sent < len(req.output):
                    yield {"token": req.output[sent]}
                    sent += 1
            if final is not None:
                break
        if final is None:
            raise RuntimeError(
                f"generate_stream: request {uid} did not finish within "
                f"{max_steps} steps")
        yield {"done": True, **final}

    def _find_request(self, uid):
        eng = self.engine
        for r in eng.queue:
            if r.uid == uid:
                return r
        for r in eng.running.values():
            if r.uid == uid:
                return r
        return None

    def residency_summary(self, max_len: int = 128):
        """Resident prefix sequences for router gossip."""
        return self.engine.residency_summary(max_len=max_len)

    def set_residency_listener(self, cb):
        """Gossip push: fires on KV eviction."""
        self.engine.on_residency_drop = cb

    def warmup(self):
        """Prime the replica before it becomes routable: run one tiny
        request end to end.  A decode-role replica warms with two tokens,
        so one batched decode (where its imported sequences land) runs."""
        mnt = 2 if self.phase == "decode" else 1
        self.engine.submit([1, 2, 3, 4], max_new_tokens=mnt)
        self.engine.run(max_steps=64)

    @property
    def stats(self):
        return self.engine.stats

    def spec_stats(self):
        """Speculative-decoding counters (k, proposed, accepted,
        acceptance_rate, rounds, enabled) when a draft is armed; None on
        plain replicas."""
        return self.session.spec_stats() if self.session else None

    def block_telemetry(self):
        """Live paged-pool gauges the replica set aggregates per group
        (None on the slot pool)."""
        return self.engine.block_telemetry()

    def qos_stats(self):
        """The WFQ scheduler's counters (its preemptions, virtual clock,
        flows) plus the engine's preemption and resume totals; None when
        QoS is not armed."""
        if self._qos is None:
            return None
        out = self._qos.stats()
        out["engine_preemptions"] = self.engine.stats.preemptions
        out["engine_preempt_resumes"] = self.engine.stats.preempt_resumes
        return out

    def handoff_stats(self):
        """Disaggregation counters (exports on prefill replicas, imports
        and recompute fallbacks on decode replicas), summed per group by
        ``ReplicaSet.stats()``; None on unified replicas."""
        if self.phase == "serve":
            return None
        return {
            "role": self.phase,
            "exports": self._handoff_exports,
            "imports": self._handoff_imports,
            "recomputes": self._handoff_recomputes,
        }


def llm_service_factory(cfg: ModelConfig, params=None, **engine_kw):
    """Factory suitable for ServiceDescription(factory=...).  Servicer and
    engine kwargs (``device``, ``seed``, pool sizes, ...) pass through."""

    def make():
        return LLMServicer(cfg, params, **engine_kw)

    return make


def llm_model_group(name: str, cfg: ModelConfig, params=None, *,
                    weight: float = 1.0, replicas: Optional[int] = None,
                    slo_p95_ms: Optional[float] = None,
                    requirements=None, role: str = "serve",
                    paired_with: Optional[str] = None,
                    min_replicas: Optional[int] = None,
                    max_replicas: Optional[int] = None,
                    borrow_limit: Optional[int] = None, **engine_kw):
    """One model config of a multi-model service: a ``ModelGroup`` whose
    factory builds an ``LLMServicer`` for ``cfg``.  ``role="prefill"`` /
    ``"decode"`` declare a disaggregated pair sharing the set (the prefill
    group names the decode group in ``paired_with``) and set the
    servicers' ``phase``; the prefill group's ``slo_p95_ms`` is then a
    TTFT target and the decode group's an ITL target."""
    if role in ("prefill", "decode"):
        engine_kw.setdefault("phase", role)
    return ModelGroup(name=name,
                      factory=llm_service_factory(cfg, params, **engine_kw),
                      weight=weight, replicas=replicas,
                      slo_p95_ms=slo_p95_ms, requirements=requirements,
                      role=role, paired_with=paired_with,
                      min_replicas=min_replicas, max_replicas=max_replicas,
                      borrow_limit=borrow_limit)
