"""LLM servicer + client helpers: the glue between the middleware service
abstraction and the continuous-batching engine (Figs. 1-2: AI workers).

The counterpart of the JAX package's ``serving/client.py`` for the unified
``phase="serve"`` replica: dense and MoE configs get the block-paged
engine by default, state-carrying ones (rwkv6, zamba2) the slot pool, and
``draft_group`` arms speculative decoding (``SpecDecodeSession``).
Disaggregated phases, QoS scheduling and ``generate_stream`` are not
ported yet; the first two raise (ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

import time
from typing import Optional

from repro_torch.core.service import ModelGroup
from repro_torch.models.config import ModelConfig
from .engine import (InferenceEngine, SpecDecodeSession,
                     make_engine_from_scratch)

_NOT_PORTED = "not ported to PyTorch yet: ROADMAP Queue 1 item 8"


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
             "itl_s": float, "latency_s": float}.

    ``device`` (default: the CUDA card) is where the engine and, for
    ``params=None``, the freshly drawn weights live.

    ``draft_group`` arms cross-group speculative decoding: a co-located
    draft engine (``_resolve_draft_engine``) proposes ``spec_k`` tokens a
    round and this replica's engine verifies them in one extend forward
    (``SpecDecodeSession``); greedy output stays token-for-token the
    target's, sampled requests are refused, and ``spec_stats()`` exposes
    the counters the replica set sums per group.  ``qos_preempt`` keeps
    the reference's signature; QoS raises here."""

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
        if phase != "serve":
            raise NotImplementedError(
                f"disaggregated phase={phase!r} is {_NOT_PORTED}")
        if qos or qos_class_weights is not None:
            raise NotImplementedError(f"QoS scheduling is {_NOT_PORTED}")
        self.phase = phase
        engine_kw = _resolve_paged(cfg, engine_kw)
        if params is None:
            self.engine = make_engine_from_scratch(cfg, seed=seed,
                                                   device=device, **engine_kw)
        else:
            self.engine = InferenceEngine(cfg, params, device=device,
                                          **engine_kw)
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

    def submit(self, payload, *, envelope=None, **meta) -> int:
        tenant = envelope.tenant if envelope is not None else None
        qos_class = envelope.priority if envelope is not None else "normal"
        if envelope is not None and envelope.handoff is not None:
            raise NotImplementedError(f"KV handoff import is {_NOT_PORTED}")
        return self._stepper.submit(
            payload["prompt"],
            max_new_tokens=payload.get("max_new_tokens", 16),
            temperature=payload.get("temperature", 0.0),
            eos_id=payload.get("eos_id"),
            tenant=tenant, qos_class=qos_class,
        )

    def _result(self, req) -> dict:
        itl = None
        if (req.first_token_at is not None and req.finished_at is not None
                and len(req.output) > 1):
            itl = ((req.finished_at - req.first_token_at)
                   / (len(req.output) - 1))
        return {
            "tokens": req.output,
            "n_prompt": req.n_prompt,
            "ttft_s": (req.first_token_at - req.submitted_at
                       if req.first_token_at else None),
            "itl_s": itl,
            "latency_s": req.finished_at - req.submitted_at,
        }

    def step(self):
        out = []
        if not self._stepper.has_work():
            time.sleep(1e-4)
            return out
        self._stepper.step()
        for req in self._stepper.collect_finished():
            out.append((req.uid, self._result(req)))
        return out

    def residency_summary(self, max_len: int = 128):
        """Resident prefix sequences for router gossip."""
        return self.engine.residency_summary(max_len=max_len)

    def set_residency_listener(self, cb):
        """Gossip push: fires on KV eviction."""
        self.engine.on_residency_drop = cb

    def warmup(self):
        """Prime the replica before it becomes routable: run one tiny
        request end to end."""
        self.engine.submit([1, 2, 3, 4], max_new_tokens=1)
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
        return None  # QoS scheduling is not ported yet

    def handoff_stats(self):
        return None  # unified replicas hand nothing off


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
    factory builds an ``LLMServicer`` for ``cfg``.  Disaggregated roles
    (``"prefill"``/``"decode"``) are not ported yet."""
    if role in ("prefill", "decode"):
        raise NotImplementedError(
            f"disaggregated role={role!r} is {_NOT_PORTED}")
    return ModelGroup(name=name,
                      factory=llm_service_factory(cfg, params, **engine_kw),
                      weight=weight, replicas=replicas,
                      slo_p95_ms=slo_p95_ms, requirements=requirements,
                      role=role, paired_with=paired_with,
                      min_replicas=min_replicas, max_replicas=max_replicas,
                      borrow_limit=borrow_limit)
