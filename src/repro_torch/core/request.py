"""First-class inference request envelope + routing context.

``InferenceRequest`` is the one record that travels from the client
surface (``ReplicaSet.request`` / the middleware's INFERENCE dispatch)
through routing, the endpoint queue, and into the servicer.  It replaces
the magic payload keys and meta side-channels that had grown organically:

  * ``{"model": ...}`` payload tag        -> ``env.model``
  * ``meta["_model"]`` reroute hint       -> ``env.model``
  * ``meta["_t0"]`` latency stamp         -> ``env.submitted_at``
  * ``{"_import": ...}`` handoff payload  -> ``env.handoff``
  * ``meta["_replays"]`` crash counter    -> ``env.replays``

and adds the multi-tenant QoS fields the serving stack rides on:
``tenant`` (the accounting/admission identity), ``priority`` (the QoS
class: weighted-fair share + preemption order + per-class SLO windows)
and ``deadline_s`` (a client latency budget carried for schedulers).

Bare payloads keep working: ``InferenceRequest.wrap`` is the one
normalization adapter — the ONLY place the legacy ``{"model": ...}``
payload key is still interpreted — so every internal path deals in
envelopes only.

``RouteContext`` bundles the per-pick candidate-set arguments that
``Router.pick()`` had accreted as keywords (``n_instances``, ``group``,
``queue_depths``, ``members``, ``affinity_group``, ``info``); the router
API is now ``route(env, ctx)`` with ``pick()`` kept as a deprecation
shim.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional, Sequence

#: the default QoS class of requests that declare none.  Class weights
#: (see ``ExecutionPolicy.qos_class_weights``) give "high" a larger
#: weighted-fair share than "normal" than "low"; unknown classes weigh 1.
DEFAULT_PRIORITY = "normal"

DEFAULT_CLASS_WEIGHTS = {"high": 4.0, "normal": 2.0, "low": 1.0}


class AdmissionDenied(RuntimeError):
    """A tenant's token-bucket admission refused this request (rate
    limit exceeded).  Carried to the client through the request future;
    counted per tenant on the replica set."""

    def __init__(self, tenant: Optional[str], message: str = ""):
        super().__init__(message or f"tenant {tenant!r} over admission "
                                    f"rate limit")
        self.tenant = tenant


@dataclasses.dataclass
class InferenceRequest:
    """One inference request, end to end.

    ``payload`` is what the servicer consumes (dict/list/str, unchanged);
    everything else is routing/accounting/QoS state that used to hide in
    payload keys and private meta entries.  ``meta`` carries remaining
    caller keywords through to the servicer (non-underscore keys only,
    same contract as before).
    """

    payload: Any = None
    model: Optional[str] = None  # model-group tag (multi-model routing)
    tenant: Optional[str] = None  # accounting + admission identity
    priority: str = DEFAULT_PRIORITY  # QoS class: "high"/"normal"/"low"
    deadline_s: Optional[float] = None  # client latency budget (seconds)
    affinity: Any = None  # router affinity key (signature/prefix); None
    #                       -> the router derives one from the payload
    handoff: Optional[dict] = None  # exported paged-KV payload (disagg
    #                                 decode leg); replaces "_import"
    submitted_at: Optional[float] = None  # perf_counter stamp; set once
    #                                       and carried through replays/
    #                                       reroutes/handoffs so latency
    #                                       windows see end-to-end time
    replays: int = 0  # crash-replay budget consumed (was meta _replays)
    meta: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.submitted_at is None:
            self.submitted_at = time.perf_counter()
        if not self.priority:
            self.priority = DEFAULT_PRIORITY

    @classmethod
    def wrap(cls, payload, *, model: Optional[str] = None,
             tenant: Optional[str] = None, priority: Optional[str] = None,
             deadline_s: Optional[float] = None, affinity: Any = None,
             meta: Optional[dict] = None) -> "InferenceRequest":
        """Normalization adapter: turn a bare payload (or an existing
        envelope) into an ``InferenceRequest``.

        This is the ONE back-compat site where the legacy conventions are
        still honored: a dict payload's ``{"model": ...}`` tag becomes
        ``env.model`` (the key stays in the payload — single-model
        servicers historically saw it and must keep doing so), and
        ``tenant``/``priority``/``deadline_s`` keys in ``meta`` (e.g.
        task metadata) are lifted onto the envelope.  Explicit keyword
        arguments win over both."""
        if isinstance(payload, cls):
            env = payload
            if meta:
                env.meta.update(meta)
            if model is not None:
                env.model = model
            if tenant is not None:
                env.tenant = tenant
            if priority is not None:
                env.priority = priority
            if deadline_s is not None:
                env.deadline_s = deadline_s
            if affinity is not None:
                env.affinity = affinity
            return env
        meta = dict(meta or {})
        if tenant is None:
            tenant = meta.pop("tenant", None)
        else:
            meta.pop("tenant", None)
        if priority is None:
            priority = meta.pop("priority", None)
        else:
            meta.pop("priority", None)
        if deadline_s is None:
            deadline_s = meta.pop("deadline_s", None)
        else:
            meta.pop("deadline_s", None)
        if model is None and isinstance(payload, dict):
            tag = payload.get("model")
            if tag is not None:
                model = str(tag)
        return cls(payload=payload, model=model, tenant=tenant,
                   priority=priority or DEFAULT_PRIORITY,
                   deadline_s=deadline_s, affinity=affinity, meta=meta)

    def servicer_kwargs(self) -> dict:
        """The keyword arguments forwarded to the servicer: public meta
        keys only (underscore-prefixed entries are private to the
        service layer, the same filter ``ServiceInstance`` always
        applied)."""
        return {k: v for k, v in self.meta.items()
                if not k.startswith("_")}


@dataclasses.dataclass
class RouteContext:
    """Candidate-set context for one routing decision.

    Collapses the keyword surface ``Router.pick()`` had grown: the
    balance-state key (``group``), the live candidates and their stable
    identities (``n_instances``/``members``/``queue_depths``), the
    sticky-state namespace (``affinity_group``), and the outcome
    out-dict (``info``, filled with ``{"affinity": "hit"|"miss"|
    "spill"}`` by sticky routers)."""

    n_instances: int
    group: Any = "default"
    queue_depths: Optional[Sequence[float]] = None
    members: Optional[Sequence] = None
    affinity_group: Optional[Any] = None
    info: Optional[dict] = None
