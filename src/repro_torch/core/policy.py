"""Execution policies: high-level constraints guiding task->resource mapping."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class ExecutionPolicy:
    # scheduling
    oversubscription: float = 4.0  # ready tasks kept per free core (backfill)
    backfill: bool = True  # smaller tasks may jump blocked head-of-line tasks
    backfill_window: int = 64  # how deep into the ready queue backfill looks
    # placement
    default_partition: Optional[str] = None
    colocate_coupled: bool = True  # coupled pairs pinned to the same node
    placement: str = "first_fit"  # | "best_fit": how task placements and
    #                               service replica claims pack onto nodes
    # routing (inference)
    routing: str = "balanced"  # random | round_robin | balanced |
    #                            least_loaded | prefix_affinity |
    #                            radix_affinity
    affinity_prefix_len: int = 32  # prompt tokens/chars hashed into the
    #                                sticky key (prefix_affinity routing)
    affinity_spill_factor: float = 2.0  # sticky replica sheds when its
    #                                     queue depth exceeds
    #                                     factor * (min depth + 1); <=0
    #                                     disables spilling entirely
    affinity_max_prefix: int = 128  # radix_affinity: prompt tokens kept
    #                                 (lossless) in the session/residency
    #                                 radix indices
    affinity_min_match: int = 8  # radix_affinity: shortest common prefix
    #                              that counts as a match (shorter ones
    #                              route by load, not stickiness)
    affinity_headroom_watermark: float = 0.1  # radix_affinity: a member
    #                              whose gossiped free-block fraction
    #                              falls below this ranks after every
    #                              non-starved prefix match (its engine
    #                              is about to evict the matched
    #                              residency); <=0 disables headroom
    #                              weighting
    residency_sync_every: int = 32  # routed requests between residency
    #                                 gossip pulls from the replicas'
    #                                 engines (0 disables the periodic
    #                                 pull; stats() always syncs)
    # services: replication + autoscaling
    replicas: int = 1  # default replica count when a ServiceDescription
    #                    leaves ``replicas`` unset
    autoscale: bool = False  # grow/shrink replica sets (see `autoscaler`)
    autoscaler: str = "queue_depth"  # | "latency_slo" |
    #                  "weighted_capacity" (repro.core.autoscale; the last
    #                  one drives multi-model sets: per-group SLO control
    #                  with weight-anchored, capacity-neutral rebalancing)
    autoscale_min_replicas: int = 1
    autoscale_max_replicas: int = 4
    autoscale_high_depth: float = 4.0  # mean outstanding reqs/replica to grow
    autoscale_low_depth: float = 0.5  # ... below which we shrink
    autoscale_interval_s: float = 0.05  # sampling period
    autoscale_sustain: int = 3  # consecutive hot/cold samples before acting
    autoscale_sustain_up: Optional[int] = None  # override grow sustain
    #                       (latency_slo defaults to 1: breached SLOs are
    #                       acted on fast)
    autoscale_sustain_down: Optional[int] = None  # override shrink sustain
    #                       (latency_slo defaults to 3x autoscale_sustain:
    #                       slow, deliberate cool-down)
    slo_p95_ms: float = 250.0  # latency_slo: p95 end-to-end target
    slo_window_s: float = 5.0  # latency_slo: latency sample window
    slo_down_factor: float = 0.5  # latency_slo: shrink only when p95 is
    #                               under factor * slo (and queues shallow)
    # speculative decoding (weighted_capacity draft-group entitlements):
    # a draft-role ModelGroup's weight is scaled by the set's measured
    # acceptance rate, and once enough proposals are observed a rate
    # below the floor force-shrinks the group toward its min_replicas —
    # spec-decode turns off gracefully instead of burning cores
    spec_min_acceptance: float = 0.3  # acceptance floor for draft groups
    spec_min_proposed: int = 256  # proposals to observe before judging
    # multi-tenant QoS (see repro.core.request / repro.serving.qos)
    qos_class_weights: Optional[dict] = None  # priority-class -> weighted-
    #                     fair share (None: DEFAULT_CLASS_WEIGHTS high=4
    #                     normal=2 low=1); drives per-replica WFQ ordering
    #                     and decode preemption
    qos_protected_class: Optional[str] = None  # weighted_capacity judges a
    #                     group's SLO on this class's p95 when samples
    #                     exist (isolation signal: scale for the class the
    #                     SLO protects, not the saturating bulk traffic)
    qos_preempt: bool = True  # WFQ may preempt decoding sequences of
    #                     lighter classes (retire paged KV to residency,
    #                     resume token-identically) to admit a heavier
    #                     class's queued request
    tenant_rate: Optional[float] = None  # per-tenant admission rate
    #                     (cost units/s; None = unlimited) enforced by a
    #                     router token bucket BEFORE placement
    tenant_burst_s: float = 2.0  # bucket depth in seconds at the rate
    tenant_rates: Optional[dict] = None  # per-tenant rate overrides
    warmup: bool = False  # prime new replicas (servicer.warmup(): compile
    #                       + a token of decode) before the router sees them
    # fault tolerance
    max_retries: int = 1
    straggler_factor: float = 0.0  # >0: duplicate tasks slower than
    #                                factor x median runtime (first wins)
    straggler_min_samples: int = 10
    # services
    inference_timeout_s: float = 1200.0  # per-INFERENCE-task result wait
    service_ready_timeout: float = 30.0
    service_heartbeat: float = 5.0
    restart_failed_services: bool = True
    restart_backoff_s: float = 0.05  # first relaunch delay after a crash;
    #                                  doubles per consecutive crash
    restart_backoff_max_s: float = 2.0  # exponential backoff ceiling; a
    #                                     replica healthy for 4x this long
    #                                     earns a fresh restart budget
    restart_max_attempts: int = 6  # consecutive crash-relaunches before a
    #                                replica is declared dead (degraded
    #                                set); <=0 means retry forever
    dead_replica_grace_s: float = 2.0  # how long a declared-dead replica
    #                                    stays visible (degraded) before it
    #                                    is folded out of the set with its
    #                                    stats merged into the aggregate;
    #                                    <0 keeps the corpse forever
