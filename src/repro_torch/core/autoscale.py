"""Pluggable replica autoscaling policies (§III-C: services and tasks
co-scheduled inside one job allocation).

The ``ServiceManager`` control loop no longer hard-codes queue-depth
scaling: it asks an ``Autoscaler`` for each replica set's desired size and
only then applies *admission control* — the target is bounded by what the
set's partition ``Allocation`` can still physically claim
(``Allocation.fits``), so "scale up" can be denied (event + stat, never an
exception) but can never overbook the ledger shared with tasks.

Three policies ship:

  * ``QueueDepthAutoscaler`` — the original behavior: grow when mean
    outstanding requests per live replica stays above
    ``autoscale_high_depth`` for ``autoscale_sustain_up`` consecutive
    ticks, shrink below ``autoscale_low_depth`` for
    ``autoscale_sustain_down`` ticks.
  * ``LatencySLOAutoscaler`` — targets a p95 end-to-end latency
    (``slo_p95_ms``) computed from the per-endpoint latency windows the
    replica set aggregates in ``stats()``.  Hysteresis is *asymmetric*:
    scale-up triggers after ``autoscale_sustain_up`` (default 1 — a
    violated SLO is acted on fast), scale-down needs the p95 to sit below
    ``slo_down_factor * slo`` AND the queues to be shallow for
    ``autoscale_sustain_down`` (default ``3 * autoscale_sustain``) ticks.
    Only samples from requests *started after the last scaling action*
    count, so latency accumulated under the old replica count cannot
    trigger a second, oscillating correction.
  * ``WeightedCapacityAutoscaler`` — multi-model replica sets: runs the
    SLO logic per model group (each against its own ``slo_p95_ms``),
    anchors each group's share of the partition to ``ModelGroup.weight``,
    and when a violating group cannot grow (set at max, or no ledger
    headroom) *rebalances* — retires a replica from the most
    over-entitled non-violating group to admit one for the violator,
    capacity-neutral under the single shared ``Allocation``.

All are bounded by ``[autoscale_min_replicas, autoscale_max_replicas]``
and, through the manager, by ``Allocation.free_capacity()``.
"""
from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Optional, Sequence


def percentile(samples: Sequence[float], q: float) -> Optional[float]:
    """Nearest-rank percentile (q in [0, 1]); None on empty input."""
    if not samples:
        return None
    xs = sorted(samples)
    idx = min(len(xs) - 1, max(0, math.ceil(q * len(xs)) - 1))
    return xs[idx]


class LatencyWindow:
    """Bounded sliding window of request latencies (one per endpoint).

    Each observation is ``(completed_at, seconds)``; queries can restrict
    to a recent wall-clock window and/or to samples whose request *started*
    (``completed_at - seconds``) after a given instant — the SLO
    autoscaler uses the latter to ignore latency incurred under a previous
    replica count.  ``histogram()`` exposes log2-ms buckets for operators.
    """

    def __init__(self, maxlen: int = 512):
        self._samples: deque = deque(maxlen=maxlen)
        self._lock = threading.Lock()
        self.count = 0  # lifetime observations (window-independent)

    def observe(self, seconds: float, now: Optional[float] = None):
        now = time.perf_counter() if now is None else now
        with self._lock:
            self._samples.append((now, float(seconds)))
            self.count += 1

    def samples(self, window_s: Optional[float] = None,
                started_after: Optional[float] = None,
                now: Optional[float] = None) -> list:
        now = time.perf_counter() if now is None else now
        with self._lock:
            snap = list(self._samples)
        out = []
        for t, dt in snap:
            if window_s is not None and now - t > window_s:
                continue
            if started_after is not None and t - dt < started_after:
                continue
            out.append(dt)
        return out

    def p95(self, window_s: Optional[float] = None,
            started_after: Optional[float] = None) -> Optional[float]:
        return percentile(self.samples(window_s, started_after), 0.95)

    def histogram(self, window_s: Optional[float] = None,
                  samples: Optional[list] = None) -> dict:
        """Log2 millisecond buckets: {"<=1ms": n, "<=2ms": n, ...}.  Pass
        ``samples`` (an earlier ``samples()`` result) to reuse a snapshot
        instead of copying the deque again."""
        out: dict = {}
        for dt in (self.samples(window_s) if samples is None else samples):
            ms = dt * 1e3
            edge = 1 << max(0, math.ceil(math.log2(max(ms, 1e-3))))
            out[f"<={edge}ms"] = out.get(f"<={edge}ms", 0) + 1
        return out


class Autoscaler:
    """Base policy: per-service sustain counters + bounds bookkeeping.

    Subclasses implement ``_direction(name, rs) -> int`` returning +1
    (wants to grow), -1 (wants to shrink), or 0; the base class applies the
    asymmetric sustain hysteresis and the [min, max] replica bounds.  The
    manager applies capacity bounds on top (see ``ServiceManager``).
    """

    def __init__(self, policy):
        self.policy = policy
        self._hot: dict = {}
        self._cold: dict = {}
        self._last_action: dict = {}  # name -> perf_counter of last scale

    # -- knobs ---------------------------------------------------------------
    @property
    def sustain_up(self) -> int:
        v = getattr(self.policy, "autoscale_sustain_up", None)
        return v if v and v > 0 else self._default_sustain_up()

    @property
    def sustain_down(self) -> int:
        v = getattr(self.policy, "autoscale_sustain_down", None)
        return v if v and v > 0 else self._default_sustain_down()

    def _default_sustain_up(self) -> int:
        return max(1, getattr(self.policy, "autoscale_sustain", 3))

    def _default_sustain_down(self) -> int:
        return max(1, getattr(self.policy, "autoscale_sustain", 3))

    # -- manager surface -----------------------------------------------------
    def prune(self, live_names):
        """Drop counters for service names that no longer exist."""
        for d in (self._hot, self._cold, self._last_action):
            for k in [k for k in d if k not in live_names]:
                del d[k]

    def note_scaled(self, name: str):
        """The manager issued a scaling action for ``name``: restart the
        hysteresis and remember when, so signal predating the action is
        discounted."""
        self._hot[name] = 0
        self._cold[name] = 0
        self._last_action[name] = time.perf_counter()

    def desired(self, name: str, rs) -> Optional[int]:
        """Target replica count for one tick, or None for no change."""
        pol = self.policy
        live = rs.n_live
        direction = self._direction(name, rs)
        if direction > 0 and live < pol.autoscale_max_replicas:
            self._hot[name] = self._hot.get(name, 0) + 1
            self._cold[name] = 0
            if self._hot[name] >= self.sustain_up:
                self._hot[name] = 0
                return rs.n_replicas + 1
        elif direction < 0 and live > pol.autoscale_min_replicas:
            self._cold[name] = self._cold.get(name, 0) + 1
            self._hot[name] = 0
            if self._cold[name] >= self.sustain_down:
                self._cold[name] = 0
                return rs.n_replicas - 1
        else:
            self._hot[name] = 0
            self._cold[name] = 0
        return None

    # -- subclass hook -------------------------------------------------------
    def _direction(self, name: str, rs) -> int:
        raise NotImplementedError


class QueueDepthAutoscaler(Autoscaler):
    """Grow when the mean live queue depth per replica stays high, shrink
    when it stays low — the original symmetric-sustain policy."""

    def _direction(self, name, rs) -> int:
        depth = rs.mean_depth()
        if depth > self.policy.autoscale_high_depth:
            return 1
        if depth < self.policy.autoscale_low_depth:
            return -1
        return 0


class LatencySLOAutoscaler(Autoscaler):
    """Hold a p95 end-to-end latency target (``slo_p95_ms``).

    Scale up fast when the windowed p95 of requests started since the last
    scaling action breaches the SLO; scale down slowly — only when p95 is
    comfortably under (``slo_down_factor``) AND queues are shallow, both
    sustained.  No fresh signal (an idle service) counts toward shrink.
    """

    def _default_sustain_up(self) -> int:
        return 1  # a breached SLO is acted on at the next tick

    def _default_sustain_down(self) -> int:
        return 3 * max(1, getattr(self.policy, "autoscale_sustain", 3))

    def _direction(self, name, rs) -> int:
        pol = self.policy
        slo_s = getattr(pol, "slo_p95_ms", 250.0) / 1e3
        window = getattr(pol, "slo_window_s", 5.0)
        down = getattr(pol, "slo_down_factor", 0.5)
        p95 = rs.latency_p95(window_s=window,
                             started_after=self._last_action.get(name))
        if p95 is None:
            # distinguish the two no-fresh-signal cases (the loaded steady
            # state paid a single latency_p95 above; this second, wider
            # query only runs on the quiet paths):
            if rs.latency_p95(window_s=window) is None:
                # nothing completed recently at all: a genuinely idle set
                # with shallow queues may cool down
                return -1 if rs.mean_depth() < pol.autoscale_low_depth else 0
            # recent traffic, but every sample predates the last scaling
            # action: judging it would oscillate — wait for fresh signal
            return 0
        if p95 > slo_s:
            return 1
        if p95 < down * slo_s and rs.mean_depth() < pol.autoscale_low_depth:
            return -1
        return 0


class WeightedCapacityAutoscaler(LatencySLOAutoscaler):
    """Per-model-group SLO autoscaling with weighted entitlements and
    capacity-neutral rebalancing (multi-model replica sets).

    Each model group runs the ``LatencySLOAutoscaler`` control logic
    against ITS OWN latency windows and SLO target
    (``ModelGroup.slo_p95_ms``, falling back to ``policy.slo_p95_ms``),
    with per-group sustain counters.  A group's share of the partition is
    anchored to its ``weight``: when a violating group wants a replica but
    the set is at ``autoscale_max_replicas`` or the partition has no free
    headroom for its shape, the scaler *rebalances* — it retires one
    replica from a donor group (not itself violating, holding more than
    one replica, preferring the group furthest ABOVE its weighted share,
    then the coldest) so the violating group can be admitted on the freed
    capacity.  Every group keeps at least its ``ModelGroup.min_replicas``
    floor (default 1 — a model with no replica cannot serve; an explicit
    0 allows scale-to-zero) and never exceeds its ``max_replicas``
    ceiling; plain grows/shrinks remain bounded by
    ``autoscale_max_replicas`` (total across groups) and the ledger.

    Speculative decoding closes the loop on draft-role groups
    (``ModelGroup.role == "draft"``): the set-wide acceptance rate
    (``ReplicaSet.spec_totals()``) scales the draft's effective weight —
    a draft whose proposals are mostly rejected becomes the most
    over-entitled donor — and once ``spec_min_proposed`` proposals have
    been observed, a rate below ``spec_min_acceptance`` force-shrinks the
    group one replica per tick (no sustain) toward its floor: spec-decode
    turns itself off gracefully instead of burning cores.

    Disaggregated serving closes the loop on prefill/decode-role groups:
    a prefill group's direction is judged against its TTFT window and a
    decode group's against its ITL window (``latency_p95(phase=...)``),
    so the prefill:decode ratio tracks the traffic mix (long-prompt vs
    chatty) instead of one blended end-to-end number.  Donor picks honor
    ``ModelGroup.borrow_limit``: a donor is never taken more than its
    limit below its weight-anchored entitlement.

    The manager consumes this policy through ``desired_groups(name, rs)``
    — one dict of per-group targets per tick, applied shrink-first so a
    rebalance inside a full partition never needs transient headroom
    (grows-first — warm handoff — when the partition has free headroom
    for every grow; see ``ReplicaSet.scale_groups``).
    Single-group sets degenerate to plain per-set SLO scaling.
    """

    def prune(self, live_names):
        # counters are keyed (service, group): prune on the service half
        for d in (self._hot, self._cold, self._last_action):
            for k in [k for k in d
                      if (k[0] if isinstance(k, tuple) else k)
                      not in live_names]:
                del d[k]

    def note_scaled(self, name: str):
        # one scaling ACTION restarts every group's hysteresis for the
        # service: the applied targets changed the whole set's signal
        for d in (self._hot, self._cold):
            for k in list(d):
                if (k[0] if isinstance(k, tuple) else k) == name:
                    d[k] = 0
        self._last_action[name] = time.perf_counter()

    def _group_phase(self, rs, group: str) -> Optional[str]:
        """Which latency window prices this group's SLO: disaggregated
        prefill groups are judged on TTFT, decode groups on ITL, every
        other role on end-to-end latency (None)."""
        role_fn = getattr(rs, "group_role", None)
        role = role_fn(group) if role_fn else "serve"
        return {"prefill": "ttft", "decode": "itl"}.get(role)

    def _group_direction(self, name: str, rs, group: str) -> int:
        """The LatencySLOAutoscaler direction logic, per model group.
        Prefill/decode-role groups read their per-phase window (TTFT /
        ITL) instead of end-to-end latency, so each pool's SLO violation
        grows it independently.

        With ``policy.qos_protected_class`` set, the group is judged on
        that priority class's end-to-end p95 whenever such samples exist
        — the isolation signal: capacity follows the class the SLO
        protects, not the saturating bulk traffic — falling back to the
        usual phase/end-to-end window when the class is quiet."""
        pol = self.policy
        slo_s = rs.group_slo_ms(group) / 1e3
        window = getattr(pol, "slo_window_s", 5.0)
        down = getattr(pol, "slo_down_factor", 0.5)
        phase = self._group_phase(rs, group)
        kw = {} if phase is None else {"phase": phase}
        cls = getattr(pol, "qos_protected_class", None)
        if cls is not None and phase is None:
            ckw = {"tenant_class": cls}
            if rs.latency_p95(window_s=window, group=group,
                              **ckw) is not None:
                kw = ckw  # class samples exist: judge on the class
        p95 = rs.latency_p95(window_s=window,
                             started_after=self._last_action.get(name),
                             group=group, **kw)
        if p95 is None:
            if rs.latency_p95(window_s=window, group=group, **kw) is None:
                # genuinely idle group with shallow queues may cool down
                return (-1 if rs.mean_depth(group=group)
                        < pol.autoscale_low_depth else 0)
            return 0  # only stale (pre-action) samples: wait, don't judge
        if p95 > slo_s:
            return 1
        if p95 < down * slo_s and \
                rs.mean_depth(group=group) < pol.autoscale_low_depth:
            return -1
        return 0

    def _pick_donor(self, grower: str, targets: dict, dirs: dict,
                    weights: dict, growers, bounds=None,
                    borrows=None) -> Optional[str]:
        """Group to retire a replica from so ``grower`` can be admitted:
        not itself wanting to grow, above its per-group floor (default
        1), preferring the largest surplus over its weighted share and
        then the coldest direction.  None when nobody can donate.

        ``borrows`` (group -> ``ModelGroup.borrow_limit`` or None) caps
        how far BELOW its weight-anchored entitlement a donor may be
        taken: a group with ``borrow_limit=b`` never donates below
        ``ceil(entitlement) - b`` replicas — a sustained burst on one
        group borrows bounded capacity instead of hollowing its siblings
        out to their absolute floors."""
        total = sum(targets.values())
        total_w = sum(weights.values()) or float(len(weights))
        best = None
        for g, n in targets.items():
            floor = (bounds or {}).get(g, (1, None))[0]
            ent = total * weights[g] / total_w
            borrow = (borrows or {}).get(g)
            if borrow is not None:
                floor = max(floor, math.ceil(ent) - borrow)
            if g == grower or g in growers or n <= floor:
                continue
            if dirs.get(g, 0) > 0:
                continue  # donating from a violating group helps nobody
            surplus = n - ent
            key = (surplus, -dirs.get(g, 0))
            if best is None or key > best[0]:
                best = (key, g)
        return best[1] if best else None

    def desired_groups(self, name: str, rs) -> Optional[dict]:
        """Per-group replica targets for one tick, or None for no change.
        ``rs`` is a ``ReplicaSet`` (or anything exposing the group surface:
        ``group_counts``/``group_weight``/``group_slo_ms``/
        ``latency_p95``/``mean_depth``/``capacity_headroom``)."""
        pol = self.policy
        counts = rs.group_counts()
        if not counts:
            return None
        role_fn = getattr(rs, "group_role", None)
        roles = {g: (role_fn(g) if role_fn else "serve") for g in counts}
        bounds_fn = getattr(rs, "group_bounds", None)
        bounds = {g: (bounds_fn(g) if bounds_fn else (1, None))
                  for g in counts}
        borrow_fn = getattr(rs, "group_borrow_limit", None)
        borrows = ({g: borrow_fn(g) for g in counts} if borrow_fn
                   else None)
        # speculative-decoding feedback: the set-wide acceptance rate
        # (accepted / proposed across every spec session) prices a
        # draft-role group's entitlement.  Below the floor — once enough
        # proposals have been observed to judge — the draft force-shrinks
        # toward its min_replicas (no sustain: a collapsed acceptance is
        # as decisive as a breached SLO), turning spec-decode off
        # gracefully instead of burning cores on rejected proposals.
        acceptance = None
        if any(r == "draft" for r in roles.values()) \
                and hasattr(rs, "spec_totals"):
            proposed, accepted = rs.spec_totals()
            if proposed >= max(1, getattr(pol, "spec_min_proposed", 256)):
                acceptance = accepted / proposed
        min_acc = getattr(pol, "spec_min_acceptance", 0.3)
        forced = set()
        dirs = {}
        for g in counts:
            d = self._group_direction(name, rs, g)
            if roles[g] == "draft" and acceptance is not None:
                if acceptance < min_acc:
                    d = -1
                    if counts[g] > bounds[g][0]:
                        forced.add(g)
                elif d < 0:
                    d = 0  # a paying draft group is not idle overhead:
                    #        its work shows up as the target's latency
            key = (name, g)
            if d > 0:
                self._hot[key] = self._hot.get(key, 0) + 1
                self._cold[key] = 0
            elif d < 0:
                self._cold[key] = self._cold.get(key, 0) + 1
                self._hot[key] = 0
            else:
                self._hot[key] = 0
                self._cold[key] = 0
            dirs[g] = d
        growers = [g for g in counts if dirs[g] > 0
                   and self._hot.get((name, g), 0) >= self.sustain_up]
        shrinkers = [g for g in counts if dirs[g] < 0
                     and (g in forced
                          or self._cold.get((name, g), 0)
                          >= self.sustain_down)]
        targets = dict(counts)
        weights = {g: max(0.0, rs.group_weight(g)) for g in counts}
        if acceptance is not None:
            for g in counts:  # entitlement scales with measured usefulness
                if roles[g] == "draft":
                    weights[g] *= acceptance
        for g in growers:
            gmax = bounds[g][1]
            if gmax is not None and targets[g] >= gmax:
                continue  # pinned by the operator's per-group ceiling
            donor = None
            headroom = rs.capacity_headroom(group=g)
            at_max = sum(targets.values()) >= pol.autoscale_max_replicas
            if at_max or (headroom is not None and headroom < 1):
                donor = self._pick_donor(g, targets, dirs, weights, growers,
                                         bounds=bounds, borrows=borrows)
                if donor is None:
                    # nothing to retire and nothing free: a sustained
                    # denial episode, visible on the set's stats
                    if hasattr(rs, "_note_admission_denied"):
                        rs._note_admission_denied("rebalance",
                                                  once_per_episode=True)
                    continue
                targets[donor] -= 1
                self._cold[(name, donor)] = 0
            targets[g] += 1
            self._hot[(name, g)] = 0
        min_total = max(1, getattr(pol, "autoscale_min_replicas", 1))
        for g in shrinkers:
            if targets[g] != counts[g]:
                continue  # already donated (or grew) this tick
            if targets[g] <= bounds[g][0]:
                continue  # per-group floor (default: every model keeps
                #           at least one replica; an explicit
                #           min_replicas=0 lets a draft scale off)
            if sum(targets.values()) <= min_total:
                continue  # the SET total honors autoscale_min_replicas,
                #           same floor the per-set policies enforce
            targets[g] -= 1
            self._cold[(name, g)] = 0
        return targets if targets != counts else None


AUTOSCALERS = {
    "queue_depth": QueueDepthAutoscaler,
    "latency_slo": LatencySLOAutoscaler,
    "weighted_capacity": WeightedCapacityAutoscaler,
}


def autoscaler_from_policy(policy) -> Autoscaler:
    kind = getattr(policy, "autoscaler", None) or "queue_depth"
    try:
        cls = AUTOSCALERS[kind]
    except KeyError:
        raise ValueError(
            f"unknown autoscaler {kind!r}; one of {sorted(AUTOSCALERS)}")
    return cls(policy)
