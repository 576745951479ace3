"""Weighted-fair queueing + decode preemption for multi-tenant QoS.

``WFQScheduler`` sits between a servicer and its ``InferenceEngine``:
every submitted request is stamped with a VIRTUAL FINISH TIME — the
tenant/class flow's virtual clock advanced by ``cost / weight`` — and
``schedule()`` re-orders the engine's admission queue by those stamps
before each step.  Heavier classes (see ``DEFAULT_CLASS_WEIGHTS``)
accumulate virtual time more slowly, so under contention their requests
sort ahead; an idle flow's clock is pulled up to the global virtual
clock on its next submit, so sleeping never banks credit (the classic
WFQ start-time rule).

When the queue head cannot be admitted (no free sequence slot, or not
enough free + reclaimable blocks for its reservation) and ``preempt``
is on, the scheduler preempts the running DECODE-phase sequence with
the lightest class weight and the latest virtual finish — strictly
lighter than the head's class.  The victim is RE-STAMPED at its flow's
current virtual time (preempted work re-enters the queue as new work),
so it always sorts behind the head that displaced it — preemption can
never churn by re-admitting the victim first.  Preempted KV retires to
residency and the victim re-enters the queue (see
``InferenceEngine.preempt_sequence``); its resume is token-identical,
so QoS is invisible in transcripts.

The scheduler is deliberately engine-agnostic about WHAT admission
needs — it recomputes the head's block need with the engine's own
``_blocks_needed`` (coverage-blind, i.e. conservative: a resident match
only makes admission easier).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.request import DEFAULT_CLASS_WEIGHTS


class WFQScheduler:
    """Per-replica weighted-fair admission order with decode preemption."""

    def __init__(self, class_weights: Optional[dict] = None,
                 preempt: bool = True, max_preempt_per_round: int = 4):
        self.weights = dict(DEFAULT_CLASS_WEIGHTS if class_weights is None
                            else class_weights)
        self.preempt = preempt
        self.max_preempt_per_round = max_preempt_per_round
        self._vtime: dict = {}  # (tenant, class) flow -> virtual clock
        self._v = 0.0  # global virtual clock (floor for idle flows)
        self._finish: dict = {}  # uid -> virtual finish stamp
        self.preempted = 0  # scheduler-initiated preemptions

    def weight_of(self, qos_class: str) -> float:
        return max(self.weights.get(qos_class, 1.0), 1e-9)

    # -- submission ---------------------------------------------------------
    def on_submit(self, req, cost: Optional[float] = None):
        """Stamp an engine ``Request`` with its virtual finish time.
        ``cost`` defaults to the work the request will actually do
        (prompt prefill + decode budget, in tokens)."""
        if cost is None:
            cost = len(req.prompt) + req.max_new_tokens
        flow = (req.tenant, req.qos_class)
        start = max(self._vtime.get(flow, 0.0), self._v)
        fin = start + cost / self.weight_of(req.qos_class)
        self._vtime[flow] = fin
        self._finish[req.uid] = fin

    def on_finish(self, uid: int):
        self._finish.pop(uid, None)

    # -- scheduling ---------------------------------------------------------
    def _need(self, eng, req) -> int:
        """Coverage-blind block need for admitting ``req`` (mirrors
        ``_admit_paged`` / ``_readmit_preempted`` without their resident-
        prefix credit)."""
        if req.output:  # preempted readmit: catch-up over the transcript
            total = req.n_prompt + req.max_new_tokens
        else:
            m = min(req.n_prompt, eng.max_len - 1)
            total = m + req.max_new_tokens
        return eng._blocks_needed(total, 0)

    def _head_admits(self, eng, head) -> bool:
        if len(eng.running) >= eng.max_running:
            return False
        avail = (eng.pool.n_free + eng._reclaimable_blocks()
                 - eng._reserved)
        return avail >= self._need(eng, head)

    def schedule(self, eng):
        """Re-order ``eng.queue`` by virtual finish and, if the head is
        blocked, preempt lighter running decodes to make room.  Call
        immediately before ``eng.step()`` (the step's admission pass then
        sees the WFQ order)."""
        if not eng.queue:
            return
        fin = self._finish
        eng.queue.sort(key=lambda r: fin.get(r.uid, 0.0))  # stable
        head = eng.queue[0]
        head_fin = fin.get(head.uid, 0.0)
        self._v = max(self._v, head_fin)
        if not (self.preempt and getattr(eng, "paged", False)):
            return
        head_w = self.weight_of(head.qos_class)
        tries = self.max_preempt_per_round
        while tries > 0 and not self._head_admits(eng, head):
            victim = None
            vkey = None
            for r in eng.running.values():
                if r.done or r.pending_tokens or not r.output \
                        or r.truncated:
                    continue  # only decode-phase sequences are preemptable
                w = self.weight_of(r.qos_class)
                if w >= head_w:
                    continue  # never preempt an equal/heavier class
                key = (-w, fin.get(r.uid, 0.0))  # lightest class first,
                #                                  then latest finish
                if victim is None or key > vkey:
                    victim, vkey = r, key
            if victim is None or not eng.preempt_sequence(victim.uid):
                break
            # re-stamp the victim at its flow's CURRENT virtual time: the
            # catch-up replay is new work, and the fresh stamp (>= the
            # global clock >= head_fin) pins it behind the head it made
            # room for
            w = self.weight_of(victim.qos_class)
            flow = (victim.tenant, victim.qos_class)
            start = max(self._vtime.get(flow, 0.0), self._v)
            nf = start + (victim.n_prompt + victim.max_new_tokens) / w
            self._vtime[flow] = nf
            self._finish[victim.uid] = nf
            self.preempted += 1
            tries -= 1
        # preempted victims re-entered the queue: restore WFQ order
        eng.queue.sort(key=lambda r: fin.get(r.uid, 0.0))
        if len(self._finish) > 4096:  # prune stamps of departed requests
            live = {r.uid for r in eng.queue}
            live.update(eng.running.keys())
            self._finish = {u: f for u, f in self._finish.items()
                            if u in live}

    def stats(self) -> dict:
        return {"preempted": self.preempted,
                "virtual_clock": self._v,
                "flows": len(self._vtime)}
