"""What the engine did, recorded from outside: each prompt chunk and each
decode step, with the sequences that shared it.

``Recorder.install(engine)`` wraps two methods of one
``repro_torch.serving.engine.InferenceEngine`` instance (the chunked
prefill step and the batched decode step of the paged pool) and keeps, in
one log in the order they ran, ``("chunk", t, uid, pos0, T)`` and
``("step", t, [(uid, pos), ...], B)``: the rows a decode step fed, in the
engine's batch order, and the padded batch it ran at.  It reads only the
engine's host-side request books, so it adds no device work and no
synchronisation.  The reference reads the log to work out which rows
shared an MoE layer's capacity; the model-FLOP count and the paged-decode
bytes read it too.
"""
from __future__ import annotations

import time


def pow2(n: int) -> int:
    B = 1
    while B < n:
        B *= 2
    return B


class Recorder:
    def __init__(self):
        self.log: list = []
        self.requests: dict = {}  # uid -> the engine's Request
        self.step_attended = 0  # this decode step's attended positions
        self.step_batch = 0

    def reset(self):
        self.log = []
        self.requests = {}

    def install(self, engine):
        orig_prefill = engine._prefill_step_paged
        orig_decode = engine._decode_step_paged

        def prefill_step():
            before = [(r, r.pos) for r in engine._prefill_order]
            orig_prefill()
            t = time.perf_counter()
            for r, pos0 in before:
                if r.pos > pos0:
                    self.requests[r.uid] = r
                    self.log.append(("chunk", t, r.uid, pos0, r.pos - pos0))

        def decode_step():
            active = [r for r in engine.running.values()
                      if not r.pending_tokens and not r.done and r.output]
            rows = [(r.uid, r.pos) for r in active]
            B = pow2(len(rows)) if rows else 0
            self.step_batch = B
            # padding rows attend one position of the null block
            self.step_attended = sum(p + 1 for _, p in rows) + B - len(rows)
            events = orig_decode()
            if rows:
                t = time.perf_counter()
                for r in active:
                    self.requests[r.uid] = r
                self.log.append(("step", t, rows, B))
            return events

        engine._prefill_step_paged = prefill_step
        engine._decode_step_paged = decode_step

    def window(self, t0: float, t1: float):
        """(chunks as (pos0, T, last), steps as position lists) that ended
        inside [t0, t1]."""
        chunks, steps = [], []
        for ev in self.log:
            if not t0 <= ev[1] <= t1:
                continue
            if ev[0] == "chunk":
                r = self.requests[ev[2]]
                chunks.append((ev[3], ev[4], ev[3] + ev[4] >= len(r.prompt)))
            else:
                steps.append([p for _, p in ev[2]])
        return chunks, steps
