"""Event tracing + the paper's evaluation metrics.

Events are appended lock-free-ish (list.append is atomic under the GIL) as
``(timestamp, uid, state, task_type, tag)`` tuples.  From a trace we compute:

  * heterogeneity width HW(t) — number of DISTINCT task types running
    concurrently (Exp 2, Fig 4),
  * throughput (tasks/s) and per-task overhead (Exp 1, Fig 3),
  * agent decision rate vs AI-HPC realization rate ARR (Exp 6, Fig 7),
  * utilization timelines.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Any, Optional


class EventLog:
    def __init__(self):
        self.events: list = []  # (ts, uid, state, task_type, tag)
        self.t0 = time.perf_counter()

    def emit(self, uid: str, state: str, task_type: str = "", tag: str = ""):
        self.events.append((time.perf_counter(), uid, state, task_type, tag))

    def clear(self):
        self.events.clear()
        self.t0 = time.perf_counter()

    # ------------------------------------------------------------------
    # Derived metrics
    # ------------------------------------------------------------------
    def intervals(self):
        """[(start, end, uid, task_type)] for tasks that ran."""
        start: dict = {}
        out = []
        for ts, uid, state, ttype, _ in self.events:
            if state == "RUNNING":
                start[uid] = (ts, ttype)
            elif state in ("DONE", "FAILED", "CANCELED") and uid in start:
                s, tt = start.pop(uid)
                out.append((s, ts, uid, tt))
        return out

    def heterogeneity_width(self, resolution: float = 0.01):
        """[(t, HW)] sampled timeline of distinct concurrent task types."""
        iv = self.intervals()
        if not iv:
            return []
        points = []
        for s, e, _, tt in iv:
            points.append((s, 1, tt))
            points.append((e, -1, tt))
        points.sort()
        counts: dict = defaultdict(int)
        timeline = []
        for ts, delta, tt in points:
            counts[tt] += delta
            if counts[tt] == 0:
                del counts[tt]
            timeline.append((ts - self.t0, len(counts)))
        # downsample to resolution
        out = []
        last_t = None
        for t, hw in timeline:
            if last_t is None or t - last_t >= resolution:
                out.append((t, hw))
                last_t = t
            else:
                out[-1] = (out[-1][0], max(out[-1][1], hw))
        return out

    def peak_hw(self) -> int:
        tl = self.heterogeneity_width()
        return max((hw for _, hw in tl), default=0)

    def throughput(self, state: str = "DONE") -> float:
        ts = [e[0] for e in self.events if e[2] == state]
        if len(ts) < 2:
            return 0.0
        return len(ts) / max(1e-9, max(ts) - min(ts))

    def windowed_rate(self, state: str, window: float = 1.0,
                      tag: Optional[str] = None):
        """[(t, events/s)] sliding-window rate for a state transition."""
        ts = sorted(e[0] - self.t0 for e in self.events
                    if e[2] == state and (tag is None or e[4] == tag))
        if not ts:
            return []
        out = []
        t = ts[0]
        end = ts[-1]
        while t <= end + window:
            lo = bisect.bisect_left(ts, t - window)
            hi = bisect.bisect_right(ts, t)
            out.append((t, (hi - lo) / window))
            t += window / 4
        return out

    def realization_lag(self, decision_tag: str = "decision",
                        realize_state: str = "RUNNING") -> list:
        """Per-event lag between agent decisions and HPC task starts."""
        decisions = sorted(e[0] for e in self.events if e[4] == decision_tag)
        starts = sorted(e[0] for e in self.events if e[2] == realize_state)
        lags = []
        di = 0
        for s in starts:
            while di < len(decisions) - 1 and decisions[di + 1] <= s:
                di += 1
            if decisions and decisions[di] <= s:
                lags.append(s - decisions[di])
        return lags
