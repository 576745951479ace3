"""Reduce a ``torch.profiler`` trace to the numbers the metrics read.

Works on plain tuples so that tests can feed it a synthetic trace:

* ``device``: ``(name, start_ns, end_ns, correlation, linked)`` of every
  kernel, copy and memset on the card, ``linked`` the correlation id of
  the host operator or range it was launched under;
* ``host``: ``(name, start_ns, end_ns, thread, correlation, kind)`` of
  every host event, ``kind`` one of ``op`` (an operator or a
  ``record_function`` range), ``runtime`` (a CUDA runtime or driver call,
  which carries the correlation id of the work it launched).

The device's busy time is the length of the union of its intervals (the
arithmetic of the repository's ``profile_engine.py``, which sums kernel
times, done as a union so that overlapping work counts once).  An idle gap
is a stretch between two busy intervals; it is named by the innermost
host event on the launching thread at its midpoint, or ``python (no host
op)`` where there is none.  A range's device time is the time of the
device work launched from inside it.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

NO_HOST_OP = "python (no host op)"


def merge(intervals):
    """Union of ``(start, end)`` intervals -> sorted disjoint list."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def busy_ns(device) -> int:
    return sum(e - s for s, e in merge((d[1], d[2]) for d in device))


NAME_CHARS = 96  # kernel names are C++ signatures; their heads suffice


def device_ops(device, n: int = 10):
    tot = defaultdict(int)
    for name, s, e, *_ in device:
        tot[name[:NAME_CHARS]] += e - s
    top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
    return [[name, ns / 1e9] for name, ns in top]


def launch_thread(host):
    """The thread that issued most device work."""
    count = defaultdict(int)
    for ev in host:
        if ev[5] == "runtime":
            count[ev[3]] += 1
    return max(count, key=count.get) if count else None


def idle_gaps(device, host, n: int = 10):
    busy = merge((d[1], d[2]) for d in device)
    thread = launch_thread(host)
    evs = sorted((s, e, name) for name, s, e, th, _, _ in host
                 if th == thread)
    starts = [ev[0] for ev in evs]
    tot = defaultdict(int)
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = (a + b) // 2
        name = NO_HOST_OP
        i = bisect.bisect_right(starts, mid) - 1
        # the latest-starting event that still covers mid is the innermost
        for j in range(i, max(-1, i - 4096), -1):
            if evs[j][1] >= mid:
                name = evs[j][2]
                break
        tot[name] += b - a
    top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
    return [[name, ns / 1e9] for name, ns in top]


def range_device_ns(device, host, range_name: str) -> tuple:
    """(device ns, launches) of the work launched inside host ranges named
    ``range_name``: work whose runtime call lies inside such a range on
    its thread, or whose launch the profiler linked to the range itself."""
    ranges = sorted((s, e, th, corr) for name, s, e, th, corr, kind in host
                    if name == range_name and kind == "op")
    if not ranges:
        return 0, 0
    starts = [r[0] for r in ranges]
    own = {r[3] for r in ranges}
    launched = set()
    for name, s, e, th, corr, kind in host:
        if kind != "runtime":
            continue
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and ranges[i][1] >= s and ranges[i][2] == th:
            launched.add(corr)
    total, n = 0, 0
    for name, s, e, corr, linked in device:
        if corr in launched or linked in own:
            total += e - s
            n += 1
    return total, n


def from_profiler(prof):
    """(device, host) tuples from a stopped ``torch.profiler.profile``.
    A host event whose name starts with ``cu`` is a CUDA runtime or
    driver call; a device event named as a host event is the profiler's
    mirror of a range, not device work."""
    from torch.autograd import DeviceType

    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        s, e, name = ev.start_ns(), ev.end_ns(), ev.name()
        if ev.device_type() == DeviceType.CUDA:
            device.append((name, s, e, ev.correlation_id(),
                           ev.linked_correlation_id()))
        else:
            host.append((name, s, e, ev.start_thread_id(),
                         ev.correlation_id(),
                         "runtime" if name.startswith("cu") else "op"))
    names = {h[0] for h in host}
    return [d for d in device if d[0] not in names], host


def summarize(prof, window_s: float, ranges=()) -> dict:
    device, host = from_profiler(prof)
    out = {"window_s": window_s, "busy_s": busy_ns(device) / 1e9,
           "device_ops": device_ops(device),
           "idle_gaps": idle_gaps(device, host), "ranges": {},
           "kernels": len(device)}
    for name in ranges:
        ns, n = range_device_ns(device, host, name)
        out["ranges"][name] = {"device_s": ns / 1e9, "launches": n}
    return out
