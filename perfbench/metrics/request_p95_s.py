"""95th percentile of client-side latency (from ``ReplicaSet.request`` to
the future's result) over every request that completed in the window.  A
per-layer reading: the end-to-end judgement is the rate, since this tail
rests on the few longest requests a window finishes."""
from perfbench.harness import percentile


def read(w):
    return percentile([c["latency"] for c in w.completions
                       if c["result"] is not None], 95)
