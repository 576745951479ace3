"""Mean over the window's requests of the client-side latency less the
servicer's own ``latency_s``: the time spent in ``Rhapsody``'s router,
endpoint queue and ``ServiceInstance`` thread, in milliseconds."""


def read(w):
    d = [c["latency"] - c["result"]["latency_s"] for c in w.completions
         if c["result"] is not None]
    return 1e3 * sum(d) / len(d) if d else None
