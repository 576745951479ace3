"""Mean over the window's completed requests of the servicer's
``queue_s``, in milliseconds: the engine's submit to its first admission
of the request, the wait in the engine's queue.  ``middleware_ms`` does
not hold it (the servicer's ``latency_s`` starts at the engine's submit);
nothing where the results carry no ``queue_s``."""


def read(w):
    q = [c["result"]["queue_s"] for c in w.completions
         if c["result"] is not None
         and c["result"].get("queue_s") is not None]
    return 1e3 * sum(q) / len(q) if q else None
