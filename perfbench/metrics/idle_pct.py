"""Share of the traced window in which no operation ran on the card, in
percent (the union of the profiler's device intervals)."""


def read(w):
    if w.trace is None or not w.trace["window_s"] or not w.trace["kernels"]:
        return None
    return 100.0 * (1.0 - w.trace["busy_s"] / w.trace["window_s"])
