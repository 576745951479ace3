"""The paged decode attention's share of its roofline in the traced part
of the window: the least time for the bytes its calls need
(``yardstick.paged_decode_bytes`` at the HBM rate) over the device time of
the work launched inside its ``record_function`` range, in percent."""
from perfbench import yardstick


def read(w):
    if w.trace is None:
        return None
    dev = w.trace["ranges"].get("perfbench.paged_decode", {})
    if not dev.get("device_s") or not w.trace.get("decode_bytes"):
        return None
    least = w.trace["decode_bytes"] / yardstick.HBM_BYTES_PER_S
    return 100.0 * least / dev["device_s"]
