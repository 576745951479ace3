"""Model FLOPs of the window's work (``yardstick.window_flops``: the
weights each token uses, its attention, and the unembedding of the rows
whose logits are used) over the window's seconds at the card's bf16 peak,
in percent."""
from perfbench import yardstick


def read(w):
    flops = yardstick.window_flops(w.model, w.chunks, w.steps)
    if not flops or w.seconds <= 0:
        return None
    return 100.0 * flops / (w.seconds * yardstick.PEAK_BF16_FLOPS)
