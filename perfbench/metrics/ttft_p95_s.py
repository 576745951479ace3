"""95th percentile of the servicer's ``ttft_s`` (engine submit to first
token) over the requests that completed in the window."""
from perfbench.harness import percentile


def read(w):
    return percentile([c["result"]["ttft_s"] for c in w.completions
                       if c["result"] is not None
                       and c["result"].get("ttft_s") is not None], 95)
