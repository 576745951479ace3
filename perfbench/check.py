"""Whether the served tokens are right: the reference judges them.

After the window, a sample of the requests that finished in it (drawn
from the seed, the one with the most served tokens always in it) is run
through the float32 reference (``reference/model.py``) over its prompt
and served tokens, and each served token is judged by how far its logit
lies below the reference's best at that position.  The number compared is
the widest such gap; greedy decoding in the configuration's precision
keeps it small, and a wrong token, a cache read from the wrong place or a
step that forgot its state puts it far out.

For an MoE model the capacity drops of every layer depend on which rows
shared a batch, so the reference runs every sequence the engine served up
to the last step of the sample, each position in the batch it was served
in (``recorder.Recorder``), and works out every routing and drop itself.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from perfbench.recorder import pow2
from perfbench.reference import model as ref


def chunk_buckets(engine: dict) -> tuple:
    """The prompt-chunk sizes the paged engine pads to, from its settings
    (``max_len``, ``prefill_buckets``, ``prefill_chunk``,
    ``max_num_batched_tokens``)."""
    buckets = tuple(b for b in engine["prefill_buckets"]
                    if b <= engine["max_len"]) or (engine["max_len"],)
    chunk = min(engine.get("prefill_chunk") or max(buckets),
                engine["max_num_batched_tokens"])
    return tuple(b for b in buckets if b <= chunk) or (chunk,)


def bucket(n: int, buckets) -> int:
    return next((b for b in buckets if n <= b), buckets[-1])


def sample(finished: list, n: int, seed: int) -> list:
    """``n`` of ``finished`` (engine requests), the longest among them."""
    if not finished:
        return []
    finished = sorted(finished, key=lambda r: r.uid)
    longest = max(range(len(finished)),
                  key=lambda i: (len(finished[i].output), -finished[i].uid))
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFF, 0x5A])
    pick = set(rng.permutation(len(finished))[:max(0, n - 1)].tolist())
    pick.add(longest)
    return [finished[i] for i in sorted(pick)]


def sequences(m: dict, engine: dict, rec, scored: list, with_batches: bool):
    """Reference inputs (``seqs``, ``caps``) and the served tokens, or a
    reason they cannot be built."""
    scored_ids = {r.uid for r in scored}
    last = max((i for i, ev in enumerate(rec.log)
                if (ev[0] == "chunk" and ev[2] in scored_ids)
                or (ev[0] == "step" and any(u in scored_ids
                                            for u, _ in ev[2]))),
               default=-1)
    fed: dict = {}  # uid -> {pos: (batch, order)}
    caps = []
    buckets = chunk_buckets(engine)
    for i, ev in enumerate(rec.log[:last + 1]):
        if ev[0] == "chunk":
            _, _, uid, pos0, T = ev
            rows = [(uid, pos0 + t) for t in range(T)]
            cap = ref.capacity(m, bucket(T, buckets)) if with_batches else 0
        else:
            rows = ev[2]
            cap = ref.capacity(m, ev[3]) if with_batches else 0
        b = len(caps)
        caps.append(cap)
        for j, (uid, pos) in enumerate(rows):
            if with_batches or uid in scored_ids:
                fed.setdefault(uid, {})[pos] = (b, j)
    seqs, served = [], []
    for uid, cells in fed.items():
        r = rec.requests[uid]
        n_p = len(r.prompt)
        L = max(cells) + 1
        first = min(cells)
        if sorted(cells) != list(range(first, L)):
            return None, None, None, f"request {uid}: positions not contiguous"
        if first > n_p or L > n_p + len(r.output):
            return None, None, None, f"request {uid}: positions out of range"
        toks = [r.prompt[p] if p < n_p else r.output[p - n_p]
                for p in range(L)]
        seq = {"tokens": toks, "score": []}
        if with_batches:
            seq["batch"] = [cells[p][0] if p in cells else ref.NONE
                            for p in range(L)]
            seq["order"] = [cells[p][1] if p in cells else 0
                            for p in range(L)]
        if uid in scored_ids:
            if L != n_p + len(r.output) - 1:
                return None, None, None, (
                    f"request {uid}: {L} positions fed for "
                    f"{n_p} + {len(r.output)} tokens")
            seq["score"] = list(range(n_p - 1, L))
            served += list(r.output)
        seqs.append(seq)
    return seqs, caps, served, None


def judge(m: dict, engine: dict, seed: int, rec, finished: list, n: int,
          device, control: bool = False) -> dict:
    """The widest and the mean gap over a sample of ``finished`` (engine
    requests); with ``control``, the control's too, under ``control``."""
    t = time.perf_counter()
    scored = sample(finished, n, seed)
    out = {"requests": len(scored)}
    if not scored:
        return {**out, "error": "no request finished in the window"}
    seqs, caps, served, err = sequences(m, engine, rec, scored,
                                        bool(m.get("n_experts")))
    if err:
        return {**out, "error": err}
    hid, drops = ref.forward(m, seed, seqs, caps, device=device)
    ctl = None
    if control:
        ctl, _ = ref.forward(m, seed, seqs, caps, device=device,
                             precision="fp8")
    served_t = torch.tensor(served, dtype=torch.long, device=device)
    gap, ctl_gap = ref.readout(m, seed, hid, served_t, device=device,
                               control_hidden=ctl)
    out.update({"tokens": len(served), "sequences": len(seqs),
                "positions": sum(len(s["tokens"]) for s in seqs),
                "reference_drops": drops,
                "widest_gap": float(gap.max()),
                "mean_gap": float(gap.mean()),
                "seconds": time.perf_counter() - t})
    if ctl_gap is not None:  # the control's first-ranked tokens, judged alike
        out["control"] = {"tokens": len(served),
                          "widest_gap": float(ctl_gap.max()),
                          "mean_gap": float(ctl_gap.mean())}
    return out
