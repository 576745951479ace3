"""A float32 forward of a decoder-only transformer, dense or
mixture-of-experts, in plain PyTorch, run layer by layer over many
sequences at once.

The architecture, as the configuration file's ``model`` keys state it:
token embedding; per layer a pre-norm block of RMSNorm (scale, eps
``norm_eps``), grouped-query attention (q/k/v/o projections without bias,
rotary positions on the two halves of each head with frequencies
``theta^(-i/half)``, causal softmax at scale 1/sqrt(D); query head ``j``
reads kv head ``j // (Hq / Hkv)``) and a residual add, then RMSNorm and
either an MLP (``relu2``: squared ReLU, non-gated, as Nemotron-4; or a
SiLU-gated MLP) or, from ``first_dense_layers`` on, a mixture of experts
(DeepSeekMoE: softmax router over ``n_experts``, the ``top_k`` largest
renormalised, SiLU-gated experts of width ``d_ff``, plus
``n_shared_experts`` always-on experts as one MLP of width
``n_shared_experts·d_ff``) and a residual add; a final RMSNorm and an
untied unembedding.

Capacity.  A served MoE layer computes at most ``C`` (token, expert)
assignments per expert in each batch it runs, ``C = max(1,
ceil(n·top_k/n_experts·cf))`` for a batch of ``n`` rows, in row order and
then in order of the token's ranked experts; the rest are dropped.  Each
sequence position therefore carries the batch it was computed in (a prompt
chunk or a decode step of the served run, from the benchmark's record of
which sequences shared it), its row in that batch, and the batch's
capacity; this forward works out every routing, rank and drop again from
its own float32 numbers.  Positions with batch ``-1`` drop nothing.

``precision="fp8"`` is the control: every matrix product of a weight the
configuration serves in bfloat16 takes both operands rounded to float8
e4m3 (per-row and per-column scales), accumulating in float32.

Weights come from ``perfbench.weights`` (the tensors the program was
given), drawn again part by part on the device and read in float32.
"""
from __future__ import annotations

import math

import torch

from perfbench import weights as W

NONE = -1
FP8_MAX = 448.0


def set_precision():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _q8(x, dim):
    s = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def mm(x, w, fp8: bool):
    """x [n, a] @ w [a, b] in float32 (fp8: both operands rounded)."""
    w = w.float()
    if fp8:
        return _q8(x, -1) @ _q8(w, 0)
    return x @ w


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) \
        * scale.float()


def rope(x, pos, theta):
    """x [n, H, D], pos [n]."""
    half = x.shape[-1] // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half)
    ang = pos.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def act(name, x):
    if name == "relu2":
        return torch.relu(x).square()
    if name == "silu":
        return torch.nn.functional.silu(x)
    raise ValueError(f"activation {name!r}")


def mlp(m, h, up, down, gate, fp8):
    a = mm(h, up, fp8)
    if gate is not None:
        a = act(m["activation"], mm(h, gate, fp8)) * a
    else:
        a = act(m["activation"], a)
    return mm(a, down, fp8)


def capacity(m, n_rows: int) -> int:
    cf = max(m["decode_capacity_factor"], m["capacity_factor"])
    return max(1, math.ceil(n_rows * m["top_k"] / m["n_experts"] * cf))


def route(m, h, router):
    """(weights [N,k], experts [N,k]) of the float32 router."""
    probs = torch.softmax(h @ router.float(), dim=-1)
    p, i = torch.sort(probs, dim=-1, descending=True, stable=True)
    p, i = p[:, :m["top_k"]], i[:, :m["top_k"]]
    return p / p.sum(-1, keepdim=True).clamp(min=1e-9), i


def keep_mask(m, experts, batch, order, caps):
    """[N,k] bool: the assignments each batch's capacity admits."""
    N, k = experts.shape
    E = m["n_experts"]
    dev = experts.device
    b = batch[:, None].expand(N, k).reshape(-1)
    o = order[:, None].expand(N, k).reshape(-1)
    e = experts.reshape(-1)
    slot = torch.arange(k, device=dev).repeat(N)
    R = int(order.max()) + 1 if N else 1
    group = (b + 1) * E + e  # batch -1 ranks apart
    key = (group * R + o) * k + slot
    idx = torch.argsort(key)
    gs = group[idx]
    first = torch.ones_like(gs, dtype=torch.bool)
    first[1:] = gs[1:] != gs[:-1]
    pos = torch.arange(gs.numel(), device=dev)
    start = torch.cummax(torch.where(first, pos, 0), 0).values
    rank = torch.empty_like(pos).scatter_(0, idx, pos - start)
    cap = caps[b.clamp(min=0)]
    return ((b < 0) | (rank < cap)).reshape(N, k)


def moe(m, h, w, batch, order, caps, fp8):
    top_w, top_i = route(m, h, w["router"])
    keep = keep_mask(m, top_i, batch, order, caps)
    y = torch.zeros_like(h)
    gate = w.get("e_gate")
    for e in range(m["n_experts"]):
        hit = (top_i == e) & keep
        rows = hit.any(-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        wt = (top_w * hit)[rows].sum(-1, keepdim=True)
        out = mlp(m, h[rows], w["e_up"][e], w["e_down"][e],
                  None if gate is None else gate[e], fp8)
        y.index_add_(0, rows, out * wt)
    if "s_up" in w:
        y += mlp(m, h, w["s_up"], w["s_down"], w.get("s_gate"), fp8)
    return y, keep


class Batch:
    """Sequences laid end to end: tokens, positions, the served batch of
    each position, its row there, and the batches' capacities."""

    def __init__(self, seqs, caps, device):
        self.starts, n = [], 0
        for s in seqs:
            self.starts.append(n)
            n += len(s["tokens"])
        self.lengths = [len(s["tokens"]) for s in seqs]
        cat = lambda key, fill: torch.tensor(  # noqa: E731
            [v for s in seqs for v in (s.get(key) or [fill] * len(s["tokens"]))],
            dtype=torch.long, device=device)
        self.tokens = cat("tokens", 0)
        self.pos = torch.cat([torch.arange(L, device=device)
                              for L in self.lengths]) if seqs else \
            torch.zeros(0, dtype=torch.long, device=device)
        self.batch = cat("batch", NONE)
        self.order = cat("order", 0)
        self.caps = torch.tensor(list(caps) or [0], dtype=torch.long,
                                 device=device)
        self.score = torch.tensor(
            [st + p for s, st in zip(seqs, self.starts) for p in s["score"]],
            dtype=torch.long, device=device)


def forward(m, seed, seqs, caps=(), *, device, precision="f32",
            q_chunk=512, row_chunk=8192, on_layer=None):
    """Final-normed hidden states [n_score, d] at every sequence's
    ``score`` positions.  ``seqs``: dicts of ``tokens`` (every position
    fed), ``score`` (positions to read out) and, for an MoE model,
    ``batch`` / ``order`` per position; ``caps`` the capacity of each
    batch id."""
    set_precision()
    fp8 = precision == "fp8"
    bt = Batch(seqs, caps, device)
    d, hd = m["d_model"], m["head_dim"]
    hq, hkv = m["n_heads"], m["n_kv_heads"]
    G = hq // hkv
    eps, theta = m["norm_eps"], m["rope_theta"]
    x = W.embedding(m, seed, device)[bt.tokens].float()
    drops = 0
    for i in range(m["n_layers"]):
        w = W.layer(m, seed, i, device)
        h = rmsnorm(x, w["ln_attn"], eps)
        k = rope(mm(h, w["k"], fp8).view(-1, hkv, hd), bt.pos, theta)
        v = mm(h, w["v"], fp8).view(-1, hkv, hd)
        for st, L in zip(bt.starts, bt.lengths):
            for a in range(0, L, q_chunk):
                b = min(L, a + q_chunk)
                q = rope(mm(h[st + a:st + b], w["q"], fp8).view(-1, hq, hd),
                         bt.pos[st + a:st + b], theta)
                q = q.view(b - a, hkv, G, hd)
                s = torch.einsum("tkgd,skd->kgts", q, k[st:st + b]) / math.sqrt(hd)
                causal = (torch.arange(b, device=device)[None, :]
                          <= torch.arange(a, b, device=device)[:, None])
                s = s.masked_fill(~causal, float("-inf"))
                o = torch.einsum("kgts,skd->tkgd", torch.softmax(s, -1),
                                 v[st:st + b]).reshape(b - a, hq * hd)
                x[st + a:st + b] += mm(o, w["o"], fp8)
        del h, k, v
        if W.is_moe_layer(m, i):
            h = rmsnorm(x, w["ln_mlp"], eps)
            y, keep = moe(m, h, w, bt.batch, bt.order, bt.caps, fp8)
            drops += int((~keep).sum())
            x += y
            del h, y
        else:
            for a in range(0, x.shape[0], row_chunk):
                h = rmsnorm(x[a:a + row_chunk], w["ln_mlp"], eps)
                x[a:a + row_chunk] += mlp(m, h, w["up"], w["down"],
                                          w.get("gate"), fp8)
        del w
        if on_layer is not None:
            on_layer(i)
    hs = rmsnorm(x[bt.score], torch.ones(d, device=device), eps)
    return hs, drops


def readout(m, seed, hidden, served, *, device, control_hidden=None,
            vocab_chunk=32768):
    """Per scored row: the reference's best logit minus the logit of the
    served token (``served`` [n]); with ``control_hidden``, also minus the
    logit of the token the control ranks first."""
    set_precision()
    wu = W.unembedding(m, seed, device)
    n = hidden.shape[0]
    best = torch.full((n,), float("-inf"), device=device)
    at_served = torch.zeros(n, device=device)
    ctl_best = torch.full((n,), float("-inf"), device=device)
    ctl_arg = torch.zeros(n, dtype=torch.long, device=device)
    for a in range(0, m["vocab"], vocab_chunk):
        blk = wu[:, a:a + vocab_chunk].float()
        lg = hidden @ blk
        best = torch.maximum(best, lg.max(-1).values)
        inb = (served >= a) & (served < a + blk.shape[1])
        idx = (served - a).clamp(0, blk.shape[1] - 1)
        at_served = torch.where(inb, lg.gather(1, idx[:, None])[:, 0],
                                at_served)
        if control_hidden is not None:
            cl = mm(control_hidden, blk, True)
            v, j = cl.max(-1)
            upd = v > ctl_best
            ctl_best = torch.where(upd, v, ctl_best)
            ctl_arg = torch.where(upd, j + a, ctl_arg)
    gap = best - at_served
    if control_hidden is None:
        return gap, None
    ref_at_ctl = (hidden * wu[:, ctl_arg].float().T).sum(-1)
    return gap, best - ref_at_ctl
