"""The reference's capacity rule and its weights, at small sizes."""
import math

import pytest
import torch

from perfbench import weights
from perfbench.reference import model as ref

M = {"n_experts": 4, "top_k": 2, "capacity_factor": 1.25,
     "decode_capacity_factor": 1.0}


def _brute_keep(experts, batch, order, caps):
    """Each batch's rows in order, each row's slots in order; an expert
    takes an assignment while it has taken fewer than the capacity."""
    keep = torch.zeros_like(experts, dtype=torch.bool)
    taken = {}
    rows = sorted(range(len(batch)), key=lambda t: (batch[t], order[t]))
    for t in rows:
        for s in range(experts.shape[1]):
            b, e = int(batch[t]), int(experts[t, s])
            if b < 0:
                keep[t, s] = True
                continue
            n = taken.get((b, e), 0)
            keep[t, s] = n < caps[b]
            taken[(b, e)] = n + 1
    return keep


@pytest.mark.parametrize("seed", range(6))
def test_capacity_rule_matches_the_brute_force(seed):
    g = torch.Generator().manual_seed(seed)
    N = 40
    experts = torch.stack([torch.randperm(4, generator=g)[:2]
                           for _ in range(N)])
    experts[:12] = torch.tensor([0, 1])  # crowd two experts
    batch = torch.randint(-1, 3, (N,), generator=g)
    order = torch.empty(N, dtype=torch.long)
    for b in range(-1, 3):
        idx = (batch == b).nonzero()[:, 0]
        order[idx] = torch.randperm(len(idx), generator=g)
    caps = torch.tensor([1, 3, 2])
    got = ref.keep_mask(M, experts, batch, order, caps)
    assert torch.equal(got, _brute_keep(experts, batch, order, caps))
    assert not got.all()


def test_capacity_follows_the_batch_rows():
    assert ref.capacity(M, 1) == 1
    assert ref.capacity(M, 64) == math.ceil(64 * 2 / 4 * 1.25)
    big = {"n_experts": 64, "top_k": 6, "capacity_factor": 1.25,
           "decode_capacity_factor": 4.0}
    assert ref.capacity(big, 64) == 24 and ref.capacity(big, 768) == 288


def test_route_ranks_ties_by_lower_expert_and_renormalises():
    h = torch.zeros(1, 3)
    w, i = ref.route({"top_k": 2}, h, torch.zeros(3, 4))
    assert i.tolist() == [[0, 1]] and w.tolist() == [[0.5, 0.5]]


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "nemotron-4-340b"])
def test_weights_have_the_programs_layout(arch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model

    cfg = get_smoke_config(arch)
    want = get_model(cfg).init(torch.Generator().manual_seed(0), cfg,
                               device="cpu")
    m = {k: getattr(cfg, k) for k in (
        "n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
        "vocab", "n_experts", "top_k", "n_shared_experts",
        "first_dense_layers", "dense_ff", "gated_mlp", "param_dtype")}
    got = weights.port_params(m, 3, "cpu")

    def leaves(t, pre=""):
        if isinstance(t, dict):
            for k in sorted(t):
                yield from leaves(t[k], f"{pre}/{k}")
        elif isinstance(t, list):
            for i, v in enumerate(t):
                yield from leaves(v, f"{pre}[{i}]")
        else:
            yield pre, tuple(t.shape), t.dtype

    assert list(leaves(got)) == list(leaves(want))
    again = weights.port_params(m, 3, "cpu")
    assert torch.equal(got["blocks"][-1]["attn"]["q"]["w"],
                       again["blocks"][-1]["attn"]["q"]["w"])
    other = weights.port_params(m, 4, "cpu")
    assert not torch.equal(got["embed"]["table"], other["embed"]["table"])


def test_fp8_control_rounds_both_operands():
    g = torch.Generator().manual_seed(1)
    x, w = torch.randn(8, 32, generator=g), torch.randn(32, 16, generator=g)
    exact, low = ref.mm(x, w, False), ref.mm(x, w, True)
    err = (low - exact).abs().max() / exact.abs().max()
    assert 1e-3 < err < 0.2
