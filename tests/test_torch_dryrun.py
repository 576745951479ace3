"""The port's launch tooling against the JAX package's, on the CPU: the
shape grid and ``cell_supported`` (equal), the abstract parameters and
AdamW state of every arch at full width (leaf count, elements and bytes
equal to ``jax.eval_shape``'s, stacked reference leaves counted per
layer; nemotron's moments 8-bit), the batch specs (equal), the cache
template (the reference's bytes at decode_32k but its per-layer ``len``;
the port's own prefill cache's structure); the cost counter
(``launch/cost.py``): each family's smoke forward counts exactly the FLOPs
``repro.launch.hlo_cost.analyze`` reads off the reference's compiled
forward, and a loss-and-gradient step with remat "none" on both sides at
most 5 % more (measured at B 2 x S 64 over all eleven archs: 1.2 to 4.0 %
more, about one unembedding-sized product that the reference's HLO does
not show as a dot); on
``meta`` the FLOPs outside the kernels equal the CPU count and each kernel
is charged its ``kernels/cost.py`` formula, and no launch counter moves;
the bytes of a linear; one microbatch charged n times equal to the step
with n microbatches; then the dry-run CLI and the ``roofline`` suite that
reads its records.  Inputs are made with numpy from a seed."""
import json
import math

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import build, fresh, to_jax, to_torch  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import hlo_cost  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.training.optim import OptimizerConfig as JaxOpt  # noqa: E402
from benchmarks_torch import bench_roofline, common  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.configs import list_archs  # noqa: E402
from repro_torch.kernels import cost as kcost  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.mamba2 import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.rwkv6 import ops as wkv_ops  # noqa: E402
from repro_torch.launch import cost, dryrun  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.training import optim  # noqa: E402
from repro_torch.training.train import (TrainConfig,  # noqa: E402
                                        make_train_step)

FAMILIES = ("llama3.2-3b", "deepseek-moe-16b", "rwkv6-1.6b", "zamba2-2.7b",
            "whisper-small", "internvl2-1b")  # dense, moe, ssm, hybrid,
# encdec, vlm
GRAD_FLOPS_TOL = 0.05  # port / reference - 1 for a loss-and-gradient step
META = torch.device("meta")


def _ref_leaves(tree, path=()):
    """(shape, itemsize) of every leaf of a reference tree, a stacked
    ``blocks``/``enc_blocks`` leaf [L, ...] counted as L leaves and a
    ``groups`` leaf [G, K, ...] as G x K, as the port keeps them."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in _ref_leaves(v, path + (k,))]
    shape, isz = tuple(tree.shape), np.dtype(tree.dtype).itemsize
    n = 1
    if {"blocks", "enc_blocks"} & set(path[:2]):
        n, shape = shape[0], shape[1:]
    elif "groups" in path[:2]:
        n, shape = shape[0] * shape[1], shape[2:]
    return [(shape, isz)] * n


def _totals_ref(leaves):
    return (len(leaves), sum(math.prod(s) for s, _ in leaves),
            sum(math.prod(s) * i for s, i in leaves))


def _totals(tensors):
    return (len(tensors), sum(t.numel() for t in tensors),
            sum(t.numel() * t.element_size() for t in tensors))


def _spec(t):
    return tuple(t.shape), str(t.dtype).split(".")[-1]


def _batch(cfg, B=2, S=64, seed=0):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab, size=(B, S + 1)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
         "loss_mask": np.ones((B, S), np.float32)}
    if cfg.family == "encdec":
        b["frame_embeds"] = rng.randn(B, S, cfg.d_model).astype(np.float32)
    if cfg.family == "vlm":
        b["patch_embeds"] = rng.randn(B, cfg.vision_tokens,
                                      cfg.d_model).astype(np.float32)
    return b


def _grad_step(api, cfg):
    def step(p, b):
        loss, _ = api.loss(p, b, cfg)
        return torch.autograd.grad(loss, optim.tree_leaves(p),
                                   allow_unused=True, materialize_grads=True)
    return step


def _launch_counts():
    return (da_ops.launches, da_ops.contiguous_launches, fa_ops.launches,
            wkv_ops.launches, ssd_ops.launches)


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------


def test_shapes_and_cell_supported_equal_reference():
    assert specs.SHAPES == jspecs.SHAPES
    assert specs.LONG_CONTEXT_FAMILIES == jspecs.LONG_CONTEXT_FAMILIES
    assert specs.WHISPER_FRAMES == jspecs.WHISPER_FRAMES
    for arch in list_archs():
        for shape in specs.SHAPES:
            assert specs.cell_supported(get_config(arch), shape) == \
                jspecs.cell_supported(jax_get_config(arch), shape)


@pytest.mark.parametrize("arch", list_archs())
def test_abstract_state_equals_reference(arch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    quant = arch in dryrun.QUANTIZED_OPT
    assert quant == (arch == "nemotron-4-340b")
    jparams, _ = jspecs.abstract_params(jax_get_model(jcfg), jcfg)
    jopt = jspecs.abstract_opt_state(jparams, JaxOpt(quantize_states=quant))
    params, _ = specs.abstract_params(get_model(cfg), cfg)
    opt = specs.abstract_opt_state(
        params, optim.OptimizerConfig(quantize_states=quant))
    leaves = optim.tree_leaves(params)
    assert all(t.device == META and t.requires_grad for t in leaves)
    assert _totals(leaves) == _totals_ref(_ref_leaves(jparams))
    moments = optim.tree_leaves(opt["moments"])
    assert _totals(moments) == _totals_ref(_ref_leaves(jopt["moments"]))
    assert {t.dtype for t in moments} == (
        {torch.int8, torch.uint8, torch.float32} if quant
        else {torch.float32})
    # the step counter is the CPU's, as on the card: not a meta byte
    assert specs.tree_bytes(opt) == sum(
        t.numel() * t.element_size() for t in moments)


def test_batch_specs_equal_reference():
    for arch in list_archs():
        jcfg, cfg = jax_get_config(arch), get_config(arch)
        for ours, theirs in (
                (specs.train_batch_specs(cfg, 4, 128),
                 jspecs.train_batch_specs(jcfg, 4, 128)),
                (specs.prefill_batch_specs(cfg, 4, 128),
                 jspecs.prefill_batch_specs(jcfg, 4, 128))):
            assert set(ours) == set(theirs), arch
            for k, v in ours.items():
                assert v.device == META
                assert _spec(v) == (tuple(theirs[k].shape),
                                    str(theirs[k].dtype)), (arch, k)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "deepseek-moe-16b",
                                  "rwkv6-1.6b", "zamba2-2.7b",
                                  "whisper-small", "internvl2-1b"])
def test_cache_template(arch):
    """decode_32k: the reference's bytes but for ``len`` (the port keeps
    one [B] length vector, the reference one a layer); at the smoke
    config the structure of the port's real prefill cache."""
    seq, batch, _ = specs.SHAPES["decode_32k"]
    ours = specs.cache_template(get_config(arch), batch, seq)
    theirs = jspecs.cache_template(jax_get_config(arch), batch, seq)

    def no_len(leaves):
        return sum(math.prod(s) * i for s, i in leaves)

    def named(tree, path=()):
        if isinstance(tree, dict):
            return [x for k, v in tree.items() for x in named(v, path + (k,))]
        return [(path, tree)]

    assert no_len([(tuple(t.shape), t.element_size())
                   for p, t in named(ours) if p[-1] != "len"]) == no_len(
        [(tuple(t.shape), np.dtype(t.dtype).itemsize)
         for p, t in named(theirs) if p[-1] != "len"])

    cfg = get_smoke_config(arch)
    api = get_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    b = to_torch(_batch(cfg, 2, 16))
    if cfg.family == "encdec":
        b["frame_embeds"] = torch.zeros(2, specs.WHISPER_FRAMES, cfg.d_model)
    max_len = 32 + (cfg.vision_tokens if cfg.family == "vlm" else 0)
    with torch.no_grad():
        real, _ = api.prefill(params, {k: v for k, v in b.items()
                                       if k in ("tokens", "frame_embeds",
                                                "patch_embeds")},
                              cfg, max_len=max_len)
    tmpl = specs.cache_template(cfg, 2, max_len)
    assert [(p, _spec(t)) for p, t in named(tmpl)] == \
        [(p, _spec(t)) for p, t in named(real)]
    if arch == "llama3.2-3b":  # the dry-run's decode cell: the template in
        with torch.no_grad():  # decode on meta
            pm, _ = specs.abstract_params(api, cfg)
            tok = torch.empty(2, dtype=torch.int32, device=META)
            cache, logits = api.decode(pm, tmpl, tok, cfg)
        assert _spec(logits) == ((2, cfg.vocab), "float32")


# ---------------------------------------------------------------------------
# the cost counter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", FAMILIES)
def test_counted_forward_flops_equal_reference(arch):
    """Each family's smoke forward: exactly the reference's HLO FLOPs."""
    cfg, api, params, tcfg, tp = build(arch=arch)
    b = _batch(cfg)
    hlo = jax.jit(lambda p, bb: api.forward(p, bb, cfg)).lower(
        params, to_jax(b)).compile().as_text()
    counted = cost.analyze(get_model(tcfg).forward, tp, to_torch(b), tcfg)
    assert counted["flops"] == hlo_cost.analyze(hlo)["flops"]
    assert counted["collective_bytes"] == 0.0
    assert counted["collective_detail"] == {}
    assert counted["bytes"] > 0 and counted["peak_bytes"] > 0


@pytest.mark.parametrize("arch", ["llama3.2-3b", "zamba2-2.7b"])
def test_counted_grad_flops_near_reference(arch):
    """A loss-and-gradient step, remat "none" on both sides: at most
    GRAD_FLOPS_TOL above the reference's HLO FLOPs, never below."""
    cfg, api, params, tcfg, tp = build(arch=arch)
    b = _batch(cfg, 2, 32)
    jcfg, tcfg = cfg.scaled(remat="none"), tcfg.scaled(remat="none")
    hlo = jax.jit(jax.grad(lambda p: api.loss(p, to_jax(b), jcfg)[0])).lower(
        params).compile().as_text()
    ref = hlo_cost.analyze(hlo)["flops"]
    got = cost.analyze(_grad_step(get_model(tcfg), tcfg), fresh(tp),
                       to_torch(b))["flops"]
    assert ref <= got <= ref * (1 + GRAD_FLOPS_TOL), (got / ref)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "rwkv6-1.6b",
                                  "zamba2-2.7b"])
def test_meta_charges_kernels_and_launches_nothing(arch):
    """A loss-and-gradient step on meta: the FLOPs outside the kernels
    equal the CPU count less the kernels' plain versions, each kernel is
    charged its formula once a forward, and no launch counter moves."""
    cfg = get_smoke_config(arch, remat="none")
    api = get_model(cfg)
    cpu_p = api.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    for t in optim.tree_leaves(cpu_p):
        t.requires_grad_(True)
    b = to_torch(_batch(cfg, 2, 32))
    step = _grad_step(api, cfg)
    on_cpu = cost.run(step, cpu_p, b)[1]
    before = _launch_counts()
    on_meta = cost.run(step, specs.abstract_params(api, cfg)[0],
                       {k: v.to(META) for k, v in b.items()})[1]
    assert _launch_counts() == before

    # the plain versions' FLOPs on the CPU, one call at the model's shapes
    B, S = 2, 32
    g = torch.Generator().manual_seed(0)
    plain = {}
    if cfg.family != "ssm":
        n_attn = (cfg.n_layers // cfg.attn_every if cfg.family == "hybrid"
                  else cfg.n_layers)
        q = torch.randn(B, S, cfg.n_heads, cfg.head_dim, generator=g)
        k = torch.randn(B, S, cfg.n_kv_heads, cfg.head_dim, generator=g)
        one = cost.analyze(fa_ref.attention_fwd_ref, q, k, k)["flops"]
        plain["flash_attention"] = (n_attn, one,
                                    kcost.flash_attention(q, k, k))
    if cfg.family == "ssm":
        from repro_torch.kernels.rwkv6 import ref as wkv_ref
        H, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
        r = torch.randn(B, S, H, hd, generator=g)
        L = min(cfg.rwkv_chunk, S)
        one = cost.analyze(wkv_ref.wkv_chunked_ref, r, r, r, -r.abs(),
                           torch.ones(H, hd), L, None)["flops"]
        plain["wkv6"] = (cfg.n_layers, one, kcost.wkv(r, L, False))
    if cfg.family == "hybrid":
        from repro_torch.kernels.mamba2 import ref as ssd_ref
        from repro_torch.models.mamba2 import ssm_dims
        _, H, N, _ = ssm_dims(cfg)
        P = cfg.ssm_head_dim
        x = torch.randn(B, S, H, P, generator=g)
        Bm = torch.randn(B, S, N, generator=g)
        L = min(cfg.ssm_chunk, S)
        one = cost.analyze(ssd_ref.ssd_chunked_ref, x, torch.rand(B, S, H),
                           -torch.ones(H), Bm, Bm, L, None)["flops"]
        plain["ssd"] = (cfg.n_layers, one, kcost.ssd(x, Bm, L, False))
    assert set(on_meta.kernels) == set(plain)
    outside = on_cpu.flops
    for name, (calls, one, (flops, nbytes)) in plain.items():
        assert on_meta.kernels[name] == [calls, calls * flops, calls * nbytes]
        outside -= calls * one
    assert on_meta.flops - sum(v[1] for v in on_meta.kernels.values()) == \
        outside


def test_meta_decode_kernels_charge_every_position():
    B, S, Hq, Hkv, D = 3, 40, 4, 2, 16
    q = torch.empty(B, 1, Hq, D, device=META)
    kv = torch.empty(B, S, Hkv, D, device=META)
    ln = torch.empty(B, dtype=torch.int32, device=META)
    store = torch.empty(9, 8, Hkv, D, device=META)
    bt = torch.empty(B, 5, dtype=torch.int32, device=META)
    before = _launch_counts()
    with cost.CostCounter() as c:
        out = da_ops.decode_attention(q, kv, kv, ln)
        out2 = da_ops.paged_decode_attention(q, store, store, bt, ln)
    assert _launch_counts() == before
    assert _spec(out) == _spec(out2) == ((B, 1, Hq, D), "float32")
    assert c.kernels["decode_attention"][1:] == list(
        kcost.decode_attention(q, kv, B * S))
    assert c.kernels["paged_decode_attention"][1:] == list(
        kcost.paged_decode_attention(q, store, bt, B * 5 * 8))
    assert kcost.decode_attention(q, kv)[0] == 4 * B * S * Hq * D


def test_linear_bytes_are_its_operands_and_output():
    x = torch.randn(4, 7, 32)
    w = torch.randn(32, 48)
    got = cost.analyze(lambda x, w: x @ w, x, w)
    assert got["bytes"] == (4 * 7 * 32 + 32 * 48 + 4 * 7 * 48) * 4
    assert got["flops"] == 2 * 4 * 7 * 32 * 48
    # in place: the target read and written once, a copy reads its source
    y = torch.randn(4, 7, 48)
    assert cost.analyze(lambda a, b: a.add_(b), y, y.clone())["bytes"] == \
        3 * y.numel() * 4
    assert cost.analyze(lambda a, b: a.copy_(b), y, y.clone())["bytes"] == \
        2 * y.numel() * 4
    assert cost.analyze(lambda a: a.reshape(-1, 4).t()[:2], x[0])[
        "bytes"] == 0  # views
    assert cost.analyze(lambda a: a.to(torch.bfloat16), x)["bytes"] == \
        x.numel() * 6


def test_peak_counts_what_is_alive():
    def fn(x):
        a = x * 2  # 4 KB alive
        b = a + 1  # 8 KB alive
        del a
        c = b * 3  # 8 KB again
        return c

    x = torch.empty(1024)  # 4 KB, the argument
    c = cost.run(fn, x)[1]
    assert c.peak == 3 * 4096
    assert c.largest[:3] == (4096, (1024,), "torch.float32")


def test_one_microbatch_charged_n_times_equals_the_step():
    cfg, _, _, tcfg, tp = build(arch="llama3.2-3b")
    api = get_model(tcfg)
    tc = TrainConfig(global_batch=4, seq_len=16, microbatches=2)
    b = to_torch(_batch(cfg, 4, 16))

    def state():
        p = fresh(tp)
        return {"params": p, "opt": optim.adamw_init(p, tc.optimizer)}

    real = cost.analyze(make_train_step(api, tcfg, tc), state(), b)
    counted = cost.analyze(dryrun.counted_train_step(api, tcfg, tc),
                           state(), b)
    assert (counted["flops"], counted["bytes"]) == (real["flops"],
                                                    real["bytes"])
    one = cost.analyze(make_train_step(api, tcfg, TrainConfig(
        global_batch=2, seq_len=16)), state(),
        {k: v[:2] for k, v in b.items()})
    assert one["flops"] < real["flops"] < 2 * one["flops"] + 1


def test_dryrun_cli_and_roofline_suite(tmp_path, monkeypatch, capsys):
    """llama3.2-3b at full width, cut to 2 layers: four records, long_500k
    skipped; then the roofline suite reads them."""
    out = tmp_path / "dryrun_torch.json"
    assert dryrun.main(["--arch", "llama3.2-3b", "--out", str(out),
                        "--override", "n_layers=2"]) == 0
    printed = capsys.readouterr().out
    assert printed.count("[dryrun] llama3.2-3b x ") == 4
    recs = {r["shape"]: r for r in json.loads(out.read_text())}
    assert set(recs) == set(specs.SHAPES)
    assert recs["long_500k"]["status"] == "skipped"
    cfg = get_config("llama3.2-3b", n_layers=2)
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        r = recs[shape]
        assert r["status"] == "ok", r
        rl, mem = r["roofline"], r["memory"]
        assert rl["t_compute_s"] == rl["flops_per_device"] / dryrun.PEAK_FLOPS
        assert rl["t_memory_s"] == rl["bytes_per_device"] / dryrun.HBM_BW
        assert rl["t_collective_s"] == 0.0
        assert rl["bottleneck"] in ("compute", "memory")
        seq, batch, kind = specs.SHAPES[shape]
        tokens = batch * (1 if kind == "decode" else seq)
        assert rl["model_flops_total"] == (
            6 if kind == "train" else 2) * cfg.active_param_count() * tokens
        assert mem["est_live_bytes"] >= mem["argument_size_in_bytes"] > 0
        assert mem["fits"] == (mem["est_live_bytes"] <= dryrun.HBM_BYTES)
    train = recs["train_4k"]
    assert train["microbatches"] == dryrun.MICROBATCHES["llama3.2-3b"]
    assert train["kernels"]["flash_attention"]["calls"] == 2 * 2 * 4
    mem = train["memory"]
    assert mem["params_bytes"] + mem["opt_bytes"] + mem["batch_bytes"] == \
        mem["argument_size_in_bytes"]
    assert mem["opt_bytes"] == 4 * mem["params_bytes"]  # bf16 -> f32 m, v
    assert recs["decode_32k"]["kernels"]["decode_attention"]["calls"] == 2
    monkeypatch.setattr(common, "RESULTS_DIR", str(tmp_path))
    rep = common.Reporter()
    assert bench_roofline.main(rep) == {"records": 3}
    names = [r[0] for r in rep.rows]
    assert names == [f"roofline_llama3.2-3b_{s}" for s in
                     ("train_4k", "prefill_32k", "decode_32k")] + [
        "roofline_summary"]
    assert "cells_ok=3 errors=0 skipped=1" in rep.rows[-1][2]


# ---------------------------------------------------------------------------
# The mesh cells: a subprocess under the ``fake`` process group (it is
# process-global, as the reference sets XLA_FLAGS before importing JAX)
# ---------------------------------------------------------------------------

MESH_SCRIPT = r"""
import json, sys, warnings
warnings.filterwarnings("ignore")
import torch
import torch.distributed as dist
from repro_torch.launch import cost, dryrun
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import fake_world, make_local_mesh
from repro_torch.models import nn

out = {"cells": []}
for arch in ("llama3.2-3b", "nemotron-4-340b"):
    for mp in (False, True):
        out["cells"].append(dryrun.run_cell(
            arch, "train_4k", overrides={"n_layers": 2}, multi_pod=mp))
for shape in ("prefill_32k", "decode_32k"):
    for mp in (False, True):
        out["cells"].append(dryrun.run_cell(
            "llama3.2-3b", shape, overrides={"n_layers": 2}, multi_pod=mp))
# the hill-climb's C pair, cut to 2 layers (16 x 16)
import contextlib
from repro_torch.launch import hillclimb
with contextlib.redirect_stdout(sys.stderr):  # (its progress lines)
    out["hillclimb"] = hillclimb.run(
        [c for c in hillclimb.CELLS if c[0].startswith("C")],
        {"n_layers": 2})
out["micro_after"] = dict(dryrun.MICROBATCHES)
# an MLP's forward on a 2 x 2 mesh, counted: its FSDP all-gathers alone
dist.destroy_process_group()
fake_world(4)
mesh = make_local_mesh(2, 2, device="cpu")
d, ff = 64, 256
values, axes = nn.split(nn.mlp_init(torch.Generator(), d, ff,
                                    device="meta"))
sh = shd.make_shardings(axes, shd.TRAIN_RULES, mesh)
p = {k: {"w": shd.place(values[k]["w"], sh[k]["w"])} for k in values}
x = shd.place(torch.empty((4, 8, d), device="meta"),
              shd.NamedSharding(mesh, ("data", None, None)))
with nn.mesh_context(mesh):
    rec = cost.analyze(lambda p, x: nn.mlp_apply(p, x), p, x)
out["mlp"] = {"collective_bytes": rec["collective_bytes"],
              "collective_detail": rec["collective_detail"],
              "specs": {k: list(sh[k]["w"].spec) for k in sh}}
json.dump(out, sys.stdout)
"""


@pytest.fixture(scope="module")
def mesh_dryrun():
    import subprocess
    import sys

    proc = subprocess.run([sys.executable, "-c", MESH_SCRIPT],
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout)


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ["llama3.2-3b", "nemotron-4-340b"])
def test_mesh_train_cells_count_per_device(mesh_dryrun, arch, multi_pod):
    """The train cell on each production mesh (cut to 2 layers): ``ok``,
    ``n_chips`` 256 / 512, per-device FLOPs below one device's share of
    the whole step's work times the TP waste bound, and collectives."""
    rec = next(r for r in mesh_dryrun["cells"] if r["arch"] == arch
               and r["shape"] == "train_4k" and r["multi_pod"] == multi_pod)
    assert rec["status"] == "ok", rec
    n = 512 if multi_pod else 256
    assert rec["n_chips"] == n == rec["n_devices"]
    assert rec["mesh"] == ({"pod": 2, "data": 16, "model": 16} if multi_pod
                           else {"data": 16, "model": 16})
    rl = rec["roofline"]
    assert rl["collective_bytes_per_device"] > 0
    assert rl["t_collective_s"] == (rl["collective_bytes_per_device"]
                                    / dryrun.LINK_BW)
    detail = rl["collective_detail"]
    assert detail["per_op_bytes"]["all-gather"] > 0  # FSDP gathers
    assert detail["per_op_bytes"]["all-reduce"] > 0
    assert 0 < rl["useful_flops_ratio"] <= 1
    assert rec["kernels"]["flash_attention"]["calls"] > 0


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_mesh_serving_cells_count_per_device(mesh_dryrun, shape, multi_pod):
    """llama3.2-3b's serving cells (cut to 2 layers) on each production
    mesh: ``ok``, ``n_chips`` 256 / 512, collectives counted; the decode
    kernel charged at its rank's shard: batch 128 over the data ranks,
    the 32768 cached positions over the 16 model ranks."""
    rec = next(r for r in mesh_dryrun["cells"] if r["shape"] == shape
               and r["multi_pod"] == multi_pod)
    assert rec["status"] == "ok", rec
    n = 512 if multi_pod else 256
    assert rec["n_chips"] == n == rec["n_devices"]
    rl = rec["roofline"]
    assert rl["collective_bytes_per_device"] > 0
    if shape == "decode_32k":
        from repro_torch.configs import get_config

        cfg = get_config("llama3.2-3b")
        b_local = 128 // (32 if multi_pod else 16)
        s_local = 32768 // 16
        per_call = (b_local * s_local * cfg.n_kv_heads * cfg.head_dim * 2
                    * cfg.cdtype.itemsize)  # K and V, each read once
        k = rec["kernels"]["decode_attention"]
        assert k["calls"] == 2  # one a layer
        assert per_call <= k["bytes"] / 2 < 1.01 * per_call
    else:  # live prefill runs chunked attention in plain ops, as repro
        assert "decode_attention" not in rec["kernels"]


def test_hillclimb_records(mesh_dryrun):
    """The hill-climb's C pair (cut to 2 layers) on the 16 x 16 mesh: the
    reference's record keys, ``dominant_s`` the largest roofline term and
    ``roofline_fraction`` the compute term over it; ``MICROBATCHES`` is
    left as it was."""
    recs = mesh_dryrun["hillclimb"]
    assert [r["label"] for r in recs] == ["C0-baseline", "C*-optimized"]
    for r in recs:
        assert {"label", "arch", "shape", "overrides", "roofline",
                "dominant_s", "roofline_fraction"} <= set(r)
        rl = r["roofline"]
        dom = max(rl["t_compute_s"], rl["t_memory_s"], rl["t_collective_s"])
        assert r["dominant_s"] == dom > 0
        assert r["roofline_fraction"] == rl["t_compute_s"] / dom
    assert recs[1]["overrides"] == {"explicit_tp": True}
    assert mesh_dryrun["micro_after"] == dryrun.MICROBATCHES


def test_hillclimb_cells_are_the_reference_cells():
    """``CELLS`` equal the reference's, read from its source (importing
    it would set ``XLA_FLAGS`` for this whole process)."""
    import ast
    import pathlib

    from repro_torch.launch import hillclimb

    src = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro" / \
        "launch" / "hillclimb.py"
    tree = ast.parse(src.read_text())
    node = next(n for n in tree.body if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "CELLS")
    assert hillclimb.CELLS == ast.literal_eval(node.value)


def test_fsdp_gathers_counted_by_hand(mesh_dryrun):
    """A gated MLP (d 64, ff 256) on a 2 x 2 mesh, x batch-sharded: up and
    gate [d, ff] are sharded (data, model) and down [ff, d] (model, data);
    each is all-gathered over "data" once, into its model shard: 3 all-
    gathers of d * ff / 2 float32 each, and nothing else moves (the down
    projection's output stays a partial sum)."""
    m = mesh_dryrun["mlp"]
    assert m["specs"] == {"up": ["data", "model"], "gate": ["data", "model"],
                          "down": ["model", "data"]}
    gathered = 3 * 64 * 256 // 2 * 4
    assert m["collective_detail"] == {"per_op_bytes": {"all-gather":
                                                       gathered},
                                      "counts": {"all-gather": 3}}
    assert m["collective_bytes"] == gathered
