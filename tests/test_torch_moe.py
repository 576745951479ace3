"""The port's mixture-of-experts FFN and MoE models against the JAX
package's, on the same weights and inputs (made with numpy from a seed):
``route`` (weights, ids and aux within 1e-6, ties included),
``_expert_compute`` and ``moe_apply`` at the training and the decode
capacity, a batch built to overflow capacity included (1e-5, which holds
only if the drop sets agree), the dropless ``moe_reference``, ``forward``
logits (1e-4), ``loss`` and every gradient leaf against ``jax.grad``
(1e-5 relative on the loss, 1e-4 on the leaves), AdamW's decay of the
first dense layers, and the paged engine's greedy transcripts and block
accounting in ``direct`` and ``gather`` decode modes, on the smoke
configs of deepseek-moe-16b and moonshot-v1-16b-a3b."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import build  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import nn as jnn  # noqa: E402
from repro.models.config import ModelConfig as JaxConfig  # noqa: E402
from repro.serving.engine import InferenceEngine as JaxEngine  # noqa: E402
from repro.training import optim as joptim  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.serving.engine import InferenceEngine  # noqa: E402
from repro_torch.training import optim as toptim  # noqa: E402

ARCHS = ("deepseek-moe-16b", "moonshot-v1-16b-a3b")


@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    return build(arch=request.param)


def _t(a):
    return torch.from_numpy(np.array(a))


def _moe_params(cfg, seed):
    """One MoE layer's reference params and the port's copy."""
    params = jax.tree.map(np.array, jnn.split(
        jmoe.moe_init(jax.random.PRNGKey(seed), cfg))[0])
    return params, jax.tree.map(_t, params)


def _pair(**kw):
    """The same MoE config in both packages."""
    cfg = JaxConfig(family="moe", vocab=64, d_model=32, n_heads=4,
                    d_ff=16, **kw)
    return cfg, ModelConfig(**dataclasses.asdict(cfg))


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ---------------------------------------------------------------------------
# route: weights, ids, aux; the tie order of jax.lax.top_k
# ---------------------------------------------------------------------------


def _route_both(w, x, cfg, tcfg):
    jw, ji, ja = jmoe.route(jnp.asarray(w), jnp.asarray(x), cfg)
    tw, ti, ta = tmoe.route(_t(w), _t(x), tcfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6, atol=1e-6)
    return ti.numpy()


@pytest.mark.parametrize("E,k", [(8, 2), (64, 6)])
def test_route_matches_reference(E, k):
    cfg, tcfg = _pair(n_experts=E, top_k=k)
    _route_both(_x((32, E), 0) / 4, _x((40, 32), 1), cfg, tcfg)


def test_route_all_tie_picks_the_lowest_ids():
    """A zero router: every expert ties, and both packages route to
    experts 0..k-1 with equal weights."""
    cfg, tcfg = _pair(n_experts=8, top_k=3)
    ids = _route_both(np.zeros((32, 8), np.float32), _x((10, 32), 2), cfg,
                      tcfg)
    assert (ids == np.arange(3)[None, :]).all()


def test_route_two_way_tie_picks_the_lower_id():
    """Experts 5 and 2 get bit-equal logits (equal router columns) and
    lead every token: the lower id comes first."""
    cfg, tcfg = _pair(n_experts=8, top_k=2)
    w = _x((32, 8), 3) / 8
    x = np.abs(_x((12, 32), 4))
    w[:, 2] = w[:, 5] = 1.0
    ids = _route_both(w, x, cfg, tcfg)
    assert (ids == np.array([2, 5])[None, :]).all()


# ---------------------------------------------------------------------------
# expert compute and moe_apply: capacity, drops, decode factor
# ---------------------------------------------------------------------------


def _apply_both(cfg, tcfg, p, tp, x, decode):
    jy, ja = jmoe.moe_apply(p, jnp.asarray(x), cfg, decode=decode)
    ty, ta = tmoe.moe_apply(tp, _t(x), tcfg, decode=decode)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6, atol=1e-6)
    return ty


def _overflowing():
    """T 16, 4 experts, top-2, capacity factor 1.0: capacity 8, and a
    router leaning on expert 1 sends it more than 8 of the 32
    assignments."""
    cfg, tcfg = _pair(n_experts=4, top_k=2, n_shared_experts=1,
                      capacity_factor=1.0)
    p, tp = _moe_params(cfg, 5)
    p["router"]["w"][:, 1] += 0.5
    tp["router"]["w"][:, 1] += 0.5
    x = np.abs(_x((2, 8, 32), 6))
    return cfg, tcfg, p, tp, x


@pytest.mark.parametrize("decode", [False, True])
def test_moe_apply_overflowing_capacity_matches_reference(decode):
    cfg, tcfg, p, tp, x = _overflowing()
    _, ids, _ = tmoe.route(tp["router"]["w"], _t(x.reshape(16, 32)), tcfg)
    counts = np.bincount(ids.numpy().ravel(), minlength=4)
    C = tmoe._capacity(16, tcfg, decode)
    assert C == (32 if decode else 8)
    assert (counts.max() > C) == (not decode)  # drops at training capacity
    ty = _apply_both(cfg, tcfg, p, tp, x, decode)
    dropless, _ = tmoe.moe_reference(tp, _t(x), tcfg)
    # the drops change the output; the decode capacity drops nothing
    assert torch.allclose(ty, dropless, rtol=1e-5, atol=1e-5) == decode


def test_expert_compute_matches_reference():
    """The dispatch alone at a capacity that drops, over a local expert
    range (the reference's expert-parallel slice)."""
    cfg, tcfg, p, tp, x = _overflowing()
    xf = x.reshape(16, 32)
    jw, ji, _ = jmoe.route(jnp.asarray(p["router"]["w"]), jnp.asarray(xf),
                           cfg)
    for offset, n_local, C in ((0, 4, 8), (2, 2, 5), (0, 4, 1)):
        kw = dict(expert_offset=offset, n_local=n_local, capacity=C)
        sl = slice(offset, offset + n_local)
        jy = jmoe._expert_compute(
            jnp.asarray(xf), jw, ji, jnp.asarray(p["up"][sl]),
            jnp.asarray(p["gate"][sl]), jnp.asarray(p["down"][sl]), cfg=cfg,
            **kw)
        ty = tmoe._expert_compute(
            _t(xf), _t(jw), _t(ji), tp["up"][sl], tp["gate"][sl],
            tp["down"][sl], cfg=tcfg, **kw)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("decode", [False, True])
def test_moe_apply_on_the_smoke_layer_matches_reference(lm, decode):
    cfg, _, params, tcfg, tp = lm
    p = jax.tree.map(lambda a: a[0], params["blocks"]["moe"])
    x = _x((3, 7, cfg.d_model), 7)
    _apply_both(cfg, tcfg, p, tp["blocks"][cfg.first_dense_layers]["moe"],
                x, decode)


def test_moe_reference_matches_reference(lm):
    cfg, _, params, tcfg, tp = lm
    p = jax.tree.map(lambda a: a[0], params["blocks"]["moe"])
    x = _x((2, 5, cfg.d_model), 8)
    jy, ja = jmoe.moe_reference(p, jnp.asarray(x), cfg)
    ty, ta = tmoe.moe_reference(tp["blocks"][1]["moe"], _t(x), tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)


# ---------------------------------------------------------------------------
# the model: forward, loss and gradients, AdamW's decay
# ---------------------------------------------------------------------------


def _batch(vocab, B, S, seed):
    tokens = np.random.RandomState(seed).randint(0, vocab, size=(B, S + 1))
    tokens = tokens.astype(np.int32)
    return {"tokens": tokens[:, :-1], "targets": tokens[:, 1:],
            "loss_mask": np.ones((B, S), np.float32)}


def _per_layer(tree, cfg):
    """Reference tree -> {port path: ndarray}: ``pre/layer_i`` to block i,
    stacked block j to block ``first_dense_layers + j``."""
    out = {}
    n_pre = cfg.first_dense_layers

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif path[0] == "pre":
            out[("blocks", int(path[1].split("_")[1])) + path[2:]] = \
                np.asarray(t, np.float32)
        elif path[0] == "blocks":
            for j in range(cfg.n_layers - n_pre):
                out[("blocks", n_pre + j) + path[1:]] = np.asarray(
                    t[j], np.float32)
        else:
            out[path] = np.asarray(t, np.float32)

    walk(tree, ())
    return out


def _assert_tree_close(ref_tree, cfg, ttree, tol):
    want = _per_layer(ref_tree, cfg)
    got = dict(toptim.named_leaves(ttree))
    assert set(got) == set(want)
    for path, t in got.items():
        np.testing.assert_allclose(t.detach().float().numpy(), want[path],
                                   rtol=tol, atol=tol, err_msg=str(path))


def test_get_model_serves_the_moe_family(lm):
    """The dense API with chunked extend and paged decode; layer 0 dense
    (``dense_ff``), the rest MoE; the router stays float32."""
    cfg, _, _, tcfg, tp = lm
    api = get_model(tcfg)
    assert api.extend is not None and api.decode_paged is not None
    assert ["moe" in b for b in tp["blocks"]] == [False, True, True]
    assert tp["blocks"][0]["mlp"]["up"]["w"].shape[1] == cfg.dense_ff
    p = api.init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert set(p["blocks"][1]) == set(tp["blocks"][1])
    assert {k: tuple(v.shape) for k, v in p["blocks"][1]["moe"].items()
            if k != "router" and k != "shared"} == \
        {k: tuple(v.shape) for k, v in tp["blocks"][1]["moe"].items()
         if k != "router" and k != "shared"}
    bf16 = tcfg.scaled(param_dtype="bfloat16", compute_dtype="bfloat16")
    p = api.init(torch.Generator().manual_seed(0), bf16, device="cpu")
    assert p["blocks"][1]["moe"]["router"]["w"].dtype == torch.float32
    assert p["blocks"][1]["moe"]["up"].dtype == torch.bfloat16


def test_bridge_names_the_item_of_groups_it_does_not_take():
    """The bridge takes every family's groups; an encoder-decoder's tree
    (``enc_blocks``, ``enc_ln_f``, ``pos_embed`` and the decoder blocks'
    ``ln_cross``/``cross`` beside the dense groups) converts leaf by leaf,
    stacked layers unstacked.  A group no family has still raises."""
    from repro.configs import get_smoke_config
    from repro.models import get_model as jax_get_model
    from repro_torch.models.convert import params_from_numpy

    cfg = get_smoke_config("whisper-small")
    tree = jax.tree.map(np.asarray, jnn.split(jax_get_model(cfg).init(
        jax.random.PRNGKey(0), cfg))[0])
    tcfg = ModelConfig(**dataclasses.asdict(cfg))
    got = dict(toptim.named_leaves(params_from_numpy(tree, tcfg, "cpu")))
    want = {}
    for path, a in toptim.named_leaves(tree):
        if path[0] in ("blocks", "enc_blocks"):
            want.update({(path[0], i) + path[1:]: a[i]
                         for i in range(a.shape[0])})
        else:
            want[path] = a
    assert set(got) == set(want)
    assert {("enc_ln_f", "scale"), ("pos_embed", "table"),
            ("blocks", 1, "cross", "o", "w"),
            ("enc_blocks", 1, "attn", "q", "w")} <= set(got)
    for path, t in got.items():
        np.testing.assert_array_equal(t.numpy(), want[path], str(path))
    with pytest.raises(ValueError, match="not part of"):
        params_from_numpy(dict(tree, extra={}), tcfg, "cpu")


def test_forward_matches_reference(lm):
    cfg, api, params, tcfg, tp = lm
    batch = _batch(cfg.vocab, 2, 24, seed=0)
    jl, ja = api.forward(params, {"tokens": jnp.asarray(batch["tokens"])},
                         cfg)
    tl, ta = get_model(tcfg).forward(tp, {"tokens": _t(batch["tokens"])},
                                     tcfg)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)
    assert float(ta) > 0


def test_loss_and_gradients_match_reference(lm):
    cfg, api, params, tcfg, tp = lm
    batch = _batch(cfg.vocab, 2, 16, seed=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: api.loss(p, jb, cfg), has_aux=True)(params)
    tp = toptim.tree_map(lambda t: t.detach().clone().requires_grad_(True),
                         tp)
    leaves = toptim.tree_leaves(tp)
    tloss, tm = get_model(tcfg).loss(tp, {k: _t(v) for k, v in
                                          batch.items()}, tcfg)
    grads = torch.autograd.grad(tloss, leaves)
    for got, want in ((tloss, jloss), (tm["ce"], jm["ce"]),
                      (tm["aux"], jm["aux"])):
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=1e-5)
    _assert_tree_close(jgrads, cfg, toptim.tree_unflatten(tp, grads), 1e-4)


def test_adamw_decays_the_dense_layers_by_rank(lm):
    """The reference keeps the first dense layers unstacked (``pre``), so
    their [d] scales are not decayed while every stacked MoE block leaf
    is; one update from zero gradients matches it leaf by leaf."""
    cfg, _, params, tcfg, tp = lm
    opt = joptim.OptimizerConfig(lr=0.1, weight_decay=0.5, warmup_steps=1)
    zeros = jax.tree.map(jnp.zeros_like, params)
    jnew, _, _ = joptim.adamw_update(zeros, joptim.adamw_init(params, opt),
                                     params, opt)
    topt = toptim.OptimizerConfig(**vars(opt))
    tparams = toptim.tree_map(lambda t: t.detach().clone(), tp)
    toptim.adamw_update(toptim.tree_map(torch.zeros_like, tparams),
                        toptim.adamw_init(tparams, topt), tparams, topt)
    _assert_tree_close(jnew, cfg, tparams, 1e-6)
    assert bool((tparams["blocks"][0]["ln_attn"]["scale"] == 1).all())
    assert bool((tparams["blocks"][1]["ln_attn"]["scale"] < 1).all())


# ---------------------------------------------------------------------------
# the paged engine on the MoE smoke configs, both decode modes
# ---------------------------------------------------------------------------

ENGINE_KW = dict(max_num_seqs=4, max_num_batched_tokens=256, max_len=64,
                 prefill_buckets=(16, 32), seed=0, paged=True, block_size=8)
COUNTERS = ("prefill_tokens", "decode_tokens", "decode_steps", "cow_copies",
            "prefix_reuse_hits", "prefix_cached_tokens", "peak_running",
            "free_blocks", "reserved_blocks")
# tests/test_paged_serving.py: mixed lengths across chunk and block edges,
# and ragged lengths at the block edges 7/8/9 and 15/16/17
PROMPTS = {"mixed": (1, (3, 8, 9, 17, 30)),
           "block_edges": (7, (7, 8, 9, 15, 16, 17))}


def _drive(eng, prompts, new_tokens):
    uids = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
    done = eng.run()
    return [done[u].output for u in uids]


@pytest.mark.parametrize("mode", ["direct", "gather"])
@pytest.mark.parametrize("scenario", sorted(PROMPTS))
def test_paged_engine_matches_reference(lm, scenario, mode):
    cfg, _, params, tcfg, tp = lm
    seed, lens = PROMPTS[scenario]
    rng = np.random.RandomState(seed)
    prompts = [list(rng.randint(1, cfg.vocab, size=n)) for n in lens]
    ref = JaxEngine(cfg, params, paged_decode_mode=mode, **ENGINE_KW)
    eng = InferenceEngine(tcfg, tp, device="cpu", paged_decode_mode=mode,
                          **ENGINE_KW)
    assert _drive(eng, prompts, 6) == _drive(ref, prompts, 6)
    for name in COUNTERS:
        if name == "decode_steps":  # counted by the port only
            assert eng.stats.decode_steps > 0
            continue
        assert getattr(eng.stats, name) == getattr(ref.stats, name), name
    assert eng.block_telemetry() == ref.block_telemetry()
    assert eng.pool.alloc._ref == ref.pool.alloc._ref
