"""The port's sharded train step against the JAX package's unsharded one.

Four gloo processes on the CPU (one spawn for the module;
``tests/_torch_mesh_ranks.py``) run every case: a smoke config of each
family on a 2 x 2 ``("data", "model")`` mesh (llama3.2-3b also on 1 x 4,
where its 6 heads do not divide the model axis and attention takes the
reference's fallback), the state placed by ``TRAIN_RULES``, with 1 and 2
microbatches and ``explicit_tp`` (with ``fsdp_params`` and
``seq_shard_activations``) off and on.  Each is held against
``repro.training.train.make_train_step`` without a mesh on the same
weights and batches: the first batch's loss (1e-5 relative) and every
gradient leaf (gathered; 1e-4), then the parameters after 1-2 AdamW steps
(rtol 2e-3, atol 2e-5: the tolerances of ``tests/test_torch_training.py``)
and each step's loss.  AdamW runs with eps 1e-6 (see ``OPT``); one case keeps
its moments in 8 bits, held to the reference's codes and scales.

deepseek-moe-16b runs expert-parallel (its experts split over "model",
each rank's capacity from its data shard's tokens).  Capacity per shard
changes which tokens drop, so its steps run at a capacity factor of
``n_experts / top_k``, where no shard can drop a token (asserted); the
EP layer at the config's own capacity factor, drops included, equals the
sum over data shards and model offsets of the reference's
``_expert_compute`` (the drops asserted too).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_mesh_ranks as ranks  # noqa: E402
from repro.configs import get_smoke_config  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import nn as jnn  # noqa: E402
from repro.training import optim as joptim  # noqa: E402
from repro.training import train as jtrain  # noqa: E402

TOL = 1e-4
B, S = 4, 16
TP = dict(explicit_tp=True, fsdp_params=True, seq_shard_activations=True)
MOE = "deepseek-moe-16b"


def _nodrop(arch):
    c = get_smoke_config(arch)
    return dict(capacity_factor=c.n_experts / c.top_k)


# (id, arch, mesh, microbatches, cfg overrides, steps)
CASES = [
    ("rhapsody-2x2-mb1", "rhapsody-demo", (2, 2), 1, {}, 2),
    ("rhapsody-2x2-mb2-tp", "rhapsody-demo", (2, 2), 2, TP, 2),
    ("llama-2x2-mb1-tp", "llama3.2-3b", (2, 2), 1, TP, 1),
    ("llama-1x4-mb2-tp", "llama3.2-3b", (1, 4), 2, TP, 1),
    ("deepseek-2x2-mb1", MOE, (2, 2), 1, _nodrop(MOE), 1),
    ("deepseek-2x2-mb2-tp", MOE, (2, 2), 2, dict(_nodrop(MOE), **TP), 1),
    ("whisper-2x2-mb1", "whisper-small", (2, 2), 1, {}, 1),
    ("whisper-2x2-mb2-tp", "whisper-small", (2, 2), 2, TP, 1),
    ("internvl-2x2-mb2", "internvl2-1b", (2, 2), 2, {}, 1),
    ("internvl-2x2-mb1-tp", "internvl2-1b", (2, 2), 1, TP, 1),
    ("rwkv6-2x2-mb1", "rwkv6-1.6b", (2, 2), 1, {}, 2),
    ("rwkv6-2x2-mb2-tp", "rwkv6-1.6b", (2, 2), 2, TP, 1),
    ("zamba2-2x2-mb1", "zamba2-2.7b", (2, 2), 1, {}, 1),
    ("zamba2-2x2-mb2-tp", "zamba2-2.7b", (2, 2), 2, TP, 1),
    ("rhapsody-2x2-mb1-q8", "rhapsody-demo", (2, 2), 1, {}, 1),
]
Q8 = {"rhapsody-2x2-mb1-q8"}
# test_torch_training's schedule.  eps 1e-6: AdamW's first update is
# g / (|g| + eps) elementwise, so an element whose gradient is near 0 moves
# by up to lr / 2 on a gradient difference of eps; the shards sum the
# gradients in another order than one device (differences ~4e-9 here), and
# eps 1e-8 would let such an element differ by ~lr / 3 (one device differs
# from the reference so too, by less); eps 1e-6 bounds it below 2e-5
OPT = dict(lr=1e-3, warmup_steps=1, decay_steps=10, eps=1e-6)


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    out = {"tokens": tokens, "targets": np.roll(tokens, -1, axis=1),
           "loss_mask": np.ones((B, S), np.float32)}
    if cfg.family == "encdec":
        out["frame_embeds"] = (rng.standard_normal((B, S, cfg.d_model))
                               * 0.02).astype(np.float32)
    if cfg.family == "vlm":
        n = cfg.vision_tokens or 16
        out["patch_embeds"] = (rng.standard_normal((B, n, cfg.d_model))
                               * 0.02).astype(np.float32)
    return out


def _port_layout(tree, cfg):
    """A reference tree -> {port path: ndarray}."""
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.training import optim

    tcfg = ModelConfig(**dataclasses.asdict(cfg))
    return {p: t.float().numpy() for p, t in optim.named_leaves(
        params_from_numpy(jax.tree.map(np.asarray, tree), tcfg, "cpu"))}


def _port_layout_raw(tree, cfg):
    """As ``_port_layout``, each leaf keeping its dtype (8-bit codes)."""
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.training import optim

    tcfg = ModelConfig(**dataclasses.asdict(cfg))
    return {p: t.numpy() for p, t in optim.named_leaves(
        params_from_numpy(jax.tree.map(np.asarray, tree), tcfg, "cpu"))}


def _payload(case):
    """(cfg, the reference's params, the ranks' payload) of a case: the
    weights and batches, nothing compiled."""
    cid, arch, mesh, micro, over, steps = case
    cfg = get_smoke_config(arch).scaled(**over)
    params, _ = jnn.split(jax_get_model(cfg).init(jax.random.PRNGKey(0), cfg))
    optk = dict(OPT, quantize_states=cid in Q8)
    payload = {"id": cid, "kind": "step", "cfg": dataclasses.asdict(cfg),
               "mesh": mesh, "microbatches": micro, "opt": optk,
               "weights": jax.tree.map(np.asarray, params),
               "batches": [_batch(cfg, 10 + i) for i in range(steps)]}
    return cfg, params, payload


def _first_grads(cfg, params, batch, cache):
    """The reference's loss and gradient on ``batch``.  Without a mesh the
    TP flags change nothing (``test_torch_mesh`` holds the reference's own
    test of that), so the cases of one family share one computation."""
    plain = cfg.scaled(**{k: False for k in TP})
    key = (plain.name, repr(plain))
    if key not in cache:
        api = jax_get_model(plain)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        cache[key] = jax.jit(jax.value_and_grad(
            lambda p, b: api.loss(p, b, plain), has_aux=True))(params, jb)
    return cache[key]


def _reference(case, cfg, params, payload, cache):
    """The reference's loss and gradient on the first batch and its
    unsharded steps, in the port's layout."""
    cid, micro = case[0], case[3]
    api = jax_get_model(cfg)
    batches = payload["batches"]
    (loss0, _), grads = _first_grads(cfg, params, batches[0], cache)
    opt = joptim.OptimizerConfig(**payload["opt"])
    tc = jtrain.TrainConfig(global_batch=B, seq_len=S, microbatches=micro,
                            optimizer=opt)
    state = {"params": jax.tree.map(jnp.array, params),
             "opt": joptim.adamw_init(params, opt)}
    step = jtrain.make_train_step(api, cfg, tc)
    losses = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    ref = {"loss0": float(loss0), "grads": _port_layout(grads, cfg),
           "params": _port_layout(state["params"], cfg), "losses": losses}
    if cid in Q8:
        ref["moments"] = _port_layout_raw(state["opt"]["moments"], cfg)
    return ref


# ---------------------------------------------------------------------------
# EP with drops: one MoE layer against the reference's per-shard compute
# ---------------------------------------------------------------------------


def _moe_case():
    cfg = get_smoke_config(MOE)
    p, _ = jnn.split(jmoe.moe_init(jax.random.PRNGKey(3), cfg))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, 8, cfg.d_model)).astype(np.float32)
    # reference: each data shard routes its tokens; each model rank runs its
    # experts at the shard's capacity; the model ranks' outputs are summed
    dp, mp = 2, 2
    n_local = cfg.n_experts // mp
    ys, drops = [], 0
    for s in range(dp):
        xs = jnp.asarray(x[s * B // dp:(s + 1) * B // dp]).reshape(
            -1, cfg.d_model)
        tw, ti, _ = jmoe.route(p["router"]["w"], xs, cfg)
        cap = jmoe._capacity(xs.shape[0], cfg, False)
        counts = np.bincount(np.asarray(ti).reshape(-1),
                             minlength=cfg.n_experts)
        drops += int(np.maximum(counts - cap, 0).sum())
        y = sum(jmoe._expert_compute(
            xs, tw, ti, p["up"][j * n_local:(j + 1) * n_local],
            p.get("gate")[j * n_local:(j + 1) * n_local]
            if "gate" in p else None,
            p["down"][j * n_local:(j + 1) * n_local],
            expert_offset=j * n_local, n_local=n_local, capacity=cap,
            cfg=cfg) for j in range(mp))
        ys.append(np.asarray(y))
    y = np.concatenate(ys).reshape(x.shape)
    if "shared" in p:
        y = y + np.asarray(jnn.mlp_apply(p["shared"], jnp.asarray(x),
                                         activation=cfg.activation,
                                         compute_dtype=cfg.cdtype))
    payload = {"id": "moe-ep-drops", "kind": "moe",
               "cfg": dataclasses.asdict(cfg),
               "moe": jax.tree.map(np.asarray, p), "x": x}
    return y, drops, payload


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks run every case while this process computes the
    reference's side."""
    import threading

    built = [(case, *_payload(case)) for case in CASES]
    y, drops, moe_payload = _moe_case()
    payloads = [b[3] for b in built] + [moe_payload]
    got = {}
    ranks_run = threading.Thread(target=lambda: got.update(ranks.spawn(
        "train_steps", {"cases": payloads},
        str(tmp_path_factory.mktemp("sharded")))))
    ranks_run.start()
    cache = {}
    refs = {case[0]: (cfg, _reference(case, cfg, params, payload, cache))
            for case, cfg, params, payload in built}
    ranks_run.join()
    assert got, "the ranks returned nothing"
    return refs, (y, drops), got


def _ok(got, cid):
    r = got[cid]
    assert "error" not in r, r.get("error")
    return r


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_sharded_step_equals_reference(runs, case):
    refs, _, got = runs
    cfg, ref = refs[case[0]]
    r = _ok(got, case[0])
    np.testing.assert_allclose(r["loss0"], ref["loss0"], rtol=1e-5)
    assert set(r["grads"]) == set(ref["grads"])
    for path, g in r["grads"].items():
        np.testing.assert_allclose(g, ref["grads"][path], rtol=TOL, atol=TOL,
                                   err_msg=str(path))
    np.testing.assert_allclose([m["loss"] for m in r["metrics"]],
                               ref["losses"], rtol=1e-5)
    for path, p in r["params"].items():
        np.testing.assert_allclose(p, ref["params"][path], rtol=2e-3,
                                   atol=2e-5, err_msg=str(path))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_state_is_sharded_by_the_train_rules(runs, case):
    """The embedding table is sharded on its embed dim over "model" and the
    unembedding (or tied table) over both axes where they divide: the
    rules reached the placements."""
    _, _, got = runs
    r = _ok(got, case[0])
    pl = r["placements"]
    mesh = case[2]
    model_axis = ("Shard", 1)
    assert pl[("embed", "table")][1] == model_axis
    if ("unembed", "w") in pl and mesh[0] > 1:
        assert pl[("unembed", "w")] == [("Shard", 0), ("Shard", 1)]


def test_moe_steps_drop_nothing():
    """The EP step cases run where no shard can drop: capacity of each
    data shard's tokens at factor n_experts / top_k is >= its tokens."""
    c = get_smoke_config(MOE).scaled(**_nodrop(MOE))
    t_local = B * S // 2 // 2  # two microbatches, two data shards
    cap = math.ceil(t_local * c.top_k / c.n_experts * c.capacity_factor)
    assert cap >= t_local


def test_ep_layer_with_drops_equals_reference_per_shard(runs):
    _, (y, drops), got = runs
    r = _ok(got, "moe-ep-drops")
    assert drops > 0  # the case exercises dropped tokens
    np.testing.assert_allclose(r["y"], y, rtol=TOL, atol=TOL)


def test_q8_moments_equal_reference(runs):
    """The 8-bit moments after a sharded step, gathered: every scale within
    1e-5 of the reference's, the codes equal but for rounding ties (at
    most 0.1 % of a leaf's codes, by one).  The case holds leaves whose
    shards split a quantization row (``split_blocks``: scales reduced
    over the shards) beside leaves quantized shard by shard."""
    refs, _, got = runs
    cid = next(iter(Q8))
    r = _ok(got, cid)
    want = refs[cid][1]["moments"]
    assert set(r["moments"]) == set(want)
    assert r["split_blocks"] and len(r["split_blocks"]) < len(r["params"])
    for path, a in r["moments"].items():
        b = want[path]
        if path[-1] in ("ms", "vs"):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-12,
                                       err_msg=str(path))
        else:
            d = np.abs(a.astype(np.int32) - b.astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() <= 1e-3, path
