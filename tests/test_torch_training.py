"""The port's dense training path against the JAX package's on the same
weights and batches: ``forward`` logits (against the reference under
``attention_impl="auto"`` and ``"pallas"`` in interpret mode, 1e-4), every
gradient leaf of ``loss_fn`` (stacked reference leaves mapped to per-layer
ones, 1e-4), and 1 and 3 ``make_train_step`` steps, plain and with 8-bit
moments, with 1 and 4 microbatches (parameters within rtol 2e-3, atol
2e-5, the reference's own step tolerance; loss, grad norm and lr within
1e-5 relative).  With 8-bit moments, steps 2 and 3 start from the
reference's state (teacher forcing): where a stored ``v`` code is 0 and
the ``m`` code is not, the update is ``m / sqrt(g^2 / 20)``-like and
amplifies float32 gradient differences by orders of magnitude, so there
at most 0.1 % of the elements may differ (see ``_assert_q8_close``).
Then the optimizer's decay rule and schedule, the data pipeline,
checkpoints, remat (full and dots equal to none; dots against the
reference's dots, 1e-4) and the launcher on the CPU.  Inputs are made
with numpy from a seed."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import build  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.substrate import data as jdata  # noqa: E402
from repro.training import optim as joptim  # noqa: E402
from repro.training import train as jtrain  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import get_model, make_batch  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.substrate import data as tdata  # noqa: E402
from repro_torch.training import optim as toptim  # noqa: E402
from repro_torch.training.checkpoint import Checkpointer  # noqa: E402
from repro_torch.training.train import (TrainConfig,  # noqa: E402
                                        make_train_step, train_loop)

TOL = 1e-4


@pytest.fixture(scope="module")
def lm():
    return build()


def _batch(vocab, B, S, seed):
    tokens = np.random.RandomState(seed).randint(0, vocab, size=(B, S + 1))
    tokens = tokens.astype(np.int32)
    return {"tokens": tokens[:, :-1], "targets": tokens[:, 1:],
            "loss_mask": np.ones((B, S), np.float32)}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _fresh(tparams):
    """A copy of the port's parameters that a step may update in place."""
    return toptim.tree_map(lambda t: t.detach().clone().requires_grad_(True),
                           tparams)


def _per_layer(tree, L, dtype=np.float32):
    """Reference tree -> {port path: ndarray}, stacked block leaves split
    into per-layer ones (``dtype=None`` keeps each leaf's dtype)."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif path[0] == "blocks":
            for i in range(L):
                out[("blocks", i) + path[1:]] = np.asarray(t[i], dtype)
        else:
            out[path] = np.asarray(t, dtype)

    walk(tree, ())
    return out


def _assert_tree_close(ref_tree, tparams, L, rtol, atol):
    want = _per_layer(ref_tree, L)
    got = dict(toptim.named_leaves(tparams))
    assert set(got) == set(want)
    for path, t in got.items():
        np.testing.assert_allclose(t.detach().float().numpy(), want[path],
                                   rtol=rtol, atol=atol, err_msg=str(path))


def _assert_q8_close(jparams, moments_before, tparams, L):
    """Parameters within the step tolerance, except that elements whose
    incoming ``v`` code is 0 under a non-zero ``m`` code (ill-conditioned
    updates) may miss it at no more than 0.1 % of their count."""
    want = _per_layer(jparams, L)
    missed = ill_total = 0
    for path, t in toptim.named_leaves(tparams):
        got = t.detach().numpy()
        bad = np.abs(got - want[path]) > 2e-5 + 2e-3 * np.abs(want[path])
        ill = ((moments_before[path + ("vq",)] == 0)
               & (moments_before[path + ("mq",)] != 0))
        assert not (bad & ~ill).any(), path
        missed += int((bad & ill).sum())
        ill_total += int(ill.sum())
    assert missed <= 1e-3 * ill_total, (missed, ill_total)


def _load_reference_state(jstate, tstate, L):
    """Overwrite the port's train state with the reference's."""
    params = _per_layer(jstate["params"], L)
    with torch.no_grad():
        for path, t in toptim.named_leaves(tstate["params"]):
            t.copy_(torch.from_numpy(np.array(params[path])))
    moments = _per_layer(jstate["opt"]["moments"], L, dtype=None)
    for path, _ in toptim.named_leaves(tstate["opt"]["moments"]):
        parent = toptim._moment_dict(tstate["opt"]["moments"], path[:-1])
        parent[path[-1]] = torch.from_numpy(np.array(moments[path]))
    tstate["opt"]["step"] = torch.tensor(int(jstate["opt"]["step"]),
                                         dtype=torch.int32)


def _rel(a, b, tol=1e-5):
    assert abs(float(a) - float(b)) <= tol * max(abs(float(b)), 1e-30), \
        (float(a), float(b))


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_forward_matches_reference(lm, impl):
    cfg, _, params, tcfg, tp = lm
    jcfg = cfg.scaled(attention_impl=impl)
    batch = _batch(cfg.vocab, 2, 32, seed=0)
    jl, jaux = jax.jit(lambda p, b: jax_get_model(jcfg).forward(p, b, jcfg))(
        params, _jax(batch))
    tl, taux = get_model(tcfg).forward(tp, _torch(batch), tcfg)
    assert tuple(tl.shape) == (2, 32, cfg.vocab)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)
    assert float(taux) == float(jaux) == 0.0


def test_gradients_match_reference(lm):
    cfg, api, params, tcfg, tp = lm
    batch = _batch(cfg.vocab, 2, 32, seed=1)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: api.loss(p, _jax(batch), cfg), has_aux=True))(params)
    tp = _fresh(tp)
    leaves = toptim.tree_leaves(tp)
    tloss, tm = get_model(tcfg).loss(tp, _torch(batch), tcfg)
    grads = torch.autograd.grad(tloss, leaves)
    tloss = tloss.detach()
    _rel(tloss, jloss)
    _rel(tm["ce"].detach(), jm["ce"])
    assert float(tm["tokens"]) == float(jm["tokens"]) == 64
    _assert_tree_close(jgrads, toptim.tree_unflatten(tp, grads),
                       cfg.n_layers, TOL, TOL)


@pytest.mark.parametrize("quantize", [False, True], ids=["plain", "q8"])
@pytest.mark.parametrize("n_micro", [1, 4])
def test_train_steps_match_reference(lm, quantize, n_micro):
    """Steps 1 and 3 of both packages' steps on the same weights and
    batches."""
    cfg, api, params, tcfg, tp = lm
    opt = joptim.OptimizerConfig(lr=1e-3, warmup_steps=1, decay_steps=10,
                                 quantize_states=quantize)
    jstate = {"params": params, "opt": joptim.adamw_init(params, opt)}
    jstep = jtrain.make_train_step(
        api, cfg, jtrain.TrainConfig(microbatches=n_micro, optimizer=opt),
        donate=False)
    topt = toptim.OptimizerConfig(**vars(opt))
    tparams = _fresh(tp)
    tstate = {"params": tparams, "opt": toptim.adamw_init(tparams, topt)}
    tstep = make_train_step(get_model(tcfg), tcfg,
                            TrainConfig(microbatches=n_micro, optimizer=topt))
    for i in range(3):
        batch = _batch(cfg.vocab, 4, 16, seed=10 + i)
        if quantize and i:
            _load_reference_state(jstate, tstate, cfg.n_layers)
        before = _per_layer(jstate["opt"]["moments"], cfg.n_layers,
                            dtype=None)
        jstate, jm = jstep(jstate, _jax(batch))
        tstate, tm = tstep(tstate, _torch(batch))
        for key in ("loss", "grad_norm", "lr", "ce"):
            _rel(tm[key], jm[key])
        if quantize:
            _assert_q8_close(jstate["params"], before, tstate["params"],
                             cfg.n_layers)
        elif i in (0, 2):
            _assert_tree_close(jstate["params"], tstate["params"],
                               cfg.n_layers, 2e-3, 2e-5)
        if quantize:  # stored codes differ by one, at rounding ties only
            want = _per_layer(jstate["opt"]["moments"], cfg.n_layers)
            flips = total = 0
            for path, t in toptim.named_leaves(tstate["opt"]["moments"]):
                if path[-1] in ("mq", "vq"):
                    d = np.abs(t.numpy().astype(np.float32) - want[path])
                    assert d.max() <= 1, path
                    flips, total = flips + int((d > 0).sum()), total + d.size
            assert flips <= 1e-3 * total, (flips, total)
    assert int(tstate["opt"]["step"]) == int(jstate["opt"]["step"]) == 3


def test_block_rmsnorm_scales_are_decayed(lm):
    """The reference stacks block leaves to [L, d], so ``ndim >= 2`` decays
    every block leaf; the port decays its per-layer [d] scales too, and
    leaves the top-level [d] ``ln_f`` scale alone."""
    cfg, _, params, tcfg, tp = lm
    opt = joptim.OptimizerConfig(lr=0.1, weight_decay=0.5, warmup_steps=1)
    zeros = jax.tree.map(jnp.zeros_like, params)
    jnew, _, _ = jax.jit(lambda g, s, p: joptim.adamw_update(g, s, p, opt))(
        zeros, joptim.adamw_init(params, opt), params)
    topt = toptim.OptimizerConfig(**vars(opt))
    tparams = _fresh(tp)
    tzeros = toptim.tree_map(torch.zeros_like, tparams)
    toptim.adamw_update(tzeros, toptim.adamw_init(tparams, topt), tparams,
                        topt)
    _assert_tree_close(jnew, tparams, cfg.n_layers, 1e-6, 1e-7)
    for layer in tparams["blocks"]:
        torch.testing.assert_close(layer["ln_attn"]["scale"].detach(),
                                   torch.full((cfg.d_model,), 1 - 0.1 * 0.5))
    assert bool((tparams["ln_f"]["scale"] == 1).all())


def test_lr_schedule_matches_reference():
    cfg = toptim.OptimizerConfig(lr=1.0, warmup_steps=10, decay_steps=100,
                                 min_lr_ratio=0.1)
    jcfg = joptim.OptimizerConfig(**vars(cfg))
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 1000):
        _rel(toptim.lr_at(step, cfg), joptim.lr_at(jnp.asarray(step), jcfg),
             1e-6)
    assert toptim.lr_at(0, cfg) < 0.2
    assert toptim.lr_at(1000, cfg) == pytest.approx(0.1, abs=0.01)


def test_data_pipeline_tokens_equal_reference_and_resume():
    cfg = dict(vocab=512, seq_len=32, global_batch=4, seed=7)
    ref = jdata.DataPipeline(jdata.DataConfig(**cfg))
    mine = tdata.DataPipeline(tdata.DataConfig(**cfg), device="cpu")
    np.testing.assert_array_equal(mine.corpus.tokens, ref.corpus.tokens)
    for _ in range(3):
        a, b = mine.next_batch(), ref.next_batch()
        for key in ("tokens", "targets", "loss_mask"):
            np.testing.assert_array_equal(a[key].numpy(), np.asarray(b[key]))
    shard = tdata.DataPipeline(tdata.DataConfig(**cfg, dp_size=2, dp_rank=1),
                               device="cpu")
    np.testing.assert_array_equal(
        shard.next_batch()["tokens"].numpy(),
        np.asarray(jdata.DataPipeline(jdata.DataConfig(
            **cfg, dp_size=2, dp_rank=1)).next_batch()["tokens"]))
    saved = mine.state()
    want = mine.next_batch()["tokens"]
    again = tdata.DataPipeline(tdata.DataConfig(**cfg), device="cpu")
    again.restore(saved)
    assert torch.equal(again.next_batch()["tokens"], want)
    with pytest.raises(ValueError, match="seed"):
        again.restore({"step": 1, "seed": 8})


def test_checkpoint_round_trip_gc_and_corrupt_skip(tmp_path):
    state = {"params": {"w": torch.randn(3, 4, dtype=torch.bfloat16),
                        "blocks": [{"s": torch.ones(4)}]},
             "opt": {"step": torch.tensor(7, dtype=torch.int32)},
             "data": {"step": 5, "seed": 0}}
    ck = Checkpointer(str(tmp_path), keep=2)
    for step in (10, 20, 30):
        ck.save(state, step)
    assert ck.steps() == [20, 30]  # keep=2 collected step 10
    restored, step = ck.restore_latest(state)
    assert step == 30
    assert restored["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(restored["params"]["w"], state["params"]["w"])
    assert torch.equal(restored["params"]["blocks"][0]["s"], torch.ones(4))
    assert restored["opt"]["step"].dtype == torch.int32
    assert int(restored["opt"]["step"]) == 7
    assert int(restored["data"]["step"]) == 5
    with open(os.path.join(tmp_path, "step_00000030.npz"), "r+b") as f:
        f.seek(10)
        f.write(b"\xde\xad\xbe\xef")
    assert not ck.is_valid(30)
    _, step = ck.restore_latest(state)
    assert step == 20  # fell back to the last valid checkpoint


def test_remat_full_equals_none(lm):
    cfg, _, _, tcfg, tp = lm
    batch = _torch(_batch(cfg.vocab, 2, 32, seed=2))
    out = {}
    for remat in ("full", "none"):
        c = ModelConfig(**{**vars(tcfg), "remat": remat})
        p = _fresh(tp)
        loss, _ = get_model(c).loss(p, batch, c)
        out[remat] = (loss, torch.autograd.grad(loss,
                                                toptim.tree_leaves(p)))
    torch.testing.assert_close(out["full"][0], out["none"][0], rtol=0,
                               atol=0)
    for a, b in zip(out["full"][1], out["none"][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    dots = ModelConfig(**{**vars(tcfg), "remat": "dots"})
    p = _fresh(tp)
    loss, _ = get_model(dots).loss(p, batch, dots)
    torch.testing.assert_close(loss, out["none"][0], rtol=0, atol=0)
    for a, b in zip(torch.autograd.grad(loss, toptim.tree_leaves(p)),
                    out["none"][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_remat_dots_matches_reference(lm):
    """``remat="dots"`` (the linears' outputs saved, the rest recomputed)
    against the reference's ``checkpoint_dots_with_no_batch_dims``: the
    loss and every gradient leaf."""
    cfg, api, params, tcfg, tp = lm
    jcfg = cfg.scaled(remat="dots")
    c = ModelConfig(**{**vars(tcfg), "remat": "dots"})
    batch = _batch(cfg.vocab, 2, 32, seed=3)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_get_model(jcfg).loss(p, _jax(batch), jcfg),
        has_aux=True))(params)
    tp = _fresh(tp)
    tloss, _ = get_model(c).loss(tp, _torch(batch), c)
    grads = torch.autograd.grad(tloss, toptim.tree_leaves(tp))
    _rel(tloss.detach(), jloss)
    _assert_tree_close(jgrads, toptim.tree_unflatten(tp, grads),
                       cfg.n_layers, TOL, TOL)


def test_make_batch_and_train_loop_on_cpu(lm):
    _, _, _, tcfg, tp = lm
    gen = torch.Generator().manual_seed(0)
    b = make_batch(tcfg, 4, 16, gen, device="cpu")
    assert b["tokens"].dtype == torch.int32 and b["tokens"].shape == (4, 16)
    assert torch.equal(b["targets"][:, :-1], b["tokens"][:, 1:])
    tc = TrainConfig(global_batch=4, seq_len=16, optimizer=toptim.
                     OptimizerConfig(lr=1e-2, warmup_steps=2,
                                     decay_steps=100))
    batches = iter([make_batch(tcfg, 4, 16, gen, device="cpu")] * 8)
    _, hist = train_loop(get_model(tcfg), tcfg, tc, steps=8,
                         data_iter=batches, device="cpu", log_every=7)
    assert hist[-1]["loss"] < hist[0]["loss"]


def test_launcher_trains_and_resumes_on_cpu(tmp_path, capsys):
    args = ["--device", "cpu", "--smoke", "--steps", "3", "--log-every",
            "1", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    out = launch_train.main(args)
    assert out["steps"] == 3 and out["device"] == "cpu"
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    more = launch_train.main(args[:4] + ["4"] + args[5:] + ["--resume"])
    assert more["steps"] == 2  # resumed at step 2's checkpoint
    printed = capsys.readouterr().out
    assert "[train] resumed from step 2" in printed
    assert "[train] done: 3 steps, arch=rhapsody-demo" in printed


def test_launcher_trains_moe_on_cpu(capsys):
    """``--arch deepseek-moe-16b`` trains its smoke config: the MoE
    forward and loss, with the router's aux in the loss."""
    out = launch_train.main(["--device", "cpu", "--arch", "deepseek-moe-16b",
                             "--steps", "3", "--log-every", "1"])
    assert out["steps"] == 3 and np.isfinite(out["losses"]).all()
    assert "arch=deepseek-moe-16b" in capsys.readouterr().out


def test_attention_apply_raises_for_unported_modes(lm):
    """Non-causal self-attention and cross-attention (keys from ``x_kv``,
    with and without rope) through ``attention_apply``, against the
    reference on the same weights and inputs: PyTorch ops on both sides
    (the reference sends only causal self-attention to its kernel)."""
    from repro.models import attention as jattention
    from repro_torch.models import attention

    cfg, _, params, tcfg, tp = lm
    rng = np.random.RandomState(8)
    x = rng.randn(2, 6, cfg.d_model).astype(np.float32)
    x_kv = rng.randn(2, 11, cfg.d_model).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], params["blocks"]["attn"])
    for kw in ({"causal": False}, {"causal": False, "x_kv": x_kv},
               {"causal": True, "x_kv": x_kv, "rope": False}):
        tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}
        want = jattention.attention_apply(
            jp, jnp.asarray(x), cfg,
            **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()})
        got = attention.attention_apply(tp["blocks"][0]["attn"],
                                        torch.from_numpy(x), tcfg, **tkw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TOL, atol=TOL, err_msg=str(kw))
