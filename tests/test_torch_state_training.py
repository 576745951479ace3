"""Training the port's state-carrying families (rwkv6, zamba2) against the
JAX package's on the same weights and batches, at smoke size in float32:
the loss (1e-5 relative) and every gradient leaf of ``loss`` (stacked
reference leaves, ``blocks`` [L, ...] and ``groups`` [G, K, ...], mapped to
per-layer ones; atol = rtol = 1e-4, the dense path's limit); 1 and 3
``make_train_step`` steps, plain and with 8-bit moments, with 1 and 4
microbatches, at the dense path's step tolerances (with 8-bit moments,
steps 2 and 3 start from the reference's state, as
``tests/test_torch_training.py`` explains); remat full and dots equal to
none, and dots against the reference's dots (the loss 1e-5 relative, the
leaves 1e-4); the
``wkv`` and ``ssd`` autograd Functions' gradients equal to autograd
straight through their plain versions; AdamW's decay of a hybrid's
stacked 1-D leaves; and the trainer launcher on the CPU.  Inputs are made
with numpy from a seed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import (assert_tree_close as _assert_tree_close,  # noqa: E402,E501
                           build, fresh as _fresh, per_layer as _per_layer,
                           to_jax as _jax, to_torch as _torch)
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.training import optim as joptim  # noqa: E402
from repro.training import train as jtrain  # noqa: E402
from repro_torch.kernels.mamba2 import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.mamba2 import ref as ssd_ref  # noqa: E402
from repro_torch.kernels.rwkv6 import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.rwkv6 import ref as wkv_ref  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.training import optim as toptim  # noqa: E402
from repro_torch.training.train import (TrainConfig,  # noqa: E402
                                        make_train_step)

TOL = 1e-4
ARCHS = ("rwkv6-1.6b", "zamba2-2.7b")


@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    return build(arch=request.param)


def _batch(vocab, B, S, seed):
    tokens = np.random.RandomState(seed).randint(0, vocab, size=(B, S + 1))
    tokens = tokens.astype(np.int32)
    return {"tokens": tokens[:, :-1], "targets": tokens[:, 1:],
            "loss_mask": np.ones((B, S), np.float32)}


def _assert_q8_close(jparams, moments_before, tparams):
    """As ``tests/test_torch_training.py``: elements whose incoming ``v``
    code is 0 under a non-zero ``m`` code may miss the step tolerance at
    no more than 0.1 % of their count."""
    want = _per_layer(jparams)
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


def _load_reference_state(jstate, tstate):
    params = _per_layer(jstate["params"])
    with torch.no_grad():
        for path, t in toptim.named_leaves(tstate["params"]):
            t.copy_(torch.from_numpy(np.array(params[path])))
    moments = _per_layer(jstate["opt"]["moments"], dtype=None)
    for path, _ in toptim.named_leaves(tstate["opt"]["moments"]):
        parent = toptim._moment_dict(tstate["opt"]["moments"], path[:-1])
        parent[path[-1]] = torch.from_numpy(np.array(moments[path]))
    tstate["opt"]["step"] = torch.tensor(int(jstate["opt"]["step"]),
                                         dtype=torch.int32)


def _rel(a, b, tol=1e-5):
    assert abs(float(a) - float(b)) <= tol * max(abs(float(b)), 1e-30), \
        (float(a), float(b))


def test_loss_and_gradients_match_reference(lm):
    cfg, api, params, tcfg, tp = lm
    batch = _batch(cfg.vocab, 2, 32, seed=1)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: api.loss(p, _jax(batch), cfg), has_aux=True))(params)
    tp = _fresh(tp)
    tloss, tm = get_model(tcfg).loss(tp, _torch(batch), tcfg)
    grads = torch.autograd.grad(tloss, toptim.tree_leaves(tp))
    _rel(tloss.detach(), jloss)
    _rel(tm["ce"].detach(), jm["ce"])
    assert float(tm["tokens"]) == float(jm["tokens"]) == 64
    assert all(bool(g.abs().sum() > 0) for g in grads
               if g.dim() >= 2), "a matrix leaf got no gradient"
    _assert_tree_close(jgrads, toptim.tree_unflatten(tp, grads), TOL, TOL)


@pytest.mark.parametrize("quantize", [False, True], ids=["plain", "q8"])
@pytest.mark.parametrize("n_micro", [1, 4])
def test_train_steps_match_reference(lm, quantize, n_micro):
    """Steps 1 and 3 of both packages' steps on the same weights and
    batches; zamba2's parameters agree only if AdamW decays the 1-D leaves
    of its stacked ``groups`` as the reference does."""
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
            _load_reference_state(jstate, tstate)
        before = _per_layer(jstate["opt"]["moments"], dtype=None)
        jstate, jm = jstep(jstate, _jax(batch))
        tstate, tm = tstep(tstate, _torch(batch))
        for key in ("loss", "grad_norm", "lr", "ce"):
            _rel(tm[key], jm[key])
        if quantize:
            _assert_q8_close(jstate["params"], before, tstate["params"])
        elif i in (0, 2):
            _assert_tree_close(jstate["params"], tstate["params"], 2e-3,
                               2e-5)
    assert int(tstate["opt"]["step"]) == int(jstate["opt"]["step"]) == 3


def test_adamw_decays_the_hybrids_stacked_leaves_by_rank(lm):
    """With zero gradients only the decay moves a parameter: the reference
    decays every leaf of zamba2's ``groups`` ([G, K, ...], so 2-D and up;
    ``A_log``, ``D``, ``dt_bias``, the norm scales and conv biases among
    them) and rwkv6's ``blocks``, and no top-level 1-D leaf (``shared``'s
    scales, ``ln_f``)."""
    cfg, _, params, tcfg, tp = lm
    opt = joptim.OptimizerConfig(lr=0.1, weight_decay=0.5, warmup_steps=1)
    zeros = jax.tree.map(jnp.zeros_like, params)
    jnew, _, _ = jax.jit(lambda g, s, p: joptim.adamw_update(g, s, p, opt))(
        zeros, joptim.adamw_init(params, opt), params)
    topt = toptim.OptimizerConfig(**vars(opt))
    tparams = _fresh(tp)
    toptim.adamw_update(toptim.tree_map(torch.zeros_like, tparams),
                        toptim.adamw_init(tparams, topt), tparams, topt)
    _assert_tree_close(jnew, tparams, 1e-6, 1e-7)
    stacked = "groups" if tcfg.family == "hybrid" else "blocks"
    for path, leaf in toptim.named_leaves(tparams):
        assert toptim.decays(path, leaf) == (path[0] == stacked
                                             or leaf.dim() >= 2), path


def test_remat_full_equals_none(lm):
    cfg, _, _, tcfg, tp = lm
    assert tcfg.remat == "full"
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
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-5)
    _assert_tree_close(jgrads, toptim.tree_unflatten(tp, grads), TOL, TOL)


def _scan_inputs(kind, s0_set, dtype=torch.float32, seed=0):
    """Inputs of a ``wkv`` (T 37 in chunks of 8, so T is padded) or ``ssd``
    (T 48 in chunks of 16) call, drawn with numpy."""
    rng = np.random.RandomState(seed)

    def t(*shape, scale=1.0, dt=dtype):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)).to(dt)

    if kind == "wkv":
        B, T, H, hd, L = 2, 37, 2, 8, 8
        lw = -torch.exp(t(B, T, H, hd, scale=0.5, dt=torch.float32) - 1.0)
        args = [t(B, T, H, hd), t(B, T, H, hd), t(B, T, H, hd), lw,
                t(H, hd, scale=0.5, dt=torch.float32)]
        state = t(B, H, hd, hd, scale=0.1, dt=torch.float32)
    else:
        B, T, H, P, N, L = 2, 48, 3, 8, 4, 16
        dt_ = torch.nn.functional.softplus(
            t(B, T, H, dt=torch.float32) - 1.0)
        A = -torch.exp(t(H, scale=0.5, dt=torch.float32))
        args = [t(B, T, H, P), dt_, A, t(B, T, N), t(B, T, N)]
        state = t(B, H, N, P, scale=0.1, dt=torch.float32)
    return args, (state if s0_set else None), L


def _scan_call(kind, args, s0, L, *, plain):
    if kind == "wkv":
        if plain:  # the reference's padding, straight through autograd
            T = args[0].shape[1]
            pad = -T % L
            padded = [torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad))
                      for a in args[:4]]
            y, s = wkv_ref.wkv_chunked_ref(*padded, args[4], L, s0)
            return y[:, :T], s
        return wkv_ops.wkv(*args, chunk=L, s0=s0)
    if plain:
        return ssd_ref.ssd_chunked_ref(*args, L, s0)
    return ssd_ops.ssd(*args, chunk=L, h0=s0)


@pytest.mark.parametrize("cotangent", ["y", "state", "both"])
@pytest.mark.parametrize("s0_set", [False, True], ids=["s0_absent",
                                                       "s0_set"])
@pytest.mark.parametrize("kind", ["wkv", "ssd"])
def test_scan_function_gradients_equal_autograd_of_plain(kind, s0_set,
                                                         cotangent):
    """The Function's backward (the plain version recomputed under
    autograd) gives every input's gradient, from either output's
    cotangent, as autograd straight through the plain version; each
    gradient in its input's dtype."""
    args, s0, L = _scan_inputs(kind, s0_set)
    leaves = args + ([s0] if s0 is not None else [])
    rng = np.random.RandomState(1)
    grads = {}
    for plain in (False, True):
        inputs = [a.detach().clone().requires_grad_() for a in leaves]
        y, s = _scan_call(kind, inputs[:5], inputs[5] if s0_set else None,
                          L, plain=plain)
        assert y.grad_fn is not None and s.grad_fn is not None
        rng.seed(1)
        wy = torch.from_numpy(rng.standard_normal(y.shape).astype(np.float32))
        ws = torch.from_numpy(rng.standard_normal(s.shape).astype(np.float32))
        total = ((y * wy).sum() if cotangent != "state" else 0) \
            + ((s * ws).sum() if cotangent != "y" else 0)
        grads[plain] = torch.autograd.grad(total, inputs, allow_unused=True,
                                           materialize_grads=True)
    for name, a, b, x in zip(range(6), grads[False], grads[True], leaves):
        assert a.dtype == x.dtype, name
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["wkv", "ssd"])
def test_scan_function_gradients_keep_bf16_inputs_dtype(kind):
    args, s0, L = _scan_inputs(kind, True, dtype=torch.bfloat16)
    inputs = [a.detach().clone().requires_grad_() for a in args + [s0]]
    y, s = _scan_call(kind, inputs[:5], inputs[5], L, plain=False)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    grads = torch.autograd.grad(y.float().sum() + s.sum(), inputs)
    assert [g.dtype for g in grads] == [a.dtype for a in inputs]
    assert all(bool(torch.isfinite(g.float()).all()) for g in grads)


def test_ssd_refuses_a_ragged_length_before_the_function_runs():
    args, _, _ = _scan_inputs("ssd", False)
    with pytest.raises(ValueError, match="not divisible"):
        ssd_ops.ssd(*[a[:, :40].contiguous() if a.dim() > 1 else a
                      for a in args],
                    chunk=16)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains_and_resumes_state_family_on_cpu(arch, tmp_path,
                                                         capsys):
    args = ["--device", "cpu", "--arch", arch, "--steps", "3", "--batch",
            "4", "--seq", "32", "--log-every", "1", "--ckpt-dir",
            str(tmp_path), "--ckpt-every", "2"]
    out = launch_train.main(args)
    assert out["steps"] == 3 and out["device"] == "cpu"
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    more = launch_train.main(args[:5] + ["4"] + args[6:] + ["--resume"])
    assert more["steps"] == 2  # resumed at step 2's checkpoint
    printed = capsys.readouterr().out
    assert "[train] resumed from step 2" in printed
    assert f"[train] done: 3 steps, arch={arch}" in printed
