"""Remat ``"dots"`` on the port: ``torch.utils.checkpoint`` with a selective
policy that saves the outputs of ``mm``/``addmm`` (the linears and the
unembedding), the counterpart of the reference's
``checkpoint_dots_with_no_batch_dims``.  On the CPU at smoke width: an MoE
model's loss (1e-5 relative) and every gradient leaf (1e-4) against the
reference's ``remat="dots"``; every family's loss and gradients equal to
``"none"``'s; and, read by the cost counter, no ``mm`` is recomputed in
the backward (``"dots"`` counts ``"none"``'s mm FLOPs), the FLOPs by
which ``"full"`` exceeds ``"dots"`` are exactly ``"full"``'s recomputed
mm FLOPs, and the hand-written kernels' forwards are recomputed, not
saved (on ``meta``: two charges a layer).  The dense and state families
are held to the reference's ``"dots"`` in ``tests/test_torch_training.py``
and ``tests/test_torch_state_training.py``.  Inputs are made with numpy
from a seed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import build, fresh  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import cost, specs  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.training import optim  # noqa: E402

FAMILIES = ("llama3.2-3b", "deepseek-moe-16b", "rwkv6-1.6b", "zamba2-2.7b",
            "whisper-small")  # every remat_wrap: blocks, MoE, rwkv6 blocks,
# zamba2 groups, the encoder


def _batch(cfg, B, S, seed):
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


def _loss_and_grads(api, cfg):
    def step(p, b):
        loss, _ = api.loss(p, b, cfg)
        return loss, torch.autograd.grad(
            loss, optim.tree_leaves(p), allow_unused=True,
            materialize_grads=True)
    return step


def test_moe_remat_dots_matches_reference():
    """deepseek-moe-16b's smoke config: the first layer dense (the
    reference's ``pre/layer_0``), the rest MoE with batched expert
    products that ``"dots"`` recomputes."""
    cfg, api, params, tcfg, tp = build(arch="deepseek-moe-16b")
    jcfg, c = cfg.scaled(remat="dots"), tcfg.scaled(remat="dots")
    b = _batch(cfg, 2, 16, seed=4)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_get_model(jcfg).loss(
            p, {k: jnp.asarray(v) for k, v in b.items()}, jcfg),
        has_aux=True))(params)
    p = fresh(tp)
    loss, grads = _loss_and_grads(get_model(c), c)(
        p, {k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    n_pre = cfg.first_dense_layers
    want = {}
    for path, a in optim.named_leaves(jgrads):
        if path[0] == "pre":
            want[("blocks", int(path[1].split("_")[1])) + path[2:]] = a
        elif path[0] == "blocks":
            for j in range(a.shape[0]):
                want[("blocks", n_pre + j) + path[1:]] = a[j]
        else:
            want[path] = a
    got = dict(optim.named_leaves(optim.tree_unflatten(p, grads)))
    assert set(got) == set(want)
    for path, g in got.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(want[path]),
                                   rtol=1e-4, atol=1e-4, err_msg=str(path))


@pytest.mark.parametrize("arch", FAMILIES)
def test_dots_recomputes_everything_but_the_dots(arch):
    b = {k: torch.from_numpy(v) for k, v in
         _batch(get_smoke_config(arch), 2, 16, seed=5).items()}
    runs = {}
    for remat in ("none", "full", "dots"):
        cfg = get_smoke_config(arch, remat=remat)
        api = get_model(cfg)
        p = api.init(torch.Generator().manual_seed(0), cfg, device="cpu")
        for t in optim.tree_leaves(p):
            t.requires_grad_(True)
        (loss, grads), counter = cost.run(_loss_and_grads(api, cfg), p, b)
        runs[remat] = loss, grads, counter
    loss, grads, dots = runs["dots"]
    assert torch.equal(loss, runs["none"][0])
    for a, g in zip(grads, runs["none"][1]):
        torch.testing.assert_close(a, g, rtol=1e-6, atol=1e-7)
    full, none = runs["full"][2], runs["none"][2]

    def mm(c):
        return c.by_op["aten.mm"][1] + c.by_op["aten.addmm"][1]

    assert mm(dots) == mm(none)  # no mm recomputed in the backward
    assert mm(full) > mm(none)
    assert full.flops - dots.flops == mm(full) - mm(dots)
    assert dots.flops > none.flops  # bmm and the rest are recomputed


@pytest.mark.parametrize("arch", ["llama3.2-3b", "zamba2-2.7b",
                                  "rwkv6-1.6b"])
def test_dots_recomputes_the_kernels(arch):
    """On meta the kernels' forwards are charged twice a layer under
    ``"dots"`` as under ``"full"``: their outputs are not ``mm``'s, so
    the policy recomputes them; once under ``"none"``."""
    calls = {}
    for remat in ("none", "full", "dots"):
        cfg = get_smoke_config(arch, remat=remat)
        api = get_model(cfg)
        p = specs.abstract_params(api, cfg)
        b = specs.train_batch_specs(cfg, 2, 32)
        calls[remat] = {k: v["calls"] for k, v in cost.analyze(
            _loss_and_grads(api, cfg), p, b)["kernels"].items()}
    assert calls["dots"] == calls["full"] == {
        k: 2 * n for k, n in calls["none"].items()}
