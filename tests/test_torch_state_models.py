"""The port's rwkv6 and zamba2 models against the JAX package's on the same
weights, at smoke size in float32: the weight bridge; ``forward`` logits;
``prefill`` logits and every state leaf; then 4 ``decode`` steps, all
within atol = rtol = 1e-4 (matmul and scan sums taken in another order)
with identical greedy tokens.  rwkv6 prompt lengths include ones that are
no multiple of its ``rwkv_chunk`` (8); zamba2's are at most its
``ssm_chunk`` (16) or a multiple of it, and a length that is neither
raises the same ``ValueError`` in both packages.  Inputs are made with
numpy from a seed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import build  # noqa: E402
from repro_torch.models import get_model, make_batch  # noqa: E402

TOL = 1e-4
PROMPT_LENS = {"rwkv6-1.6b": (5, 21), "zamba2-2.7b": (5, 32)}


@pytest.fixture(scope="module", params=sorted(PROMPT_LENS))
def lm(request):
    return request.param, build(arch=request.param)


def _close(a, b):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)
    if a.ndim and a.dtype.kind == "f":
        np.testing.assert_array_equal(b.argmax(-1), a.argmax(-1))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, list):
        for i, t in enumerate(tree):
            yield from _leaves(t, f"{path}/{i}")
    else:
        yield path, tree


def test_weight_bridge_and_init_structure(lm):
    """Stacked reference leaves ([L, ...], zamba2 [G, K, ...]) unstack into
    the port's per-layer lists unchanged, and the port's own init draws
    the same structure, shapes and leaf types."""
    arch, (cfg, _, params, tcfg, tp) = lm
    ref = jax.tree.map(np.asarray, params)
    if cfg.family == "ssm":
        layers = [(tp["blocks"][i], ref["blocks"], (i,))
                  for i in range(cfg.n_layers)]
    else:
        K = cfg.attn_every
        layers = [(tp["groups"][g][i], ref["groups"], (g, i))
                  for g in range(cfg.n_layers // K) for i in range(K)]
    for mine, theirs, idx in layers:
        got, want = dict(_leaves(mine)), dict(_leaves(theirs))
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(), want[k][idx])
    gen = torch.Generator().manual_seed(0)
    fresh = get_model(tcfg).init(gen, tcfg, device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in _leaves(fresh)} == \
        {k: (tuple(v.shape), v.dtype) for k, v in _leaves(tp)}


def test_forward_matches_reference(lm):
    arch, (cfg, api, params, tcfg, tp) = lm
    toks = np.random.RandomState(0).randint(0, cfg.vocab, size=(2, 32))
    jl, _ = api.forward(params, {"tokens": jnp.asarray(toks, jnp.int32)},
                        cfg)
    tl, aux = get_model(tcfg).forward(
        tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    _close(jl, tl)
    assert float(aux) == 0.0



def test_zamba2_forward_at_head_dim_80_matches_reference():
    """zamba2-2.7b's shared attention block has head_dim 80, a width the
    flash kernel takes since its Hopper rebuild; at the smoke widths
    otherwise, ``hybrid_forward`` (the plain flash forward on the CPU)
    gives the reference's logits."""
    from repro.configs import get_smoke_config

    cfg, api, params, tcfg, tp = build(
        cfg=get_smoke_config("zamba2-2.7b", head_dim=80))
    toks = np.random.RandomState(3).randint(0, cfg.vocab, size=(2, 32))
    jl, _ = api.forward(params, {"tokens": jnp.asarray(toks, jnp.int32)},
                        cfg)
    tl, _ = get_model(tcfg).forward(tp, {"tokens": torch.from_numpy(toks)},
                                    tcfg)
    _close(jl, tl)

@pytest.mark.parametrize("i", range(2))
def test_prefill_state_and_decode_match_reference(lm, i):
    arch, (cfg, api, params, tcfg, tp) = lm
    T = PROMPT_LENS[arch][i]
    tapi = get_model(tcfg)
    toks = np.random.RandomState(i).randint(0, cfg.vocab, size=(2, T))
    jc, jl = api.prefill(params, {"tokens": jnp.asarray(toks, jnp.int32)},
                         cfg, max_len=40)
    tc, tl = tapi.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                          max_len=40)
    _close(jl, tl)
    ref_leaves = dict(_leaves(jax.tree.map(np.asarray, jc)))
    my_leaves = dict(_leaves(tc))
    assert my_leaves.keys() == ref_leaves.keys()
    for k, v in ref_leaves.items():
        _close(v, my_leaves[k])
    for _ in range(4):
        nxt = np.asarray(jl).argmax(-1)
        jc, jl = api.decode(params, jc, jnp.asarray(nxt, jnp.int32), cfg)
        tc, tl = tapi.decode(tp, tc, torch.from_numpy(nxt), tcfg)
        _close(jl, tl)


def test_zamba2_prompt_length_limit_matches_reference():
    """``ssd_chunked`` takes T <= ssm_chunk or a multiple of it; 20 tokens
    with a chunk of 16 raise the same ``ValueError`` in both packages (a
    limit of the reference, kept as it is)."""
    cfg, api, params, tcfg, tp = build(arch="zamba2-2.7b")
    toks = np.zeros((1, 20), np.int32)
    with pytest.raises(ValueError, match="T=20 not divisible by chunk=16"):
        api.prefill(params, {"tokens": jnp.asarray(toks)}, cfg, max_len=32)
    with pytest.raises(ValueError, match="T=20 not divisible by chunk=16"):
        get_model(tcfg).prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                                max_len=32)


def test_recurrent_oracles_match_chunked(lm):
    """The recurrent oracles (``wkv_recurrent`` through
    ``time_mix_apply(chunked=False)``; ``mamba_block_apply(
    recurrent_oracle=True)``) give the chunked path's block output."""
    from repro_torch.models import mamba2, rwkv6

    arch, (cfg, _, _, tcfg, tp) = lm
    x = torch.from_numpy(np.random.RandomState(4).randn(
        2, 16, tcfg.d_model).astype(np.float32))
    if cfg.family == "ssm":
        bp = tp["blocks"][0]
        a, sa = rwkv6.rwkv_block_apply(bp, x, tcfg)
        b, sb = rwkv6.rwkv_block_apply(bp, x, tcfg, chunked=False)
        torch.testing.assert_close(sa["att"]["wkv"], sb["att"]["wkv"],
                                   rtol=TOL, atol=TOL)
    else:
        bp = tp["groups"][0][0]
        a = mamba2.mamba_block_apply(bp, x, tcfg)
        b = mamba2.mamba_block_apply(bp, x, tcfg, recurrent_oracle=True)
    torch.testing.assert_close(a, b, rtol=TOL, atol=TOL)


def test_make_batch_and_loss(lm):
    """``make_batch`` serves the state-carrying families (tokens only);
    their ``loss`` on it equals the reference's within 1e-5 relative
    (``tests/test_torch_state_training.py`` holds the gradients)."""
    arch, (cfg, api, params, tcfg, tp) = lm
    batch = make_batch(tcfg, 2, 16, device="cpu")
    assert set(batch) == {"tokens", "targets", "loss_mask"}
    assert tuple(batch["tokens"].shape) == (2, 16)
    loss, metrics = get_model(tcfg).loss(tp, batch, tcfg)
    want, _ = api.loss(params, {k: jnp.asarray(v.numpy())
                                for k, v in batch.items()}, cfg)
    assert abs(float(loss) - float(want)) <= 1e-5 * abs(float(want))
    assert float(metrics["tokens"]) == 32
