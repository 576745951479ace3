"""nemotron-4-340b's attention shapes on the port: head_dim 192 and 12
query heads per kv head.

The JAX package's Pallas kernels, run in interpret mode as
``tests/test_kernels.py`` runs them, against the port's plain versions
(what its wrappers run on the CPU) at float32 2e-5, the reference tests'
tolerance: the contiguous decode over ragged lengths 1..S (and its
log-sum-exp against a masked logsumexp, -inf at length 0), the paged
decode at block size 16 with tables pointing past each length at the
null block 0, and the causal flash forward at Hq 12 over Hkv 1, S 128 and
256 (its lse against a masked logsumexp too).  Then a nemotron-shaped
narrow model (2 layers, d_model 128, 12 heads of 192 over one kv head,
relu² MLP, float32) built from the reference's weights: its prefill,
extend, decode and paged-decode logits within 1e-5 of ``repro``'s with
equal greedy tokens, its forward loss within 1e-5, and one AdamW step's
parameters within ``tests/test_torch_training.py``'s step tolerance.
Inputs are made with numpy from a seed."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import build, per_layer  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.kernels.decode_attention.ops import (  # noqa: E402
    decode_attention as jax_decode)
from repro.kernels.decode_attention.ops import (  # noqa: E402
    paged_decode_attention as jax_paged)
from repro.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention as jax_flash)
from repro.training import optim as joptim  # noqa: E402
from repro.training import train as jtrain  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.training import optim as toptim  # noqa: E402
from repro_torch.training.train import (TrainConfig,  # noqa: E402
                                        make_train_step)

KERNEL_TOL = 2e-5  # the reference's own limit (tests/test_kernels.py)
MODEL_TOL = 1e-5
HKV, G, D = 1, 12, 192  # nemotron-4-340b: 96 heads over 8 kv heads, D 192


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _masked_lse(q, k, lens):
    """float64 log-sum-exp of each query head's scaled scores over the
    first ``lens[b]`` positions (-inf where there are none):
    q [B, Hkv, G, D], k [B, S, Hkv, D] -> [B, Hkv * G]."""
    B, S = k.shape[:2]
    s = np.einsum("bhgd,bshd->bhgs", q.astype(np.float64),
                  k.astype(np.float64)) / np.sqrt(q.shape[-1])
    s = np.where(np.arange(S)[None, None, None] < lens[:, None, None, None],
                 s, -np.inf)
    mx = s.max(-1, keepdims=True)
    with np.errstate(invalid="ignore", divide="ignore"):
        out = np.log(np.exp(s - np.where(np.isfinite(mx), mx, 0)).sum(-1)) \
            + np.where(np.isfinite(mx), mx, 0)[..., 0]
    return out.reshape(B, -1)


@pytest.mark.parametrize("S,bk", [(96, 32), (256, 64)])
def test_contiguous_decode_matches_reference_kernel(S, bk):
    """Every length 1..S (several rows a call) and one past S: the port's
    plain version equals the Pallas kernel; with ``return_lse`` the
    log-sum-exp equals a masked logsumexp, -inf at length 0."""
    rng = np.random.RandomState(S)
    lens = np.concatenate([np.arange(1, S + 1), [S + 9]]).astype(np.int32)
    for rows in np.array_split(np.arange(len(lens)), 4):
        ln = lens[rows]
        B = len(ln)
        q = rng.randn(B, 1, HKV * G, D).astype(np.float32)
        kc = rng.randn(B, S, HKV, D).astype(np.float32)
        vc = rng.randn(B, S, HKV, D).astype(np.float32)
        want = np.asarray(jax_decode(*(jnp.asarray(a) for a in
                                       (q, kc, vc, ln)),
                                     block_k=bk, interpret=True))
        got = da_ops.decode_attention(_t(q), _t(kc), _t(vc), _t(ln))
        np.testing.assert_allclose(got.numpy(), want, rtol=KERNEL_TOL,
                                   atol=KERNEL_TOL)
        ln0 = ln.copy()
        ln0[0] = 0  # a rank's shard holding none of the sequence
        out, lse = da_ops.decode_attention(_t(q), _t(kc), _t(vc), _t(ln0),
                                           return_lse=True)
        want_lse = _masked_lse(q[:, 0].reshape(B, HKV, G, D), kc,
                               np.minimum(ln0, S))
        assert torch.isneginf(lse[0]).all() and not out[0].any()
        np.testing.assert_allclose(lse[1:].numpy(), want_lse[1:],
                                   rtol=KERNEL_TOL, atol=KERNEL_TOL)


def test_paged_decode_matches_reference_kernel():
    """Block size 16, permuted distinct blocks, ragged lengths at the
    block edges; logical blocks past each length point at null block 0."""
    rng = np.random.RandomState(3)
    bs, mb, num_blocks = 16, 8, 81
    lens = np.asarray([1, 15, 16, 17, 31, 32, 33, 100, 127, 128],
                      np.int32)
    B = len(lens)
    q = rng.randn(B, 1, HKV * G, D).astype(np.float32)
    ks = rng.randn(num_blocks, bs, HKV, D).astype(np.float32)
    vs = rng.randn(num_blocks, bs, HKV, D).astype(np.float32)
    bt = rng.permutation(np.arange(1, num_blocks))[:B * mb]
    bt = bt.reshape(B, mb).astype(np.int32)
    for b in range(B):
        bt[b, -(-int(lens[b]) // bs):] = 0
    want = np.asarray(jax_paged(*(jnp.asarray(a) for a in
                                  (q, ks, vs, bt, lens)), interpret=True))
    got = da_ops.paged_decode_attention(*(_t(a) for a in
                                          (q, ks, vs, bt, lens)))
    np.testing.assert_allclose(got.numpy(), want, rtol=KERNEL_TOL,
                               atol=KERNEL_TOL)


@pytest.mark.parametrize("S", [128, 256])
def test_flash_forward_matches_reference_kernel(S):
    """Causal, 12 query heads over one kv head at D 192: out against the
    Pallas kernel, lse against a masked logsumexp of the causal scores."""
    rng = np.random.RandomState(S + 1)
    q = rng.randn(1, S, HKV * G, D).astype(np.float32)
    k = rng.randn(1, S, HKV, D).astype(np.float32)
    v = rng.randn(1, S, HKV, D).astype(np.float32)
    want = np.asarray(jax_flash(*(jnp.asarray(a) for a in (q, k, v)),
                                causal=True, block_q=64, block_k=64,
                                interpret=True))
    got = fa_ops.flash_attention(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(got.numpy(), want, rtol=KERNEL_TOL,
                               atol=KERNEL_TOL)
    _, lse = fa_ref.attention_fwd_ref(_t(q), _t(k), _t(v))
    s = np.einsum("bqhd,bkd->bhqk", q.astype(np.float64),
                  k[:, :, 0].astype(np.float64)) / np.sqrt(D)
    s = np.where(np.tril(np.ones((S, S), bool)), s, -np.inf)
    mx = s.max(-1, keepdims=True)
    want_lse = np.log(np.exp(s - mx).sum(-1)) + mx[..., 0]
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=KERNEL_TOL,
                               atol=KERNEL_TOL)


def _cfg():
    return get_config("nemotron-4-340b").scaled(
        n_layers=2, d_model=128, n_heads=12, n_kv_heads=1, head_dim=192,
        d_ff=256, vocab=512, param_dtype="float32", compute_dtype="float32")


@pytest.fixture(scope="module")
def lm():
    return build(cfg=_cfg())


def _close(want, got):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=MODEL_TOL, atol=MODEL_TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_narrow_model_is_nemotron_shaped(lm):
    cfg, _, _, tcfg, tp = lm
    assert (cfg.activation, cfg.gated_mlp) == ("relu2", False)
    assert tcfg.head_dim == D and tcfg.n_heads // tcfg.n_kv_heads == G
    assert "gate" not in tp["blocks"][0]["mlp"]


def test_prefill_extend_decode_match_reference(lm):
    cfg, api, params, tcfg, tp = lm
    tapi = get_model(tcfg)
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg.vocab, size=(2, 11)).astype(np.int32)
    jc, jl = api.prefill(params, {"tokens": jnp.asarray(toks)}, cfg,
                         max_len=32, last_only=False)
    tc, tl = tapi.prefill(tp, {"tokens": _t(toks).long()}, tcfg, max_len=32,
                          last_only=False)
    _close(jl, tl)
    for _ in range(3):
        nxt = np.asarray(jl if jl.ndim == 2 else jl[:, -1]).argmax(-1)
        jc, jl = api.decode(params, jc, jnp.asarray(nxt, jnp.int32), cfg)
        tc, tl = tapi.decode(tp, tc, _t(nxt).long(), tcfg)
        _close(jl, tl)
    chunk = rng.randint(0, cfg.vocab, size=(2, 5)).astype(np.int32)
    jc, jl = api.extend(params, jc, jnp.asarray(chunk), cfg)
    tc, tl = tapi.extend(tp, tc, _t(chunk).long(), tcfg)
    _close(jl, tl)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["scan"]["k"]),
                               rtol=MODEL_TOL, atol=MODEL_TOL)
    assert tc["len"].tolist() == np.asarray(jc["scan"]["len"][0]).tolist()


def test_paged_decode_step_matches_reference(lm):
    """``decode_paged`` over block size 16 (lengths 0, 7 and one short of
    the table's end): logits and the store's new rows."""
    cfg, api, params, tcfg, tp = lm
    rng = np.random.RandomState(1)
    L, N, bs, mb, B = cfg.n_layers, 24, 16, 3, 3
    shape = (L, N, bs, cfg.n_kv_heads, cfg.head_dim)
    ks = rng.randn(*shape).astype(np.float32)
    vs = rng.randn(*shape).astype(np.float32)
    bt = rng.permutation(np.arange(1, N))[:B * mb].reshape(B, mb)
    bt = bt.astype(np.int32)
    lens = np.asarray([0, 7, mb * bs - 1], np.int32)
    wphys = np.asarray([bt[b, lens[b] // bs] for b in range(B)], np.int32)
    woff = (lens % bs).astype(np.int32)
    for b in range(B):
        bt[b, lens[b] // bs + 1:] = 0
    toks = rng.randint(0, cfg.vocab, size=B).astype(np.int32)
    store = {"scan": {"k": jnp.asarray(ks), "v": jnp.asarray(vs),
                      "len": jnp.zeros(ks.shape[:2], jnp.int32)}}
    jstore, jl = api.decode_paged(params, store, *(jnp.asarray(a) for a in (
        bt, lens, toks, wphys, woff)), cfg)
    tstore = {"k": _t(ks.copy()), "v": _t(vs.copy())}
    tstore, tl = get_model(tcfg).decode_paged(
        tp, tstore, _t(bt), _t(lens), _t(toks).long(), _t(wphys).long(),
        _t(woff).long(), tcfg)
    _close(jl, tl)
    for name in ("k", "v"):
        np.testing.assert_allclose(tstore[name].numpy(),
                                   np.asarray(jstore["scan"][name]),
                                   rtol=MODEL_TOL, atol=MODEL_TOL)


def _batch(vocab, B, S, seed):
    tokens = np.random.RandomState(seed).randint(0, vocab, size=(B, S + 1))
    tokens = tokens.astype(np.int32)
    return {"tokens": tokens[:, :-1], "targets": tokens[:, 1:],
            "loss_mask": np.ones((B, S), np.float32)}


def test_forward_loss_and_one_adamw_step_match_reference(lm):
    """The training path (causal attention through the flash wrapper's
    plain version): the loss within 1e-5 relative, then one AdamW step's
    parameters within rtol 2e-3, atol 2e-5 (the reference's own step
    tolerance).  Adam's eps is 1e-3, as in the card-vs-CPU step of
    ``chip_smoke.py``: with 1e-8 the first update is lr·g/(|g| + eps), so
    an element whose gradient sits at float32 rounding's scale moves by a
    step whose size depends on that rounding."""
    cfg, api, params, tcfg, tp = lm
    batch = _batch(cfg.vocab, 2, 64, seed=4)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: _t(v) for k, v in batch.items()}
    jloss, _ = api.loss(params, jb, cfg)
    with torch.no_grad():
        tloss, _ = get_model(tcfg).loss(tp, tb, tcfg)
    assert abs(float(tloss) - float(jloss)) <= MODEL_TOL * abs(float(jloss))

    opt = joptim.OptimizerConfig(lr=1e-3, warmup_steps=1, decay_steps=10,
                                 eps=1e-3)
    jstate = {"params": params, "opt": joptim.adamw_init(params, opt)}
    jstep = jtrain.make_train_step(
        api, cfg, jtrain.TrainConfig(optimizer=opt), donate=False)
    topt = toptim.OptimizerConfig(**vars(opt))
    tparams = toptim.tree_map(
        lambda t: t.detach().clone().requires_grad_(True), tp)
    tstate = {"params": tparams, "opt": toptim.adamw_init(tparams, topt)}
    tstep = make_train_step(get_model(tcfg), tcfg,
                            TrainConfig(optimizer=topt))
    jstate, jm = jstep(jstate, jb)
    tstate, tm = tstep(tstate, tb)
    for key in ("loss", "grad_norm"):
        assert abs(float(tm[key]) - float(jm[key])) <= \
            MODEL_TOL * abs(float(jm[key])), key
    want = per_layer(jstate["params"])
    got = dict(toptim.named_leaves(tstate["params"]))
    assert set(got) == set(want)
    for path, t in got.items():
        np.testing.assert_allclose(t.detach().numpy(), want[path],
                                   rtol=2e-3, atol=2e-5, err_msg=str(path))
