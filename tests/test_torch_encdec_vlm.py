"""The port's encoder-decoder (whisper-small) and vision-prefix
(internvl2-1b) families against the JAX package's on the same weights, at
smoke size in float32: ``sinusoidal_positions`` (bit-equal), the weight
bridge, ``encode``, ``forward`` and ``loss_fn`` (with and without the
vision prefix), ``prefill`` (its cache, cross K/V included), then
``extend_step`` and ``decode_step`` past the prompt (learned positions read
at the cache length), at atol = rtol = 1e-4 with equal greedy tokens; the
slot engine's greedy transcripts against the reference engine's (the
engine's zero frontend stubs, whisper's cross K/V zero-padded to 1500
frames, a VLM prompt no longer than the prefix, a free slot decoding past
the learned table); every gradient leaf of ``loss`` and 1 and 3 AdamW steps
against ``jax.value_and_grad`` and ``repro``'s optimizer (encoder blocks'
1-D leaves decayed); the launchers on the CPU.  Inputs, frontend
embeddings included, are made with numpy from a seed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import (assert_tree_close as _assert_tree_close,  # noqa: E402,E501
                           build, fresh as _fresh, per_layer as _per_layer,
                           to_jax as _jax, to_torch as _torch)
from repro.models import nn as jnn  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.serving.engine import InferenceEngine as JaxEngine  # noqa: E402
from repro.training import optim as joptim  # noqa: E402
from repro.training import train as jtrain  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import get_model, make_batch, nn  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.serving.engine import (InferenceEngine,  # noqa: E402
                                        make_engine_from_scratch)
from repro_torch.serving.kvcache import WHISPER_FRAMES  # noqa: E402
from repro_torch.training import optim as toptim  # noqa: E402
from repro_torch.training.train import (TrainConfig,  # noqa: E402
                                        make_train_step)

TOL = 1e-4
ARCHS = ("whisper-small", "internvl2-1b")
FRAMES = 24  # stubbed audio frames of the model-level checks


@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    return build(arch=request.param)


@pytest.fixture(scope="module")
def whisper():
    return build(arch="whisper-small")


def _batch(cfg, B, S, seed, *, prefix=True):
    """Tokens, next-token targets and a loss mask, plus the family's
    stubbed frontend: frames [B, FRAMES, d] (encdec), patches [B,
    vision_tokens, d] (vlm; ``prefix=False`` leaves them out)."""
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, cfg.vocab, size=(B, S + 1)).astype(np.int32)
    out = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:],
           "loss_mask": np.ones((B, S), np.float32)}
    if cfg.family == "encdec":
        out["frame_embeds"] = (rng.randn(B, FRAMES, cfg.d_model) * 0.02
                               ).astype(np.float32)
    if cfg.family == "vlm" and prefix:
        out["patch_embeds"] = (rng.randn(B, cfg.vision_tokens, cfg.d_model)
                               * 0.02).astype(np.float32)
    return out


def _close(ref, got, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(ref), rtol=tol, atol=tol)


def _close_greedy(ref, got):
    _close(ref, got)
    np.testing.assert_array_equal(got.detach().numpy().argmax(-1),
                                  np.asarray(ref).argmax(-1))


@pytest.mark.parametrize("n_pos,d", [(1500, 768), (FRAMES, 64), (7, 10)])
def test_sinusoidal_positions_equal_reference(n_pos, d):
    np.testing.assert_array_equal(nn.sinusoidal_positions(n_pos, d).numpy(),
                                  np.asarray(jnn.sinusoidal_positions(n_pos,
                                                                      d)))


def test_weight_bridge_and_own_init(lm):
    """Every reference leaf lands in the port unchanged (stacked layers
    unstacked), and the port's own init draws the same tree of shapes."""
    cfg, api, params, tcfg, tp = lm
    want = _per_layer(params)
    got = dict(toptim.named_leaves(tp))
    assert set(got) == set(want)
    for path, t in got.items():
        np.testing.assert_array_equal(t.numpy(), want[path], str(path))
    mine = get_model(tcfg).init(torch.Generator().manual_seed(0), tcfg,
                                device="cpu")
    assert {p: tuple(t.shape) for p, t in toptim.named_leaves(mine)} == \
        {p: a.shape for p, a in want.items()}
    if cfg.family == "encdec":
        assert len(tp["enc_blocks"]) == cfg.enc_layers
        assert {"ln_cross", "cross"} <= set(tp["blocks"][0])
        assert abs(mine["pos_embed"]["table"].std().item() - 0.01) < 1e-3


def test_encode_matches_reference(whisper):
    cfg, _, params, tcfg, tp = whisper
    frames = _batch(cfg, 2, 4, seed=0)["frame_embeds"]
    _close(jtfm.encode(params, jnp.asarray(frames), cfg),
           tfm.encode(tp, torch.from_numpy(frames), tcfg))


@pytest.mark.parametrize("prefix", [True, False], ids=["prefix", "text"])
def test_forward_and_loss_match_reference(lm, prefix):
    """Logits at the text positions only (the vision prefix is not
    scored), the aux and the loss; ``text`` drops the VLM's patches."""
    cfg, api, params, tcfg, tp = lm
    batch = _batch(cfg, 2, 12, seed=1, prefix=prefix)
    jl, ja = api.forward(params, _jax(batch), cfg)
    tl, ta = get_model(tcfg).forward(tp, _torch(batch), tcfg)
    assert tuple(tl.shape) == (2, 12, cfg.vocab)
    _close_greedy(jl, tl)
    jloss, jm = api.loss(params, _jax(batch), cfg)
    tloss, tm = get_model(tcfg).loss(tp, _torch(batch), tcfg)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(tm["ce"]), float(jm["ce"]), rtol=1e-5)


def test_prefill_extend_decode_match_reference(lm):
    """``prefill`` (cache leaves, cross K/V, len counting the prefix,
    every position's logits), then a 3-token ``extend_step`` and 4
    ``decode_step``s fed the reference's greedy tokens, each step's logits
    and the caches at the end."""
    cfg, api, params, tcfg, tp = lm
    batch = _batch(cfg, 2, 9, seed=2)
    del batch["targets"], batch["loss_mask"]
    max_len = 48
    jc, jl = api.prefill(params, _jax(batch), cfg, max_len=max_len,
                         last_only=False)
    tapi = get_model(tcfg)
    tc, tl = tapi.prefill(tp, _torch(batch), tcfg, max_len=max_len,
                          last_only=False)
    S = 9 + (cfg.vision_tokens if cfg.family == "vlm" else 0)
    assert tuple(tl.shape) == (2, S, cfg.vocab)
    _close_greedy(jl, tl)
    leaves = ("k", "v") + (("cross_k", "cross_v")
                           if cfg.family == "encdec" else ())
    assert set(tc) == set(leaves) | {"len"}
    for name in leaves:
        _close(jc["scan"][name], tc[name])
    if cfg.family == "encdec":
        assert tuple(tc["cross_k"].shape[2:]) == (FRAMES, cfg.n_kv_heads,
                                                  cfg.head_dim)
    assert tc["len"].tolist() == [S, S]
    _, jlast = api.prefill(params, _jax(batch), cfg, max_len=max_len)
    _, tlast = tapi.prefill(tp, _torch(batch), tcfg, max_len=max_len)
    _close_greedy(jlast, tlast)

    chunk = np.random.RandomState(3).randint(0, cfg.vocab, (2, 3))
    jc, jl = api.extend(params, jc, jnp.asarray(chunk, jnp.int32), cfg)
    tc, tl = tapi.extend(tp, tc, torch.from_numpy(chunk), tcfg)
    _close_greedy(jl, tl)
    tok = np.asarray(jl[:, -1]).argmax(-1)
    for _ in range(4):
        jc, jl = api.decode(params, jc, jnp.asarray(tok, jnp.int32), cfg)
        tc, tl = tapi.decode(tp, tc, torch.from_numpy(tok), tcfg)
        _close_greedy(jl, tl)
        tok = np.asarray(jl).argmax(-1)
    assert tc["len"].tolist() == [S + 7] * 2
    for name in leaves:
        _close(jc["scan"][name], tc[name])


@pytest.mark.parametrize("arch", ["internvl2-1b", "rhapsody-demo"])
def test_prefill_past_max_len_raises_as_reference(arch):
    """Finding (c): a vision prefix plus a bucket past ``max_len`` does not
    fit the cache; the reference's pad fails, and the port raises where a
    negative ``F.pad`` would crop the cache (a plain prompt past
    ``max_len`` too)."""
    cfg, api, params, tcfg, tp = build(arch=arch)
    batch = _batch(cfg, 1, 12, seed=4)
    del batch["targets"], batch["loss_mask"]
    max_len = (cfg.vision_tokens or 0) + 8
    with pytest.raises(ValueError):
        api.prefill(params, _jax(batch), cfg, max_len=max_len)
    with pytest.raises(ValueError, match="does not fit"):
        get_model(tcfg).prefill(tp, _torch(batch), tcfg, max_len=max_len)


ENGINE_KW = dict(max_num_seqs=3, max_num_batched_tokens=256, max_len=64,
                 prefill_buckets=(16, 32), seed=0)


def test_slot_engine_matches_reference(lm):
    """Greedy transcripts and counters through the slot pool on the same
    weights: 4 requests over 3 slots (prompts of 3, 8, 20 and 40 tokens;
    the VLM's first two no longer than its 8-token prefix, finding (b);
    whisper's 64 zero frames padded to 1500 cross positions, finding (a)),
    then a short request beside a long one whose free slot decodes past
    the learned table's ``max_seq`` (128).  ``make_engine_from_scratch``
    builds a serving engine for both families too."""
    cfg, _, params, tcfg, tp = lm
    rng = np.random.RandomState(5)
    prompts = [list(rng.randint(0, cfg.vocab, size=n)) for n in (3, 8, 20,
                                                                 40)]

    def run(mk):
        eng = mk(**ENGINE_KW)
        uids = [eng.submit(p, max_new_tokens=5) for p in prompts]
        done = eng.run()
        outs = [done[u].output for u in uids]
        uids = [eng.submit(prompts[3], max_new_tokens=2),
                eng.submit(prompts[0], max_new_tokens=100)]
        done = eng.run()
        return eng, outs + [done[u].output for u in uids]

    ref_eng, ref_out = run(lambda **kw: JaxEngine(cfg, params, paged=False,
                                                  **kw))
    eng, out = run(lambda **kw: InferenceEngine(tcfg, tp, device="cpu",
                                                paged=False, **kw))
    assert out == ref_out
    assert [len(o) for o in out] == [5] * 4 + [2, 100]
    for name in ("steps", "prefill_tokens", "decode_tokens",
                 "active_slot_steps", "slot_steps"):
        assert getattr(eng.stats, name) == getattr(ref_eng.stats, name), name
    lens = eng.pool.cache["len"].tolist()
    assert lens == np.asarray(ref_eng.pool.cache["scan"]["len"][0]).tolist()
    assert max(lens) > cfg.max_seq
    if cfg.family == "encdec":
        assert eng.pool.cache["cross_k"].shape[2] == WHISPER_FRAMES
    scratch = make_engine_from_scratch(tcfg, device="cpu", **ENGINE_KW)
    scratch.submit(prompts[1], max_new_tokens=2)
    assert len(scratch.run()) == 1


def test_loss_gradients_match_reference(lm):
    cfg, api, params, tcfg, tp = lm
    batch = _batch(cfg, 2, 10, seed=6)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: api.loss(p, _jax(batch), cfg), has_aux=True))(params)
    tp = _fresh(tp)
    tloss, _ = get_model(tcfg).loss(tp, _torch(batch), tcfg)
    grads = torch.autograd.grad(tloss, toptim.tree_leaves(tp))
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    _assert_tree_close(jgrads, toptim.tree_unflatten(tp, grads), TOL, TOL)


@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_steps_match_reference(lm, n_micro):
    """Steps 1 and 3 of both packages' AdamW steps on the same weights and
    batches (frontend embeddings split with the tokens into microbatches);
    whisper's parameters agree only if the encoder blocks' 1-D leaves are
    decayed as the reference decays its stacked ``enc_blocks``.  Adam's
    eps is 1e-3: internvl's k bias has an exactly-zero gradient (a shift
    of every key by one vector moves each query's scores by one constant),
    so both packages hold only rounding noise there, which a smaller eps
    turns into full-size steps of either sign."""
    cfg, api, params, tcfg, tp = lm
    opt = joptim.OptimizerConfig(lr=1e-3, eps=1e-3, warmup_steps=1,
                                 decay_steps=10)
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
        batch = _batch(cfg, 2, 8, seed=10 + i)
        jstate, jm = jstep(jstate, _jax(batch))
        tstate, tm = tstep(tstate, _torch(batch))
        for key in ("loss", "grad_norm", "lr", "ce"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-5)
        if i in (0, 2):
            _assert_tree_close(jstate["params"], tstate["params"], 2e-3,
                               2e-5)


def test_adamw_decays_the_encoder_blocks_by_rank(whisper):
    """With zero gradients only the decay moves a parameter: the reference
    decays every leaf of the stacked ``blocks`` and ``enc_blocks`` (their
    1-D norm scales and biases too) and the 2-D position table, and no
    top-level 1-D leaf (``ln_f``, ``enc_ln_f``)."""
    cfg, _, params, tcfg, tp = whisper
    opt = joptim.OptimizerConfig(lr=0.1, weight_decay=0.5, warmup_steps=1)
    zeros = jax.tree.map(jnp.zeros_like, params)
    jnew, _, _ = jax.jit(lambda g, s, p: joptim.adamw_update(g, s, p, opt))(
        zeros, joptim.adamw_init(params, opt), params)
    topt = toptim.OptimizerConfig(**vars(opt))
    tparams = _fresh(tp)
    toptim.adamw_update(toptim.tree_map(torch.zeros_like, tparams),
                        toptim.adamw_init(tparams, topt), tparams, topt)
    _assert_tree_close(jnew, tparams, 1e-6, 1e-7)
    for path, leaf in toptim.named_leaves(tparams):
        assert toptim.decays(path, leaf) == (
            path[0] in ("blocks", "enc_blocks") or leaf.dim() >= 2), path


def test_make_batch_draws_the_frontend_stubs():
    """frames [B, seq, d] and patches [B, vision_tokens, d] by default,
    ``frontend_len`` of either on request; N(0, 1) x 0.02."""
    for arch, name, n in (("whisper-small", "frame_embeds", 12),
                          ("internvl2-1b", "patch_embeds", 8)):
        cfg = get_smoke_config(arch)
        gen = torch.Generator().manual_seed(0)
        batch = make_batch(cfg, 2, 12, gen, device="cpu")
        assert tuple(batch[name].shape) == (2, n, cfg.d_model)
        assert 0.01 < float(batch[name].std()) < 0.03
        short = make_batch(cfg, 2, 12, gen, device="cpu", frontend_len=5)
        assert short[name].shape[1] == 5


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_serves_on_cpu(arch, capsys):
    out = launch_serve.main(["--device", "cpu", "--arch", arch,
                             "--requests", "4", "--max-new-tokens", "4"])
    assert len(out["results"]) == 4
    assert all(len(r["tokens"]) == 4 for r in out["results"])
    assert out["errors"] == [None, None]
    assert f"[serve] {arch} x 2 replicas ready" in capsys.readouterr().out


def test_train_launcher_on_cpu(capsys):
    """internvl2-1b trains text-only, as the reference's launcher does;
    whisper-small's token batches carry no ``frame_embeds``, and the port
    says so where the reference fails with ``KeyError: 'frame_embeds'``."""
    out = launch_train.main(["--device", "cpu", "--arch", "internvl2-1b",
                             "--steps", "3", "--log-every", "1"])
    assert out["steps"] == 3 and np.isfinite(out["losses"]).all()
    assert "arch=internvl2-1b" in capsys.readouterr().out
    with pytest.raises(KeyError, match="frame_embeds"):
        launch_train.main(["--device", "cpu", "--arch", "whisper-small",
                           "--steps", "1"])
