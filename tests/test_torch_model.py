"""The port's dense LM against the JAX package's on the same weights:
the weight bridge, then ``prefill`` / ``extend_step`` / ``decode_step`` /
``paged_decode_step`` logits at atol = rtol = 1e-4 in float32 (matmul sums
taken in another order) with identical greedy tokens, on the rhapsody-demo
and llama3.2-3b smoke configs; a 4096-token prefill on the chunked path
that the reference takes above 2048 positions.  Inputs are made with numpy from a seed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import build  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serving.sampling import filter_logits, sample  # noqa: E402

TOL = 1e-4
ARCHS = ["rhapsody-demo", "llama3.2-3b"]


@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    return build(arch=request.param)


def _close(a, b):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(b.argmax(-1), a.argmax(-1))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_weight_bridge(lm):
    """Layouts carry over unchanged ([d_in, d_out]; stacked layers
    unstacked), and the port's own init draws the same structure."""
    cfg, _, params, tcfg, tp = lm
    ref = jax.tree.map(np.asarray, params)
    np.testing.assert_array_equal(tp["embed"]["table"].numpy(),
                                  ref["embed"]["table"])
    np.testing.assert_array_equal(tp["unembed"]["w"].numpy(),
                                  ref["unembed"]["w"])
    assert len(tp["blocks"]) == cfg.n_layers
    for i, layer in enumerate(tp["blocks"]):
        for name in ("q", "k", "v", "o"):
            np.testing.assert_array_equal(layer["attn"][name]["w"].numpy(),
                                          ref["blocks"]["attn"][name]["w"][i])
        np.testing.assert_array_equal(layer["mlp"]["gate"]["w"].numpy(),
                                      ref["blocks"]["mlp"]["gate"]["w"][i])
    gen = torch.Generator().manual_seed(0)
    mine = get_model(tcfg).init(gen, tcfg, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path
    ref_shapes = {jax.tree_util.keystr(k): v.shape[1:] if "blocks" in
                  jax.tree_util.keystr(k) else v.shape
                  for k, v in flat(ref)[0]}
    my_shapes = {jax.tree_util.keystr(k): tuple(v.shape)
                 for k, v in flat({**mine, "blocks": mine["blocks"][0]})[0]}
    assert my_shapes == ref_shapes
    o = mine["blocks"][0]["attn"]["o"]["w"]
    assert abs(o.std().item() * np.sqrt(tcfg.n_heads * tcfg.head_dim) - 1) \
        < 0.2
    assert abs(mine["embed"]["table"].std().item() - 1) < 0.1



@pytest.mark.parametrize("arch", ["llama3.2-3b", "rwkv6-1.6b",
                                  "zamba2-2.7b"])
def test_init_and_weight_bridge_default_to_the_card(arch, monkeypatch):
    """With no ``device``, ``init`` and ``params_from_numpy`` go to the CUDA
    card, as the port's other entry points do: without one they raise
    ``RuntimeError``; ``device="cpu"`` asks for the CPU."""
    from repro_torch.models.convert import params_from_numpy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config(arch)
    api = get_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.init(torch.Generator().manual_seed(0), cfg)
    params = api.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    tree = {k: v for k, v in params.items() if k not in ("blocks", "groups")}
    tree = {k: {n: t.float().numpy() for n, t in v.items()}
            for k, v in tree.items() if k in ("embed", "ln_f")}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy(tree, cfg)
    assert params_from_numpy(tree, cfg, device="cpu")["embed"][
        "table"].device.type == "cpu"

def test_prefill_decode_extend_match_reference(lm):
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
    np.testing.assert_allclose(tc["k"].numpy(),
                               np.asarray(jc["scan"]["k"]), rtol=TOL,
                               atol=TOL)
    assert tc["len"].tolist() == np.asarray(jc["scan"]["len"][0]).tolist()


def test_long_prefill_takes_the_chunked_path():
    """Above 2048 positions the reference's ``_pick_impl`` prefills with
    block-wise chunked attention: at S 4096 the port's prefill equals the
    reference's (logits and cache), ``attention_impl="full"`` and
    ``"chunked"`` are honored and agree, and on meta the largest score
    tensor of the default path is one query block's [B, H, block_q,
    kv_len], never the whole [B, H, S, S]."""
    from repro_torch.launch import cost, specs

    cfg, api, params, tcfg, tp = build(arch="llama3.2-3b")
    tapi = get_model(tcfg)
    S, bq = 4096, tcfg.attn_chunk_q
    toks = np.random.RandomState(6).randint(0, cfg.vocab, size=(1, S))
    toks = toks.astype(np.int32)
    jc, jl = jax.jit(lambda p, t: api.prefill(p, {"tokens": t}, cfg,
                                               max_len=S))(
        params, jnp.asarray(toks))
    outs = {}
    for impl in ("auto", "full", "chunked"):
        c = tcfg.scaled(attention_impl=impl)
        with torch.no_grad():
            outs[impl] = tapi.prefill(tp, {"tokens": _t(toks)}, c, max_len=S)
    tc, tl = outs["auto"]
    _close(jl, tl)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["scan"]["k"]),
                               rtol=TOL, atol=TOL)
    _close(outs["full"][1].numpy(), outs["chunked"][1])

    def largest(impl):
        c = tcfg.scaled(attention_impl=impl)
        b = specs.prefill_batch_specs(c, 1, S)
        with torch.no_grad():
            counter = cost.run(lambda p, b: tapi.prefill(p, b, c, max_len=S),
                               specs.abstract_params(tapi, c)[0], b)[1]
        return counter.largest

    H = tcfg.n_heads  # the einsum's bmm folds B and H: [B*H, q, k]
    for impl in ("auto", "chunked"):
        nbytes, shape, dtype, _ = largest(impl)
        assert (nbytes, shape[-2:], dtype) == (
            H * bq * S * 4, (bq, S), "torch.float32"), shape
    assert largest("full")[:2] == (H * S * S * 4, (H, S, S))


def _paged_inputs(cfg, seed):
    rng = np.random.RandomState(seed)
    L, N, bs, mb, B = cfg.n_layers, 24, 4, 5, 3
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
    return ks, vs, bt, lens, toks, wphys, woff


@pytest.mark.parametrize("jax_impl", ["auto", "pallas"])
def test_paged_decode_step_matches_reference(lm, jax_impl):
    """``paged_decode_step`` logits and store writes vs the reference; with
    ``attention_impl="pallas"`` the reference runs its Pallas kernel in
    interpret mode."""
    cfg, _, params, tcfg, tp = lm
    jcfg = cfg.scaled(attention_impl=jax_impl)
    japi = jax_get_model(jcfg)
    ks, vs, bt, lens, toks, wphys, woff = _paged_inputs(cfg, 1)
    store = {"scan": {"k": jnp.asarray(ks), "v": jnp.asarray(vs),
                      "len": jnp.zeros(ks.shape[:2], jnp.int32)}}
    jstore, jl = japi.decode_paged(params, store, *(jnp.asarray(a) for a in (
        bt, lens, toks, wphys, woff)), jcfg)
    tstore = {"k": _t(ks.copy()), "v": _t(vs.copy())}
    tstore, tl = get_model(tcfg).decode_paged(
        tp, tstore, _t(bt), _t(lens), _t(toks).long(), _t(wphys).long(),
        _t(woff).long(), tcfg)
    _close(jl, tl)
    np.testing.assert_allclose(tstore["k"].numpy(),
                               np.asarray(jstore["scan"]["k"]), rtol=TOL,
                               atol=TOL)


def test_chunked_extend_equals_full_prefill(lm):
    """A prompt fed in chunks gives the cache and final logits of one full
    prefill (masked softmax columns underflow to exact zeros; the tolerance
    covers float32 matmuls run at other shapes, which the CPU BLAS sums
    in another order)."""
    _, _, _, tcfg, tp = lm
    tapi = get_model(tcfg)
    rng = np.random.RandomState(2)
    prompt = _t(rng.randint(0, tcfg.vocab, size=(1, 13))).long()
    full_cache, full = tapi.prefill(tp, {"tokens": prompt}, tcfg, max_len=32)
    shape = (tcfg.n_layers, 1, 32, tcfg.n_kv_heads, tcfg.head_dim)
    cache = {"k": torch.zeros(shape), "v": torch.zeros(shape),
             "len": torch.zeros(1, dtype=torch.int32)}
    for a, b in ((0, 4), (4, 9), (9, 13)):
        cache, logits = tapi.extend(tp, cache, prompt[:, a:b], tcfg)
    torch.testing.assert_close(logits[:, -1], full, rtol=1e-5, atol=1e-5)
    assert int(logits[0, -1].argmax()) == int(full[0].argmax())
    torch.testing.assert_close(cache["k"], full_cache["k"], rtol=1e-5,
                               atol=1e-5)


def test_decode_at_a_full_cache_matches_reference():
    """A decode step whose length has reached max_len: the reference's
    ``.at[].set`` drops the out-of-range K/V write and its mask admits every
    position, so the step returns logits and leaves the cache as it was.
    The port does the same (it used to raise ``IndexError``)."""
    cfg, api, params, tcfg, tp = build()
    toks = np.random.RandomState(5).randint(0, cfg.vocab, size=(2, 8))
    jc, jl = api.prefill(params, {"tokens": jnp.asarray(toks, jnp.int32)},
                         cfg, max_len=8, last_only=True)
    tapi = get_model(tcfg)
    tc, _ = tapi.prefill(tp, {"tokens": _t(toks).long()}, tcfg, max_len=8)
    before = {name: tc[name].clone() for name in ("k", "v")}
    nxt = np.asarray(jl).argmax(-1)
    jc, jl = api.decode(params, jc, jnp.asarray(nxt, jnp.int32), cfg)
    tc, tl = tapi.decode(tp, tc, _t(nxt).long(), tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    for name in ("k", "v"):
        assert torch.equal(tc[name], before[name])
        np.testing.assert_allclose(tc[name].numpy(),
                                   np.asarray(jc["scan"][name]), rtol=1e-5,
                                   atol=1e-5)
    assert tc["len"].tolist() == np.asarray(jc["scan"]["len"][0]).tolist() \
        == [9, 9]


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "rwkv6-1.6b",
                                  "zamba2-2.7b", "whisper-small",
                                  "internvl2-1b"])
def test_every_family_gets_its_api(arch):
    """Every family is ported.  MoE, encdec (whisper) and vlm (internvl)
    serve and train through the transformer's API; encdec and vlm run only
    on the slot pool, so their ``decode_paged`` goes unused, as the
    reference notes (``src/repro/models/__init__.py``).  rwkv6 and zamba2
    serve and train: ``get_model`` returns their family's API (no paged
    entry points, as in the reference), its ``loss`` the family's own."""
    cfg = get_smoke_config(arch)
    api = get_model(cfg)
    if cfg.family in ("moe", "encdec", "vlm"):
        assert api.loss.__module__ == "repro_torch.models.transformer"
        assert api.prefill.__module__ == "repro_torch.models.transformer"
        assert api.extend is not None and api.decode_paged is not None
        return
    module = {"ssm": "rwkv6", "hybrid": "mamba2"}[cfg.family]
    assert api.prefill.__module__ == f"repro_torch.models.{module}"
    assert api.decode.__module__ == f"repro_torch.models.{module}"
    assert api.extend is None and api.decode_paged is None
    assert api.loss.__module__ == f"repro_torch.models.{module}"
    assert api.loss.__name__ == {"ssm": "rwkv_loss",
                                 "hybrid": "hybrid_loss"}[cfg.family]


def test_sampling_filters_and_greedy():
    """Greedy takes the first maximum, as ``jnp.argmax``; top-k=1 and
    top-p=0 leave only the most probable token whatever the generator
    draws."""
    rng = np.random.RandomState(3)
    logits = _t(rng.randn(4, 50).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    greedy = sample(logits, gen)
    for kw in ({"top_k": 1}, {"top_p": 0.0}):
        for _ in range(5):
            assert sample(logits, gen, temperature=1.3, **kw).tolist() == \
                greedy.tolist()
    kept = filter_logits(logits, temperature=1.0, top_k=5)
    assert (torch.isfinite(kept).sum(-1) == 5).all()
    tied = logits.clone()
    tied[1, 7] = tied[1, 9] = tied[1].max() + 1.0
    assert sample(tied, gen).tolist() == np.asarray(
        jnp.argmax(jnp.asarray(tied.numpy()), -1)).tolist()
    assert sample(tied, gen)[1] == 7
