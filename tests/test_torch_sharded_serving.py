"""The port's serving under a device mesh against the JAX package's
unsharded serving.

Four gloo processes on the CPU (one spawn for the module;
``tests/_torch_mesh_ranks.py``) run every case on a 2 x 2 ``("data",
"model")`` mesh: the parameters placed by ``SERVE_RULES``, the cache laid
out by ``cache_specs`` (the KV sequence over "model", so each rank's
decode attends its half and the halves are combined by their
log-sum-exp), the paged store by its kv heads over "model".  Each family's
smoke config (rhapsody-demo dense with TP, deepseek-moe-16b with EP,
zamba2-2.7b, rwkv6-1.6b, whisper-small): ``prefill``, an ``extend`` chunk
(the transformer families) and three greedy ``decode_step``s, and
rhapsody-demo's ``paged_decode_step``, held against ``repro``'s
unsharded functions on the same weights (float32 logits within 1e-5,
greedy tokens equal).  The paged engine (rhapsody-demo; decoding on
the store and through a gathered view) and the slot engine (zamba2) on 2
x 2 serve the same requests as on one device and as
``repro``'s engine: transcripts, counters and block telemetry equal, and
equal on every rank.  The plain decode's log-sum-exp combine over two
halves of a cache equals the whole cache, a half with no valid position
included.
"""
import dataclasses

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
from repro.serving.engine import InferenceEngine as JaxEngine  # noqa: E402

TOL = 1e-5
B, S, T, STEPS, MAX_LEN = 4, 16, 8, 3, 64
BLOCK = 8
MOE = "deepseek-moe-16b"

# (id, arch, cfg overrides, extend, paged)
CASES = [
    ("rhapsody-tp", "rhapsody-demo", dict(explicit_tp=True), True, True),
    ("deepseek-ep", MOE, {}, True, False),
    ("zamba2", "zamba2-2.7b", {}, False, False),
    ("rwkv6", "rwkv6-1.6b", {}, False, False),
    ("whisper", "whisper-small", {}, True, False),
]
FRAMES = 24  # whisper's stubbed frames (even: split over "model")
PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], [3] * 12, [11, 12, 13, 14],
           [5, 6], [2, 4, 6, 8, 10, 12], [9] * 7, [13, 1, 13]]
ENGINE_KW = dict(max_num_seqs=4, max_num_batched_tokens=128, max_len=64,
                 prefill_buckets=(16, 32), seed=0)
# (id, arch, paged, paged decode mode): the paged engine decodes on the
# store ("direct") or through a gathered contiguous view ("gather")
ENGINES = [("engine-paged", "rhapsody-demo", True, "direct"),
           ("engine-paged-gather", "rhapsody-demo", True, "gather"),
           ("engine-slot", "zamba2-2.7b", False, "direct")]


def _weights(cfg, seed=0):
    params, _ = jnn.split(jax_get_model(cfg).init(jax.random.PRNGKey(seed),
                                                  cfg))
    return params


def _batch(cfg, rng):
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "encdec":
        out["frame_embeds"] = (rng.standard_normal((B, FRAMES, cfg.d_model))
                               * 0.02).astype(np.float32)
    return out


def _paged_inputs(cfg, cache, rng):
    """A block store holding the prefill's K/V of every sequence through a
    shuffled block table, and the next STEPS steps' tokens and cells."""
    L = cfg.n_layers
    mb = MAX_LEN // BLOCK
    nb = B * mb + 1
    tables = rng.permutation(np.arange(1, nb)).reshape(B, mb).astype(
        np.int32)
    k = np.asarray(cache["scan"]["k"])
    v = np.asarray(cache["scan"]["v"])
    store = {n: np.zeros((L, nb, BLOCK) + k.shape[3:], np.float32)
             for n in ("k", "v")}
    for b in range(B):
        for pos in range(S):
            blk, off = tables[b, pos // BLOCK], pos % BLOCK
            store["k"][:, blk, off] = k[:, b, pos]
            store["v"][:, blk, off] = v[:, b, pos]
    steps = [S + i for i in range(STEPS)]
    return {"store": store, "tables": tables,
            "lens": np.full((B,), S, np.int32),
            "tokens": [rng.integers(0, cfg.vocab, (B,)).astype(np.int32)
                       for _ in steps],
            "write_phys": [tables[:, p // BLOCK].astype(np.int64)
                           for p in steps],
            "write_off": [np.full((B,), p % BLOCK, np.int64) for p in steps]}


def _reference(cfg, params, case_payload):
    """The reference's unsharded prefill / extend / greedy decodes (and
    paged steps) on the case's inputs."""
    api = jax_get_model(cfg)
    batch = {k: jnp.asarray(v) for k, v in case_payload["batch"].items()}
    out = {"decode": [], "tokens": []}
    cache, logits = api.prefill(params, batch, cfg, max_len=MAX_LEN)
    out["prefill"] = np.asarray(logits)
    if case_payload["extend"] is not None:
        cache, logits = api.extend(params, cache,
                                   jnp.asarray(case_payload["extend"]), cfg)
        out["extend"] = np.asarray(logits)
        tok = np.asarray(logits[:, -1]).argmax(-1)
    else:
        tok = out["prefill"].argmax(-1)
    for _ in range(STEPS):
        out["tokens"].append([int(t) for t in tok])
        cache, logits = api.decode(params, cache,
                                   jnp.asarray(tok, jnp.int32), cfg)
        out["decode"].append(np.asarray(logits))
        tok = out["decode"][-1].argmax(-1)
    return out


def _reference_paged(cfg, params, pg):
    api = jax_get_model(cfg)
    L = cfg.n_layers
    store = {"scan": {"k": jnp.asarray(pg["store"]["k"]),
                      "v": jnp.asarray(pg["store"]["v"]),
                      "len": jnp.zeros((L, 1), jnp.int32)}}
    lens = jnp.asarray(pg["lens"])
    outs = []
    for tok, wp, wo in zip(pg["tokens"], pg["write_phys"], pg["write_off"]):
        store, logits = api.decode_paged(
            params, store, jnp.asarray(pg["tables"]), lens, jnp.asarray(tok),
            jnp.asarray(wp), jnp.asarray(wo), cfg)
        outs.append(np.asarray(logits))
        lens = lens + 1
    return outs


def _engine_run(cfg, params, paged, mode):
    eng = JaxEngine(cfg, params, paged=paged, block_size=BLOCK,
                    paged_decode_mode=mode, **ENGINE_KW)
    uids = [eng.submit(p, max_new_tokens=6) for p in PROMPTS]
    done = eng.run()
    return [done[u].output for u in uids]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks run every case while this process computes the
    reference's side."""
    import threading

    rng = np.random.default_rng(0)
    payloads, refs = [], {}
    for cid, arch, over, ext, paged in CASES:
        cfg = get_smoke_config(arch).scaled(**over)
        params = _weights(cfg)
        pl = {"id": cid, "kind": "serve", "cfg": dataclasses.asdict(cfg),
              "weights": jax.tree.map(np.asarray, params),
              "batch": _batch(cfg, rng),
              "extend": (rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
                         if ext else None),
              "steps": STEPS, "max_len": MAX_LEN}
        refs[cid] = (cfg, params, pl)
        if paged:
            api = jax_get_model(cfg)
            cache, _ = api.prefill(params, {"tokens": jnp.asarray(
                pl["batch"]["tokens"])}, cfg, max_len=MAX_LEN)
            pl["paged"] = _paged_inputs(cfg, cache, rng)
        payloads.append(pl)
    engines = {}
    for cid, arch, paged, mode in ENGINES:
        cfg = get_smoke_config(arch)
        params = _weights(cfg, seed=1)
        engines[cid] = (cfg, params, paged, mode)
        payloads.append({"id": cid, "kind": "engine",
                         "cfg": dataclasses.asdict(cfg),
                         "weights": jax.tree.map(np.asarray, params),
                         "paged": paged, "block_size": BLOCK,
                         "engine_kw": dict(ENGINE_KW,
                                           paged_decode_mode=mode),
                         "prompts": PROMPTS, "new_tokens": 6})
    got = {}
    ranks_run = threading.Thread(target=lambda: got.update(ranks.spawn(
        "serve_steps", {"cases": payloads},
        str(tmp_path_factory.mktemp("serving")))))
    ranks_run.start()
    want = {}
    for cid, (cfg, params, pl) in refs.items():
        want[cid] = _reference(cfg, params, pl)
        if "paged" in pl:
            want[cid]["paged"] = _reference_paged(cfg, params, pl["paged"])
    for cid, (cfg, params, paged, mode) in engines.items():
        want[cid] = _engine_run(cfg, params, paged, mode)
    ranks_run.join()
    assert got, "the ranks returned nothing"
    return want, got


def _ok(got, cid):
    r = got[cid]
    assert "error" not in r, r.get("error")
    return r


def _close(a, b, what):
    np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL, err_msg=what)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_prefill_and_decode_equal_reference(runs, case):
    want, got = runs
    r, w = _ok(got, case[0]), want[case[0]]
    _close(r["prefill"], w["prefill"], "prefill")
    if case[3]:
        _close(r["extend"], w["extend"], "extend")
    assert r["tokens"] == w["tokens"]
    for i, (a, b) in enumerate(zip(r["decode"], w["decode"])):
        _close(a, b, f"decode step {i}")
        assert list(a.argmax(-1)) == list(b.argmax(-1))


def test_paged_decode_equals_reference(runs):
    want, got = runs
    cid = next(c[0] for c in CASES if c[4])
    r, w = _ok(got, cid), want[cid]
    assert len(r["paged"]) == STEPS
    for i, (a, b) in enumerate(zip(r["paged"], w["paged"])):
        _close(a, b, f"paged step {i}")
        assert list(a.argmax(-1)) == list(b.argmax(-1))
    # the store's kv heads lie on "model": each rank holds half of them
    assert r["paged_local_heads"] == get_smoke_config(
        "rhapsody-demo").n_kv_heads // 2


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_cache_is_laid_out_by_cache_specs(runs, case):
    """The cache the steps ran on, laid out by ``cache_specs``' rule after
    the prefill, keeps that layout through the extend and decode steps'
    in-place writes: the batch over "data" and, for K/V, the sequence over
    "model"."""
    _, got = runs
    pl = _ok(got, case[0])["cache_placements"]
    # (data, model) placements of each leaf: the batch's dim, then the
    # dim "model" splits (the K/V sequence, the state's heads, d_in)
    want = {
        "rhapsody-demo": {"k": (1, 2), "v": (1, 2), "len": (0, None)},
        MOE: {"k": (1, 2), "v": (1, 2), "len": (0, None)},
        "whisper-small": {"k": (1, 2), "cross_k": (1, 2), "len": (0, None)},
        "zamba2-2.7b": {"attn/k": (1, 2), "attn/len": (1, None),
                        "ssm/ssm": (2, 3), "ssm/conv/x": (2, 4),
                        "ssm/conv/B": (2, None)},
        "rwkv6-1.6b": {"att/wkv": (1, 2), "att/shift": (1, None),
                       "ffn/shift": (1, None)},
    }[case[1]]
    for leaf, (bdim, mdim) in want.items():
        assert pl[leaf] == [("Shard", bdim),
                            ("Replicate",) if mdim is None
                            else ("Shard", mdim)], leaf


def test_moe_cases_drop_nothing():
    """The decode capacity (factor max(decode, train)) of each data shard's
    tokens covers every assignment: no EP shard can drop a token, so the
    sharded MoE equals the unsharded one."""
    cfg = get_smoke_config(MOE)
    for tokens in (B * S // 2, B * T // 2, B // 2):
        cap = jmoe._capacity(tokens, cfg, True)
        assert cap >= tokens


@pytest.mark.parametrize("cid", [e[0] for e in ENGINES])
def test_engine_on_mesh_equals_one_rank_and_reference(runs, cid):
    want, got = runs
    r = _ok(got, cid)
    assert r["mesh"]["outputs"] == want[cid]
    assert r["mesh"]["outputs"] == r["one"]["outputs"]
    assert r["mesh"]["stats"] == r["one"]["stats"]
    assert r["mesh"]["telemetry"] == r["one"]["telemetry"]
    assert r["ranks_equal"], "the ranks' transcripts or books differ"


def _combine_lse(outs, lses):
    """Shards' outputs [B,Hkv,G,D] with their log-sum-exps [B,Hkv,G] ->
    the whole: sum_r exp(lse_r - lse) out_r, lse = log sum_r exp(lse_r)."""
    lse = torch.stack(lses)
    w = torch.exp(lse - lse.max(dim=0).values)
    out = sum(w_r[..., None] * o for w_r, o in zip(w, outs))
    return out / w.sum(dim=0)[..., None]


def test_plain_decode_lse_combines_halves():
    """``decode_ref``'s (out, lse) over the two halves of a cache,
    combined, equal the whole cache's output; a half with no valid
    position gives 0 and -inf and adds nothing."""
    from repro_torch.kernels.decode_attention import ref

    g = torch.Generator().manual_seed(0)
    Bq, Hkv, G, D, Sc = 3, 2, 2, 16, 32
    q = torch.randn((Bq, Hkv, G, D), generator=g)
    k = torch.randn((Bq, Sc, Hkv, D), generator=g)
    v = torch.randn((Bq, Sc, Hkv, D), generator=g)
    lens = torch.tensor([5, 16, 29], dtype=torch.int32)
    whole, lse = ref.decode_ref(q, k, v, lens, return_lse=True)
    h = Sc // 2
    parts = [ref.decode_ref(q, k[:, j * h:(j + 1) * h],
                            v[:, j * h:(j + 1) * h],
                            (lens - j * h).clamp(0, h).to(torch.int32),
                            return_lse=True) for j in range(2)]
    # the first row's second half holds no valid position
    assert torch.all(parts[1][0][0] == 0)
    assert torch.all(torch.isneginf(parts[1][1][0]))
    got = _combine_lse([o for o, _ in parts], [s for _, s in parts])
    torch.testing.assert_close(got, whole, rtol=TOL, atol=TOL)
    comb = torch.logsumexp(torch.stack([s for _, s in parts]), dim=0)
    torch.testing.assert_close(comb, lse, rtol=TOL, atol=TOL)
    assert not torch.isnan(got).any()
