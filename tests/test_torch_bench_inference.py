"""The port's exp3 bench (``benchmarks_torch/bench_inference_scaling.py``)
against the reference's (``benchmarks/bench_inference_scaling.py``) on the
CPU, on the same weights: the baseline configs' rows and request counts,
the paged comparison's block accounting and transcripts, the paged
service's telemetry, the recompute fallback, a disaggregated pair, the
identity-padded speculative target and the three streams, the autoscale
and multi-model scenarios on the copied middleware, and each ``--json``
mode's row keys.  No assertion reads a clock: the timing gates of
``benchmarks/check_bench_json.py`` are the card's to judge.  Also the
extend path's drop of writes past the cache, which the disaggregation
scenario's reference engine reaches."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import build, dense_cfg  # noqa: E402
from benchmarks import bench_inference_scaling as jbench  # noqa: E402
from benchmarks_torch import bench_inference_scaling as bench  # noqa: E402
from repro.core.request import InferenceRequest as JaxEnvelope  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.serving.client import llm_service_factory as jfactory  # noqa: E402
from repro.serving.engine import InferenceEngine as JaxEngine  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serving.engine import InferenceEngine  # noqa: E402

CPU = "cpu"
# fields of a row that read a clock
CLOCKED = {"seconds", "tokens_per_s", "decode_tokens_per_s",
           "generated_tokens_per_s", "utilization", "speedup_vs_vanilla",
           "ttft_p95_ms", "itl_p95_ms", "ttft_speedup", "itl_speedup"}
# keys the port's baseline row adds to the reference's
BASELINE_EXTRA = {"generated_tokens_per_s", "generated_tokens",
                  "decode_steps"}


@pytest.fixture(scope="module")
def lm():
    """The reference's demo config and its seed-0 weights, both packages'
    (every reference engine of the bench draws these)."""
    return build(dense_cfg())


def _unclocked(row):
    return {k: v for k, v in row.items() if k not in CLOCKED}


@pytest.mark.parametrize("n_replicas,cpc", [(1, 2), (2, 1)])
def test_run_config_rows_match_reference(lm, n_replicas, cpc):
    _, _, _, tcfg, tparams = lm
    got = bench.run_config(n_replicas, cpc, reqs_per_client=3,
                           device=CPU, cfg=tcfg, params=tparams)
    want = jbench.run_config(n_replicas, cpc, reqs_per_client=3)
    assert set(got) == set(want) | BASELINE_EXTRA
    for k in ("replicas", "clients", "requests"):
        assert got[k] == want[k]
    assert got["requests"] == n_replicas * cpc * 3
    assert sum(got["per_replica_requests"]) == got["requests"]
    assert len(got["per_replica_requests"]) == n_replicas
    assert got["generated_tokens"] == 8 * got["requests"]
    assert got["decode_steps"] > 0 and 0 < got["utilization"] <= 1


def test_paged_compare_matches_reference(lm, monkeypatch):
    """Every unclocked field of the three rows equals the reference's, and
    each engine's transcripts (stem, then the branches) are the
    reference's."""
    _, _, _, tcfg, tparams = lm
    ref_outs = []
    drive = jbench._drive

    def recording(eng, prompts, new_tokens):
        outs, peak = drive(eng, prompts, new_tokens)
        ref_outs.append(outs)
        return outs, peak

    monkeypatch.setattr(jbench, "_drive", recording)
    want = jbench.run_paged_compare()
    rows, runs = bench.paged_compare(device=CPU, cfg=tcfg, params=tparams)
    assert [set(r) for r in rows] == [set(r) for r in want]
    assert [_unclocked(r) for r in rows] == [_unclocked(r) for r in want]
    assert all(r["tokens_match"] for r in rows)
    for i, (name, _) in enumerate(bench.PAGED_VARIANTS):
        assert runs[name]["outs"] == ref_outs[2 * i] + ref_outs[2 * i + 1]
    # the three engines serve one weight set
    assert all(run["engine"].params is tparams for run in runs.values())


def test_paged_service_matches_reference(lm):
    _, _, _, tcfg, tparams = lm
    got = bench.run_paged_service(device=CPU, cfg=tcfg, params=tparams)
    want = jbench.run_paged_service()
    assert got == want


def _reference_fallback_row(cfg, params, *, n_handoffs=3, prompt_len=24,
                            new_tokens=6):
    """The fallback scenario on the reference's servicers, driven through
    the keys they read: a prefill step's ``"handoff_export"`` offered on
    an envelope's ``handoff`` (the reference bench's own drive reads
    ``"_handoff"`` and submits an ``"_import"`` payload key, so it hands
    nothing off)."""
    import random

    kw = dict(max_num_seqs=4, max_len=64, prefill_buckets=(16, 32),
              paged=True, block_size=8)
    pre = jfactory(cfg, params, phase="prefill", max_num_batched_tokens=256,
                   **kw)()
    dec = jfactory(cfg, params, phase="decode", num_blocks=9,
                   max_num_batched_tokens=64, **kw)()
    rng = random.Random(2)
    prompts = [[rng.randrange(1, cfg.vocab) for _ in range(prompt_len)]
               for _ in range(n_handoffs)]
    ref = JaxEngine(cfg, params, seed=0, max_num_batched_tokens=256, **kw)
    uids = [ref.submit(p, max_new_tokens=new_tokens) for p in prompts]
    done = ref.run()
    ref_out = {tuple(p): done[u].output for p, u in zip(prompts, uids)}
    occ = dec.submit({"prompt": [3] * 30, "max_new_tokens": 30})
    dec.step()
    for p in prompts:
        pre.submit({"prompt": p, "max_new_tokens": new_tokens})
    handoffs = []
    while len(handoffs) < n_handoffs:
        handoffs += [r["handoff_export"] for _, r in pre.step()
                     if r.get("handoff_export") is not None]
    for pay in handoffs:
        payload = {"prompt": list(pay["prompt"])}
        dec.submit(payload, envelope=JaxEnvelope(payload=payload,
                                                 handoff=pay))
    results = {}
    while len(results) < n_handoffs + 1:
        results.update(dec.step())
    hs = dec.handoff_stats()
    match = all(any(r["tokens"] == ref_out[tuple(pay["prompt"])]
                    and r.get("recompute")
                    for u, r in results.items() if u != occ)
                for pay in handoffs)
    return {"scenario": "disagg_fallback", "exports": n_handoffs,
            "imports": hs["imports"], "recomputes": hs["recomputes"],
            "completed": len(results), "tokens_match": match}


def test_disagg_fallback_matches_reference_servicers(lm):
    cfg, _, params, tcfg, tparams = lm
    (got,) = bench.run_disagg_fallback(device=CPU, cfg=tcfg, params=tparams)
    want = _reference_fallback_row(cfg, params)
    assert got == want
    assert got == {"scenario": "disagg_fallback", "exports": 3,
                   "imports": 0, "recomputes": 3, "completed": 4,
                   "tokens_match": True}


DISAGG_COMPARE_KEYS = {
    "scenario", "mode", "replicas", "requests", "n_long", "n_chat",
    "long_len", "chat_len", "unified_budget", "prefill_budget",
    "ttft_p95_ms", "itl_p95_ms", "tokens_match", "wrong_role", "handoffs",
    "recomputes", "per_group"}


def test_disagg_pair_hands_every_request_off(lm):
    """Two replicas, a smaller load: greedy tokens equal to one engine's,
    every disaggregated request finished on the decode replica through a
    handoff, and phase-pure latency windows; the rows carry the keys the
    reference's ``run_disagg`` writes (its ``return`` dicts)."""
    _, _, _, tcfg, tparams = lm
    uni, dis = bench.run_disagg(n_replicas=2, n_long=3, n_chat=4,
                                device=CPU, cfg=tcfg, params=tparams)
    assert set(uni) == DISAGG_COMPARE_KEYS
    assert set(dis) == DISAGG_COMPARE_KEYS | {"ttft_speedup", "itl_speedup"}
    for r in (uni, dis):
        assert r["tokens_match"] and r["wrong_role"] == 0
        assert r["requests"] == 7
    assert dis["handoffs"] >= dis["requests"] and dis["recomputes"] == 0
    roles = {gs["role"]: gs for gs in dis["per_group"].values()}
    assert roles["prefill"]["itl_p95_ms"] is None
    assert roles["prefill"]["ttft_p95_ms"] is not None
    assert roles["prefill"]["handoff_exports"] > 0
    assert roles["decode"]["ttft_p95_ms"] is None
    assert roles["decode"]["itl_p95_ms"] is not None


def test_disagg_row_keys_are_the_references():
    """The reference's ``run_disagg`` rows, read from its source: the
    literal keys of its ``one_mode`` row plus the two speedups."""
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(jbench.run_disagg))
    rows = [n for n in ast.walk(tree) if isinstance(n, ast.Dict)
            and any(isinstance(k, ast.Constant) and k.value == "scenario"
                    for k in n.keys)]
    assert len(rows) == 1
    assert {k.value for k in rows[0].keys} == DISAGG_COMPARE_KEYS


def _spec_weights(layers_target=3):
    """The reference's three draws (draft seed 0, target seed 1,
    adversarial draft seed 7) in both packages."""
    d = build(jbench._spec_cfg(1), seed=0)
    t = build(jbench._spec_cfg(layers_target), seed=1)
    bad = build(jbench._spec_cfg(1), seed=7)
    return d, t, bad


def test_identity_padded_target_computes_the_drafts_logits():
    (_, _, _, dcfg, dparams), (_, _, _, tcfg, tparams), _ = _spec_weights()
    o_before = tparams["blocks"][1]["attn"]["o"]["w"].clone()
    padded = bench._identity_padded(dparams, tparams, 1)
    api = get_model(tcfg)
    tokens = torch.tensor([[5, 17, 300, 2, 44, 9, 81]])
    _, want = api.prefill(dparams, {"tokens": tokens}, dcfg, max_len=16)
    _, got = api.prefill(padded, {"tokens": tokens}, tcfg, max_len=16)
    assert torch.equal(got, want)
    assert len(padded["blocks"]) == tcfg.n_layers == 3
    assert padded["blocks"][0] is dparams["blocks"][0]
    for bp in padded["blocks"][1:]:
        assert not bp["attn"]["o"]["w"].any()
        assert not bp["mlp"]["down"]["w"].any()
    # the target's own weights are left as they were
    assert torch.equal(tparams["blocks"][1]["attn"]["o"]["w"], o_before)


def test_speculative_streams_match_reference_at_reduced_depth():
    d, t, bad = _spec_weights()
    kw = dict(k=4, target_layers=3, draft_layers=1, new_tokens=8, repeats=1)
    rows = bench.run_speculative(device=CPU, draft_params=d[4],
                                 target_params=t[4], bad_draft_params=bad[4],
                                 **kw)
    want = jbench.run_speculative(**kw)
    assert [set(r) for r in rows] == [set(r) for r in want]
    by = {r["stream"]: r for r in rows}
    ref = {r["stream"]: r for r in want}
    assert all(r["tokens_match"] for r in rows)
    hi, lo = by["high_acceptance"], by["low_acceptance"]
    assert hi["proposed"] == ref["high_acceptance"]["proposed"] > 0
    assert hi["accepted"] == hi["proposed"] and hi["enabled"] is True
    assert by["vanilla"]["proposed"] == 0
    assert lo["enabled"] is False
    assert lo["proposed"] == ref["low_acceptance"]["proposed"]


def test_autoscale_saturate_is_denied_on_the_ledger():
    got = bench.run_autoscale("queue_depth", "saturate", warm_s=0.3,
                              heavy_s=2.5)
    want = jbench.run_autoscale("queue_depth", "saturate", warm_s=0.1,
                                heavy_s=0.3)
    assert set(got) == set(want)
    assert got["service_replicas"] == got["final_replicas"]
    assert got["service_cores"] == got["final_replicas"]
    assert got["final_replicas"] == got["capacity"]
    assert got["admission_denied"] > 0 and got["requests"] > 0


def test_multi_model_routes_by_group_on_one_ledger():
    rows = bench.run_multi_model(warm_s=0.3, shift_s=3.0)
    want = jbench.run_multi_model(warm_s=0.1, shift_s=0.3)
    assert [set(r) for r in rows] == [set(r) for r in want]
    assert {r["group"] for r in rows} == {"alpha", "beta"}
    for r in rows:
        assert r["wrong_route"] == 0 and r["requests"] > 0
    ledger = {r["ledger_service_cores"] for r in rows}
    assert len(ledger) == 1
    assert sum(r["service_cores"] for r in rows) == ledger.pop()


def test_extend_past_the_cache_drops_writes_as_reference(lm):
    """A padded chunk whose tail runs past the cache: the reference's
    ``.at[].set`` drops those writes; the port's extend drops them too
    (it raised ``IndexError``).  Rows reaching past Smax and one that ends
    on its last row, so the last row's own entry survives the drop."""
    cfg, _, params, tcfg, tparams = lm
    B, T, Smax = 3, 8, 24
    rng = np.random.RandomState(0)
    x = rng.randn(B, T, cfg.d_model).astype(np.float32)
    ck = rng.randn(B, Smax, cfg.n_kv_heads, cfg.head_dim).astype(np.float32)
    cv = rng.randn(*ck.shape).astype(np.float32)
    lens = np.array([Smax - 3, 2, Smax - T], np.int32)
    j_out, j_k, j_v, j_len = jattn.attention_extend(
        jax.tree.map(lambda a: a[0], params["blocks"])["attn"],
        jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(lens),
        cfg)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    t_out, t_k, t_v, t_len = tattn.attention_extend(
        tparams["blocks"][0]["attn"], torch.from_numpy(x), tk, tv,
        torch.from_numpy(lens), tcfg)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=1e-5)
    np.testing.assert_allclose(t_k.numpy(), np.asarray(j_k), atol=1e-5)
    np.testing.assert_allclose(t_v.numpy(), np.asarray(j_v), atol=1e-5)
    assert t_len.tolist() == np.asarray(j_len).tolist()
    # rows the chunk never reached are untouched
    assert np.array_equal(t_k.numpy()[1, 2 + T:], ck[1, 2 + T:])


def test_chunk_past_max_len_serves_as_reference(lm):
    """The paged engine of the disaggregation scenario's reference run
    (max_len 128, buckets up to 128, budget 256): four 96-token prompts
    and a chat prompt in one step leave a chunk of 80 tokens at position
    16, padded to 128, past the view's end.  Transcripts equal the
    reference engine's."""
    cfg, _, params, tcfg, tparams = lm
    kw = dict(seed=0, max_num_seqs=8, max_len=128, paged=True, block_size=8,
              num_blocks=160, max_num_batched_tokens=256,
              prefill_buckets=(16, 32, 64, 128))
    rng = np.random.RandomState(1)
    prompts = [list(map(int, rng.randint(1, cfg.vocab, size=n)))
               for n in (8, 96, 96, 96, 96)]
    outs = {}
    for name, eng in (("jax", JaxEngine(cfg, params, **kw)),
                      ("torch", InferenceEngine(tcfg, tparams, device=CPU,
                                                **kw))):
        uids = [eng.submit(p, max_new_tokens=6) for p in prompts]
        done = eng.run()
        outs[name] = [done[u].output for u in uids]
    assert outs["torch"] == outs["jax"]
