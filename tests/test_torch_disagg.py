"""The port's disaggregated prefill->decode serving against the JAX
package's, on the same weights, scenario by scenario as
``tests/test_disagg.py``: the paged-KV export/import round trip (dense and
MoE: transcripts equal to the reference's and to a unified engine's, the
payload's keys and shapes the reference's with leaves within 1e-5, the
imported blocks bit-equal to the payload, and a payload the reference
exported finishing in the port with the reference's tokens), the import
refusals with the reference's block accounting, the servicer's recompute
fallback, ``generate_stream``, the service handoff with phase-pure
latency windows, and the launcher's ``--disagg``."""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import build  # noqa: E402
from repro.core.request import InferenceRequest as JaxEnvelope  # noqa: E402
from repro.serving.client import LLMServicer as JaxServicer  # noqa: E402
from repro.serving.engine import InferenceEngine as JaxEngine  # noqa: E402
from repro_torch.core import (ExecutionPolicy, ResourceDescription,  # noqa: E402
                              ResourceRequirements, Rhapsody,
                              ServiceDescription)
from repro_torch.core.request import InferenceRequest  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serving.client import (LLMServicer,  # noqa: E402
                                        llm_model_group)
from repro_torch.serving.engine import InferenceEngine  # noqa: E402
from repro_torch.serving.kvcache import extract_blocks  # noqa: E402

ENGINE_KW = dict(max_num_seqs=4, max_num_batched_tokens=256, max_len=64,
                 prefill_buckets=(16, 32), seed=0, paged=True, block_size=8)
SV_KW = dict(max_num_seqs=4, max_num_batched_tokens=256, max_len=64,
             paged=True, block_size=8, num_blocks=64,
             prefill_buckets=(16, 32))
# chunked extend vs the reference's, f32 (ROADMAP "check these first")
LEAF_TOL = 1e-5
STAMPS = ("submitted_at", "first_token_at")


@pytest.fixture(scope="module")
def dense_lm():
    return build()


@pytest.fixture(scope="module")
def moe_lm():
    return build(arch="deepseek-moe-16b")


def _packages(lm):
    """-> {"jax": engine maker, "torch": engine maker} on one weight set."""
    cfg, _, params, tcfg, tparams = lm
    return {"jax": lambda **kw: JaxEngine(cfg, params, **kw),
            "torch": lambda **kw: InferenceEngine(tcfg, tparams,
                                                  device="cpu", **kw)}


def _prefill_export_all(pre, n, max_steps=200):
    """Pump a prefill-role paged engine until ``n`` sequences exported."""
    payloads = {}
    for _ in range(max_steps):
        if len(payloads) >= n:
            break
        pre.step_prefill_only()
        for uid in pre.exportable():
            payloads[uid] = pre.export_sequence(uid)
    assert len(payloads) == n, "prefill engine never exported every seq"
    return payloads


def _unified(mk, prompts, mnt, **kw):
    eng = mk(**{**ENGINE_KW, **kw})
    uids = [eng.submit(p, max_new_tokens=mnt) for p in prompts]
    done = eng.run()
    return [done[u].output for u in uids]


def _accounting(eng):
    return eng.block_telemetry(), list(eng.pool.alloc._ref), eng._reserved


# ---------------------------------------------------------------------------
# Engine-level export/import round trip
# ---------------------------------------------------------------------------


def _round_trip(mk, prompts, mnt=6):
    """Prefill on one engine, export, import into another, finish there:
    -> (pre, dec, payloads in prompt order, transcripts).  In the port, the
    blocks each import filled, extracted again, equal the payload exactly."""
    pre = mk(**ENGINE_KW)
    dec = mk(**ENGINE_KW)
    uids = [pre.submit(p, max_new_tokens=mnt) for p in prompts]
    payloads = _prefill_export_all(pre, len(prompts))
    assert not pre.running  # exports retire on the prefill side
    moved = {}
    for uid in uids:
        pay = payloads[uid]
        nuid = dec.import_sequence(pay)
        assert nuid is not None
        moved[uid] = nuid
        if isinstance(dec, InferenceEngine):
            n_pre = dec.cfg.first_dense_layers if dec.cfg.is_moe else 0
            again = extract_blocks(dec.pool.cache, dec.running[nuid].table,
                                   n_pre)
            assert all(torch.equal(again[k], v)
                       for k, v in pay["leaves"].items())
    done = dec.run()
    for uid in uids:
        pay, req = payloads[uid], done[moved[uid]]
        # the prefill-side tokens open the final output, and the stamps
        # travel with the sequence
        assert req.output[:len(pay["output"])] == pay["output"]
        assert (req.submitted_at, req.first_token_at) == \
            (pay["submitted_at"], pay["first_token_at"])
    return (pre, dec, [payloads[u] for u in uids],
            [done[moved[u]].output for u in uids])


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_export_import_round_trip_matches_reference(family, dense_lm, moe_lm):
    """Greedy outputs survive the migration: the port's transcripts equal
    the reference's and a unified engine's; its payloads carry the
    reference's metadata, keys and shapes (leaves within 1e-5); the
    imported blocks hold the payload's bytes exactly; both sides' block
    accounting equals the reference's."""
    lm = dense_lm if family == "dense" else moe_lm
    cfg = lm[0]
    mk = _packages(lm)
    rng = np.random.RandomState(0)
    prompts = [list(map(int, rng.randint(1, cfg.vocab, size=n)))
               for n in (5, 12, 23)]
    jpre, jdec, jpays, jouts = _round_trip(mk["jax"], prompts)
    pre, dec, pays, outs = _round_trip(mk["torch"], prompts)
    assert outs == jouts
    assert outs == _unified(mk["torch"], prompts, 6)
    for pay, jpay in zip(pays, jpays):
        assert {k: v for k, v in pay.items()
                if k not in STAMPS + ("leaves",)} == \
            {k: v for k, v in jpay.items() if k not in STAMPS + ("leaves",)}
        assert set(pay["leaves"]) == set(jpay["leaves"])
        for path, leaf in pay["leaves"].items():
            assert leaf.device.type == "cpu"
            assert tuple(leaf.shape) == jpay["leaves"][path].shape, path
            np.testing.assert_allclose(leaf.numpy(), jpay["leaves"][path],
                                       rtol=0, atol=LEAF_TOL, err_msg=path)
    for a, b in ((pre, jpre), (dec, jdec)):
        assert _accounting(a) == _accounting(b)
    assert dec.stats.decode_tokens == jdec.stats.decode_tokens
    assert dec.stats.decode_steps > 0 and pre.stats.decode_steps == 0


def test_imported_blocks_equal_the_payload_bit_for_bit(dense_lm):
    """Right after the import the decode engine's blocks, extracted again,
    equal the payload exactly, bf16 included (host torch tensors, not
    numpy, carry it)."""
    tcfg = dense_lm[3]
    for dtype in ("float32", "bfloat16"):
        c = tcfg.scaled(param_dtype=dtype, compute_dtype=dtype)
        p = get_model(c).init(torch.Generator().manual_seed(0), c,
                              device="cpu")
        pre = InferenceEngine(c, p, device="cpu", **ENGINE_KW)
        dec = InferenceEngine(c, p, device="cpu", **ENGINE_KW)
        pre.submit(list(range(1, 20)), max_new_tokens=4)
        (pay,) = _prefill_export_all(pre, 1).values()
        assert pay["leaves"][("scan", "k")].dtype == c.cdtype
        nuid = dec.import_sequence(pay)
        table = dec.running[nuid].table
        assert 0 not in table  # never the null block
        again = extract_blocks(dec.pool.cache, table)
        for path, leaf in pay["leaves"].items():
            assert torch.equal(again[path], leaf), (dtype, path)


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_reference_exported_payload_finishes_in_the_port(family, dense_lm,
                                                         moe_lm):
    """A payload the reference engine exported (numpy leaves) imports into
    the port's engine and finishes with the reference's tokens."""
    lm = dense_lm if family == "dense" else moe_lm
    cfg = lm[0]
    mk = _packages(lm)
    rng = np.random.RandomState(2)
    prompts = [list(map(int, rng.randint(1, cfg.vocab, size=n)))
               for n in (7, 19, 30)]
    jpre, jdec, jpays, jouts = _round_trip(mk["jax"], prompts, mnt=5)
    dec = mk["torch"](**ENGINE_KW)
    uids = [dec.import_sequence(pay) for pay in jpays]
    assert None not in uids
    done = dec.run()
    assert [done[u].output for u in uids] == jouts
    assert _accounting(dec) == _accounting(jdec)


def _full_slots(mk):
    pre = mk(**ENGINE_KW)
    tight = mk(**ENGINE_KW, max_running=1)
    tight.submit([3] * 10, max_new_tokens=30)
    tight.step()  # the occupant is admitted: running == max_running
    prompt = [5, 6, 7, 8, 9]
    pre.submit(prompt, max_new_tokens=4)
    (pay,) = _prefill_export_all(pre, 1).values()
    before = _accounting(tight)
    refused = tight.import_sequence(pay)
    after = _accounting(tight)
    roomy = mk(**ENGINE_KW)
    nuid = roomy.import_sequence(pay)
    out = roomy.run()[nuid].output
    return refused, before, after, out, _unified(mk, [prompt], 4)[0]


def _exhausted_pool(mk):
    pre = mk(**ENGINE_KW)
    # num_blocks=9: the null block + 8 usable, exactly one max_len sequence
    dec = mk(**{**ENGINE_KW, "num_blocks": 9})
    dec.submit([3] * 30, max_new_tokens=30)  # reserves all 8 blocks
    dec.step()
    pre.submit([7, 8, 9, 10, 11], max_new_tokens=4)
    (pay,) = _prefill_export_all(pre, 1).values()
    before = _accounting(dec)
    refused = dec.import_sequence(pay)
    return refused, before, _accounting(dec), None, None


@pytest.mark.parametrize("scenario", [_full_slots, _exhausted_pool],
                         ids=["full_slots", "exhausted_pool"])
def test_import_refusals_match_reference(scenario, dense_lm):
    """At max_running, or with the whole pool reserved, the import returns
    None and leaks no reservation, as the reference's does; the untouched
    payload still lands on a roomier engine and finishes as a unified
    run."""
    mk = _packages(dense_lm)
    got, want = scenario(mk["torch"]), scenario(mk["jax"])
    refused, before, after, out, unified = got
    assert refused is None and want[0] is None
    assert before == after
    assert (before, after) == (want[1], want[2])
    assert out == unified == want[3]


def test_import_refuses_a_block_size_mismatch(dense_lm):
    mk = _packages(dense_lm)
    pays = []
    for name in ("jax", "torch"):
        pre = mk[name](**ENGINE_KW)
        pre.submit([1, 2, 3], max_new_tokens=3)
        (pay,) = _prefill_export_all(pre, 1).values()
        other = mk[name](**{**ENGINE_KW, "block_size": 16})
        assert other.import_sequence(pay) is None
        pays.append(_accounting(other))
    assert pays[0] == pays[1]


# ---------------------------------------------------------------------------
# Servicer-level handoff: counters and recompute fallback
# ---------------------------------------------------------------------------


def _recompute_fallback(Servicer, Envelope, cfg, params, **dev):
    pre = Servicer(cfg, params, phase="prefill", **SV_KW, **dev)
    dec = Servicer(cfg, params, phase="decode",
                   **{**SV_KW, "max_num_batched_tokens": 64,
                      "num_blocks": 9}, **dev)
    dec.engine.submit([3] * 30, max_new_tokens=30)  # pins the pool
    dec.engine.step()
    prompts = [[7, 8, 9, 10, 11], [1, 2, 3], [4] * 9]
    for p in prompts:
        pre.submit({"prompt": p, "max_new_tokens": 5})
    handoffs = []
    for _ in range(200):
        if len(handoffs) == len(prompts):
            break
        for _uid, res in pre.step():
            assert res.get("role") == "prefill"
            assert res.get("handoff_export") is not None
            handoffs.append(res["handoff_export"])
    assert pre.handoff_stats() == {"role": "prefill",
                                   "exports": len(prompts),
                                   "imports": 0, "recomputes": 0}
    new_uids = [dec.submit({"prompt": list(pay["prompt"])},
                           envelope=Envelope(
                               payload={"prompt": list(pay["prompt"])},
                               handoff=pay))
                for pay in handoffs]
    stamps = {r.uid: r.submitted_at for r in dec.engine.queue}
    assert [stamps[u] for u in new_uids] == \
        [pay["submitted_at"] for pay in handoffs]
    results = {}
    for _ in range(2000):
        if len(results) == len(prompts) + 1:  # + the occupant
            break
        for uid, res in dec.step():
            results[uid] = res
    flags = [{k: results[u].get(k) for k in ("handoff", "recompute", "role")}
             for u in new_uids]
    assert all(results[u]["latency_s"] >= 0
               and results[u]["ttft_s"] is not None for u in new_uids)
    return (dec.handoff_stats(), flags,
            [results[u]["tokens"] for u in new_uids], _accounting(dec.engine))


def test_servicer_recompute_fallback_matches_reference(dense_lm):
    """Every handoff refused by a block-exhausted decode pool is
    recomputed on the decode replica: counted, flagged in the result,
    keeping the original submit stamp, and with the reference's tokens
    (which are the unified engine's)."""
    cfg, _, params, tcfg, tparams = dense_lm
    got = _recompute_fallback(LLMServicer, InferenceRequest, tcfg, tparams,
                              device="cpu")
    want = _recompute_fallback(JaxServicer, JaxEnvelope, cfg, params)
    assert got == want
    hs, flags, tokens, _ = got
    assert hs == {"role": "decode", "exports": 0, "imports": 0,
                  "recomputes": 3}
    assert all(f == {"handoff": True, "recompute": True, "role": "decode"}
               for f in flags)
    prompts = [[7, 8, 9, 10, 11], [1, 2, 3], [4] * 9]
    assert tokens == _unified(_packages(dense_lm)["torch"], prompts, 5)


def test_servicer_phases_refuse_the_slot_pool_and_a_draft(dense_lm):
    _, _, _, tcfg, tparams = dense_lm
    for phase in ("prefill", "decode"):
        with pytest.raises(ValueError, match="block-paged"):
            LLMServicer(tcfg, tparams, phase=phase, device="cpu",
                        **{**SV_KW, "paged": False})
        with pytest.raises(ValueError, match="do not compose"):
            LLMServicer(tcfg, tparams, phase=phase, device="cpu",
                        draft_group=tcfg, **SV_KW)
    with pytest.raises(ValueError, match="phase must be"):
        LLMServicer(tcfg, tparams, phase="both", device="cpu", **SV_KW)


def test_decode_role_warmup_runs_one_decode(dense_lm):
    """A decode-role replica warms with two tokens, so its batched decode
    runs once; a prefill-role one with one token."""
    _, _, _, tcfg, tparams = dense_lm
    for phase, steps in (("decode", 1), ("prefill", 0), ("serve", 0)):
        sv = LLMServicer(tcfg, tparams, phase=phase, device="cpu", **SV_KW)
        sv.warmup()
        assert sv.stats.decode_steps == steps, phase
        assert not sv.engine.running and not sv.engine.queue


# ---------------------------------------------------------------------------
# generate_stream / ttft_s
# ---------------------------------------------------------------------------


def _servicers(lm):
    cfg, _, params, tcfg, tparams = lm
    return (LLMServicer(tcfg, tparams, device="cpu", **SV_KW),
            JaxServicer(cfg, params, **SV_KW))


def test_generate_stream_tokens_then_final(dense_lm):
    """Tokens stream in generation order; the final event repeats them
    with step()'s latency keys; both equal the reference's stream."""
    sv, jsv = _servicers(dense_lm)
    payload = {"prompt": [5, 6, 7], "max_new_tokens": 6}
    events = list(sv.generate_stream(payload))
    jevents = list(jsv.generate_stream(payload))
    toks = [e["token"] for e in events[:-1]]
    final = events[-1]
    assert final["done"] is True
    assert final["tokens"] == toks and len(toks) == 6
    assert final["ttft_s"] is not None and final["ttft_s"] > 0
    assert final["itl_s"] is not None and final["latency_s"] > 0
    assert toks == [e["token"] for e in jevents[:-1]]
    # the port's results add the hand-off and queue waits to the
    # reference's keys (no envelope here, so no hand-off)
    assert set(final) == set(jevents[-1]) | {"handoff_s", "queue_s"}
    assert 0 <= final["queue_s"] <= final["ttft_s"]
    assert final["handoff_s"] is None
    assert toks == _unified(_packages(dense_lm)["torch"], [[5, 6, 7]], 6)[0]


def test_generate_stream_empty_generation_has_no_ttft(dense_lm):
    """max_new_tokens <= 0 yields only the final event, ttft_s None, as
    the reference's."""
    sv, jsv = _servicers(dense_lm)
    payload = {"prompt": [5, 6], "max_new_tokens": 0}
    events = list(sv.generate_stream(payload))
    assert events == list(jsv.generate_stream(payload))
    assert len(events) == 1 and events[0]["done"] is True
    assert events[0]["tokens"] == [] and events[0]["ttft_s"] is None


def test_generate_stream_resumed_sequence_stamps_ttft(dense_lm):
    """A follow-up turn resuming resident prefix KV skips the prefill; its
    first token still stamps ttft_s, and its tokens and the prefix hits
    equal the reference's."""
    outs = []
    for sv in _servicers(dense_lm):
        prompt = [11, 12, 13, 14, 15, 16]
        out1 = list(sv.generate_stream({"prompt": prompt,
                                        "max_new_tokens": 4}))[-1]
        prompt2 = prompt + out1["tokens"] + [9]
        out2 = list(sv.generate_stream({"prompt": prompt2,
                                        "max_new_tokens": 4}))[-1]
        assert sv.engine.stats.prefix_reuse_hits >= 1
        assert out2["ttft_s"] is not None and out2["ttft_s"] > 0
        outs.append((out1["tokens"], out2["tokens"],
                     sv.engine.stats.prefix_reuse_hits,
                     sv.engine.stats.prefix_cached_tokens))
    assert outs[0] == outs[1]


def test_generate_stream_refused_on_prefill_replicas(dense_lm):
    _, _, _, tcfg, tparams = dense_lm
    sv = LLMServicer(tcfg, tparams, phase="prefill", device="cpu", **SV_KW)
    with pytest.raises(ValueError, match="prefill"):
        next(sv.generate_stream({"prompt": [1, 2], "max_new_tokens": 2}))


def test_generate_stream_keeps_other_results_for_step(dense_lm):
    """Results of other requests finishing during a stream are returned by
    the next step(), not dropped."""
    sv, _ = _servicers(dense_lm)
    other = sv.submit({"prompt": [3, 4, 5, 6], "max_new_tokens": 2})
    final = list(sv.generate_stream({"prompt": [5, 6, 7],
                                     "max_new_tokens": 6}))[-1]
    assert final["done"] is True
    got = sv.step()
    assert [uid for uid, _ in got] == [other]
    assert got[0][1]["tokens"] == _unified(
        _packages(dense_lm)["torch"], [[3, 4, 5, 6]], 2)[0]


# ---------------------------------------------------------------------------
# End to end: a disaggregated pair behind one ReplicaSet
# ---------------------------------------------------------------------------


def test_disagg_service_handoff_and_phase_pure_stats(dense_lm):
    """Prompts addressed to the prefill group come back decoded by the
    decode group with the reference engine's tokens; TTFT samples land
    only in the prefill group's window and ITL only in the decode
    group's, and the handoff counters reconcile."""
    cfg, _, params, tcfg, tparams = dense_lm
    engine_kw = dict(max_num_seqs=4, max_len=64, paged=True, block_size=8,
                     num_blocks=64, prefill_buckets=(16, 32))
    rh = Rhapsody(ResourceDescription(nodes=1, cores_per_node=8),
                  policy=ExecutionPolicy(routing="radix_affinity"),
                  n_workers=1)
    try:
        rs = rh.add_service(ServiceDescription(
            name="llm", replicas=2,
            requirements=ResourceRequirements(ranks=1, cores_per_rank=1),
            models=[
                llm_model_group("pre", tcfg, tparams, role="prefill",
                                paired_with="dec", replicas=1,
                                max_num_batched_tokens=256, device="cpu",
                                **engine_kw),
                llm_model_group("dec", tcfg, tparams, role="decode",
                                replicas=1, max_num_batched_tokens=64,
                                device="cpu", **engine_kw),
            ]))
        assert rs.group_role("pre") == "prefill"
        rng = np.random.RandomState(0)
        prompts = [list(map(int, rng.randint(1, cfg.vocab, size=n)))
                   for n in (20, 12, 33)]
        futs = [rs.request({"prompt": p, "max_new_tokens": 6,
                            "model": "pre"}) for p in prompts]
        results = [f.result(60.0) for f in futs]
        ref = JaxEngine(cfg, params, max_num_batched_tokens=256, **engine_kw)
        ref_uids = [ref.submit(p, max_new_tokens=6) for p in prompts]
        ref_done = ref.run()
        for res, ruid in zip(results, ref_uids):
            assert res["tokens"] == ref_done[ruid].output
            assert res.get("handoff") is True
            assert res.get("role") == "decode"
            assert res.get("recompute") is None
            assert res["ttft_s"] is not None and res["itl_s"] is not None
        deadline = time.perf_counter() + 10
        while time.perf_counter() < deadline:
            tot = rs.handoff_totals()
            if tot["imports"] + tot["recomputes"] >= len(prompts):
                break
            time.sleep(0.05)
        assert rs.handoff_totals() == {"exports": len(prompts),
                                       "imports": len(prompts),
                                       "recomputes": 0}
        pg = rs.stats()["per_group"]
        assert pg["pre"]["role"] == "prefill"
        assert pg["pre"]["handoff_exports"] == len(prompts)
        assert pg["pre"]["ttft_p95_ms"] is not None
        assert pg["pre"]["itl_p95_ms"] is None  # never decodes
        assert pg["dec"]["itl_p95_ms"] is not None
        assert pg["dec"]["ttft_p95_ms"] is None  # phase-pure windows
        pre_eng, dec_eng = (inst.servicer.engine for inst in rs.instances)
        assert pre_eng.stats.decode_steps == 0
        assert dec_eng.stats.decode_steps > 0
        with pytest.raises(ValueError):
            rs.latency_p95(group="pre", phase="nope")
    finally:
        rh.close()


def test_launcher_disagg_on_cpu(capsys):
    """``--disagg`` splits the replicas into a prefill and a decode pool;
    every result comes back handed off; ``--no-paged`` is refused."""
    out = serve.main(["--device", "cpu", "--smoke", "--disagg",
                      "--replicas", "2", "--requests", "6",
                      "--max-new-tokens", "4"])
    res = out["results"]
    assert len(res) == 6 and all(len(r["tokens"]) == 4 for r in res)
    assert all(r.get("handoff") is True and r.get("role") == "decode"
               for r in res)
    assert out["errors"] == [None, None]
    assert out["handoff_totals"] == {"exports": 6, "imports": 6,
                                     "recomputes": 0}
    assert out["decode_steps"] > 0
    printed = capsys.readouterr().out
    assert "disaggregated {'prefill': 1, 'decode': 1}" in printed
    assert "[serve] disagg: 6/6 sequences migrated" in printed
    assert "per-phase groups" in printed
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--smoke", "--disagg", "--no-paged"])
