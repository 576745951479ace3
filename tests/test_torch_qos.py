"""The port's QoS preemption against the JAX package's, on the same weights,
scenario by scenario as ``tests/test_qos.py``: a decoding sequence
preempted to residency resumes with the transcript of uninterrupted decode
and its first-token stamp (also when eviction took its blocks and it is
prefilled again), queued / prefilling / finished / unknown sequences are
refused, the weighted-fair scheduler preempts a lighter decode for a
blocked heavier head, and the servicer's ``qos=True``; in each, the
transcripts, the preemption counters and the block accounting equal the
reference's."""
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import build  # noqa: E402
from repro.core.request import InferenceRequest as JaxEnvelope  # noqa: E402
from repro.serving.client import LLMServicer as JaxServicer  # noqa: E402
from repro.serving.engine import InferenceEngine as JaxEngine  # noqa: E402
from repro.serving.qos import WFQScheduler as JaxWFQ  # noqa: E402
from repro_torch.core.request import InferenceRequest  # noqa: E402
from repro_torch.serving.client import LLMServicer  # noqa: E402
from repro_torch.serving.engine import InferenceEngine  # noqa: E402
from repro_torch.serving.qos import WFQScheduler  # noqa: E402

ENGINE_KW = dict(max_num_seqs=4, max_num_batched_tokens=64, max_len=64,
                 paged=True, block_size=8, num_blocks=32,
                 prefill_buckets=(16, 32))
COUNTERS = ("preemptions", "preempt_resumes", "prefill_tokens",
            "decode_tokens", "prefix_cached_tokens",
            "evicted_residencies", "cow_copies", "free_blocks",
            "reserved_blocks")


@pytest.fixture(scope="module")
def lm():
    return build()


def _makers(lm):
    cfg, _, params, tcfg, tparams = lm
    return (lambda **kw: InferenceEngine(tcfg, tparams, device="cpu", **kw),
            lambda **kw: JaxEngine(cfg, params, **kw))


def _drain(eng, sched=None, done=None):
    done = {} if done is None else done
    for _ in range(2000):
        if not eng.has_work():
            break
        if sched is not None:
            sched.schedule(eng)
        eng.step()
        for r in eng.collect_finished():
            done[r.uid] = r
    return done


def _record(eng):
    return ({n: getattr(eng.stats, n) for n in COUNTERS},
            eng.block_telemetry(), list(eng.pool.alloc._ref), eng._reserved)


def _alone(mk, kw, prompts, mnt):
    """Each prompt on its own, one after the other: no contention."""
    eng = mk(**kw)
    outs = []
    for p in prompts:
        uid = eng.submit(p, max_new_tokens=mnt)
        outs.append(_drain(eng)[uid].output)
    return outs


# ---------------------------------------------------------------------------
# Engine preemption: retire to residency, resume token-identically
# ---------------------------------------------------------------------------


def _preempt_resume(mk, evict):
    """Two low-class sequences decode; the first is preempted after three
    tokens.  With ``evict`` a long request queued ahead of it takes the
    whole pool first, evicting the preempted blocks, so the resume
    prefills the transcript again."""
    kw = {**ENGINE_KW, "num_blocks": 9} if evict else ENGINE_KW
    prompts = [[5] * 12, [9] * 7]
    eng = mk(**kw)
    uids = [eng.submit(p, max_new_tokens=10, tenant="a", qos_class="low")
            for p in prompts]
    for _ in range(100):
        eng.step()
        eng.collect_finished()
        req = eng.running.get(uids[0])
        if req is not None and len(req.output) >= 3:
            break
    else:
        pytest.fail("first request never reached mid-decode")
    if evict:
        uids.append(eng.submit([4] * 30, max_new_tokens=26))
    first_token_at = eng.running[uids[0]].first_token_at
    assert eng.preempt_sequence(uids[0])
    assert uids[0] not in eng.running and eng.stats.preemptions == 1
    assert eng.queue[-1].uid == uids[0] and not eng.queue[-1].table
    after_preempt = _record(eng)
    done = _drain(eng)
    assert set(done) == set(uids)
    assert done[uids[0]].first_token_at == first_token_at  # the TTFT stamp
    return [done[u].output for u in uids], after_preempt, _record(eng)


@pytest.mark.parametrize("evict", [False, True], ids=["resident", "evicted"])
def test_preempt_resume_matches_reference(evict, lm):
    """The resumed transcript equals uninterrupted decode, and the
    transcripts, counters (one preemption, one resume; the evicted case
    drops the resident blocks) and block accounting equal the
    reference's, right after the preemption and at the end."""
    mk, jmk = _makers(lm)
    got = _preempt_resume(mk, evict)
    assert got == _preempt_resume(jmk, evict)
    outs, _, (stats, *_) = got
    assert stats["preemptions"] == stats["preempt_resumes"] == 1
    assert (stats["evicted_residencies"] > 0) == evict
    prompts = [[5] * 12, [9] * 7] + ([[4] * 30] if evict else [])
    mnts = [10, 10, 26]
    want = [_alone(mk, ENGINE_KW, [p], n)[0] for p, n in zip(prompts, mnts)]
    assert outs == want


def _refusals(mk):
    eng = mk(**ENGINE_KW)
    uid = eng.submit([3] * 12, max_new_tokens=4)
    refused = [eng.preempt_sequence(uid)]  # queued: nothing to retire
    eng2 = mk(**{**ENGINE_KW, "max_num_batched_tokens": 16,
                 "prefill_buckets": (16,)})
    u2 = eng2.submit([3] * 40, max_new_tokens=4)
    eng2.step()  # one 16-token chunk of 40: mid-prefill
    assert eng2.running[u2].pending_tokens
    refused.append(eng2.preempt_sequence(u2))
    done = eng.run()
    refused.append(eng.preempt_sequence(uid))  # finished
    refused.append(eng.preempt_sequence(12345))  # unknown
    slot = mk(**{k: v for k, v in ENGINE_KW.items()
                 if k not in ("paged", "block_size", "num_blocks")})
    u3 = slot.submit([3] * 5, max_new_tokens=8)
    slot.step()
    refused.append(slot.preempt_sequence(u3))  # the slot pool
    return refused, done[uid].output, _record(eng), _record(eng2)


def test_preempt_refuses_what_is_not_decoding(lm):
    mk, jmk = _makers(lm)
    got = _refusals(mk)
    assert got == _refusals(jmk)
    assert got[0] == [False] * 5 and got[1]
    assert got[2][0]["preemptions"] == got[3][0]["preemptions"] == 0


def _wfq_squeeze(mk, Sched):
    kw = {**ENGINE_KW, "num_blocks": 7, "max_len": 32, "max_num_seqs": 2}
    prompts = {"low1": [5] * 12, "low2": [7] * 12, "high": [9] * 12}
    eng = mk(**kw)
    sched = Sched()
    uids = {}
    for k in ("low1", "low2"):
        uids[k] = eng.submit(prompts[k], max_new_tokens=8,
                             tenant="batch", qos_class="low")
        sched.on_submit(next(r for r in eng.queue if r.uid == uids[k]))
    for _ in range(100):  # the low requests occupy the pool and decode
        sched.schedule(eng)
        eng.step()
        if all(u in eng.running and eng.running[u].output
               and not eng.running[u].pending_tokens
               for u in uids.values()):
            break
    else:
        pytest.fail("low-class requests never reached decode")
    uids["high"] = eng.submit(prompts["high"], max_new_tokens=8,
                              tenant="agent", qos_class="high")
    sched.on_submit(next(r for r in eng.queue if r.uid == uids["high"]))
    done = _drain(eng, sched)
    outs = {k: done[u].output for k, u in uids.items()}
    finish = sorted(uids, key=lambda k: done[uids[k]].finished_at)
    return outs, finish, sched.stats(), _record(eng)


def test_wfq_preempts_lighter_decode_for_blocked_high_head(lm):
    """Low-class decodes hold the whole pool; a high-class arrival cannot
    be admitted; the scheduler preempts the lightest victim, the head
    admits, and every transcript equals an uncontended run's.  The
    scheduler's and the engine's counters equal the reference's."""
    mk, jmk = _makers(lm)
    got = _wfq_squeeze(mk, WFQScheduler)
    assert got == _wfq_squeeze(jmk, JaxWFQ)
    outs, finish, sstats, (stats, *_) = got
    assert sstats["preempted"] >= 1
    assert stats["preemptions"] == stats["preempt_resumes"] >= 1
    kw = {**ENGINE_KW, "num_blocks": 7, "max_len": 32, "max_num_seqs": 2}
    prompts = {"low1": [5] * 12, "low2": [7] * 12, "high": [9] * 12}
    assert outs == dict(zip(prompts, _alone(mk, kw, prompts.values(), 8)))
    assert finish.index("high") < 2  # the high head overtook a low one


# ---------------------------------------------------------------------------
# The servicer's qos=True
# ---------------------------------------------------------------------------


def _qos_servicer(Servicer, Envelope, cfg, params, **dev):
    kw = {**ENGINE_KW, "num_blocks": 7, "max_len": 32, "max_num_seqs": 2}
    sv = Servicer(cfg, params, qos=True, **kw, **dev)
    uids = {}
    for k, p in (("low1", [5] * 12), ("low2", [7] * 12)):
        uids[k] = sv.submit({"prompt": p, "max_new_tokens": 8},
                            envelope=Envelope(payload={}, tenant="batch",
                                              priority="low"))
    results = {}
    for _ in range(100):  # the low requests occupy the pool and decode
        results.update(sv.step())
        run = sv.engine.running
        if all(u in run and run[u].output and not run[u].pending_tokens
               for u in uids.values()):
            break
    uids["high"] = sv.submit({"prompt": [9] * 12, "max_new_tokens": 8},
                             envelope=Envelope(payload={}, tenant="agent",
                                               priority="high"))
    for _ in range(2000):
        if len(results) == 3:
            break
        results.update(sv.step())
    return ({k: results[u]["tokens"] for k, u in uids.items()},
            sv.qos_stats(), _record(sv.engine))


def test_qos_servicer_matches_reference(lm):
    """``LLMServicer(qos=True)`` orders admission by weighted-fair finish
    and preempts for the high-class request: tokens, ``qos_stats()`` and
    the accounting equal the reference servicer's."""
    cfg, _, params, tcfg, tparams = lm
    got = _qos_servicer(LLMServicer, InferenceRequest, tcfg, tparams,
                        device="cpu")
    assert got == _qos_servicer(JaxServicer, JaxEnvelope, cfg, params)
    tokens, qstats, _ = got
    assert qstats["preempted"] >= 1
    assert qstats["engine_preemptions"] == qstats["engine_preempt_resumes"]
    assert all(len(t) == 8 for t in tokens.values())


def test_qos_is_armed_by_flag_or_weights(lm):
    _, _, _, tcfg, tparams = lm
    kw = dict(ENGINE_KW, device="cpu")
    assert LLMServicer(tcfg, tparams, **kw).qos_stats() is None
    sv = LLMServicer(tcfg, tparams, qos_class_weights={"gold": 8.0}, **kw)
    assert sv.qos_stats() == {"preempted": 0, "virtual_clock": 0.0,
                              "flows": 0, "engine_preemptions": 0,
                              "engine_preempt_resumes": 0}
    assert sv._qos.weights == {"gold": 8.0}
    assert not LLMServicer(tcfg, tparams, qos=True, qos_preempt=False,
                           **kw)._qos.preempt
