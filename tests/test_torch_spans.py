"""The port's spans (``repro_torch.spans``): off, a span is a flag check
that builds no ``record_function``; under a CPU ``torch.profiler`` the
serving path's ranges appear, nested where the layers nest; the profiler
changes no transcript; and each served request's admission stamp falls
between its submit and its first token."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import spans  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.serving.client import LLMServicer  # noqa: E402
from repro_torch.serving.engine import make_engine_from_scratch  # noqa: E402

TINY_DENSE = ModelConfig(
    name="tiny-dense", family="dense", n_layers=2, d_model=64, n_heads=8,
    n_kv_heads=2, head_dim=8, d_ff=256, vocab=256, activation="relu2",
    gated_mlp=False, positions="rope", max_seq=128,
    param_dtype="float32", compute_dtype="float32")
# a 32-token chunk, so the 40-token prompt takes two extends
ENGINE = dict(paged=True, max_num_seqs=4, max_num_batched_tokens=64,
              max_len=128, prefill_buckets=(16, 32), prefill_chunk=32,
              block_size=16)
PROMPTS = [list(np.random.RandomState(n).randint(1, 256, size=n))
           for n in (5, 20, 40)]
SERVING_SPANS = {"servicer/step", "engine/step", "engine/extend",
                 "engine/decode", "model/unembed"}


def _engine():
    return make_engine_from_scratch(TINY_DENSE, seed=0, device="cpu",
                                    **ENGINE)


def _serve(eng, prompts=PROMPTS, new_tokens=6):
    uids = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
    done = eng.run()
    return [done[u] for u in uids]


def _cpu_profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


class _Counted:
    """Stands in for ``torch.profiler.record_function``, counting its
    constructions."""

    made = 0

    def __init__(self, name):
        type(self).made += 1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_a_span_off_builds_no_record_function(monkeypatch):
    monkeypatch.setattr(_Counted, "made", 0)
    monkeypatch.setattr(torch.profiler, "record_function", _Counted)
    assert not torch.autograd._profiler_enabled()
    with spans.span("engine/step"):
        pass
    _serve(_engine())
    assert _Counted.made == 0
    with _cpu_profile():
        with spans.span("engine/step"):
            pass
    assert _Counted.made == 1  # the same call builds one while recording


def _ranges(prof):
    """name -> [(start_ns, end_ns, thread)] of the host ranges recorded."""
    out = {}
    for ev in prof.profiler.kineto_results.events():
        out.setdefault(ev.name(), []).append(
            (ev.start_ns(), ev.end_ns(), ev.start_thread_id()))
    return out


def _inside(inner, outer):
    return any(s <= inner[0] and inner[1] <= e and th == inner[2]
               for s, e, th in outer)


def test_the_serving_spans_nest_under_a_cpu_profile():
    servicer = LLMServicer(TINY_DENSE, device="cpu", seed=0, **ENGINE)
    with _cpu_profile() as prof:
        for p in PROMPTS:
            servicer.submit({"prompt": p, "max_new_tokens": 6})
        results = []
        for _ in range(200):
            results += servicer.step()
            if len(results) == len(PROMPTS):
                break
    assert len(results) == len(PROMPTS)
    got = _ranges(prof)
    assert SERVING_SPANS <= set(got)
    # two chunks of the 40-token prompt and one of each other
    assert len(got["engine/extend"]) == 4
    unembed = got["model/unembed"]
    in_extend = [u for u in unembed if _inside(u, got["engine/extend"])]
    in_decode = [u for u in unembed if _inside(u, got["engine/decode"])]
    assert len(in_extend) == 4 and in_decode
    assert len(in_extend) + len(in_decode) == len(unembed)
    for name in ("engine/extend", "engine/decode"):
        assert all(_inside(r, got["engine/step"]) for r in got[name]), name
    assert all(_inside(r, got["servicer/step"]) for r in got["engine/step"])


def test_greedy_transcripts_equal_with_the_profiler_on_and_off():
    plain = [r.output for r in _serve(_engine())]
    with _cpu_profile():
        traced = [r.output for r in _serve(_engine())]
    assert traced == plain
    assert all(len(out) == 6 for out in plain)


def test_admission_stamp_lies_between_submit_and_first_token():
    # four sequences at most: the later prompts queue before admission
    reqs = _serve(_engine(), PROMPTS * 3)
    for r in reqs:
        assert (r.submitted_at <= r.admitted_at <= r.first_token_at
                <= r.finished_at)
    assert max(r.admitted_at - r.submitted_at for r in reqs) > 0


def test_queue_s_is_admission_less_the_submit_stamp():
    # no envelope here: the engine's queue is measured, the hand-off not
    servicer = LLMServicer(TINY_DENSE, device="cpu", seed=0, **ENGINE)
    finished = []
    orig = servicer.engine.collect_finished

    def collect():
        done = orig()
        finished.extend(done)
        return done

    servicer.engine.collect_finished = collect
    uids = [servicer.submit({"prompt": p, "max_new_tokens": 4})
            for p in PROMPTS * 2]
    results = {}
    for _ in range(400):
        results.update(servicer.step())
        if len(results) == len(uids):
            break
    by_uid = {r.uid: r for r in finished}
    for uid in uids:
        r, res = by_uid[uid], results[uid]
        assert res["queue_s"] == r.admitted_at - r.submitted_at >= 0
        assert r.envelope_at is None and res["handoff_s"] is None
        assert res["queue_s"] <= res["ttft_s"] <= res["latency_s"]
