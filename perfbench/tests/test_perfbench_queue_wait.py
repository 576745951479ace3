"""``queue_wait_ms``: the reader on synthetic windows, the stamps it reads
through ``Rhapsody`` on the tiny dense cell, and a traced run reporting
it."""
from pathlib import Path

import pytest
import torch

from perfbench import harness, spec
from perfbench.tests import tiny_root

METRICS = Path(__file__).resolve().parents[1] / "metrics"
SEED = 2 ** 31 + 29


def _window(completions):
    return harness.Window(
        seconds=2.0, setup_s=1.0, model=tiny_root.MODELS["tiny-dense"],
        completions=completions, generated=0, stats={}, chunks=[], steps=[])


def _read(w):
    return spec.reader(METRICS, "queue_wait_ms")(w)


def test_the_reader_averages_queue_s_and_reads_nothing_without_it():
    done = [{"latency": 1.0, "error": None,
             "result": {"latency_s": 0.9, "queue_s": 0.01}},
            {"latency": 2.0, "error": None,
             "result": {"latency_s": 1.9, "queue_s": 0.03}},
            {"latency": 5.0, "error": RuntimeError(), "result": None}]
    assert _read(_window(done)) == pytest.approx(20.0)
    # a program whose results carry no queue_s, and an empty window
    older = [{"latency": 1.0, "error": None, "result": {"latency_s": 0.9}}]
    assert _read(_window(older)) is None
    assert _read(_window([])) is None


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_stamps_through_rhapsody_are_ordered(one_thread):
    from repro_torch.core.middleware import Rhapsody
    from repro_torch.core.service import ServiceDescription
    from repro_torch.models.config import ModelConfig
    from repro_torch.serving.client import llm_service_factory

    cfg = ModelConfig(**tiny_root.MODELS["tiny-dense"])
    make = llm_service_factory(cfg, device="cpu", seed=SEED, paged=True,
                               **tiny_root.ENGINE)
    envelopes, finished = {}, []

    def factory():
        servicer = make()
        submit, collect = servicer.submit, servicer.engine.collect_finished

        def submit_seen(payload, *, envelope=None, **kw):
            uid = submit(payload, envelope=envelope, **kw)
            envelopes[uid] = envelope.submitted_at
            return uid

        def collect_seen():
            done = collect()
            finished.extend(done)
            return done

        servicer.submit = submit_seen
        servicer.engine.collect_finished = collect_seen
        return servicer

    rh = Rhapsody(n_workers=1)
    try:
        rs = rh.add_service(ServiceDescription(name="llm", factory=factory,
                                               ready_timeout=120.0))
        # more requests than max_num_seqs: some wait in the engine's queue
        futs = [rs.request({"prompt": list(range(1, 9 + 3 * i)),
                            "max_new_tokens": 8}) for i in range(10)]
        results = [f.result(120) for f in futs]
    finally:
        harness._stop_service(rh)
    by_out = {id(r.output): r for r in finished}
    assert len(results) == 10
    for res in results:
        r = by_out[id(res["tokens"])]
        env = envelopes[r.uid]
        assert r.envelope_at == env
        assert (env <= r.submitted_at <= r.admitted_at <= r.first_token_at
                <= r.finished_at)
        assert res["handoff_s"] == r.submitted_at - env >= 0
        assert res["queue_s"] == r.admitted_at - r.submitted_at >= 0
    assert max(res["queue_s"] for res in results) > 0


def test_a_traced_run_reports_queue_wait(tmp_path, one_thread):
    root = tiny_root.make(tmp_path)
    out = harness.run_cell(root, "t.dense", SEED, 1.0, True, device="cpu")
    assert out["correct"], out["verdict"]
    assert out["metrics"]["queue_wait_ms"]["unit"] == "ms"
    assert out["metrics"]["queue_wait_ms"]["value"] >= 0
