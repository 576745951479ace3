"""Whole runs on the CPU at a tiny size, past the look for a card: the
program served through Rhapsody, judged by the reference; a cell, a
configuration and a metric added as files alone; the check seeing each
fault a serving cell can have; the lower-precision control failing."""
import json

import pytest
import torch

from perfbench import harness
from perfbench.tests import tiny_root

SEED = 2 ** 31 + 17


@pytest.fixture
def root(tmp_path):
    # tiny matrices: one thread each, so that parallel test workers do
    # not starve the engine thread
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield tiny_root.make(tmp_path)
    torch.set_num_threads(n)


def _run(root, cell, **kw):
    return harness.run_cell(root, cell, SEED, 3.0, False, device="cpu", **kw)


@pytest.mark.parametrize("cell", ["t.dense", "t.moe"])
def test_a_sound_run_is_correct(root, cell):
    out = _run(root, cell)
    v = out["verdict"]
    assert out["correct"], v
    assert v["tokens"] > 0 and v["widest_gap"] <= tiny_root.LIMIT
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"gen_tokens_per_s", "setup_s"}
    assert list(out["check"]) == ["widest_gap", "tokens_compared"]
    if cell == "t.moe":  # the tiny decode capacity drops assignments
        assert v["reference_drops"] > 0 and v["sequences"] > v["requests"]


def test_a_cell_config_and_metric_come_from_files_alone(root):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    conf = json.loads((root / "pb/configs/tiny-dense.json").read_text())
    conf["name"] = "tiny-dense2"
    conf["model"]["n_layers"] = 1
    (root / "pb/configs/tiny-dense2.json").write_text(json.dumps(conf))
    mix = dict(tiny_root.TRAFFIC, clients=2, shared_prefix_tokens=0)
    (root / "pb/traffic/solo.json").write_text(json.dumps(mix))
    (root / "pb/metrics/completed.py").write_text(
        "def read(w):\n    return len(w.completions)\n")
    bench["configs"].append({"name": "tiny-dense2", "source": "test",
                             "file": "pb/configs/tiny-dense2.json",
                             "reduced": ["n_layers"], "why": "test"})
    bench["workloads"].append({"name": "t.new", "config": "tiny-dense2",
                               "traffic": "solo", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "completed", "unit": "requests",
                               "better": "higher", "source": "host_clock",
                               "layer": "middleware",
                               "moves": "gen_tokens_per_s",
                               "workloads": ["t.new"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = harness.run_cell(root, "t.new", SEED, 1.0, True, device="cpu")
    assert out["correct"], out["verdict"]
    assert out["metrics"]["completed"]["value"] == out["attempted"] > 0
    assert "idle_pct" not in out["metrics"]  # no device work traced


def _state_unchanged(monkeypatch):
    from repro_torch.models import transformer as tfm
    orig = tfm.paged_decode_step

    def step(p, store, *a, **kw):
        scratch = {k: v.clone() for k, v in store.items()}
        return store, orig(p, scratch, *a, **kw)[1]

    monkeypatch.setattr(tfm, "paged_decode_step", step)


def _half_batch(monkeypatch):
    from repro_torch.models import transformer as tfm
    orig = tfm.paged_decode_step

    def step(p, store, bt, lens, tokens, wp, wo, cfg, **kw):
        B = tokens.shape[0]
        h = max(1, B // 2)
        store, lg = orig(p, store, bt[:h], lens[:h], tokens[:h], wp[:h],
                         wo[:h], cfg, **kw)
        return store, lg[torch.arange(B) % h]

    monkeypatch.setattr(tfm, "paged_decode_step", step)


def _token_altered(monkeypatch):
    from repro_torch.serving.engine import InferenceEngine
    orig = InferenceEngine._decode_step_paged

    def step(self):
        events = orig(self)
        for r in self.running.values():
            if r.output and len(r.output) % 3 == 0:
                r.output[-1] = r.last_token = (r.output[-1] + 1) % 256
        return events

    monkeypatch.setattr(InferenceEngine, "_decode_step_paged", step)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _token_altered],
                         ids=lambda f: f.__name__.strip("_"))
@pytest.mark.parametrize("cell", ["t.dense", "t.moe"])
def test_each_fault_makes_the_run_incorrect(root, monkeypatch, fault, cell):
    fault(monkeypatch)
    out = _run(root, cell, check_sample=64)
    assert not out["correct"], out["verdict"]


def test_the_control_reads_far_above_the_program(root):
    out = _run(root, "t.dense", control=True, check_sample=64)
    v = out["verdict"]
    # the control, in the program's place, fails the run's own limits
    assert not out["correct"]
    assert out["check"]["widest_gap"]["value"] == v["control"]["widest_gap"]
    assert out["program"]["correct"]
    assert v["control"]["widest_gap"] > 3 * max(v["widest_gap"],
                                                tiny_root.LIMIT)
