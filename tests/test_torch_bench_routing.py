"""The port's exp4 bench (``benchmarks_torch/bench_routing.py``) against the
reference's (``benchmarks/bench_routing.py``) on the CPU: the prompt
generators give the reference's prompts for the same seeds, the synthetic
replica and affinity sweeps the reference's rows on every field that reads
no clock (and pass the reference's ``check_affinity``), the real-engine
sweeps serve every request; the runner's exp3, exp4 and kernels suites
(the kernels' plain versions on the CPU, in ``..._plain`` rows), and the
``serve_llm`` and ``train_lm`` examples, which like the runner resolve to
the card unless told ``cpu``."""
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks import bench_routing as jbench  # noqa: E402
from benchmarks.check_bench_json import check_affinity  # noqa: E402
from benchmarks_torch import bench_routing as bench  # noqa: E402
from benchmarks_torch import common, run  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = "cpu"
CLOCKED = {"seconds", "req_per_s", "req_per_s_per_replica", "tok_per_s",
           "p50_ms", "p95_ms", "p99_ms", "tokens_per_s"}


def _ints(x):
    """Nested lists of numpy or Python ints -> Python ints."""
    if isinstance(x, (list, tuple)):
        return [_ints(v) for v in x]
    return int(x)


def _unclocked(rows):
    return [{k: v for k, v in r.items() if k not in CLOCKED} for r in rows]


@pytest.mark.parametrize("seed,lo,hi", [(0, 8, 96), (2, 8, 96),
                                        (1, 32, 224)])
def test_hetero_prompts_are_the_references(seed, lo, hi):
    got = bench.hetero_prompts(40, seed=seed, lo=lo, hi=hi)
    assert _ints(got) == _ints(jbench.hetero_prompts(40, seed=seed, lo=lo,
                                                     hi=hi))


def test_session_prompts_are_the_references():
    for n, turns, seed in ((8, 8, 0), (6, 6, 3)):
        assert _ints(bench.sessioned_prompts(n, turns, seed=seed)) == _ints(
            jbench.sessioned_prompts(n, turns, seed=seed))
        assert _ints(bench.branching_prompts(n, turns, seed=seed)) == _ints(
            jbench.branching_prompts(n, turns, seed=seed))
    bases = [[1, 2, 3], [4, 5], [6]]
    got = bench._turn_waves(bases, 4, 10, np.random.RandomState(7))
    want = jbench._turn_waves(bases, 4, 10, np.random.RandomState(7))
    assert _ints(got) == _ints(want)


def test_replica_sweep_rows_match_reference():
    got = bench.replica_sweep((1, 2, 4), n_requests=16)
    want = jbench.replica_sweep((1, 2, 4), n_requests=16)
    assert [set(r) for r in got] == [set(r) for r in want]
    assert _unclocked(got) == _unclocked(want)
    assert [sum(r["per_replica_requests"]) for r in got] == [16] * 3


def test_affinity_sweep_rows_match_reference_and_pass_its_check():
    """At one replica every routing decision is forced, so the rows equal
    the reference's on every field that reads no clock; at two, the
    policies spill by the live queue depth, which the host's load sets, so
    the rows agree on the cells and requests and pass the checker."""
    kw = dict(n_sessions=3, turns=3, n_uniform=16, repeats=1)
    got = bench.affinity_sweep((1, 2), **kw)
    want = jbench.affinity_sweep((1, 2), **kw)
    assert [set(r) for r in got] == [set(r) for r in want]
    one = [i for i, r in enumerate(want) if r["replicas"] == 1]
    assert len(one) == 9
    assert _unclocked([got[i] for i in one]) == _unclocked(
        [want[i] for i in one])
    cells = ("stream", "policy", "replicas", "requests")
    assert [[r[k] for k in cells] for r in got] == [
        [r[k] for k in cells] for r in want]
    assert all(sum(r["per_replica_requests"]) == r["requests"] for r in got)
    check_affinity(got)


def test_real_engine_sweeps_serve_every_request():
    rows = bench.sweep_batching(common.Reporter(), n_prompts=4, device=CPU)
    assert [(r["max_num_seqs"], r["max_num_batched_tokens"])
            for r in rows] == [(s, t) for s in (2, 4, 8) for t in (128, 512)]
    assert all(r["tokens_per_s"] > 0 for r in rows)
    prompts = bench.hetero_prompts(10, seed=2)
    for policy in ("random", "balanced"):
        r = bench.routed_run(2, policy, prompts, device=CPU)
        assert sum(r["per_replica_requests"]) == len(prompts)
        assert len(r["per_replica_requests"]) == 2
        assert r["load_imbalance"] >= 1.0


def test_runner_runs_the_serving_and_kernel_suites_on_the_cpu(
        tmp_path, monkeypatch):
    monkeypatch.setattr(common, "RESULTS_DIR", str(tmp_path))
    rep = common.Reporter()
    payload, failures = run.run_suites(
        rep, ["exp3_inference", "exp4_routing", "kernels"], CPU)
    assert failures == []
    exp3 = payload["exp3_inference"]["configs"]
    assert [(r["replicas"], r["clients"], r["requests"]) for r in exp3] == [
        (1, 2, 16), (2, 4, 32), (4, 8, 64)]
    assert all(sum(r["per_replica_requests"]) == r["requests"]
               for r in exp3)
    exp4 = payload["exp4_routing"]
    assert len(exp4["sensitivity"]) == 6 and len(exp4["scaling"]) == 6
    kernels = payload["kernels"]
    assert sorted(kernels) == sorted(
        f"kernel_{k}_plain" for k in ("flash_attention", "decode_attention",
                                      "paged_decode_attention", "rwkv6_wkv",
                                      "mamba2_ssd"))
    assert all(v["max_abs_err"] is None for v in kernels.values())
    names = [name for name, _, _ in rep.rows]
    assert all(n.endswith("_plain") for n in names if n.startswith("kernel"))


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: run.main(["--only", "kernels"]),
                 lambda: _example("serve_llm").main(["--requests", "2"]),
                 lambda: _example("train_lm").main(["--steps", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("flags", [[], ["--multi-model"], ["--speculative"],
                                   ["--no-paged"]],
                         ids=["default", "multi-model", "speculative",
                              "no-paged"])
def test_serve_llm_example_on_the_cpu(flags, capsys):
    out = _example("serve_llm").main(["--device", CPU, "--requests", "6",
                                      *flags])
    assert len(out["results"]) == 6
    assert all(len(r["tokens"]) == 16 for r in out["results"])
    assert sum(out["per_replica_requests"]) == 6
    printed = capsys.readouterr().out
    assert "served 6 requests" in printed
    if "--no-paged" in flags:
        assert "paged-block telemetry" not in printed
    if "--speculative" in flags:
        assert out["per_group"]["chat"]["proposed"] > 0
    if "--multi-model" in flags:
        assert {g: s["requests"] for g, s in out["per_group"].items()} == {
            "chat": 3, "draft": 3}


def test_train_lm_example_resumes_from_its_checkpoint(tmp_path, capsys):
    mod = _example("train_lm")
    args = ["--device", CPU, "--batch", "4", "--seq", "32",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    first = mod.main(args + ["--steps", "4"])
    assert first["start"] == 0 and first["history"][0]["step"] == 0
    assert all(np.isfinite(h["loss"]) for h in first["history"])
    resumed = mod.main(args + ["--steps", "6", "--resume"])
    assert resumed["start"] == 4
    assert [h["step"] for h in resumed["history"]] == [5]
    assert "resumed from step 4" in capsys.readouterr().out
