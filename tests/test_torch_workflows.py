"""The paper's workflow classes on the PyTorch port, on the CPU: the
``TorchBackend`` composed with the pool backend in one allocation (the
port's ``tests/test_middleware.py::test_multi_backend_composition``), a
failing payload reaching ``on_complete`` as an error, the coupled and
agentic workflows of ``tests/test_system.py`` on the port's payloads and
LLM service, each ``benchmarks_torch`` suite at the reference's sizes (the
agent population at two agents) with the reference's task and decision
counts and no errors, the runner, and the three ``examples_torch``."""
import dataclasses
import importlib.util
import pathlib
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks import bench_heterogeneity as jbench_het  # noqa: E402
from benchmarks_torch import (bench_agentic, bench_coupling,  # noqa: E402
                              bench_heterogeneity, bench_scaling, common,
                              run)
from repro_torch.backends.local import PoolBackend  # noqa: E402
from repro_torch.backends.torchrt import TorchBackend  # noqa: E402
from repro_torch.core import (ResourceDescription,  # noqa: E402
                              ResourceRequirements, Rhapsody,
                              ServiceDescription, TaskDescription, TaskKind)
from repro_torch.core.agent import (AgentConfig,  # noqa: E402
                                    run_agent_population)
from repro_torch.core.coupling import make_store  # noqa: E402
from repro_torch.core.task import Task, TaskState  # noqa: E402
from repro_torch.serving.client import llm_service_factory  # noqa: E402
from repro_torch.substrate.simulation import (heat_stencil,  # noqa: E402
                                              surrogate_eval)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = "cpu"


def test_multi_backend_composition():
    """Paper's central claim: heterogeneous backends coexist in one
    allocation, each serving its partition."""
    backends = {"pool": PoolBackend(n_workers=2),
                "torch": TorchBackend(device=CPU)}
    rh = Rhapsody(ResourceDescription(nodes=4, cores_per_node=8),
                  backends=backends,
                  partitions={"pool": 2, "torch": 2})
    try:
        def compute(x):
            return (x * x + 1.0).sum()

        torch_tasks = [TaskDescription(fn=compute,
                                       args=(torch.arange(16.0) + i,),
                                       partition="torch",
                                       task_type="torch_compute")
                       for i in range(4)]
        py_tasks = [TaskDescription(fn=lambda i=i: i * 2, partition="pool",
                                    task_type="py_fn") for i in range(4)]
        uids = rh.submit(torch_tasks + py_tasks)
        assert rh.wait(uids, timeout=30)
        assert float(rh.result(torch_tasks[0].uid)) == float(
            ((torch.arange(16.0)) ** 2 + 1.0).sum())
        assert rh.result(py_tasks[3].uid) == 6
        assert backends["torch"].stats() == {"executed": 4, "queued": 0,
                                             "jit_cache": 0}
        assert backends["pool"].stats()["executed"] == 4
    finally:
        rh.close()


def test_torch_backend_reports_a_failing_payload_as_an_error():
    """A payload that raises reaches ``on_complete`` with its error and no
    result, is not counted as executed, and the executor thread goes on;
    through the middleware the task ends FAILED and ``result`` raises."""
    done, seen = threading.Event(), []
    backend = TorchBackend(device=CPU)

    def on_complete(task, result, error):
        seen.append((task.uid, result, error))
        if len(seen) == 2:
            done.set()

    def boom():
        raise ValueError("payload failed")

    backend.start(on_complete)
    try:
        bad = Task(TaskDescription(fn=boom))
        good = Task(TaskDescription(fn=lambda: torch.ones(3).sum()))
        backend.submit(bad)
        backend.submit(good)
        assert done.wait(10)
    finally:
        backend.shutdown()
    (uid0, res0, err0), (uid1, res1, err1) = seen
    assert uid0 == bad.uid and res0 is None
    assert isinstance(err0, ValueError) and "payload failed" in str(err0)
    assert uid1 == good.uid and err1 is None and float(res1) == 3.0
    assert backend.stats()["executed"] == 1
    caps = backend.capabilities()
    assert caps.max_concurrency == 1 and caps.supports_gpu

    rh = Rhapsody(ResourceDescription(nodes=1, cores_per_node=4),
                  backends={"torch": TorchBackend(device=CPU)},
                  partitions={"torch": 1})
    try:
        t = TaskDescription(fn=boom, partition="torch")
        assert rh.wait(rh.submit([t]), timeout=10)
        assert rh.state(t.uid) == TaskState.FAILED
        with pytest.raises(ValueError, match="payload failed"):
            rh.result(t.uid)
    finally:
        rh.close()


def test_torch_backend_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchBackend()


def demo_cfg():
    return bench_agentic.demo_cfg()


def test_heterogeneous_campaign():
    """§II-A: concurrent serial/MPI/CPU/GPU tasks with dependencies, on the
    port's payloads.  A first simulation, submitted before the pipelines,
    holds until a score has started, so the two types overlap however
    fast the payloads run."""
    rh = Rhapsody(ResourceDescription(nodes=4, cores_per_node=8,
                                      gpus_per_node=2), n_workers=4)
    scoring = threading.Event()

    def held_sim(**kw):
        assert scoring.wait(30)
        return heat_stencil(**kw)

    def score(**kw):
        scoring.set()
        return surrogate_eval(**kw)

    sim_kw = {"n": 32, "steps": 4, "device": CPU}
    mpi = ResourceRequirements(ranks=2, cores_per_rank=2)
    try:
        descs = [TaskDescription(kind=TaskKind.EXECUTABLE, fn=held_sim,
                                 kwargs=dict(sim_kw, seed=6),
                                 requirements=mpi, task_type="mpi_sim")]
        for i in range(6):
            sim = TaskDescription(
                kind=TaskKind.EXECUTABLE, fn=heat_stencil,
                kwargs=dict(sim_kw, seed=i), requirements=mpi,
                task_type="mpi_sim")
            descs.append(sim)
            descs.append(TaskDescription(
                fn=score, kwargs={"dim": 16, "hidden": 32, "seed": i,
                                  "device": CPU},
                requirements=ResourceRequirements(gpus_per_rank=1),
                task_type="gpu_score", dependencies=[sim.uid]))
        uids = rh.submit(descs)
        assert rh.wait(uids, timeout=60)
        shapes = {(d.task_type, rh.result(d.uid).shape) for d in descs}
        assert shapes == {("mpi_sim", (34, 32)),  # 2 ranks + halos
                          ("gpu_score", (32, 1))}
        assert rh.events.peak_hw() >= 2  # genuinely overlapped types
    finally:
        rh.close()


@pytest.mark.parametrize("kind", ["memory", "filesystem"])
def test_coupled_simulation_inference(kind):
    """§II-C: sim -> store -> inference pairs with real array payloads."""
    rh = Rhapsody(ResourceDescription(nodes=1, cores_per_node=8), n_workers=2)
    store = make_store(kind)
    try:
        def sim(key, seed):
            grid = heat_stencil(n=16, steps=2, seed=seed, device=CPU)
            store.put(key, grid.ravel()[:256].astype(np.float32))
            return True

        def infer(key):
            data = store.get(key, timeout=10)
            return float(surrogate_eval(data[:64][None, :],
                                        device=CPU).mean())

        descs = []
        for i in range(8):
            s = TaskDescription(kind=TaskKind.COUPLED, fn=sim,
                                args=(f"k{i}", i), task_type="sim")
            f = TaskDescription(kind=TaskKind.COUPLED, fn=infer,
                                args=(f"k{i}",), dependencies=[s.uid],
                                task_type="infer")
            descs.extend([s, f])
        uids = rh.submit(descs)
        assert rh.wait(uids, timeout=60)
        st = store.stats.summary()
        assert st["puts"] == 8 and st["gets"] == 8
        assert all(np.isfinite(rh.result(d.uid)) for d in descs[1::2])
    finally:
        store.close()
        rh.close()


def test_agentic_control_loop():
    """§II-C agentic: decisions realized as HPC tasks (the copied agent's
    default ``noop`` tool, imported from the port's substrate) with
    bounded lag, through the port's LLM service."""
    rh = Rhapsody(ResourceDescription(nodes=2, cores_per_node=8), n_workers=2)
    try:
        rh.add_service(ServiceDescription(
            name="llm", factory=llm_service_factory(
                demo_cfg(), device=CPU, max_num_seqs=4, max_len=64,
                prefill_buckets=(16,))))
        cfgs = [AgentConfig(name=f"a{k}", service="llm", n_decisions=2,
                            tasks_per_decision=2,
                            decision_payload=lambda i: {
                                "prompt": [3, 1, 4, 1, 5],
                                "max_new_tokens": 2})
                for k in range(2)]
        out = run_agent_population(rh, cfgs)
        assert out["decisions"] == 4
        assert out["tasks"] == 8
        assert not out["errors"]
        lags = rh.events.realization_lag()
        assert lags and max(lags) < 30.0
    finally:
        rh.close()


def test_exp1_scaling_at_the_reference_sizes():
    rep = common.Reporter()
    out = bench_scaling.main(rep)
    assert [r["tasks"] for r in out["weak"]] == [2048, 4096, 8192, 16384]
    assert [r["tasks"] for r in out["strong"]] == [8192] * 4
    assert all(r["done"] == r["tasks"] for r in out["weak"] + out["strong"])
    assert len(rep.rows) == 8


def _shape(desc):
    """A task description's traffic, without the port's device kwarg."""
    kwargs = {k: v for k, v in desc.kwargs.items() if k != "device"}
    return (desc.kind.value, desc.fn.__name__, kwargs,
            dataclasses.astuple(desc.requirements), desc.task_type,
            len(desc.dependencies))


def test_exp2_heterogeneity_has_the_reference_campaign_and_runs():
    for n in (24, 48):
        mine = bench_heterogeneity.build_campaign(n, device=CPU)
        ref = jbench_het.build_campaign(n)
        assert [_shape(d) for d in mine] == [_shape(d) for d in ref]
        assert all(d.kwargs["device"] == torch.device(CPU) for d in mine)
    out = bench_heterogeneity.main(common.Reporter(), device=CPU)
    assert [(c["pipelines"], c["nodes"]) for c in out["campaigns"]] == \
        [(24, 4), (48, 16)]
    for c in out["campaigns"]:
        assert c["done"] == c["tasks"] == 3 * c["pipelines"]
        assert c["distinct_types"] == 6 and c["peak_hw"] >= 1


def test_exp5_coupling_at_the_reference_sizes():
    out = bench_coupling.main(common.Reporter(), device=CPU)
    assert [(r["pairs"], r["store"]) for r in out["runs"]] == [
        (32, "memory"), (32, "filesystem"), (128, "memory"),
        (128, "filesystem")]
    for r in out["runs"]:
        assert r["puts"] == r["gets"] == r["pairs"]
        assert r["bytes_moved"] == 2 * r["pairs"] * bench_coupling.TENSOR * 4
        assert r["total_s"] > 0 and r["compute_s"] > 0


def test_exp6_agentic_at_two_agents():
    """The reference's population (4 decisions an agent, 2 tool tasks a
    decision, 12-token prompts, 4 new tokens) at two agents."""
    out = bench_agentic.main(common.Reporter(), populations=(2,),
                             device=CPU)
    (r,) = out["populations"]
    assert r["agents"] == 2 and r["decisions"] == 2 * 4
    assert r["tasks"] == 2 * 4 * 2
    assert r["errors"] == [] and r["decision_errors"] == 0
    assert r["replica_errors"] == [] and r["decode_steps"] > 0
    assert r["peak_arr"] > 0 and r["peak_decision_rate"] > 0
    assert 0 <= r["p50_lag_s"] <= r["p95_lag_s"] < 30.0


def test_qos_phase_runs_both_classes():
    """One contended phase of the QoS campaign, cut to a few decisions:
    every decision of both classes resolves and the batch tasks finish."""
    row = bench_agentic._qos_phase(
        "qos", demo_cfg(), qos_on=True, with_low=True, n_high=1, n_low=2,
        high_decisions=2, low_decisions=2, device=CPU)
    assert row["high_decisions"] == 2 and row["low_decisions"] == 4
    assert row["decision_errors"] == 0 and row["agent_errors"] == []
    assert row["batch_completed"] == row["batch_tasks"] == 16
    assert set(row["per_tenant"]) >= {"batch", "interactive"}


def test_runner_writes_its_own_results_file(tmp_path, monkeypatch,
                                                capsys):
    monkeypatch.setattr(common, "RESULTS_DIR", str(tmp_path))
    assert run.main(["--device", CPU, "--only", "exp5_coupling"]) == 0
    assert (tmp_path / "benchmarks_torch.json").exists()
    assert not (tmp_path / "benchmarks.json").exists()
    assert "exp5_memory_n32" in capsys.readouterr().out
    assert set(run.SUITES) == {"exp1_scaling", "exp2_heterogeneity",
                               "exp3_inference", "exp4_routing",
                               "exp5_coupling", "exp6_agentic", "kernels",
                               "roofline"}
    with pytest.raises(ValueError, match="unknown suites"):
        run.run_suites(common.Reporter(), ["no_such_suite"], CPU)
    monkeypatch.setitem(run.SUITES, "exp1_scaling",
                        lambda rep, device: 1 / 0)
    _, failures = run.run_suites(common.Reporter(), ["exp1_scaling"], CPU)
    assert failures and failures[0][0] == "exp1_scaling"


@pytest.mark.parametrize("name", ["quickstart", "agentic_campaign",
                                  "coupled_active_learning"])
def test_examples_run_on_the_cpu(name, capsys):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(CPU)
    printed = capsys.readouterr().out
    assert printed.strip()
