"""The serving paths end to end: ``Rhapsody`` -> ``ReplicaSet`` (2
replicas) -> ``LLMServicer`` -> the paged engine (dense) or the slot pool
(rwkv6), in both packages on the same weights and the same requests:
every request's greedy tokens must be identical.  The servicer's pool
policy, then the port's launcher, on the CPU."""
import numpy as np
import pytest

pytest.importorskip("torch")

from _torch_parity import build  # noqa: E402
from repro import core as jcore  # noqa: E402
from repro.serving.client import (  # noqa: E402
    llm_service_factory as jax_factory)
from repro_torch import core as tcore  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.serving.client import (LLMServicer,  # noqa: E402
                                        llm_model_group, llm_service_factory)

ENGINE_KW = dict(max_num_seqs=4, max_num_batched_tokens=64, max_len=64,
                 prefill_buckets=(16, 32), block_size=8)


def _serve(core, factory, prompts):
    rh = core.Rhapsody(core.ResourceDescription(nodes=2, cores_per_node=4),
                       n_workers=2)
    try:
        rs = rh.add_service(core.ServiceDescription(
            name="llm", replicas=2, factory=factory))
        descs = [core.TaskDescription(kind=core.TaskKind.INFERENCE,
                                      service="llm",
                                      payload={"prompt": p,
                                               "max_new_tokens": 5})
                 for p in prompts]
        uids = rh.submit(descs)
        assert rh.wait(uids, timeout=120)
        results = [rh.result(u) for u in uids]
        assert all(inst.error is None for inst in rs.instances)
        per_replica = [p["requests"] for p in rs.stats()["per_replica"]]
        return [r["tokens"] for r in results], per_replica
    finally:
        rh.close()


@pytest.mark.parametrize("arch", [None, "rwkv6-1.6b"])
def test_two_replica_service_matches_reference(arch):
    """Dense replicas auto-resolve to the paged engine, rwkv6 replicas to
    the slot pool (the paged knobs of ``ENGINE_KW`` are stripped)."""
    cfg, _, params, tcfg, tparams = build(arch=arch)
    rng = np.random.RandomState(0)
    prompts = [list(map(int, rng.randint(1, cfg.vocab, size=n)))
               for n in (4, 9, 13, 20, 6, 31, 11, 17)]
    ref, _ = _serve(jcore, jax_factory(cfg, params, **ENGINE_KW), prompts)
    out, per_replica = _serve(
        tcore, llm_service_factory(tcfg, tparams, device="cpu", **ENGINE_KW),
        prompts)
    assert out == ref
    assert all(len(t) == 5 for t in out)
    assert sum(per_replica) == len(prompts) and len(per_replica) == 2


def test_servicer_resolves_the_pool_as_the_reference():
    """``paged=None`` gives dense configs the paged engine and rwkv6 /
    zamba2 the slot pool with the paged-only knobs stripped; an explicit
    ``paged=False`` forces the slot pool; ``paged=True`` is refused for a
    state-carrying family with the reference's ``ValueError``."""
    _, _, _, tcfg, tparams = build()
    knobs = dict(max_num_seqs=2, max_len=32, prefill_buckets=(16,),
                 block_size=8, num_blocks=16, device="cpu")
    assert LLMServicer(tcfg, tparams, **knobs).engine.paged
    s = LLMServicer(tcfg, tparams, paged=False, **knobs)
    assert not s.engine.paged and s.block_telemetry() is None
    for arch in ("rwkv6-1.6b", "zamba2-2.7b"):
        _, _, _, scfg, sparams = build(arch=arch)
        s = LLMServicer(scfg, sparams, **knobs)
        assert not s.engine.paged and s.block_telemetry() is None
        s.warmup()
        assert s.stats.prefill_tokens == 4 and not s.engine.running
        with pytest.raises(ValueError, match="paged=True requires"):
            LLMServicer(scfg, sparams, paged=True, **knobs)


def test_servicer_hooks_and_unported_options():
    """The servicer's hooks on a unified replica; the disaggregated
    phases and QoS build (``tests/test_torch_{disagg,qos}.py`` hold them
    to the reference)."""
    _, _, _, tcfg, tparams = build()
    s = LLMServicer(tcfg, tparams, device="cpu", **ENGINE_KW)
    assert s.engine.paged and s.engine.paged_decode_mode == "direct"
    s.warmup()
    assert s.stats.prefill_tokens == 4
    assert s.block_telemetry()["total_blocks"] > 0
    assert s.spec_stats() is None and s.qos_stats() is None
    assert s.handoff_stats() is None
    uid = s.submit({"prompt": [5, 6, 7], "max_new_tokens": 3})
    results = []
    while not results:
        results = s.step()
    assert results[0][0] == uid and len(results[0][1]["tokens"]) == 3
    for kw, hs, qs in (({"phase": "prefill"}, "prefill", None),
                       ({"phase": "decode"}, "decode", None),
                       ({"qos": True}, None, 0)):
        sv = LLMServicer(tcfg, tparams, device="cpu", **kw, **ENGINE_KW)
        assert (sv.handoff_stats() or {}).get("role") == hs
        assert (sv.qos_stats() or {}).get("preempted") == qs
    for role in ("prefill", "decode"):
        group = llm_model_group("p", tcfg, tparams, role=role, device="cpu",
                                **ENGINE_KW)
        assert group.role == role and group.factory().phase == role


def test_launcher_runs_on_cpu(capsys):
    out = serve.main(["--device", "cpu", "--smoke", "--replicas", "2",
                      "--requests", "4", "--max-new-tokens", "3"])
    assert all(len(r["tokens"]) == 3 for r in out["results"])
    assert out["errors"] == [None, None]
    assert out["decode_steps"] > 0
    printed = capsys.readouterr().out
    assert "[serve] 4 requests" in printed
    assert "per-replica requests" in printed
    out = serve.main(["--device", "cpu", "--disagg", "--replicas", "2",
                      "--requests", "4", "--max-new-tokens", "3"])
    assert all(r.get("handoff") is True and len(r["tokens"]) == 3
               for r in out["results"])
    assert out["handoff_totals"]["exports"] == 4


@pytest.mark.parametrize("flags", [["--arch", "rwkv6-1.6b"], ["--no-paged"]])
def test_launcher_serves_the_slot_pool_on_cpu(flags, capsys):
    """rwkv6 (its smoke config, as the launcher's config choice says) and
    a dense ``--no-paged`` launch run on the slot pool."""
    out = serve.main(["--device", "cpu", "--smoke", "--replicas", "2",
                      "--requests", "4", "--max-new-tokens", "3"] + flags)
    assert all(len(r["tokens"]) == 3 for r in out["results"])
    assert out["errors"] == [None, None]
    assert out["decode_steps"] > 0
    assert "paged-block telemetry" not in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "moonshot-v1-16b-a3b"])
def test_launcher_serves_moe_archs_on_cpu(arch, capsys):
    """``--arch`` of an MoE arch serves its smoke config (as the
    reference's launcher does) on the paged pool."""
    out = serve.main(["--device", "cpu", "--arch", arch, "--replicas", "2",
                      "--requests", "4", "--max-new-tokens", "3"])
    assert all(len(r["tokens"]) == 3 for r in out["results"])
    assert out["errors"] == [None, None]
    assert out["decode_steps"] > 0
    printed = capsys.readouterr().out
    assert f"[serve] {arch} x 2 replicas" in printed
    assert "paged-block telemetry" in printed
