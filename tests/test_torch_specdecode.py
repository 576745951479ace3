"""The port's speculative decoding against the JAX package's, on the same
weights: the leftover-token acceptance rule, the draft-propose /
target-verify ``SpecDecodeSession`` (greedy transcripts equal to the
reference session's and to target-only decode across slot-pool and paged
mixes, a MoE target, same-model full acceptance, a perturbed draft, the
adaptive disable; the proposal counters equal the reference's), the
servicer's ``draft_group``, and the replica set's per-group spec telemetry
and the ``weighted_capacity`` autoscaler on the copied middleware,
scenario by scenario as ``tests/test_specdecode.py``."""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models.config import ModelConfig as JaxConfig  # noqa: E402
from repro.serving import client as jclient  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving import sampling as jsampling  # noqa: E402
from repro_torch.core import (ExecutionPolicy, ModelGroup,  # noqa: E402
                              ResourceDescription, ResourceRequirements,
                              Rhapsody, ServiceDescription,
                              WeightedCapacityAutoscaler)
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving.client import (LLMServicer,  # noqa: E402
                                        llm_model_group)
from repro_torch.serving.engine import (InferenceEngine,  # noqa: E402
                                        SpecDecodeSession)
from repro_torch.serving.sampling import speculative_accept  # noqa: E402

# ---------------------------------------------------------------------------
# speculative_accept: the leftover-token acceptance rule
# ---------------------------------------------------------------------------


def _i(rows):
    return torch.tensor(rows, dtype=torch.int64)


def _jax_accept(proposed, target):
    return jsampling.speculative_accept(np.asarray(proposed),
                                        np.asarray(target))


def test_speculative_accept_longest_matching_prefix():
    proposed = [[5, 6, 7],  # all accepted
                [5, 9, 7],  # diverges at position 1
                [9, 6, 7],  # diverges immediately
                [5, 6, 9]]  # diverges at the last proposal
    target = [[5, 6, 7, 8]] * 4
    n = speculative_accept(_i(proposed), _i(target))
    assert n.tolist() == [3, 1, 0, 2]
    assert n.tolist() == np.asarray(_jax_accept(proposed, target)).tolist()


def test_speculative_accept_ignores_matches_after_divergence():
    n = speculative_accept(_i([[1, 6, 7]]), _i([[5, 6, 7, 8]]))
    assert n.tolist() == [0]


def test_speculative_accept_emitted_tokens_are_target_picks():
    target = _i([[5, 6, 7, 8]])
    a = int(speculative_accept(_i([[5, 9, 7]]), target)[0])
    assert target[0, :a + 1].tolist() == [5, 6]


def test_speculative_accept_shape_validation():
    for p, t in (((2, 3), (2, 3)), ((3,), (4,))):
        with pytest.raises(ValueError, match="expected proposed"):
            speculative_accept(torch.zeros(p), torch.zeros(t))
        with pytest.raises(ValueError):
            _jax_accept(np.zeros(p), np.zeros(t))


# ---------------------------------------------------------------------------
# SpecDecodeSession against the reference session, same weights
# ---------------------------------------------------------------------------

_KW = dict(max_num_seqs=4, max_len=128)


def _mk_cfg(family="dense", n_layers=2):
    moe = dict(n_experts=4, top_k=2) if family == "moe" else {}
    return JaxConfig(family=family, vocab=64, d_model=32,
                     n_layers=n_layers, n_heads=4, **moe)


def _prompts(seed=0, lens=(5, 9, 3, 7)):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, 64, size=n))) for n in lens]


def _pair(cfg, seed, paged, noise=None):
    """The reference engine from ``seed`` and the port's on its weights
    (plus ``noise``, a {path: ndarray} added to both)."""
    ref = jengine.make_engine_from_scratch(cfg, seed=seed, paged=paged, **_KW)
    tree = jax.tree.map(np.array, ref.params)
    if noise is not None:
        tree = noise(tree)
        ref.params = jax.tree.map(jax.numpy.asarray, tree)
    tcfg = ModelConfig(**dataclasses.asdict(cfg))
    eng = InferenceEngine(tcfg, params_from_numpy(tree, tcfg, "cpu"),
                          device="cpu", paged=paged, **_KW)
    return ref, eng


def _perturb(scale, seed=9):
    """Add ``scale`` x N(0, 1) noise drawn from a seeded torch generator to
    every float leaf of a numpy tree."""
    gen = torch.Generator().manual_seed(seed)

    def noise(tree):
        return jax.tree.map(
            lambda a: a + scale * torch.randn(
                a.shape, generator=gen).numpy().astype(a.dtype), tree)

    return noise


def _run(sess, prompts, max_new):
    uids = [sess.submit(p, max_new_tokens=max_new) for p in prompts]
    done = sess.run()
    return [done[u].output for u in uids]


def _spec_both(tcfg, dcfg, prompts, paged_t, paged_d, max_new=10, dseed=2,
               perturb=0.0, **sess_kw):
    """Transcripts and counters of the reference session and the port's
    on the same target and draft weights, and target-only decode's."""
    noise = _perturb(perturb) if perturb else None
    k = sess_kw.pop("k", 3)
    jt, tt = _pair(tcfg, 1, paged_t)
    jd, td = _pair(dcfg, dseed, paged_d, noise)
    jsess = jengine.SpecDecodeSession(jt, jd, k=k, **sess_kw)
    sess = SpecDecodeSession(tt, td, k=k, **sess_kw)
    want = _run(jsess, prompts, max_new)
    got = _run(sess, prompts, max_new)
    assert got == want
    assert sess.spec_stats() == jsess.spec_stats()
    for name in ("decode_tokens", "prefill_tokens", "steps"):
        assert getattr(tt.stats, name) == getattr(jt.stats, name), name
    _, plain = _pair(tcfg, 1, paged_t)
    assert _run(plain, prompts, max_new) == got
    return got, sess


@pytest.mark.parametrize("paged_t,paged_d", [(False, False), (True, True),
                                             (True, False)])
def test_spec_greedy_equivalence_dense(paged_t, paged_d):
    _, sess = _spec_both(_mk_cfg(), _mk_cfg(n_layers=1), _prompts(),
                         paged_t, paged_d)
    ss = sess.spec_stats()
    assert ss["proposed"] > 0 and ss["rounds"] > 0 and ss["enabled"]
    assert 0.0 <= ss["acceptance_rate"] <= 1.0


def test_spec_greedy_equivalence_moe_target():
    _spec_both(_mk_cfg("moe"), _mk_cfg(n_layers=1), _prompts(), True, True)


@pytest.mark.parametrize("paged", [False, True])
def test_spec_same_model_full_acceptance(paged):
    """Draft == target: every proposal accepted (the a == k bonus path and
    the two-token ``draft_pending`` resume)."""
    cfg = _mk_cfg()
    _, sess = _spec_both(cfg, cfg, _prompts(seed=1), paged, paged, dseed=1)
    assert sess.spec_stats()["acceptance_rate"] == 1.0


@pytest.mark.parametrize("paged", [False, True])
def test_spec_perturbed_draft_ragged_acceptance(paged):
    """A slightly-off draft (the target's weights plus seeded noise):
    acceptance is ragged, 0 < rate < 1, which walks the partial-rewind
    paths."""
    cfg = _mk_cfg()
    _, sess = _spec_both(cfg, cfg, _prompts(seed=1), paged, paged, dseed=1,
                         perturb=0.02)
    assert 0.0 < sess.spec_stats()["acceptance_rate"] < 1.0


def test_spec_adaptive_disable_still_matches_vanilla():
    """A hopeless draft trips the acceptance floor after the probe window:
    the session falls back to target-only steps for good."""
    _, sess = _spec_both(_mk_cfg(), _mk_cfg(n_layers=1), _prompts(), True,
                         True, max_new=16, min_acceptance=0.9,
                         probe_proposals=8)
    assert sess.spec_stats()["enabled"] is False


def test_spec_session_rejects_sampling_and_validates_k():
    _, tgt = _pair(_mk_cfg(), 1, True)
    _, drf = _pair(_mk_cfg(n_layers=1), 2, True)
    with pytest.raises(ValueError, match="k must be"):
        SpecDecodeSession(tgt, drf, k=0)
    sess = SpecDecodeSession(tgt, drf, k=2)
    with pytest.raises(ValueError, match="greedy"):
        sess.submit([1, 2, 3], max_new_tokens=4, temperature=0.7)
    with pytest.raises(ValueError, match="max_len"):
        sess.submit([1, 2, 3], max_new_tokens=125)


def _drive(sv, prompts, max_new=8):
    uids = [sv.submit({"prompt": p, "max_new_tokens": max_new})
            for p in prompts]
    out = {}
    for _ in range(400):
        for uid, res in sv.step():
            out[uid] = res["tokens"]
        if len(out) == len(uids):
            return [out[u] for u in uids]
    raise AssertionError("servicer did not finish")


def test_servicer_draft_group_threading_matches_plain():
    """``LLMServicer(draft_group=ModelGroup)`` resolves the draft through
    the group's factory and serves greedy requests as a plain servicer
    and as the reference's servicer with the same draft do."""
    tcfg, dcfg = _mk_cfg(), _mk_cfg(n_layers=1)
    jt, _ = _pair(tcfg, 1, True)
    jd, _ = _pair(dcfg, 2, True)
    tparams = jax.tree.map(np.array, jt.params)
    dparams = jax.tree.map(np.array, jd.params)
    pt = ModelConfig(**dataclasses.asdict(tcfg))
    pd = ModelConfig(**dataclasses.asdict(dcfg))
    dg = llm_model_group("draft", pd, params_from_numpy(dparams, pd, "cpu"),
                         role="draft", paired_with="chat", min_replicas=0,
                         device="cpu", **_KW)
    assert (dg.role, dg.paired_with, dg.min_replicas) == ("draft", "chat", 0)
    tp = params_from_numpy(tparams, pt, "cpu")
    plain = LLMServicer(pt, tp, device="cpu", **_KW)
    spec = LLMServicer(pt, tp, draft_group=dg, spec_k=3, device="cpu", **_KW)
    ref = jclient.LLMServicer(
        tcfg, jt.params, draft_group=jclient.llm_model_group(
            "draft", dcfg, jd.params, role="draft", paired_with="chat",
            min_replicas=0, **_KW), spec_k=3, **_KW)
    assert plain.spec_stats() is None
    prompts = _prompts()
    assert _drive(plain, prompts) == _drive(spec, prompts) \
        == _drive(ref, prompts)
    assert spec.spec_stats() == ref.spec_stats()
    assert spec.spec_stats()["proposed"] > 0


def test_servicer_resolves_every_draft_shape():
    """A draft given as an engine, a servicer, a group or a config (a
    fresh engine from the servicer's seed, on the target's device); a
    disaggregated phase with a draft is refused as in the reference."""
    cfg = ModelConfig(**dataclasses.asdict(_mk_cfg(n_layers=1)))
    params = get_model(cfg).init(torch.Generator().manual_seed(0), cfg,
                                 device="cpu")
    eng = InferenceEngine(cfg, params, device="cpu", paged=True, **_KW)
    sv = LLMServicer(cfg, params, device="cpu", **_KW)
    for draft, want in ((eng, eng), (sv, sv.engine)):
        s = LLMServicer(cfg, params, draft_group=draft, device="cpu", **_KW)
        assert s.session.draft is want
    s = LLMServicer(cfg, params, draft_group=cfg, device="cpu", **_KW)
    assert s.session.draft.paged and s.session.draft.device.type == "cpu"
    with pytest.raises(ValueError, match="no factory"):
        LLMServicer(cfg, params, draft_group=ModelGroup(name="d"),
                    device="cpu", **_KW)
    with pytest.raises(TypeError):
        LLMServicer(cfg, params, draft_group=object(), device="cpu", **_KW)
    with pytest.raises(ValueError, match="do not compose"):
        LLMServicer(cfg, params, draft_group=cfg, phase="decode",
                    device="cpu", **_KW)


# ---------------------------------------------------------------------------
# replica set: per-group spec telemetry + per-group scaling bounds
# ---------------------------------------------------------------------------


class SpecTagged:
    """Sync servicer faking a spec session's counters (the target group's
    servicers host the sessions; plain replicas report None)."""

    def __init__(self, tag, proposed=None, accepted=0):
        self.tag, self.proposed, self.accepted = tag, proposed, accepted

    def handle(self, payload):
        return {"served_by": self.tag}

    def spec_stats(self):
        if self.proposed is None:
            return None
        return {"k": 4, "proposed": self.proposed, "accepted": self.accepted,
                "acceptance_rate": self.accepted / max(1, self.proposed),
                "rounds": 1, "enabled": True}


def _spec_pair_rh(**policy_kw):
    rh = Rhapsody(ResourceDescription(nodes=1, cores_per_node=8),
                  policy=ExecutionPolicy(**policy_kw), n_workers=1)
    rs = rh.add_service(ServiceDescription(
        name="llm",
        requirements=ResourceRequirements(ranks=1, cores_per_rank=1),
        models=[ModelGroup(name="chat",
                           factory=lambda: SpecTagged("chat", 100, 70),
                           replicas=2),
                ModelGroup(name="draft",
                           factory=lambda: SpecTagged("draft"),
                           role="draft", paired_with="chat",
                           min_replicas=0, max_replicas=2, replicas=1)]))
    return rh, rs


def test_per_group_stats_carry_spec_counters_and_roles():
    rh, rs = _spec_pair_rh()
    try:
        assert rs.spec_totals() == (200, 140)  # 2 chat replicas x (100, 70)
        pg = rs.stats()["per_group"]
        assert pg["chat"]["role"] == "serve"
        assert (pg["chat"]["proposed"], pg["chat"]["accepted"]) == (200, 140)
        assert pg["chat"]["acceptance_rate"] == pytest.approx(0.7)
        assert pg["draft"]["role"] == "draft"
        assert pg["draft"]["proposed"] == 0
        assert pg["draft"]["acceptance_rate"] == pytest.approx(0.7)
    finally:
        rh.close()


def test_replica_set_sums_the_port_sessions_counters():
    """Real port servicers with a draft behind the replica set: the
    set-wide counters are the sum of their sessions' ``spec_stats()``."""
    cfg = ModelConfig(**dataclasses.asdict(_mk_cfg(n_layers=1)))
    params = get_model(cfg).init(torch.Generator().manual_seed(1), cfg,
                                 device="cpu")
    rh = Rhapsody(ResourceDescription(nodes=2, cores_per_node=4),
                  n_workers=2)
    try:
        rs = rh.add_service(ServiceDescription(
            name="llm", replicas=2, factory=lambda: LLMServicer(
                cfg, params, draft_group=cfg, spec_k=2, device="cpu",
                **_KW)))
        futs = [rs.request({"prompt": p, "max_new_tokens": 6})
                for p in _prompts()]
        assert all(len(f.result(120.0)["tokens"]) == 6 for f in futs)
        per = [inst.servicer.spec_stats() for inst in rs.instances]
        assert rs.spec_totals() == (sum(s["proposed"] for s in per),
                                    sum(s["accepted"] for s in per))
        assert rs.spec_totals()[0] > 0
    finally:
        rh.close()


def test_group_bounds_and_scale_groups_clamping():
    rh, rs = _spec_pair_rh()
    try:
        assert rs.group_bounds("chat") == (1, None)
        assert rs.group_bounds("draft") == (0, 2)
        rs.scale_groups({"chat": 0, "draft": 0})
        assert rs.group_counts() == {"chat": 1, "draft": 0}
        rs.scale_groups({"chat": 1, "draft": 5})
        assert rs.group_counts() == {"chat": 1, "draft": 2}
        assert rs.request({"prompt": [1], "model": "chat"}
                          ).result(10.0)["served_by"] == "chat"
    finally:
        rh.close()


def test_draft_affinity_aliases_to_target_group():
    rh, rs = _spec_pair_rh()
    try:
        assert rs._affinity_alias("draft") == "chat"
        assert rs._affinity_alias("chat") == "chat"
    finally:
        rh.close()


# ---------------------------------------------------------------------------
# weighted_capacity: acceptance-driven draft entitlements (unit, fake rs)
# ---------------------------------------------------------------------------


class SpecGroupRS:
    """The group surface desired_groups() consumes, plus the spec-decode
    extensions (roles / per-group bounds / set-wide counters)."""

    multi_model = True

    def __init__(self, counts, p95_s, depths, headroom=None, weights=None,
                 roles=None, bounds=None, spec=(0, 0)):
        self._counts = dict(counts)
        self._p95 = dict(p95_s)
        self._depths = dict(depths)
        self._headroom = headroom
        self._weights = weights or {g: 1.0 for g in counts}
        self._roles = roles or {}
        self._bounds = bounds or {}
        self._spec = spec
        self.denied = 0

    def group_counts(self):
        return dict(self._counts)

    def group_weight(self, g):
        return self._weights[g]

    def group_slo_ms(self, g):
        return 100.0

    def group_role(self, g):
        return self._roles.get(g, "serve")

    def group_bounds(self, g):
        return self._bounds.get(g, (1, None))

    def spec_totals(self):
        return self._spec

    def latency_p95(self, window_s=None, started_after=None, group=None):
        return self._p95[group]

    def mean_depth(self, group=None):
        return self._depths[group]

    def capacity_headroom(self, group=None):
        return self._headroom

    def _note_admission_denied(self, where, once_per_episode=False):
        self.denied += 1


def spec_scaler(**kw):
    kw.setdefault("autoscaler", "weighted_capacity")
    kw.setdefault("autoscale_sustain_up", 1)
    kw.setdefault("autoscale_sustain_down", 1)
    kw.setdefault("autoscale_max_replicas", 8)
    kw.setdefault("autoscale_low_depth", 0.5)
    kw.setdefault("slo_p95_ms", 100.0)
    return WeightedCapacityAutoscaler(ExecutionPolicy(**kw))


def test_low_acceptance_force_shrinks_draft_without_sustain():
    a = spec_scaler(autoscale_sustain_down=5, spec_min_acceptance=0.3,
                    spec_min_proposed=100)
    rs = SpecGroupRS({"chat": 2, "draft": 2},
                     {"chat": 0.06, "draft": 0.02},
                     {"chat": 1.0, "draft": 1.0}, headroom=2,
                     roles={"draft": "draft"},
                     bounds={"draft": (0, None)},
                     spec=(500, 50))  # 10% acceptance: below the floor
    assert a.desired_groups("s", rs) == {"chat": 2, "draft": 1}
    rs._counts["draft"] = 1
    assert a.desired_groups("s", rs) == {"chat": 2, "draft": 0}
    rs._counts["draft"] = 0
    assert a.desired_groups("s", rs) is None  # at its explicit floor


def test_low_acceptance_respects_default_floor():
    a = spec_scaler(spec_min_acceptance=0.3, spec_min_proposed=100)
    rs = SpecGroupRS({"chat": 2, "draft": 1},
                     {"chat": 0.06, "draft": 0.02},
                     {"chat": 1.0, "draft": 1.0}, headroom=2,
                     roles={"draft": "draft"}, spec=(500, 0))
    assert a.desired_groups("s", rs) is None  # min_replicas defaults to 1


def test_acceptance_below_probe_threshold_is_not_judged():
    a = spec_scaler(spec_min_acceptance=0.3, spec_min_proposed=1000)
    rs = SpecGroupRS({"chat": 2, "draft": 2},
                     {"chat": 0.06, "draft": 0.02},
                     {"chat": 1.0, "draft": 5.0}, headroom=2,
                     roles={"draft": "draft"},
                     bounds={"draft": (0, None)}, spec=(500, 0))
    assert a.desired_groups("s", rs) is None


def test_acceptance_scales_draft_weight_making_it_the_donor():
    a = spec_scaler(autoscale_max_replicas=4, spec_min_acceptance=0.1,
                    spec_min_proposed=100)
    rs = SpecGroupRS({"chat": 2, "draft": 2},
                     {"chat": 0.2, "draft": 0.05},
                     {"chat": 5.0, "draft": 1.0}, headroom=0,
                     roles={"draft": "draft"},
                     bounds={"draft": (0, None)}, spec=(1000, 200))
    assert a.desired_groups("s", rs) == {"chat": 3, "draft": 1}


def test_grower_pinned_by_per_group_max_replicas():
    a = spec_scaler()
    rs = SpecGroupRS({"chat": 2, "draft": 1},
                     {"chat": 0.2, "draft": 0.06},
                     {"chat": 5.0, "draft": 1.0}, headroom=3,
                     bounds={"chat": (1, 2)})
    assert a.desired_groups("s", rs) is None


def test_donor_respects_explicit_zero_floor():
    a = spec_scaler(autoscale_max_replicas=3)
    rs = SpecGroupRS({"chat": 2, "draft": 1},
                     {"chat": 0.2, "draft": None},
                     {"chat": 5.0, "draft": 0.0}, headroom=0,
                     roles={"draft": "draft"},
                     bounds={"draft": (0, None)})
    assert a.desired_groups("s", rs) == {"chat": 3, "draft": 0}
