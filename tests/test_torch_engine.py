"""The port's block-paged engine against the JAX package's, on the same
weights and the dense scenarios of ``test_paged_serving.py``: greedy
transcripts must be identical, and so must the block accounting
(prefill/decode token counts, copy-on-write copies, prefix hits and
``block_telemetry()``)."""
import numpy as np
import pytest

pytest.importorskip("torch")

from _torch_parity import build  # noqa: E402
from repro.serving.engine import InferenceEngine as JaxEngine  # noqa: E402
from repro_torch.serving.engine import InferenceEngine  # noqa: E402

ENGINE_KW = dict(max_num_seqs=4, max_num_batched_tokens=256, max_len=64,
                 prefill_buckets=(16, 32), seed=0)


@pytest.fixture(scope="module")
def lm():
    return build()


def _drive(eng, prompts, new_tokens):
    uids = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
    done = {}
    for _ in range(100000):
        if not eng.has_work():
            break
        eng.step()
        for r in eng.collect_finished():
            done[r.uid] = r
    return [done[u].output for u in uids]


def _mixed(mk):
    rng = np.random.RandomState(1)
    prompts = [list(rng.randint(1, 512, size=n)) for n in (3, 8, 9, 17, 30)]
    eng = mk(**ENGINE_KW, block_size=8)
    return eng, _drive(eng, prompts, 6)


def _prefix_chain(mk):
    eng = mk(**ENGINE_KW, block_size=4)
    prompt, outs = [11, 12, 13, 14, 15, 16], []
    for _ in range(3):
        out = _drive(eng, [prompt], 4)[0]
        outs.append(out)
        prompt = prompt + out + [9]
    return eng, outs


def _divergence_cow(mk):
    eng = mk(**ENGINE_KW, block_size=4)
    stem = [5, 4, 3, 2, 1, 2, 3, 4, 5, 6, 7, 8]
    outs = _drive(eng, [stem], 4)
    branches = [stem[:9] + [100 + i, 101, 102] for i in range(3)]
    return eng, outs + _drive(eng, branches, 4)


def _concurrency(mk):
    rng = np.random.RandomState(2)
    prompts = [list(rng.randint(1, 512, size=6)) for _ in range(10)]
    eng = mk(**ENGINE_KW, block_size=8)
    return eng, _drive(eng, prompts, 4)


def _chunked_interleave(mk):
    rng = np.random.RandomState(3)
    prompts = [list(rng.randint(1, 512, size=5)),
               list(rng.randint(1, 512, size=40))]
    eng = mk(max_num_seqs=4, max_num_batched_tokens=8, max_len=64,
             prefill_buckets=(16, 32), seed=0, block_size=8, prefill_chunk=8)
    return eng, _drive(eng, prompts, 4)


def _eviction(mk):
    rng = np.random.RandomState(4)
    prompts = [list(rng.randint(1, 512, size=20)) for _ in range(3)]
    eng = mk(max_num_seqs=2, max_num_batched_tokens=128, max_len=32,
             prefill_buckets=(16, 32), seed=0, block_size=8, num_blocks=9)
    return eng, [_drive(eng, [p], 4)[0] for p in prompts]


def _padded_budget(mk):
    rng = np.random.RandomState(9)
    prompts = [list(rng.randint(1, 512, size=n))
               for n in (9, 9, 9, 13, 21, 30)]
    eng = mk(max_num_seqs=8, max_num_batched_tokens=24, max_len=64,
             prefill_buckets=(8, 16), seed=0, block_size=8)
    return eng, _drive(eng, prompts, 4)


def _reuse_disabled(mk):
    rng = np.random.RandomState(5)
    prompts = [list(rng.randint(1, 512, size=10)) for _ in range(3)]
    eng = mk(**ENGINE_KW, block_size=8, enable_prefix_reuse=False)
    return eng, _drive(eng, prompts, 4)


SCENARIOS = {f.__name__[1:]: f for f in (
    _mixed, _prefix_chain, _divergence_cow, _concurrency, _chunked_interleave,
    _eviction, _padded_budget, _reuse_disabled)}

COUNTERS = ("prefill_tokens", "decode_tokens", "cow_copies",
            "prefix_reuse_hits", "prefix_partial_hits",
            "prefix_cached_tokens", "evicted_residencies", "peak_running",
            "shared_block_peak", "free_blocks", "reserved_blocks")


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_engine_matches_reference(scenario, lm):
    """Exact transcripts and block accounting, scenario by scenario."""
    cfg, _, params, tcfg, tparams = lm
    run = SCENARIOS[scenario]
    ref_eng, ref_out = run(lambda **kw: JaxEngine(cfg, params, paged=True,
                                                  **kw))
    eng, out = run(lambda **kw: InferenceEngine(tcfg, tparams, device="cpu",
                                                paged=True, **kw))
    assert out == ref_out
    for name in COUNTERS:
        assert getattr(eng.stats, name) == getattr(ref_eng.stats, name), name
    assert eng.block_telemetry() == ref_eng.block_telemetry()
    assert eng.pool.alloc._ref == ref_eng.pool.alloc._ref


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_engine_gather_mode_matches_reference(scenario, lm):
    """``paged_decode_mode="gather"`` (a contiguous view through the
    slot-pool decode, the new row scattered back): the reference's
    transcripts and block accounting in the same mode."""
    cfg, _, params, tcfg, tparams = lm
    run = SCENARIOS[scenario]
    ref_eng, ref_out = run(lambda **kw: JaxEngine(
        cfg, params, paged=True, paged_decode_mode="gather", **kw))
    eng, out = run(lambda **kw: InferenceEngine(
        tcfg, tparams, device="cpu", paged=True, paged_decode_mode="gather",
        **kw))
    assert out == ref_out
    for name in COUNTERS:
        assert getattr(eng.stats, name) == getattr(ref_eng.stats, name), name
    assert eng.block_telemetry() == ref_eng.block_telemetry()
    assert eng.pool.alloc._ref == ref_eng.pool.alloc._ref


def test_engine_refuses_what_is_not_ported(lm):
    """``paged=False`` builds the slot pool, as the reference's default;
    the paged engine takes the ``"gather"`` decode mode and refuses an
    unknown one; preempting an unknown uid returns False, as the
    reference's does (``tests/test_torch_qos.py`` holds preemption)."""
    _, _, _, tcfg, tparams = lm
    slot = InferenceEngine(tcfg, tparams, device="cpu", **ENGINE_KW)
    assert not slot.paged and slot.pool.n_free == ENGINE_KW["max_num_seqs"]
    assert slot.block_telemetry() is None
    gather = InferenceEngine(tcfg, tparams, device="cpu", paged=True,
                             paged_decode_mode="gather")
    assert gather.paged_decode_mode == "gather"
    with pytest.raises(ValueError, match="paged_decode_mode"):
        InferenceEngine(tcfg, tparams, device="cpu", paged=True,
                        paged_decode_mode="telepathy")
    eng = InferenceEngine(tcfg, tparams, device="cpu", paged=True,
                          **ENGINE_KW)
    ref = JaxEngine(lm[0], lm[2], paged=True, **ENGINE_KW)
    assert eng.preempt_sequence(0) is ref.preempt_sequence(0) is False
    assert slot.preempt_sequence(0) is False
    assert eng.exportable() == [] and slot.exportable() == []
    for call in (slot.step_prefill_only, lambda: slot.export_sequence(0),
                 lambda: slot.import_sequence({})):
        with pytest.raises(ValueError, match="paged engine"):
            call()


def test_sampled_requests_terminate(lm):
    """temperature > 0 runs the sampled prefill/decode paths (no parity
    claim: the generators differ)."""
    _, _, _, tcfg, tparams = lm
    eng = InferenceEngine(tcfg, tparams, device="cpu", paged=True,
                          **ENGINE_KW, block_size=8)
    eng.submit([3, 1, 4, 1, 5, 9], max_new_tokens=5, temperature=0.8)
    (req,) = eng.run().values()
    assert len(req.output) == 5
    assert all(0 <= t < tcfg.vocab for t in req.output)


def test_engine_needs_a_card_unless_told_cpu(lm, monkeypatch):
    """No silent CPU fallback: the default device is CUDA."""
    import torch

    _, _, _, tcfg, tparams = lm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(tcfg, tparams)
