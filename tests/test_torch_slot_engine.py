"""The port's slot-pool engine (``paged=False``) against the JAX package's,
on the same weights: greedy transcripts and ``EngineStats`` counters must
be identical, and so must the pool's free slots and the resident
sequences.  Scenarios: the dense ones of ``test_serving.py`` (continuous
batching, slot reuse, the prefill-token budget, eos, prefix reuse with
partial resumes, blank-first allocation), rwkv6 and zamba2 smoke configs
with more requests than slots, and runs long enough that a free slot's
length passes ``max_len`` (its cache is full: the write is dropped and
every position attended, as in the reference)."""
import numpy as np
import pytest

pytest.importorskip("torch")

from _torch_parity import build  # noqa: E402
from repro.serving.engine import InferenceEngine as JaxEngine  # noqa: E402
from repro_torch.serving.engine import InferenceEngine  # noqa: E402

COUNTERS = ("steps", "prefill_tokens", "decode_tokens", "active_slot_steps",
            "slot_steps", "prefix_reuse_hits", "prefix_partial_hits",
            "prefix_cached_tokens")
KW = dict(max_num_seqs=4, max_num_batched_tokens=256, max_len=128,
          prefill_buckets=(16, 32, 64), seed=0)


@pytest.fixture(scope="module")
def dense():
    return build()


def _drive(eng, prompts, new_tokens, **req):
    uids = [eng.submit(p, max_new_tokens=new_tokens, **req) for p in prompts]
    done = eng.run()
    return [done[u].output for u in uids]


def _continuous_batching(mk):
    rng = np.random.RandomState(0)
    prompts = [list(rng.randint(0, 512, size=n)) for n in (5, 12, 17, 30)]
    eng = mk(**KW)
    return eng, _drive(eng, prompts, 6)


def _slot_reuse(mk):
    eng = mk(max_num_seqs=2, max_num_batched_tokens=64, max_len=64,
             prefill_buckets=(16,), seed=0)
    return eng, _drive(eng, [[1, 2, 3]] * 7, 3)


def _token_budget(mk):
    eng = mk(max_num_seqs=8, max_num_batched_tokens=16, max_len=64,
             prefill_buckets=(16,), seed=0)
    return eng, _drive(eng, [[1] * 10] * 4, 2)


def _eos(mk):
    eng = mk(max_num_seqs=2, max_len=64, prefill_buckets=(16,), seed=0)
    (out,) = _drive(eng, [[5, 6, 7]], 8)
    return eng, [out] + _drive(eng, [[5, 6, 7]], 8, eos_id=out[2])


def _prefix_chain(mk):
    eng = mk(**dict(KW, max_num_seqs=2))
    prompt, outs = [11, 12, 13, 14, 15], []
    for turn in range(3):
        (out,) = _drive(eng, [prompt], 4)
        outs.append(out)
        prompt = prompt + out + [100 + turn, 101 + turn]
    return eng, outs


def _partial_resume(mk):
    rng = np.random.RandomState(3)
    eng = mk(**KW)
    p1 = list(rng.randint(0, 512, size=24))
    p2 = p1[:20] + list(rng.randint(0, 512, size=10))
    p3 = list(rng.randint(0, 512, size=30))
    return eng, [_drive(eng, [p], 4)[0] for p in (p1, p2, p3, p3[:22])]


def _deepest_match(mk):
    rng = np.random.RandomState(5)
    eng = mk(**dict(KW, max_num_batched_tokens=512))
    stem = list(rng.randint(0, 512, size=16))
    shallow = stem + list(rng.randint(0, 512, size=4))
    deep = stem + list(rng.randint(0, 512, size=14))
    probe = deep + list(rng.randint(0, 512, size=4))
    return eng, [_drive(eng, [p], 3)[0] for p in (shallow, deep, probe)]


def _blank_first(mk):
    eng = mk(**dict(KW, max_num_seqs=2, prefill_buckets=(16, 32)))
    p1 = [1, 2, 3, 4, 5, 6, 7, 8]
    (out1,) = _drive(eng, [p1], 3)
    out2 = _drive(eng, [[9] * 10], 3)[0]
    return eng, [out1, out2, _drive(eng, [p1 + out1 + [6]], 3)[0]]


def _contention(mk):
    eng = mk(**dict(KW, max_num_seqs=1, prefill_buckets=(16, 32)))
    (out1,) = _drive(eng, [[1, 2, 3, 4, 5]], 3)
    out2 = _drive(eng, [[7, 7, 7, 7]], 3)[0]
    return eng, [out1, out2,
                 _drive(eng, [[1, 2, 3, 4, 5] + out1 + [6]], 3)[0]]


def _reuse_disabled(mk):
    eng = mk(max_num_seqs=2, max_len=64, prefill_buckets=(16,), seed=0,
             enable_prefix_reuse=False)
    (out1,) = _drive(eng, [[1, 2, 3, 4]], 3)
    return eng, [out1, _drive(eng, [[1, 2, 3, 4] + out1 + [5]], 3)[0]]


def _full_cache(mk):
    """max_len 16: a short request frees its slot, which keeps decoding on
    stale tokens past max_len while a long request runs past it too; an
    over-long prompt keeps its last max_len - 1 tokens."""
    eng = mk(max_num_seqs=2, max_num_batched_tokens=64, max_len=16,
             prefill_buckets=(16,), seed=0)
    long_prompt = list(np.random.RandomState(6).randint(0, 512, size=20))
    return eng, _short_and_long(eng, [1, 2, 3], [4, 5, 6, 7], 30) + \
        _drive(eng, [long_prompt], 4)


def _short_and_long(eng, short, long, new_tokens):
    """A 2-token request beside a long one: the short one's slot is freed
    and keeps decoding on stale tokens while the long one runs."""
    uids = [eng.submit(short, max_new_tokens=2),
            eng.submit(long, max_new_tokens=new_tokens)]
    done = eng.run()
    return [done[u].output for u in uids]


DENSE = {f.__name__[1:]: f for f in (
    _continuous_batching, _slot_reuse, _token_budget, _eos, _prefix_chain,
    _partial_resume, _deepest_match, _blank_first, _contention,
    _reuse_disabled, _full_cache)}


def _compare(lm, run):
    cfg, _, params, tcfg, tparams = lm
    ref_eng, ref_out = run(lambda **kw: JaxEngine(cfg, params, paged=False,
                                                  **kw))
    eng, out = run(lambda **kw: InferenceEngine(tcfg, tparams, device="cpu",
                                                paged=False, **kw))
    assert out == ref_out
    for name in COUNTERS:
        assert getattr(eng.stats, name) == getattr(ref_eng.stats, name), name
    assert eng.pool.n_free == ref_eng.pool.n_free
    assert eng.pool.n_free_blank == ref_eng.pool.n_free_blank
    assert eng.residency_summary() == ref_eng.residency_summary()
    assert 0 < eng.stats.decode_steps <= eng.stats.steps
    return eng, ref_eng, out


@pytest.mark.parametrize("scenario", sorted(DENSE))
def test_dense_slot_engine_matches_reference(scenario, dense):
    eng, _, out = _compare(dense, DENSE[scenario])
    assert all(out)
    assert eng.pool.n_free == eng.max_num_seqs  # every slot returned


def test_full_cache_row_drops_its_write(dense):
    """In the ``full_cache`` run the freed slot's length really passes
    max_len (16), in both packages, and the pool stays finite."""
    eng, ref_eng, _ = _compare(dense, DENSE["full_cache"])
    lens = eng.pool.cache["len"].tolist()
    assert max(lens) > eng.max_len
    assert lens == np.asarray(ref_eng.pool.cache["scan"]["len"][0]).tolist()
    assert all(bool(t.isfinite().all()) for t in (eng.pool.cache["k"],
                                                  eng.pool.cache["v"]))


STATE_PROMPTS = {"rwkv6-1.6b": (3, 9, 17),
                 "zamba2-2.7b": (3, 16, 32)}


@pytest.mark.parametrize("arch", sorted(STATE_PROMPTS))
def test_state_family_slot_engine_matches_reference(arch):
    """rwkv6 / zamba2 smoke configs: three requests through two slots, each
    prefilled at its exact length (zamba2's lengths are at most its
    ``ssm_chunk`` of 16 or a multiple of it), then a run in which the free
    slot decodes past ``max_len`` (40) while the other runs on."""
    lm = build(arch=arch)
    rng = np.random.RandomState(7)
    prompts = [list(rng.randint(0, 256, size=n))
               for n in STATE_PROMPTS[arch]]

    def run(mk):
        eng = mk(max_num_seqs=2, max_num_batched_tokens=64, max_len=40,
                 prefill_buckets=(16,), seed=0)
        outs = _drive(eng, prompts, 5)
        return eng, outs + _short_and_long(eng, prompts[0], prompts[1][:4],
                                           40)

    eng, _, out = _compare(lm, run)
    assert not eng._prefix_reuse and eng.stats.prefix_reuse_hits == 0
    assert [len(o) for o in out] == [5] * 3 + [2, 40]
    if arch == "zamba2-2.7b":
        assert int(eng.pool.cache["attn"]["len"].max()) > eng.max_len
