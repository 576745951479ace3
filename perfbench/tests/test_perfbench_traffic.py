"""The traffic generator: a seed fixes the stream, and every seed gets the
same sizes in another order."""
from collections import Counter

import pytest

from perfbench import traffic

MIX = {"clients": 4, "deck": 8, "shared_prefix_tokens": 16,
       "prompt": {"median": 192, "sigma": 0.5, "min": 64, "max": 512},
       "output": {"median": 128, "sigma": 0.6, "min": 32, "max": 384}}


def _stream(seed, n=17):
    return [[c.next() for _ in range(n)]
            for c in traffic.clients(MIX, seed, 1000)]


def test_one_seed_gives_one_stream():
    assert _stream(2 ** 31 + 11) == _stream(2 ** 31 + 11)


def test_seeds_differ_in_tokens_and_order():
    a, b = _stream(5), _stream(6)
    assert a != b
    assert [r["prompt"] for r in a[0]] != [r["prompt"] for r in b[0]]


def test_every_seed_gets_the_same_sizes():
    def sizes(seed):
        out = Counter()
        m = MIX["deck"]
        for reqs in _stream(seed, n=2 * m):
            for r in reqs:
                out[(len(r["prompt"]), "p")] += 1
            for r in reqs[m:]:  # the first request's output is a residual
                out[(r["max_new_tokens"], "o")] += 1
        return out
    assert sizes(3) == sizes(2 ** 31 + 3)


def test_lengths_within_the_mix_and_prefix_shared():
    streams = _stream(9)
    prefix = streams[0][0]["prompt"][:16]
    for reqs in streams:
        for r in reqs:
            n = len(r["prompt"]) - 16
            assert 64 <= n <= 512 and r["prompt"][:16] == prefix
            assert 1 <= r["max_new_tokens"] <= 384
            assert r["temperature"] == 0.0


def test_warmup_covers_the_buckets_and_batches():
    rounds = traffic.warmup_requests(MIX, 1, 1000, (64, 128, 256, 512, 1024),
                                     (1, 2, 4))
    assert [len(r["prompt"]) for r in rounds[0]] == [64, 128, 256, 512, 1024]
    assert [len(r) for r in rounds[1:4]] == [1, 2, 4]
    # the shared prefix is left resident before the clients start
    assert rounds[4][0]["prompt"][:16] == _stream(1)[0][0]["prompt"][:16]


SESSIONS = dict(MIX, client_sigma=0.6, session={"max_tokens": 1536})


def _served(mix, seed, n=24):
    """Each client's requests, answered with replies of the asked length."""
    out = []
    for c in traffic.clients(mix, seed, 1000):
        reqs, reply = [], None
        for _ in range(n):
            r = c.next(reply)
            reqs.append(r)
            reply = [7] * r["max_new_tokens"]
        out.append(reqs)
    return out


def test_sessions_grow_by_the_answer_and_a_turn_within_the_context():
    prefix = _served(SESSIONS, 4)[0][0]["prompt"][:16]
    starts = 0
    for reqs in _served(SESSIONS, 4):
        for a, b in zip(reqs, reqs[1:]):
            grown = a["prompt"] + [7] * a["max_new_tokens"]
            assert len(b["prompt"]) + b["max_new_tokens"] <= 1536
            assert b["prompt"][:16] == prefix
            if b["prompt"][:len(grown)] == grown:
                assert 64 <= len(b["prompt"]) - len(grown) <= 512
            else:  # a new session: the shared prefix and one turn
                starts += 1
                assert 64 <= len(b["prompt"]) - 16 <= 512
    assert 0 < starts < 4 * 23 / 2  # most turns continue a session


def _turns(reqs):
    """(tokens a request adds, tokens it asks for), after the first."""
    out = []
    for a, b in zip(reqs, reqs[1:]):
        grown = a["prompt"] + [7] * a["max_new_tokens"]
        n = (len(b["prompt"]) - len(grown)
             if b["prompt"][:len(grown)] == grown else len(b["prompt"]) - 16)
        out.append((n, b["max_new_tokens"]))
    return out


def test_every_seed_gets_the_same_turns_and_answers():
    # the transcripts' lengths follow the order; what each turn adds and
    # asks for is the same set on every seed
    def sizes(seed):
        turns = [t for reqs in _served(SESSIONS, seed, n=24)
                 for t in _turns(reqs)[7:]]  # requests 8-23
        return sorted(n for n, _ in turns), sorted(o for _, o in turns)
    assert _served(SESSIONS, 5) == _served(SESSIONS, 5)
    assert sizes(3) == sizes(2 ** 31 + 3)


def test_a_failed_or_short_answer_ends_the_session():
    c = traffic.clients(SESSIONS, 1, 1000)[0]
    first = c.next()
    assert len(c.next(None)["prompt"]) < len(first["prompt"]) + 64 + 1
    with pytest.raises(ValueError):
        c.next([1])


def test_clients_differ_by_their_factor():
    mean_out = [sum(r["max_new_tokens"] for r in reqs[1:]) / len(reqs[1:])
                for reqs in _stream(2, n=33) for _ in [0]]
    mix = dict(MIX, client_sigma=0.6)
    spread = [sum(r["max_new_tokens"] for r in reqs[1:]) / len(reqs[1:])
              for reqs in [[c.next() for _ in range(33)]
                           for c in traffic.clients(mix, 2, 1000)]]
    assert max(spread) / min(spread) > 1.5 * max(mean_out) / min(mean_out)


def test_without_shuffle_every_seed_sends_each_role_the_same_sizes():
    mix = dict(MIX, client_sigma=0.5, shuffle=False)

    def by_role(seed):
        return sorted((c.role, [(len(r["prompt"]), r["max_new_tokens"])
                                for r in [c.next() for _ in range(11)]])
                      for c in traffic.clients(mix, seed, 1000))
    a, b = by_role(3), by_role(2 ** 31 + 3)
    assert a == b
    ids = [[c.next()["prompt"] for c in traffic.clients(mix, s, 1000)]
           for s in (3, 4)]
    assert ids[0] != ids[1]
    shuffled = dict(mix, shuffle=True)
    assert by_role(3) != sorted(
        (c.role, [(len(r["prompt"]), r["max_new_tokens"])
                  for r in [c.next() for _ in range(11)]])
        for c in traffic.clients(shuffled, 3, 1000))
