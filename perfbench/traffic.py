"""The one traffic generator: a traffic file's parameters -> requests.

A traffic file (``traffic/<mix>.json``) describes a closed loop of
``clients`` users, each of whom sends its next request when the last one
has been answered.  A request is a turn of random token ids (behind an
optional prefix that every request shares) and a number of tokens to
generate greedily.  Its lengths follow lognormal distributions
(``median``, ``sigma``, clipped to ``min``..``max``).

With ``session`` a client holds a conversation: each request's prompt is
its last prompt, the tokens served for it and a new turn, as an agent
sends back its transcript with a tool's result; a session ends where the
next prompt and its answer would pass ``session.max_tokens``, and the
next one starts from the shared prefix.  The prompt's lengths do not
depend on what was served, only its reply tokens do.

With ``client_sigma`` clients differ: each one's medians are scaled by a
factor of its own, lognormal with that sigma, so a few clients send
longer turns and answers than the rest.

Every seed gets the same sizes in another order.  Each client is given a
role: a factor, and an offset into a deck of ``deck`` quantiles of each
distribution, so that the roles together cover ``deck x clients``
quantiles; the seed deals the roles to the clients, shuffles each pass
through a deck and draws the token ids.  With ``"shuffle": false`` a
role's passes come in one order for every seed, so that a window that
sees a part of a pass sees the same part on every seed (where a few long
requests carry a window's work); the seed then deals the roles and draws
the ids.  A client's first request
generates the residual of an output length drawn from the length-biased
distribution (what is left of a request already under way), so
completions are staggered from the first second.  Each client's stream
depends only on (seed, client) and the replies served to it.
"""
from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np

_N = NormalDist()


def _rng(*key):
    return np.random.default_rng([int(k) & 0xFFFFFFFFFFFF for k in key])


def _length(dist: dict, q: float, biased: bool = False,
            scale: float = 1.0) -> int:
    mu = math.log(dist["median"] * scale) + (dist["sigma"] ** 2
                                             if biased else 0.0)
    x = math.exp(mu + dist["sigma"] * _N.inv_cdf(q))
    return int(min(dist["max"], max(dist["min"], round(x))))


class Client:
    """The request stream of one client."""

    def __init__(self, mix: dict, seed: int, client: int, vocab: int,
                 prefix):
        self.mix, self.seed, self.client = mix, seed, client
        self.vocab, self.prefix = vocab, prefix
        n = mix["clients"]
        self.role = int(_rng(seed, 0xC1).permutation(n)[client])
        self.scale = math.exp(mix.get("client_sigma", 0.0)
                              * _N.inv_cdf((self.role + 0.5) / n))
        # what orders the sizes: the seed, or one order for every seed
        self.order = ((seed, client) if mix.get("shuffle", True)
                      else (0, self.role))
        self.n = 0
        self.last = None  # the session's last prompt and its answer length

    def _deck_q(self, i: int, which: int) -> float:
        m = self.mix["deck"]
        perm = _rng(*self.order, i // m, which).permutation(m)
        off = (self.role + 0.5) / self.mix["clients"]
        return (perm[i % m] + off) / m

    def first_output(self) -> int:
        n = self.mix["clients"]
        key = self.order[0]
        perm = _rng(key, 0xF1, 0).permutation(n)
        cut = _rng(key, 0xF1, 1).permutation(n)
        L = _length(self.mix["output"], (perm[self.role] + 0.5) / n,
                    biased=True, scale=self.scale)
        return max(1, math.ceil(L * (cut[self.role] + 0.5) / n))

    def next(self, reply=None) -> dict:
        """The next request; ``reply``: the tokens served for the last one
        (None where it failed, which ends a session)."""
        i = self.n
        self.n += 1
        n_turn = _length(self.mix["prompt"], self._deck_q(i, 0),
                         scale=self.scale)
        n_out = (self.first_output() if i == 0
                 else _length(self.mix["output"], self._deck_q(i, 1),
                              scale=self.scale))
        turn = _rng(self.seed, self.client, i, 7).integers(
            0, self.vocab, n_turn).tolist()
        prompt = list(self.prefix) + turn
        session = self.mix.get("session")
        if session and self.last is not None and reply is not None:
            last, n_last = self.last
            if len(reply) != n_last:
                raise ValueError(f"client {self.client}: {len(reply)} "
                                 f"tokens served for {n_last} asked")
            grown = last + list(reply) + turn
            if len(grown) + n_out <= session["max_tokens"]:
                prompt = grown
        if session:
            self.last = (prompt, n_out)
        return {"prompt": prompt, "max_new_tokens": n_out,
                "temperature": 0.0}


def clients(mix: dict, seed: int, vocab: int) -> list:
    n_pre = mix.get("shared_prefix_tokens", 0)
    prefix = _rng(seed, 0x9E).integers(0, vocab, n_pre).tolist()
    return [Client(mix, seed, c, vocab, prefix)
            for c in range(mix["clients"])]


def longest_prompt(mix: dict) -> int:
    if mix.get("session"):
        return mix["session"]["max_tokens"]
    return mix.get("shared_prefix_tokens", 0) + mix["prompt"]["max"]


def warmup_requests(mix: dict, seed: int, vocab: int, chunk_buckets,
                    decode_batches) -> list:
    """Rounds of requests that run every prompt-chunk bucket and decode
    batch size this mix reaches: one round of one prompt per bucket up to
    the longest prompt's, then one round of ``B`` short requests for each
    decode batch size ``B``; last, where the mix shares a prefix, one
    request that leaves it resident, as a deployment's system prompt is."""
    rng = _rng(seed, 0x3A)
    top = next((b for b in chunk_buckets if b >= longest_prompt(mix)),
               chunk_buckets[-1])
    rounds = [[{"prompt": rng.integers(0, vocab, b).tolist(),
                "max_new_tokens": 2, "temperature": 0.0}
               for b in chunk_buckets if b <= top]]
    for B in decode_batches:
        rounds.append([{"prompt": rng.integers(0, vocab, 24).tolist(),
                        "max_new_tokens": 4, "temperature": 0.0}
                       for _ in range(B)])
    n_pre = mix.get("shared_prefix_tokens", 0)
    if n_pre:
        prefix = _rng(seed, 0x9E).integers(0, vocab, n_pre).tolist()
        rounds.append([{"prompt": prefix + rng.integers(0, vocab, 8).tolist(),
                        "max_new_tokens": 2, "temperature": 0.0}])
    return rounds
