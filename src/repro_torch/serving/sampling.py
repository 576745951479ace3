"""Token sampling: greedy / temperature / top-k / top-p.

The counterpart of the JAX package's ``sample``.  A ``torch.Generator``
takes the place of the ``jax.random`` key, so sampled tokens differ from
the reference's; the filtered logit masks and greedy picks are the same.
"""
from __future__ import annotations

import torch


def filter_logits(logits, *, temperature: float, top_k: int = 0,
                  top_p: float = 1.0):
    """Temperature-scaled logits with the top-k, then top-p, filters applied
    (excluded tokens set to ``-inf``).  ``top_p=0`` keeps only the single
    most probable token."""
    logits = logits / temperature
    if top_k > 0:
        vals = torch.topk(logits, top_k, dim=-1).values
        logits = torch.where(logits < vals[:, -1:], float("-inf"), logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep tokens whose cumulative mass *before* them is < top_p, and
        # pin the most probable token so top_p=0 degenerates to greedy
        keep = (cum - probs) < top_p
        keep[:, 0] = True
        cutoff = torch.where(keep, sorted_logits, float("-inf")).amax(
            dim=-1, keepdim=True)
        logits = torch.where(logits < cutoff, float("-inf"), logits)
    return logits


def sample(logits, generator: torch.Generator, *, temperature: float = 0.0,
           top_k: int = 0, top_p: float = 1.0):
    """logits [B, V] -> tokens [B] int64.

    ``temperature <= 0`` is greedy (argmax, first maximum on ties).
    Otherwise a categorical draw (Gumbel-max, as ``jax.random.categorical``)
    from the filtered logits."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = filter_logits(logits.float(), temperature=temperature,
                           top_k=top_k, top_p=top_p)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return torch.argmax(logits + gumbel, dim=-1)
