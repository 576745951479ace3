"""Token sampling (greedy / temperature / top-k / top-p) and the greedy
speculative-decoding acceptance rule.

The counterpart of the JAX package's ``sample`` and
``speculative_accept``.  A ``torch.Generator``
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


def speculative_accept(proposed, target_tokens):
    """Leftover-token acceptance for greedy speculative decoding.

    ``proposed`` [B, k] are the draft's proposals; ``target_tokens``
    [B, k+1] are the target's greedy picks at the k+1 verified positions
    (position j's pick conditions on the previous token plus proposals
    ``proposed[:, :j]``).  Returns ``n_accept`` [B]: the length of the
    longest matching prefix (a proposal counts only if every earlier one
    matched, hence the cumulative product).  The emitted tokens are
    ``target_tokens[b, : n_accept[b] + 1]`` per row: the accepted
    proposals (which EQUAL the target picks) plus the target's pick at the
    first divergence (or the bonus token when all k were accepted)."""
    proposed = torch.as_tensor(proposed)
    target_tokens = torch.as_tensor(target_tokens)
    if proposed.dim() != 2 or target_tokens.dim() != 2 or \
            target_tokens.shape[1] != proposed.shape[1] + 1:
        raise ValueError(
            f"expected proposed [B, k] and target [B, k+1], got "
            f"{tuple(proposed.shape)} / {tuple(target_tokens.shape)}")
    matches = (proposed == target_tokens[:, :-1]).to(torch.int64)
    return torch.cumprod(matches, dim=1).sum(dim=1)
