"""The backward of the scan kernels' autograd Functions: recompute the
plain version under autograd from the saved inputs and differentiate it."""
from __future__ import annotations

import torch


def recompute_grads(fn, saved, needs, cotangents):
    """The gradients of ``fn(*saved)``'s outputs under ``cotangents`` with
    respect to the saved inputs that ``needs`` marks; None for the others
    (and for an absent input)."""
    with torch.enable_grad():
        inputs = [None if t is None else t.detach().requires_grad_(n)
                  for t, n in zip(saved, needs)]
        outs = fn(*inputs)
        wrt = [t for t, n in zip(inputs, needs) if n and t is not None]
        grads = iter(torch.autograd.grad(outs, wrt, cotangents)
                     if wrt else ())
    return tuple(next(grads) if n and t is not None else None
                 for t, n in zip(inputs, needs))
