"""Train step: loss and gradient, microbatch accumulation, AdamW.

The port of the JAX package's ``training/train.py`` on one device (no
mesh, no shardings).  Gradients come from ``torch.autograd.grad`` over the
parameter leaves.  With one microbatch they keep the parameters' dtype; with
several they accumulate in float32 and are divided by the count, the loss is
the mean over microbatches and the other metrics are the last
microbatch's, as in the reference.  The optimizer updates the state in
place (the reference donates it).  The profiler spans
``train/forward_backward`` and ``train/optimizer`` split a step's device
time (``profile_train.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models import ModelApi
from repro_torch.models.config import ModelConfig

from .optim import (OptimizerConfig, adamw_init, adamw_update, tree_leaves,
                    tree_unflatten)


@dataclasses.dataclass
class TrainConfig:
    global_batch: int = 8
    seq_len: int = 128
    microbatches: int = 1
    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=OptimizerConfig)
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 100
    keep_checkpoints: int = 3


def init_state(gen, api: ModelApi, cfg: ModelConfig, opt_cfg: OptimizerConfig,
               device=None):
    """Train state ``{"params", "opt"}`` on ``device`` (the CUDA card
    unless the caller asks for the CPU).  ``gen`` is a ``torch.Generator``
    on that device (seed 0 when None)."""
    dev = resolve_device(device)
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(0)
    params = api.init(gen, cfg, device=dev)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return {"params": params, "opt": adamw_init(params, opt_cfg)}


def make_train_step(api: ModelApi, cfg: ModelConfig, tcfg: TrainConfig):
    """Returns ``train_step(state, batch) -> (state, metrics)``; the state
    is updated in place and returned.  Every tensor of ``batch`` (the
    stubbed ``frame_embeds``/``patch_embeds`` too) goes to the loss, split
    on its batch dim into the microbatches."""
    opt_cfg = tcfg.optimizer
    n_micro = tcfg.microbatches

    def grad_fn(leaves, params, mb):
        loss, metrics = api.loss(params, mb, cfg)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def loss_and_grads(leaves, params, batch):
        if n_micro == 1:
            return grad_fn(leaves, params, batch)
        b = next(iter(batch.values())).shape[0]
        mbs = {k: v.reshape(n_micro, b // n_micro, *v.shape[1:])
               for k, v in batch.items()}
        grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in leaves]
        loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for i in range(n_micro):
            l, metrics, g = grad_fn(leaves, params,
                                    {k: v[i] for k, v in mbs.items()})
            for acc, gi in zip(grads, g):
                acc.add_(gi.float())
            loss = loss + l
        for acc in grads:
            acc.div_(n_micro)
        return loss / n_micro, metrics, grads

    def step(state, batch):
        params = state["params"]
        leaves = tree_leaves(params)
        for p in leaves:
            if not p.requires_grad:  # e.g. just restored from a checkpoint
                p.requires_grad_(True)
        with torch.profiler.record_function("train/forward_backward"):
            loss, metrics, grads = loss_and_grads(leaves, params, batch)
        with torch.profiler.record_function("train/optimizer"):
            _, _, stats = adamw_update(tree_unflatten(params, grads),
                                       state["opt"], params, opt_cfg)
        return state, dict(metrics, loss=loss, **stats)

    return step


def train_loop(api, cfg: ModelConfig, tcfg: TrainConfig, *, steps: int,
               data_iter, gen=None, device=None, state=None, start_step=0,
               checkpointer=None, log_every: int = 10,
               on_metrics: Optional[Callable] = None):
    """A simple training loop for examples and tests (one device)."""
    if state is None:
        state = init_state(gen, api, cfg, tcfg.optimizer, device)
    step_fn = make_train_step(api, cfg, tcfg)
    history = []
    for i in range(start_step, steps):
        batch = next(data_iter)
        state, metrics = step_fn(state, batch)
        if i % log_every == 0 or i == steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            history.append({"step": i, **m})
            if on_metrics:
                on_metrics(i, m)
        if checkpointer is not None and (i + 1) % tcfg.checkpoint_every == 0:
            checkpointer.save(state, i + 1)
    return state, history
