"""Train step: loss and gradient, microbatch accumulation, AdamW.

The port of the JAX package's ``training/train.py``.  Under a mesh
(``make_train_step(..., mesh=)``) the state and the batch are DTensors
placed by ``state_shardings`` / ``batch_shardings`` (FSDP over "data",
TP over "model", DP over ("pod", "data")); ``place_train_step`` is the
counterpart of ``jit_train_step``: it places the state and the batch by
those shardings and returns the state in them.  Gradients come from
``torch.autograd.grad`` over the parameter leaves.  With one microbatch they keep the parameters' dtype; with
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
    """-> (train state ``{"params", "opt"}`` on ``device`` (the CUDA card
    unless the caller asks for the CPU), the params' logical axes in the
    reference's layout).  ``gen`` is a ``torch.Generator`` on that device
    (seed 0 when None)."""
    dev = resolve_device(device)
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(0)
    params, axes = api.init(gen, cfg, device=dev, with_axes=True)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return {"params": params, "opt": adamw_init(params, opt_cfg)}, axes


def state_shardings(axes, opt_cfg: OptimizerConfig, mesh, *,
                    cfg: ModelConfig):
    """``NamedSharding`` trees of the train state: ``axes`` (the
    reference's layout, as ``init_state`` gives them) laid out as the
    port's parameters, mapped by ``TRAIN_RULES``."""
    from repro_torch.launch import sharding as shd
    from repro_torch.models.convert import unstack_axes

    axes = unstack_axes(axes, cfg)
    p_sh = shd.make_shardings(axes, shd.TRAIN_RULES, mesh)
    o_axes = shd.opt_axes_like(axes, opt_cfg.quantize_states)
    o_sh = shd.make_shardings(o_axes["moments"], shd.TRAIN_RULES, mesh)
    return {"params": p_sh, "opt": {"moments": o_sh}}


def batch_shardings(cfg: ModelConfig, mesh):
    """Sharding tree for a training batch dict."""
    from repro_torch.launch import sharding as shd

    tok = shd.batch_sharding(mesh, extra_dims=1)
    out = {"tokens": tok, "targets": tok, "loss_mask": tok}
    if cfg.family == "encdec":
        out["frame_embeds"] = shd.batch_sharding(mesh, extra_dims=2)
    if cfg.family == "vlm":
        out["patch_embeds"] = shd.batch_sharding(mesh, extra_dims=2)
    return out


def _place_tree(tree, shardings):
    from repro_torch.launch import sharding as shd

    if isinstance(tree, dict):
        return {k: _place_tree(v, shardings[k]) if k in shardings else v
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_place_tree(v, s) for v, s in zip(tree, shardings)]
    return shd.place(tree, shardings)


def place_state(state, state_sh):
    """The train state as DTensors by ``state_shardings``: the parameters
    (requiring gradients) and their moments (the 8-bit moments' scales as
    ``optim`` keeps them); the step stays.  A state already placed is
    redistributed where it differs."""
    from repro_torch.launch import sharding as shd
    from repro_torch.training import optim

    params = _place_tree(state["params"], state_sh["params"])
    for p in tree_leaves(params):
        p.requires_grad_(True)

    def place_moments(mom, p):
        if isinstance(mom, list):
            return [place_moments(m, q) for m, q in zip(mom, p)]
        if not ("m" in mom or "mq" in mom):
            return {k: place_moments(mom[k], p[k]) for k in mom}
        out = {}
        for k, t in mom.items():
            pl = optim._scale_placements(p) if k in ("ms", "vs") \
                else p.placements
            out[k] = shd.place(t, shd.NamedSharding(p.device_mesh, ()),
                               placements=pl)
        return out

    opt = dict(state["opt"], moments=place_moments(state["opt"]["moments"],
                                                   params))
    return {"params": params, "opt": opt}


def microbatches(x, n: int):
    """``x`` [B, ...] split on its batch dim into ``n`` contiguous
    microbatches (indexable by microbatch), as the reference splits a
    batch.  A DTensor is gathered once (the batch is small beside the
    weights) and each microbatch placed as ``x`` was: each rank keeps its
    own rows of it, nothing more moves."""
    if not hasattr(x, "to_local"):
        return x.reshape(n, x.shape[0] // n, *x.shape[1:])
    from torch.distributed.tensor import Replicate, distribute_tensor

    full = x.redistribute(x.device_mesh,
                          [Replicate()] * x.device_mesh.ndim).to_local()
    full = full.reshape(n, full.shape[0] // n, *full.shape[1:])
    return [distribute_tensor(full[i], x.device_mesh, x.placements,
                              src_data_rank=None) for i in range(n)]


def grad_accumulator(params):
    """The float32 sums of several microbatches' loss and gradients:
    zeros, the gradients laid out as the parameters (under a mesh their
    placements, as the reference's ``_pin_grads`` pins them)."""
    leaves = tree_leaves(params)
    return {"loss": torch.zeros((), dtype=torch.float32,
                                device=_local(leaves[0]).device),
            "grads": [torch.zeros_like(p, dtype=torch.float32)
                      for p in leaves]}


def microbatch_grads(api: ModelApi, cfg: ModelConfig, params, mb, mesh=None,
                     acc=None):
    """One microbatch's (loss, metrics, gradients): the loss's gradient
    over every parameter leaf, under a mesh each brought to its
    parameter's placements.  With ``acc`` (``grad_accumulator``) the loss
    and the gradients are added into it in float32 instead.
    ``make_train_step`` runs it once for each microbatch, the dry-run once
    charged for all of them."""
    leaves = tree_leaves(params)
    loss, metrics = api.loss(params, mb, cfg, mesh=mesh) \
        if mesh is not None else api.loss(params, mb, cfg)
    if mesh is not None:
        loss = loss.full_tensor()
        metrics = {k: v.full_tensor() if hasattr(v, "full_tensor") else v
                   for k, v in metrics.items()}
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    if mesh is not None:
        grads = [g.redistribute(p.device_mesh, p.placements)
                 for p, g in zip(leaves, grads)]
    loss, metrics = loss.detach(), {k: v.detach() for k, v in metrics.items()}
    if acc is None:
        return loss, metrics, grads
    acc["loss"] = acc["loss"] + loss
    for a, g in zip(acc["grads"], grads):
        a.add_(g.float())
    return acc["loss"], metrics, acc["grads"]


def accumulated_mean(acc, n: int):
    """(loss, gradients) of ``acc`` summed over ``n`` microbatches,
    divided by ``n`` (the gradients in place)."""
    for a in acc["grads"]:
        a.div_(n)
    return acc["loss"] / n, acc["grads"]


def make_train_step(api: ModelApi, cfg: ModelConfig, tcfg: TrainConfig,
                    mesh=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``; the state
    is updated in place and returned.  Every tensor of ``batch`` (the
    stubbed ``frame_embeds``/``patch_embeds`` too) goes to the loss, split
    on its batch dim into the microbatches.

    With ``mesh`` the state and the batch are DTensors (``place_state``,
    ``place_train_step``); each gradient, and the float32 accumulator of
    several microbatches, keeps its parameter's placements.  With
    ``mesh=None`` the step runs on one device."""
    opt_cfg = tcfg.optimizer
    n_micro = tcfg.microbatches

    def loss_and_grads(params, batch):
        if n_micro == 1:
            loss, metrics, grads = microbatch_grads(api, cfg, params, batch,
                                                    mesh)
            return loss, grads, metrics
        mbs = {k: microbatches(v, n_micro) for k, v in batch.items()}
        acc = grad_accumulator(params)
        for i in range(n_micro):
            _, metrics, _ = microbatch_grads(
                api, cfg, params, {k: v[i] for k, v in mbs.items()}, mesh,
                acc)
        return (*accumulated_mean(acc, n_micro), metrics)

    def step(state, batch):
        params = state["params"]
        for p in tree_leaves(params):
            if not p.requires_grad:  # e.g. just restored from a checkpoint
                p.requires_grad_(True)
        from repro_torch.models import nn

        with nn.mesh_context(mesh):
            with torch.profiler.record_function("train/forward_backward"):
                loss, grads, metrics = loss_and_grads(params, batch)
            with torch.profiler.record_function("train/optimizer"):
                _, _, stats = adamw_update(tree_unflatten(params, grads),
                                           state["opt"], params, opt_cfg)
        return state, dict(metrics, loss=loss, **stats)

    return step


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def place_train_step(step_fn, state_sh, batch_sh):
    """The counterpart of the reference's ``jit_train_step``: a step that
    places the state and the batch by ``state_sh`` / ``batch_sh`` (a
    DTensor already placed is redistributed, nothing moves when it
    matches) and returns the state in them."""
    def step(state, batch):
        state = place_state(state, state_sh)
        batch = _place_tree(batch, batch_sh)
        return step_fn(state, batch)

    return step


def train_loop(api, cfg: ModelConfig, tcfg: TrainConfig, *, steps: int,
               data_iter, gen=None, device=None, state=None, start_step=0,
               checkpointer=None, log_every: int = 10,
               on_metrics: Optional[Callable] = None):
    """A simple training loop for examples and tests (one device)."""
    if state is None:
        state, _ = init_state(gen, api, cfg, tcfg.optimizer, device)
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
