"""Dry-run: count every (arch x shape) cell of one H100 without a card.

    python -m repro_torch.launch.dryrun [--arch ID] [--shape NAME]
        [--out results/dryrun_torch.json] [--override key=value ...]

The counterpart of the JAX package's ``launch/dryrun.py`` on one device.
For each cell it builds the full-width model on the ``meta`` device (the
parameters, the optimizer state, the batch and the cache are shapes and
dtypes; nothing is allocated), runs the cell's train step, prefill or
decode step once under the cost counter (``launch/cost.py``; the
hand-written kernels launch nothing and charge their own work), and
writes the reference's record: status, memory and a three-term roofline.
``benchmarks_torch/bench_roofline.py`` reads the records.

A train cell with several microbatches counts one microbatch (loss,
gradient, float32 accumulation) and charges it once for each, the
optimizer once: the counterpart of the reference's trip-count
multiplication.  A cell that does not fit one card is still ``ok``, with
``fits: false``.  Left out: ``--multi-pod``, ``--both-meshes`` and
``--keep-hlo``, which name meshes or HLO; the port runs on one device and
compiles nothing, so ``collective_bytes`` is 0.
"""
from __future__ import annotations

import argparse
import ast
import json
import sys
import time
from typing import Any, Optional

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.kernels import cost as kernel_cost
from repro_torch.launch import cost
from repro_torch.launch import specs as sp
from repro_torch.models import get_model
from repro_torch.training.optim import (OptimizerConfig, adamw_update,
                                        tree_leaves, tree_unflatten)
from repro_torch.training.train import TrainConfig, make_train_step

# Hardware constants: the H100 SXM data sheet's figures, not measurements
# (kept beside the kernels' work formulas, which the bounds divide by them)
PEAK_FLOPS = kernel_cost.PEAK_FLOPS  # dense bf16 FLOP/s
HBM_BW = kernel_cost.HBM_BW  # HBM3 bytes/s
HBM_BYTES = kernel_cost.HBM_BYTES  # device memory

# Per-arch microbatch counts for train_4k (keep activations ~O(1 sample))
MICROBATCHES = {
    "nemotron-4-340b": 16,
    "qwen3-8b": 4,
    "llama3.2-3b": 4,
    "zamba2-2.7b": 4,
    "moonshot-v1-16b-a3b": 4,
    "deepseek-moe-16b": 4,
    "rwkv6-1.6b": 4,
}
DEFAULT_MICRO = 2

# Archs whose optimizer state only fits with 8-bit moments
QUANTIZED_OPT = {"nemotron-4-340b"}


def arch_overrides(arch: str, shape: str, extra: Optional[dict] = None) -> dict:
    over = dict(extra or {})
    return over


# ---------------------------------------------------------------------------
# Cell construction
# ---------------------------------------------------------------------------


def counted_train_step(api, cfg, tcfg: TrainConfig):
    """``make_train_step(api, cfg, tcfg)`` as the counter should see it.
    With one microbatch it is that step.  With n, one microbatch's loss,
    gradient and float32 accumulation run once under ``cost.repeat(n)``,
    then the division and AdamW once, as the step runs them."""
    n = tcfg.microbatches
    if n == 1:
        return make_train_step(api, cfg, tcfg)

    def step(state, batch):
        params = state["params"]
        leaves = tree_leaves(params)
        b = next(iter(batch.values())).shape[0]
        mb = {k: v.reshape(n, b // n, *v.shape[1:])[0]
              for k, v in batch.items()}
        grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in leaves]
        loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        with cost.repeat(n):
            l, _ = api.loss(params, mb, cfg)
            g = torch.autograd.grad(l, leaves, allow_unused=True,
                                    materialize_grads=True)
            for acc, gi in zip(grads, g):
                acc.add_(gi.float())
            loss = loss + l.detach()
            del l, g
        for acc in grads:
            acc.div_(n)
        _, _, stats = adamw_update(tree_unflatten(params, grads),
                                   state["opt"], params, tcfg.optimizer)
        return state, dict(loss=loss / n, **stats)

    return step


def build_train(api, cfg, tcfg: TrainConfig):
    """(step, (state, batch)) of a train step on ``meta``: the abstract
    parameters, AdamW state and batch of ``tcfg``'s shape."""
    params = sp.abstract_params(api, cfg)
    state = {"params": params,
             "opt": sp.abstract_opt_state(params, tcfg.optimizer)}
    batch = sp.train_batch_specs(cfg, tcfg.global_batch, tcfg.seq_len)
    return counted_train_step(api, cfg, tcfg), (state, batch)


def build_cell(arch: str, shape: str, *, overrides: Optional[dict] = None):
    """Returns (fn, example_args, cfg, extra) for the cell, on ``meta``:
    ``fn(*example_args)`` runs it once."""
    seq, batch, kind = sp.SHAPES[shape]
    cfg = get_config(arch, **arch_overrides(arch, shape, overrides))
    api = get_model(cfg)

    if kind == "train":
        opt_cfg = OptimizerConfig(quantize_states=arch in QUANTIZED_OPT)
        micro = MICROBATCHES.get(arch, DEFAULT_MICRO)
        while batch % micro and micro > 1:  # dp = 1: one device
            micro //= 2
        tcfg = TrainConfig(global_batch=batch, seq_len=seq,
                           microbatches=micro, optimizer=opt_cfg)
        fn, args = build_train(api, cfg, tcfg)
        return fn, args, cfg, {"microbatches": micro}

    params = sp.abstract_params(api, cfg)
    # vlm: the vision prefix occupies cache positions ahead of the tokens
    eff_len = seq + (cfg.vision_tokens if cfg.family == "vlm" else 0)
    if kind == "prefill":
        @torch.no_grad()
        def prefill_fn(params, b):
            return api.prefill(params, b, cfg, max_len=eff_len)

        return (prefill_fn, (params, sp.prefill_batch_specs(cfg, batch, seq)),
                cfg, {})

    @torch.no_grad()
    def decode_fn(params, cache, tokens):
        return api.decode(params, cache, tokens, cfg)

    cache = sp.cache_template(cfg, batch, seq)
    tokens = torch.empty((batch,), dtype=torch.int32, device=sp.META)
    return decode_fn, (params, cache, tokens), cfg, {}


# ---------------------------------------------------------------------------
# Roofline terms and memory
# ---------------------------------------------------------------------------


def roofline_from(cost_rec: dict, cfg, *, tokens: int, kind: str = "train",
                  seq: int = 0) -> dict:
    """Three-term roofline of a counted cell (``cost.analyze``'s keys) on
    one H100: compute at the bf16 peak, memory at the HBM rate, no
    collectives."""
    flops = float(cost_rec["flops"])
    byts = float(cost_rec["bytes"])
    t_compute = flops / PEAK_FLOPS
    t_memory = byts / HBM_BW
    t_coll = 0.0
    # 6*N*D for training (fwd+bwd), 2*N*D for inference forward; attention
    # FLOPs are excluded from MODEL_FLOPS by convention, so long-context
    # cells legitimately show ratios > 1 worth of attention compute.
    factor = 6 if kind == "train" else 2
    model_flops = factor * cfg.active_param_count() * tokens
    return {
        "flops_per_device": flops,
        "bytes_per_device": byts,
        "collective_bytes_per_device": float(cost_rec["collective_bytes"]),
        "collective_detail": cost_rec["collective_detail"],
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "bottleneck": max(
            [("compute", t_compute), ("memory", t_memory),
             ("collective", t_coll)], key=lambda kv: kv[1])[0],
        "model_flops_total": model_flops,
        "useful_flops_ratio": model_flops / flops if flops else 0.0,
    }


def memory_summary(args, cost_rec: dict) -> dict:
    """The arguments' bytes, exact from their ``meta`` tensors (a train
    cell's split into parameters, optimizer state and batch), the
    counter's peak of live storage, and whether it fits the card's memory
    (``torch.cuda.mem_get_info``; without a card the data sheet's 80
    GB)."""
    out: dict[str, Any] = {"argument_size_in_bytes": sp.tree_bytes(args)}
    if isinstance(args[0], dict) and "opt" in args[0]:
        state, batch = args
        out.update(params_bytes=sp.tree_bytes(state["params"]),
                   opt_bytes=sp.tree_bytes(state["opt"]),
                   batch_bytes=sp.tree_bytes(batch))
    cap = (float(torch.cuda.mem_get_info()[1]) if torch.cuda.is_available()
           else HBM_BYTES)
    out.update(est_live_bytes=int(cost_rec["peak_bytes"]),
               device_bytes=cap, fits=cost_rec["peak_bytes"] <= cap)
    return out


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------


def run_cell(arch: str, shape: str, *,
             overrides: Optional[dict] = None) -> dict:
    seq, batch, kind = sp.SHAPES[shape]
    cfg0 = get_config(arch)
    ok, why = sp.cell_supported(cfg0, shape)
    rec: dict[str, Any] = {"arch": arch, "shape": shape, "kind": kind,
                           "seq": seq, "batch": batch}
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    t0 = time.time()
    fn, args, cfg, extra = build_cell(arch, shape, overrides=overrides)
    t_build = time.time() - t0
    counted = cost.analyze(fn, *args)
    t_count = time.time() - t0 - t_build
    tokens = batch * (seq if kind in ("train", "prefill") else 1)
    rec.update(
        status="ok",
        n_devices=1,
        build_s=round(t_build, 2),
        count_s=round(t_count, 2),
        memory=memory_summary(args, counted),
        roofline=roofline_from(counted, cfg, tokens=tokens, kind=kind,
                               seq=seq),
        kernels=counted["kernels"],
        **extra,
    )
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(sp.SHAPES) + [None])
    ap.add_argument("--out", default=None, help="JSON output path")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg override key=value (python literal)")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.override:
        k, v = kv.split("=", 1)
        try:
            overrides[k] = ast.literal_eval(v)
        except (SyntaxError, ValueError):
            overrides[k] = v

    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(sp.SHAPES)

    records = []
    for arch in archs:
        for shape in shapes:
            label = f"{arch} x {shape} x 1 H100"
            try:
                rec = run_cell(arch, shape, overrides=overrides or None)
            except Exception as e:  # noqa: BLE001 — report, keep going
                rec = {"arch": arch, "shape": shape, "status": "error",
                       "error": f"{type(e).__name__}: {e}"}
            records.append(rec)
            st = rec["status"]
            msg = f"[dryrun] {label}: {st}"
            if st == "ok":
                r = rec["roofline"]
                msg += (f" count={rec['count_s']}s"
                        f" bottleneck={r['bottleneck']}"
                        f" t_comp={r['t_compute_s']:.2e}s"
                        f" t_mem={r['t_memory_s']:.2e}s"
                        f" t_coll={r['t_collective_s']:.2e}s"
                        f" fits={rec['memory']['fits']}")
            elif st == "error":
                msg += f" {rec['error']}"
            print(msg, flush=True)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
        print(f"[dryrun] wrote {len(records)} records to {args.out}")
    bad = [r for r in records if r["status"] == "error"]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
