"""Dry-run: count every (arch x shape) cell without a card.

    python -m repro_torch.launch.dryrun [--arch ID] [--shape NAME]
        [--multi-pod | --both-meshes] [--out results/dryrun_torch.json]
        [--override key=value ...]

The counterpart of the JAX package's ``launch/dryrun.py``.  For each cell
it builds the full-width model on the ``meta`` device (the parameters,
the optimizer state, the batch and the cache are shapes and dtypes;
nothing is allocated), runs the cell's train step, prefill or decode step
once under the cost counter (``launch/cost.py``; the hand-written kernels
launch nothing and charge their own work), and writes the reference's
record: status, memory and a three-term roofline.
``benchmarks_torch/bench_roofline.py`` reads the records.

Without a mesh flag a cell is one H100.  ``--multi-pod`` counts it on the
2 x 16 x 16 ``("pod", "data", "model")`` mesh, ``--both-meshes`` on 16 x
16 ``("data", "model")`` and on 2 x 16 x 16: this process is rank 0 of a
``fake`` process group of 256 or 512 (``launch/mesh.fake_world``), the
state and the batch are DTensors placed by ``TRAIN_RULES`` whose local
shards lie on ``meta``, and every count (FLOPs, bytes, the collectives'
bytes) is one device's.  Serving cells on a mesh are written ``skipped``
(serving under a mesh is ROADMAP Queue 1 item 15b).  The roofline divides
the counts by the H100 data sheet's constants (``kernels/cost.py``: bf16
peak, HBM rate, NVLink rate); none is a measurement.

A train cell with several microbatches counts one microbatch (loss,
gradient, float32 accumulation) and charges it once for each, the
optimizer once: the counterpart of the reference's trip-count
multiplication.  A cell that does not fit one card is still ``ok``, with
``fits: false``.  ``--keep-hlo`` is left out: the port compiles nothing.
"""
from __future__ import annotations

import argparse
import ast
import json
import math
import sys
import time
from typing import Any, Optional

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.kernels import cost as kernel_cost
from repro_torch.launch import cost
from repro_torch.launch import sharding as shd
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import (PRODUCTION, fake_world,
                                     make_production_mesh, mesh_devices)
from repro_torch.models import get_model, nn
from repro_torch.training.optim import (OptimizerConfig, adamw_update,
                                        tree_unflatten)
from repro_torch.training.train import (TrainConfig, accumulated_mean,
                                        grad_accumulator, make_train_step,
                                        microbatch_grads, microbatches,
                                        place_state, state_shardings)

# Hardware constants: the H100 SXM data sheet's figures, not measurements
# (kept beside the kernels' work formulas, which the bounds divide by them)
PEAK_FLOPS = kernel_cost.PEAK_FLOPS  # dense bf16 FLOP/s
HBM_BW = kernel_cost.HBM_BW  # HBM3 bytes/s
HBM_BYTES = kernel_cost.HBM_BYTES  # device memory
LINK_BW = kernel_cost.NVLINK_BW  # NVLink bytes/s, one direction

MESH_SKIP = ("serving under a mesh (cache specs, prefill and decode on "
             "sharded caches) is ROADMAP Queue 1 item 15b, not ported yet")

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


def counted_train_step(api, cfg, tcfg: TrainConfig, mesh=None):
    """``make_train_step(api, cfg, tcfg, mesh)`` as the counter should see
    it.  With one microbatch it is that step.  With n, the step's own
    ``microbatch_grads`` (loss, gradient, placements, float32
    accumulation) runs once under ``cost.repeat(n)``, then the step's
    ``accumulated_mean`` and AdamW once."""
    n = tcfg.microbatches
    if n == 1:
        return make_train_step(api, cfg, tcfg, mesh)

    def step(state, batch):
        params = state["params"]
        with nn.mesh_context(mesh):
            mb = {k: microbatches(v, n)[0] for k, v in batch.items()}
            acc = grad_accumulator(params)
            with cost.repeat(n):
                microbatch_grads(api, cfg, params, mb, mesh, acc)
            loss, grads = accumulated_mean(acc, n)
            _, _, stats = adamw_update(tree_unflatten(params, grads),
                                       state["opt"], params, tcfg.optimizer)
        return state, dict(loss=loss, **stats)

    return step


def build_train(api, cfg, tcfg: TrainConfig, mesh=None):
    """(step, (state, batch)) of a train step on ``meta``: the abstract
    parameters, AdamW state and batch of ``tcfg``'s shape; under a mesh
    DTensors placed by ``TRAIN_RULES`` and the batch spec."""
    params, axes = sp.abstract_params(api, cfg)
    state = {"params": params,
             "opt": sp.abstract_opt_state(params, tcfg.optimizer)}
    batch = sp.train_batch_specs(cfg, tcfg.global_batch, tcfg.seq_len)
    if mesh is not None:
        state = place_state(state, state_shardings(
            axes, tcfg.optimizer, mesh, cfg=cfg))
        batch = {k: shd.place(v, shd.batch_sharding(mesh, v.dim() - 1))
                 for k, v in batch.items()}
    return counted_train_step(api, cfg, tcfg, mesh), (state, batch)


def build_cell(arch: str, shape: str, *, overrides: Optional[dict] = None,
               mesh=None):
    """Returns (fn, example_args, cfg, extra) for the cell, on ``meta``:
    ``fn(*example_args)`` runs it once.  ``mesh``: a train cell on it."""
    seq, batch, kind = sp.SHAPES[shape]
    cfg = get_config(arch, **arch_overrides(arch, shape, overrides))
    api = get_model(cfg)

    if kind == "train":
        opt_cfg = OptimizerConfig(quantize_states=arch in QUANTIZED_OPT)
        dp = 1
        if mesh is not None:
            dp = mesh_devices(mesh) // nn.mesh_shape(mesh).get("model", 1)
        micro = MICROBATCHES.get(arch, DEFAULT_MICRO)
        while batch % (micro * dp) and micro > 1:
            micro //= 2
        tcfg = TrainConfig(global_batch=batch, seq_len=seq,
                           microbatches=micro, optimizer=opt_cfg)
        fn, args = build_train(api, cfg, tcfg, mesh)
        return fn, args, cfg, {"microbatches": micro}
    if mesh is not None:
        raise NotImplementedError(MESH_SKIP)

    params, _ = sp.abstract_params(api, cfg)
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
                  seq: int = 0, n_chips: int = 1) -> dict:
    """Three-term roofline of a counted cell (``cost.analyze``'s keys, one
    device's) on H100s: compute at the bf16 peak, memory at the HBM rate,
    collectives at the NVLink rate (the data sheet's, ``kernels/cost.py``).
    ``useful_flops_ratio`` divides the model's FLOPs by all ``n_chips``'
    counted FLOPs, as the reference's does."""
    flops = float(cost_rec["flops"])
    byts = float(cost_rec["bytes"])
    coll = float(cost_rec["collective_bytes"])
    t_compute = flops / PEAK_FLOPS
    t_memory = byts / HBM_BW
    t_coll = coll / LINK_BW
    # 6*N*D for training (fwd+bwd), 2*N*D for inference forward; attention
    # FLOPs are excluded from MODEL_FLOPS by convention, so long-context
    # cells legitimately show ratios > 1 worth of attention compute.
    factor = 6 if kind == "train" else 2
    model_flops = factor * cfg.active_param_count() * tokens
    return {
        "flops_per_device": flops,
        "bytes_per_device": byts,
        "collective_bytes_per_device": coll,
        "collective_detail": cost_rec["collective_detail"],
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "bottleneck": max(
            [("compute", t_compute), ("memory", t_memory),
             ("collective", t_coll)], key=lambda kv: kv[1])[0],
        "model_flops_total": model_flops,
        "useful_flops_ratio": (model_flops / (flops * n_chips)
                               if flops else 0.0),
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


def fake_mesh(multi_pod: bool):
    """The production mesh over a ``fake`` process group of its size
    (one made for another size is destroyed first)."""
    import torch.distributed as dist

    world = math.prod(PRODUCTION[multi_pod][0])
    if dist.is_initialized() and dist.get_world_size() != world:
        dist.destroy_process_group()
    if not dist.is_initialized():
        fake_world(world)
    return make_production_mesh(multi_pod=multi_pod)


def run_cell(arch: str, shape: str, *,
             overrides: Optional[dict] = None,
             multi_pod: Optional[bool] = None) -> dict:
    """One cell's record: on one H100 (``multi_pod`` None), or on the 16 x
    16 (False) or 2 x 16 x 16 (True) mesh."""
    seq, batch, kind = sp.SHAPES[shape]
    cfg0 = get_config(arch)
    ok, why = sp.cell_supported(cfg0, shape)
    rec: dict[str, Any] = {"arch": arch, "shape": shape, "kind": kind,
                           "seq": seq, "batch": batch}
    if multi_pod is not None:
        rec["multi_pod"] = multi_pod
    if ok and multi_pod is not None and kind != "train":
        ok, why = False, MESH_SKIP
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    t0 = time.time()
    mesh = None if multi_pod is None else fake_mesh(multi_pod)
    n_chips = 1 if mesh is None else mesh_devices(mesh)
    fn, args, cfg, extra = build_cell(arch, shape, overrides=overrides,
                                      mesh=mesh)
    t_build = time.time() - t0
    counted = cost.analyze(fn, *args)
    t_count = time.time() - t0 - t_build
    tokens = batch * (seq if kind in ("train", "prefill") else 1)
    rec.update(
        status="ok",
        n_devices=n_chips,
        build_s=round(t_build, 2),
        count_s=round(t_count, 2),
        roofline=roofline_from(counted, cfg, tokens=tokens, kind=kind,
                               seq=seq, n_chips=n_chips),
        kernels=counted["kernels"],
        **extra,
    )
    if mesh is None:
        rec["memory"] = memory_summary(args, counted)
    else:
        rec.update(n_chips=n_chips, mesh=dict(nn.mesh_shape(mesh)),
                   memory={"est_live_bytes_per_device":
                           int(counted["peak_bytes"])})
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(sp.SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2 x 16 x 16 mesh")
    ap.add_argument("--both-meshes", action="store_true",
                    help="the 16 x 16 and the 2 x 16 x 16 mesh")
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
    meshes = ([False, True] if args.both_meshes
              else [True] if args.multi_pod else [None])
    names = {None: "1 H100", False: "16x16", True: "2x16x16"}

    records = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                label = f"{arch} x {shape} x {names[mp]}"
                try:
                    rec = run_cell(arch, shape, overrides=overrides or None,
                                   multi_pod=mp)
                except Exception as e:  # noqa: BLE001 — report, keep going
                    rec = {"arch": arch, "shape": shape, "status": "error",
                           "error": f"{type(e).__name__}: {e}"}
                    if mp is not None:
                        rec["multi_pod"] = mp
                records.append(rec)
                st = rec["status"]
                msg = f"[dryrun] {label}: {st}"
                if st == "ok":
                    r = rec["roofline"]
                    msg += (f" count={rec['count_s']}s"
                            f" bottleneck={r['bottleneck']}"
                            f" t_comp={r['t_compute_s']:.2e}s"
                            f" t_mem={r['t_memory_s']:.2e}s"
                            f" t_coll={r['t_collective_s']:.2e}s")
                    if "fits" in rec["memory"]:
                        msg += f" fits={rec['memory']['fits']}"
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
