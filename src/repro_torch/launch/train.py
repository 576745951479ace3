"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

The PyTorch port of the JAX package's launcher: the same flags and output
lines, plus ``--device`` (default ``cuda``; ``cpu`` on request).  One
device, the real data pipeline, checkpoint/restart.  As in the reference,
every arch other than ``rhapsody-demo`` trains its smoke config, and
``--smoke`` asks for it there too.  The token pipeline gives no frontend
inputs: ``internvl2-1b`` trains text-only (no vision prefix), and
``whisper-small``, whose encoder needs ``frame_embeds``, raises a
``KeyError`` naming them at its first step, as the reference's launcher
does (``make_train_step`` trains it on batches that carry frames).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.device import resolve_device
from repro_torch.models import get_model
from repro_torch.substrate.data import DataConfig, DataPipeline
from repro_torch.training.checkpoint import Checkpointer
from repro_torch.training.optim import OptimizerConfig
from repro_torch.training.train import TrainConfig, init_state, make_train_step


def main(argv=None) -> dict:
    """Run the launcher; returns every step's loss, the step count, the
    seconds the steps took and the device."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rhapsody-demo",
                    choices=list_archs() + ["rhapsody-demo"])
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--quantize-opt", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda | cpu)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = (get_smoke_config(args.arch)
           if args.smoke or args.arch != "rhapsody-demo"
           else get_config(args.arch))
    api = get_model(cfg)
    opt = OptimizerConfig(lr=args.lr, warmup_steps=max(1, args.steps // 20),
                          decay_steps=args.steps,
                          quantize_states=args.quantize_opt)
    tcfg = TrainConfig(global_batch=args.batch, seq_len=args.seq,
                       microbatches=args.microbatches, optimizer=opt,
                       checkpoint_every=args.ckpt_every)
    data = DataPipeline(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                   global_batch=args.batch), device=device)
    ck = Checkpointer(args.ckpt_dir, keep=3) if args.ckpt_dir else None

    state, _ = init_state(torch.Generator(device=device).manual_seed(0), api,
                          cfg, opt, device=device)
    start = 0
    if args.resume and ck is not None:
        restored, start = ck.restore_latest({"state": state,
                                             "data": data.state()})
        if restored is not None:
            state = restored["state"]
            data.restore({k: int(v) for k, v in restored["data"].items()})
            print(f"[train] resumed from step {start}")

    step_fn = make_train_step(api, cfg, tcfg)
    t0 = time.perf_counter()
    tokens_done = 0
    losses = []
    for i in range(start, args.steps):
        batch = data.next_batch()
        state, metrics = step_fn(state, batch)
        losses.append(metrics["loss"])
        tokens_done += args.batch * args.seq
        if i % args.log_every == 0 or i == args.steps - 1:
            dt = time.perf_counter() - t0
            print(f"[train] step {i:5d} loss {float(metrics['loss']):.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"{tokens_done / max(dt, 1e-9):.0f} tok/s", flush=True)
        if ck is not None and (i + 1) % tcfg.checkpoint_every == 0:
            ck.save({"state": state, "data": data.state()}, i + 1)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    print(f"[train] done: {args.steps - start} steps, arch={cfg.name}")
    return {"losses": [float(x) for x in losses],
            "steps": args.steps - start, "seconds": seconds,
            "device": str(device)}


if __name__ == "__main__":
    main()
