"""Train the demo LM for a few hundred steps with checkpoint/restart, on the
PyTorch port.

The counterpart of ``examples/train_lm.py``: the same model, optimizer
settings and printed lines, plus ``--device`` (the CUDA card unless it
says ``cpu``) and ``--ckpt-every``.  The batches are drawn from a CPU
``torch.Generator`` seeded 1234 and moved to the device (the reference
draws them with ``jax.random``, which the port cannot reproduce); a
resumed run draws them anew from the same seed.

Run: PYTHONPATH=src python examples_torch/train_lm.py [--steps 200]
         [--resume] [--device cpu]
"""
import argparse
import os
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import get_model, make_batch
from repro_torch.training.checkpoint import Checkpointer
from repro_torch.training.optim import OptimizerConfig
from repro_torch.training.train import TrainConfig, init_state, train_loop


def main(argv=None) -> dict:
    """Train; returns the first step, the logged history and the
    device."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "rhapsody_train_lm_torch"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda | cpu)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config("rhapsody-demo")
    api = get_model(cfg)
    tcfg = TrainConfig(
        global_batch=args.batch, seq_len=args.seq, microbatches=2,
        optimizer=OptimizerConfig(lr=3e-3, warmup_steps=20,
                                  decay_steps=args.steps),
        checkpoint_every=args.ckpt_every)
    ck = Checkpointer(args.ckpt_dir, keep=2)

    state = init_state(torch.Generator(device=device).manual_seed(0), api,
                       cfg, tcfg.optimizer, device=device)
    start = 0
    if args.resume:
        restored, start = ck.restore_latest(state)
        if restored is not None:
            state = restored
            print(f"resumed from step {start}")

    def data():
        gen = torch.Generator().manual_seed(1234)
        while True:
            batch = make_batch(cfg, args.batch, args.seq, gen, "cpu")
            yield {k: v.to(device) for k, v in batch.items()}

    def log(step, m):
        print(f"step {step:4d}  loss {m['loss']:.4f}  "
              f"lr {m['lr']:.2e}  gnorm {m['grad_norm']:.2f}")

    state, hist = train_loop(api, cfg, tcfg, steps=args.steps,
                             data_iter=data(), state=state, start_step=start,
                             checkpointer=ck, log_every=20, on_metrics=log)
    if hist:
        print(f"final loss {hist[-1]['loss']:.4f} "
              f"(from {hist[0]['loss']:.4f}); checkpoints in "
              f"{args.ckpt_dir}")
    return {"start": start, "history": hist, "device": str(device)}


if __name__ == "__main__":
    main()
