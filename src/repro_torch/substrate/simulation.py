"""Simulation "executables": numerical payloads in PyTorch ops.

The counterpart of the JAX package's ``substrate/simulation.py``.  These
stand in for the paper's MPI simulation codes (GROMACS-class payloads) so
middleware benchmarks move real compute and real arrays, not sleeps:

  * ``heat_stencil``  — 2-D five-point heat equation steps,
  * ``lj_step``       — Lennard-Jones particle forces + Euler integration,
  * ``surrogate_eval``— small MLP surrogate inference (AI-in-HPC analogue).

Each accepts ``_ranks``/``_placement`` kwargs (injected by the EXECUTABLE
path of the pool backend), splits its domain across "ranks" where the
reference does, and returns a numpy array.  Each computes on ``device``:
the CUDA card unless the caller asks for the CPU (``resolve_device``).
The reference jits its step functions; here they run eagerly.

Every input is drawn from a CPU ``torch.Generator`` seeded with ``seed``
(one small ``_*_draw`` function a payload) and then moved to the device,
so a run on the card and one on the CPU compute on the same numbers.  The
reference draws with ``jax.random``, whose numbers cannot be reproduced
without JAX: the two packages' payloads agree on the same inputs, not on
the same seed.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device


def _generator(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(int(seed))


def _heat_draw(n: int, seed: int) -> torch.Tensor:
    """The initial grid, U[0, 1) of shape [n, n], on the CPU."""
    return torch.rand((n, n), generator=_generator(seed))


def _heat_steps(grid, steps: int):
    g = grid.clone()
    for _ in range(steps):
        g[1:-1, 1:-1] = 0.25 * (g[:-2, 1:-1] + g[2:, 1:-1]
                                + g[1:-1, :-2] + g[1:-1, 2:])
    return g


def heat_stencil(n: int = 64, steps: int = 10, seed: int = 0,
                 _ranks: int = 1, _placement=None,
                 device=None) -> np.ndarray:
    """Run a 2-D heat stencil; domain rows split across ranks."""
    grid = _heat_draw(n, seed).to(resolve_device(device))
    per = max(1, n // max(1, _ranks))
    outs = []
    for r in range(max(1, _ranks)):  # rank loop (domain decomposition)
        block = grid[r * per:(r + 1) * per + 2]
        if block.shape[0] < 3:
            continue
        outs.append(_heat_steps(block, steps))
    result = torch.cat(outs, dim=0) if outs else grid
    return result.cpu().numpy()


def _lj_draw(n_particles: int, seed: int) -> torch.Tensor:
    """Initial positions, U[0, 4) of shape [n_particles, 3], on the CPU."""
    return torch.rand((n_particles, 3), generator=_generator(seed)) * 4.0


def _lj_steps(pos, vel, steps: int, dt: float = 1e-3):
    eye = torch.eye(pos.shape[0], dtype=pos.dtype, device=pos.device)

    def forces(p):
        diff = p[:, None, :] - p[None, :, :]
        r2 = torch.sum(diff * diff, dim=-1) + eye
        inv6 = 1.0 / (r2 ** 3)
        mag = 24 * (2 * inv6 * inv6 - inv6) / r2
        mag = mag * (1 - eye)
        return torch.sum(mag[:, :, None] * diff, dim=1)

    for _ in range(steps):
        vel = vel + dt * forces(pos)
        pos = pos + dt * vel
    return pos, vel


def lj_step(n_particles: int = 64, steps: int = 5, seed: int = 0,
            _ranks: int = 1, _placement=None, device=None) -> np.ndarray:
    pos = _lj_draw(n_particles, seed).to(resolve_device(device))
    pos, _ = _lj_steps(pos, torch.zeros_like(pos), steps)
    return pos.cpu().numpy()


def _surrogate_draw(dim: int, d_in: int, hidden: int, seed: int):
    """(a default batch [32, dim], w1 [d_in, hidden], w2 [hidden, 1]) on
    the CPU, the weights N(0, 0.1^2)."""
    gen = _generator(seed)
    x = torch.randn((32, dim), generator=gen)
    w1 = torch.randn((d_in, hidden), generator=gen) * 0.1
    w2 = torch.randn((hidden, 1), generator=gen) * 0.1
    return x, w1, w2


def _mlp_forward(x, w1, w2):
    return torch.relu(x @ w1) @ w2


def surrogate_eval(x: Optional[np.ndarray] = None, dim: int = 64,
                   hidden: int = 128, seed: int = 0,
                   _ranks: int = 1, _placement=None,
                   device=None) -> np.ndarray:
    """Tiny MLP surrogate scoring a batch (docking-surrogate analogue)."""
    dev = resolve_device(device)
    if x is not None:
        x = torch.as_tensor(np.asarray(x, np.float32))
        if x.dim() == 1:
            x = x[None, :]
    x0, w1, w2 = _surrogate_draw(dim, dim if x is None else x.shape[-1],
                                 hidden, seed)
    x = x0 if x is None else x
    return _mlp_forward(x.to(dev), w1.to(dev), w2.to(dev)).cpu().numpy()


def noop(*args, **kwargs):
    """The Exp-1 null payload."""
    return None
