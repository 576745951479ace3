"""Meshes: ``torch.distributed.DeviceMesh``es whose dim names are the
reference's axis names.

The counterpart of the JAX package's ``launch/mesh.py``.  Every function
builds a mesh over the process group the caller has set up; importing
this module touches no distributed state.  The production meshes are
16 x 16 ``("data", "model")`` = 256 chips and 2 x 16 x 16 ``("pod",
"data", "model")`` = 512; the dry-run builds them over the ``fake``
process group (``fake_world``), this process one rank of 256 or 512, its
local shards on ``meta``.

Four ranks can share one card: NCCL refuses two ranks on one device, so
they use gloo with CUDA tensors.  Gloo's all-gather on CUDA tensors
crashes its process (a segfault in ``all_gather_into_tensor`` with 4 ranks
on one H100, torch 2.11); ``stage_all_gather_through_host()`` then
registers, by name and for CUDA tensors only, an all-gather that copies
the card's tensor to the host, runs gloo's all-gather there and copies
the result back.  It counts what it staged (``STAGED``); the other
collectives run on the card's tensors as they are.  Nothing is staged
unless the caller asks.
"""
from __future__ import annotations

import math
import os
from collections import Counter

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}

# collectives staged through host memory (stage_all_gather_through_host):
# name -> calls
STAGED: Counter = Counter()


def make_production_mesh(*, multi_pod: bool = False):
    """16 x 16 ``("data", "model")`` or, with ``multi_pod``, 2 x 16 x 16
    ``("pod", "data", "model")`` over the default process group, whose
    world must be 256 or 512: the dry-run's, over ``fake_world``, a mesh
    of the CPU's type whose DTensors keep their shards on ``meta``."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = PRODUCTION[multi_pod]
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def make_local_mesh(data: int = 1, model: int = 1, *, device=None):
    """A ``("data", "model")`` mesh over the ranks there are (``data *
    model`` of them), on ``device``'s type (the CUDA card unless the
    caller asks for the CPU)."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.device import resolve_device

    dev = torch.device(resolve_device(device))
    return init_device_mesh(dev.type, (data, model),
                            mesh_dim_names=("data", "model"))


def batch_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def mesh_devices(mesh) -> int:
    return math.prod(mesh.shape)


def fake_world(world_size: int, rank: int = 0):
    """Make this process rank ``rank`` of a ``fake`` process group of
    ``world_size``: collectives return at once and move nothing, so a
    mesh of 256 or 512 devices can be built and counted in one process.
    The group is process-global: a caller that needs another destroys
    it first (``torch.distributed.destroy_process_group``)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)


def init_ranks(rank: int, world_size: int, init_method: str, *,
               backend: str = "gloo"):
    """Join a process group of ``world_size`` ranks at ``init_method``
    (``rendezvous_file``, or ``tcp://localhost:<port>``)."""
    import torch.distributed as dist

    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)


def rendezvous_file(directory: str) -> str:
    """A ``file://`` init method in ``directory`` (private to the run, so
    runs on one host never meet: no fixed port)."""
    return "file://" + os.path.join(os.path.abspath(directory), "rendezvous")


def staged_all_gather(inp, group_size: int, group_name: str):
    """``_c10d_functional.all_gather_into_tensor`` through host memory:
    ``inp`` copied to the host, gathered there by the group's CPU backend,
    the result copied back to ``inp``'s device."""
    import torch

    STAGED["all_gather"] += 1
    host = inp.detach().to("cpu")
    out = torch.ops._c10d_functional.all_gather_into_tensor(
        host, group_size, group_name)
    out = torch.ops._c10d_functional.wait_tensor(out)
    return out.to(inp.device)


_STAGING = []  # the registered library (kept alive)


def stage_all_gather_through_host():
    """Register ``staged_all_gather`` as the CUDA kernel of
    ``_c10d_functional.all_gather_into_tensor`` in this process (once)."""
    if _STAGING:
        return
    import torch

    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", staged_all_gather, "CUDA")
    _STAGING.append(lib)
