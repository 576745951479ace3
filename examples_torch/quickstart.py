"""Quickstart: RHAPSODY middleware on the PyTorch port in ~40 lines.

Run: PYTHONPATH=src python examples_torch/quickstart.py [cpu]
(the payloads compute on the CUDA card unless given ``cpu``)
"""
import sys

from repro_torch.core import (ResourceDescription, ResourceRequirements,
                              Rhapsody, TaskDescription, TaskKind)
from repro_torch.substrate.simulation import heat_stencil, surrogate_eval


def main(device=None):
    # declare resources (virtual nodes/cores/gpus) and start the middleware
    rh = Rhapsody(ResourceDescription(nodes=4, cores_per_node=8,
                                      gpus_per_node=2), n_workers=4)
    try:
        # a multi-rank "MPI" simulation feeding a GPU-tagged surrogate
        sim = TaskDescription(
            kind=TaskKind.EXECUTABLE, fn=heat_stencil,
            kwargs={"n": 64, "steps": 8, "device": device},
            requirements=ResourceRequirements(ranks=4, cores_per_rank=2),
            task_type="mpi_sim")
        score = TaskDescription(
            fn=surrogate_eval, kwargs={"dim": 32, "device": device},
            requirements=ResourceRequirements(gpus_per_rank=1),
            task_type="gpu_surrogate", dependencies=[sim.uid])
        # plus a bag of fine-grained analysis tasks running concurrently
        others = [TaskDescription(fn=surrogate_eval,
                                  kwargs={"dim": 8, "seed": i,
                                          "device": device},
                                  task_type="analysis") for i in range(32)]

        uids = rh.submit([sim, score] + others)
        rh.wait(uids)
        print("simulation grid:", rh.result(sim.uid).shape)
        print("surrogate score:", float(rh.result(score.uid).mean()))
        print("peak heterogeneity width:", rh.events.peak_hw())
        print("throughput: %.0f tasks/s" % rh.events.throughput())
    finally:
        rh.close()


if __name__ == "__main__":
    main(*sys.argv[1:2])
