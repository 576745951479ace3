"""Coupled AI-HPC active learning (ROSE/DDSim analogue) on the PyTorch port.

Rounds of: run simulations -> exchange results through the in-memory store ->
score with a surrogate -> pick the most promising region for the next round.

Run: PYTHONPATH=src python examples_torch/coupled_active_learning.py [cpu]
(the payloads compute on the CUDA card unless given ``cpu``)
"""
import sys

import numpy as np

from repro_torch.core import (ResourceDescription, Rhapsody, TaskDescription,
                              TaskKind)
from repro_torch.core.coupling import make_store
from repro_torch.substrate.simulation import heat_stencil, surrogate_eval


def main(device=None, rounds: int = 3, sims_per_round: int = 8):
    rh = Rhapsody(ResourceDescription(nodes=2, cores_per_node=8), n_workers=4)
    store = make_store("memory")
    try:
        center = 0
        for r in range(rounds):
            # 1. candidate simulations around the current best seed
            seeds = [center + i for i in range(sims_per_round)]

            def sim(key, seed):
                grid = heat_stencil(n=32, steps=4, seed=seed, device=device)
                store.put(key, grid.astype(np.float32).ravel()[:256])
                return True

            def score(key):
                data = store.get(key, timeout=10)
                return float(surrogate_eval(data[:64][None, :],
                                            device=device).mean())

            descs = []
            score_uids = []
            for i, seed in enumerate(seeds):
                s = TaskDescription(kind=TaskKind.COUPLED, fn=sim,
                                    args=(f"r{r}s{i}", seed),
                                    task_type="sim")
                c = TaskDescription(kind=TaskKind.COUPLED, fn=score,
                                    args=(f"r{r}s{i}",),
                                    dependencies=[s.uid], task_type="score")
                descs.extend([s, c])
                score_uids.append(c.uid)
            rh.submit(descs)
            rh.wait([d.uid for d in descs])
            scores = [rh.result(u) for u in score_uids]
            best = int(np.argmax(scores))
            center = seeds[best]  # steer the next round (active learning)
            print(f"round {r}: best seed {center} "
                  f"score {scores[best]:.4f} "
                  f"(avg put {store.stats.summary()['avg_put_ms']:.3f} ms)")
        print("coupling overhead <",
              f"{store.stats.summary()['avg_get_ms']:.3f} ms/get")
        return center
    finally:
        store.close()
        rh.close()


if __name__ == "__main__":
    main(*sys.argv[1:2])
