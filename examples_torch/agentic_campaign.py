"""Agentic AI-HPC campaign on the PyTorch port: LLM-driven agents realize
decisions as HPC tasks.

Run: PYTHONPATH=src python examples_torch/agentic_campaign.py [cpu]
(the service and payloads run on the CUDA card unless given ``cpu``)
"""
import sys

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import (ResourceDescription, Rhapsody,
                              ServiceDescription, TaskDescription)
from repro_torch.core.agent import AgentConfig, run_agent_population
from repro_torch.serving.client import llm_service_factory
from repro_torch.substrate.simulation import surrogate_eval


def main(device=None, n_agents: int = 4, n_decisions: int = 3):
    cfg = get_config("rhapsody-demo").scaled(n_layers=2, d_model=64,
                                             n_heads=4, n_kv_heads=2,
                                             head_dim=16, d_ff=128, vocab=512)
    rh = Rhapsody(ResourceDescription(nodes=4, cores_per_node=8), n_workers=4)
    try:
        rh.add_service(ServiceDescription(
            name="planner", factory=llm_service_factory(
                cfg, device=device, max_num_seqs=8, max_len=64,
                prefill_buckets=(16,))))
        rng = np.random.RandomState(0)
        cfgs = [AgentConfig(
            name=f"agent{k}", service="planner", n_decisions=n_decisions,
            tasks_per_decision=2,
            decision_payload=lambda i: {
                "prompt": list(rng.randint(0, 512, 10)),
                "max_new_tokens": 4},
            make_task=lambda i, j: TaskDescription(
                fn=surrogate_eval, kwargs={"dim": 16, "seed": i * 7 + j,
                                           "device": device},
                task_type="tool_run"))
            for k in range(n_agents)]
        out = run_agent_population(rh, cfgs)
        lags = rh.events.realization_lag()
        print(f"{out['agents']} agents, {out['decisions']} decisions "
              f"-> {out['tasks']} HPC tasks")
        print(f"decision->realization lag: mean {np.mean(lags):.3f}s, "
              f"max {np.max(lags):.3f}s (bounded)")
        print(f"peak ARR {max(r for _, r in rh.events.windowed_rate('RUNNING', 0.5)):.1f} tasks/s")
        return out
    finally:
        rh.close()


if __name__ == "__main__":
    main(*sys.argv[1:2])
