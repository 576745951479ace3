"""Shared benchmark helpers: CSV emission (the port's ``benchmarks/common``;
its JSON goes to ``results/benchmarks_torch.json``, beside the reference's
``results/benchmarks.json``, never over it), a model's seeded weights and
a host clock that waits for the card."""
from __future__ import annotations

import json
import os
import time

import torch

from repro_torch.models import get_model

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "results")
RESULTS_FILE = "benchmarks_torch.json"


class Reporter:
    def __init__(self):
        self.rows = []

    def add(self, name: str, us_per_call: float, derived: str = ""):
        self.rows.append((name, us_per_call, derived))
        print(f"{name},{us_per_call:.2f},{derived}", flush=True)

    def save_json(self, payload):
        os.makedirs(RESULTS_DIR, exist_ok=True)
        path = os.path.join(RESULTS_DIR, RESULTS_FILE)
        with open(path, "w") as f:
            json.dump(payload, f, indent=1)
        return path



def init_params(cfg, device, seed: int = 0):
    """``cfg``'s weights drawn from ``seed`` on ``device``, as
    ``make_engine_from_scratch`` draws them."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return get_model(cfg).init(gen, cfg, device=device)


def clock(device) -> float:
    """``time.perf_counter()`` once the card's queued work has ended (a
    host clock read without it times the launches, not the work)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()
