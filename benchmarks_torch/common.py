"""Shared benchmark helper: CSV emission (the port's ``benchmarks/common``;
its JSON goes to ``results/benchmarks_torch.json``, beside the reference's
``results/benchmarks.json``, never over it)."""
from __future__ import annotations

import json
import os

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

