"""A cell, built from files: ``BENCHMARK.json``'s entries, the
configuration file it names, ``<paths[0]>/traffic/<traffic>.json`` and
one reader ``<paths[0]>/metrics/<metric>.py`` a metric.

A reader is a module with ``read(w)``: ``w`` is the run's
``harness.Window``; it returns a number, or ``None`` where the run gave it
nothing to read (the metric is then left out of the result).
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path


def load_bench(root) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(root, name: str) -> dict:
    root = Path(root)
    bench = load_bench(root)
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == wl["config"])
    base = root / bench["paths"][0]
    return {
        "workload": wl,
        "config": json.loads((root / conf["file"]).read_text()),
        "traffic": json.loads(
            (base / "traffic" / f"{wl['traffic']}.json").read_text()),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m, name)],
        "per_layer": [m for m in bench["per_layer"] if applies(m, name)],
        "metrics_dir": base / "metrics",
    }


def reader(metrics_dir, name: str):
    path = Path(metrics_dir) / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
