"""A checkout-like directory holding one tiny cell of each family, built
from files as a later change would add them: ``BENCHMARK.json``, a
configuration file, a traffic file and the metric readers."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

MODELS = {
    "tiny-moe": {"name": "tiny-moe", "family": "moe", "n_layers": 3,
                 "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
                 "d_ff": 32, "vocab": 256, "n_experts": 8, "top_k": 2,
                 "n_shared_experts": 2, "first_dense_layers": 1,
                 "dense_ff": 128, "capacity_factor": 1.25,
                 "decode_capacity_factor": 1.0, "activation": "silu",
                 "gated_mlp": True, "positions": "rope",
                 "rope_theta": 10000.0, "max_seq": 128, "norm_eps": 1e-06,
                 "param_dtype": "float32", "compute_dtype": "float32"},
    "tiny-dense": {"name": "tiny-dense", "family": "dense", "n_layers": 2,
                   "d_model": 64, "n_heads": 8, "n_kv_heads": 2,
                   "head_dim": 8, "d_ff": 256, "vocab": 256,
                   "activation": "relu2", "gated_mlp": False,
                   "positions": "rope", "rope_theta": 10000.0,
                   "max_seq": 128, "norm_eps": 1e-06,
                   "param_dtype": "float32", "compute_dtype": "float32"},
}
ENGINE = {"max_num_seqs": 4, "max_num_batched_tokens": 64, "max_len": 128,
          "prefill_buckets": [16, 32, 64], "prefill_chunk": 64,
          "block_size": 16, "paged_decode_mode": "direct"}
TRAFFIC = {"loop": "closed", "clients": 3, "ramp_seconds": 0.5, "deck": 4,
           "shared_prefix_tokens": 16,
           "prompt": {"median": 20, "sigma": 0.5, "min": 8, "max": 40},
           "output": {"median": 12, "sigma": 0.3, "min": 8, "max": 16}}
# the dense cell's agents resend their transcripts
SESSIONS = dict(TRAFFIC, client_sigma=0.4, session={"max_tokens": 128})
LIMIT = 1e-3  # float32 program against the float32 reference


def make(root: Path) -> Path:
    """Lay out the tiny cells ``t.moe`` and ``t.dense`` under ``root``."""
    base = root / "pb"
    (base / "configs").mkdir(parents=True)
    (base / "traffic").mkdir()
    shutil.copytree(HERE / "metrics", base / "metrics")
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    bench["paths"] = ["pb"]
    bench["configs"], bench["workloads"] = [], []
    for name, model in MODELS.items():
        conf = {"name": name, "source": "test", "reduced": [],
                "model": model, "engine": ENGINE,
                "check": {"sample": 4, "limits": {"widest_gap": LIMIT}}}
        (base / "configs" / f"{name}.json").write_text(json.dumps(conf))
        bench["configs"].append({"name": name, "source": "test",
                                 "file": f"pb/configs/{name}.json",
                                 "reduced": [], "why": "test"})
        kind = name.split("-")[1]
        bench["workloads"].append({
            "name": "t." + kind, "config": name,
            "traffic": "sessions" if kind == "dense" else "tiny",
            "chips": 1, "why": "test"})
    (base / "traffic" / "tiny.json").write_text(json.dumps(TRAFFIC))
    (base / "traffic" / "sessions.json").write_text(json.dumps(SESSIONS))
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
