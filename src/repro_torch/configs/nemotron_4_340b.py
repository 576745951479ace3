"""nemotron-4-340b [dense]: 96L d=18432 96H (GQA kv=8) d_ff=73728 vocab=256000.

Squared-ReLU (non-gated) MLP. [arXiv:2402.16819; unverified]
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-340b", family="dense",
        n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8, head_dim=192,
        d_ff=73728, vocab=256000,
        activation="relu2", gated_mlp=False,
        rope_theta=1e4, max_seq=32768,
        param_dtype="bfloat16", compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return config().scaled(
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
        d_ff=256, vocab=256, max_seq=128,
        param_dtype="float32", compute_dtype="float32",
    )
