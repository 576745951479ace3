"""llama3.2-3b [dense]: 28L d=3072 24H (GQA kv=8) d_ff=8192 vocab=128256.

[hf:meta-llama/Llama-3.2-3B; unverified]
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b", family="dense",
        n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
        d_ff=8192, vocab=128256,
        activation="silu", gated_mlp=True,
        rope_theta=5e5, max_seq=32768,
        param_dtype="bfloat16", compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return config().scaled(
        n_layers=2, d_model=48, n_heads=6, n_kv_heads=2, head_dim=8,
        d_ff=96, vocab=256, max_seq=128,
        param_dtype="float32", compute_dtype="float32",
    )
