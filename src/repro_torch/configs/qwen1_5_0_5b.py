"""qwen1.5-0.5b [dense]: 24L d=1024 16H (GQA kv=16) d_ff=2816 vocab=151936, QKV bias.

[hf:Qwen/Qwen1.5-0.5B; hf]
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-0.5b", family="dense",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=2816, vocab=151936,
        qkv_bias=True, activation="silu", gated_mlp=True,
        rope_theta=1e6, max_seq=32768,
        param_dtype="bfloat16", compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return config().scaled(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256, max_seq=128,
        param_dtype="float32", compute_dtype="float32",
    )
