"""moonshot-v1-16b-a3b [moe]: 48L d=2048 16H (kv=16) d_ff=1408 vocab=163840.

MoE 64 experts top-6 (kimi/moonlight style, fine-grained).
[hf:moonshotai/Moonlight-16B-A3B; hf]
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b", family="moe",
        n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
        d_ff=1408, vocab=163840,
        n_experts=64, top_k=6, n_shared_experts=2, first_dense_layers=1,
        dense_ff=11264, capacity_factor=1.25,
        activation="silu", gated_mlp=True,
        rope_theta=5e4, max_seq=32768,
        param_dtype="bfloat16", compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return config().scaled(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=32, dense_ff=128, vocab=256, max_seq=128,
        n_experts=8, top_k=2, n_shared_experts=2, first_dense_layers=1,
        param_dtype="float32", compute_dtype="float32",
    )
