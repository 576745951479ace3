"""deepseek-moe-16b [moe]: 28L d=2048 16H (kv=16) d_ff=1408 vocab=102400.

2 shared + 64 routed top-6, fine-grained; first layer dense.
[arXiv:2401.06066; hf]
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b", family="moe",
        n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
        d_ff=1408, vocab=102400,
        n_experts=64, top_k=6, n_shared_experts=2, first_dense_layers=1,
        dense_ff=10944, capacity_factor=1.25,
        activation="silu", gated_mlp=True,
        rope_theta=1e4, max_seq=32768,
        param_dtype="bfloat16", compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return config().scaled(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=32, dense_ff=128, vocab=256, max_seq=128,
        n_experts=8, top_k=2, n_shared_experts=2, first_dense_layers=1,
        param_dtype="float32", compute_dtype="float32",
    )
