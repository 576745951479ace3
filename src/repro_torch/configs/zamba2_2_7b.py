"""zamba2-2.7b [hybrid]: 54L d=2560 32H (kv=32) d_ff=10240 vocab=32000.

Mamba2 backbone (ssm_state=64) + one shared full-attention block applied
every 6 layers (the Zamba trick). [arXiv:2411.15242; hf]
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b", family="hybrid",
        n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
        d_ff=10240, vocab=32000,
        ssm_state=64, ssm_conv=4, ssm_head_dim=64, ssm_expand=2,
        ssm_chunk=128, attn_every=6,
        activation="gelu", gated_mlp=True,
        rope_theta=1e4, max_seq=524288,
        param_dtype="bfloat16", compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return config().scaled(
        n_layers=4, attn_every=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab=256,
        ssm_state=16, ssm_head_dim=16, ssm_chunk=16, max_seq=128,
        param_dtype="float32", compute_dtype="float32",
    )
