"""rwkv6-1.6b [ssm]: 24L d=2048 (attn-free) d_ff=7168 vocab=65536.

Finch: data-dependent per-channel decay. [arXiv:2404.05892; unverified]
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b", family="ssm",
        n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=7168, vocab=65536,
        rwkv_head_dim=64, rwkv_lora_decay=64, rwkv_lora_mix=32, rwkv_chunk=32,
        positions="none", max_seq=524288,
        param_dtype="bfloat16", compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return config().scaled(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256, rwkv_head_dim=16, rwkv_lora_decay=8,
        rwkv_lora_mix=8, rwkv_chunk=8, max_seq=128,
        param_dtype="float32", compute_dtype="float32",
    )
