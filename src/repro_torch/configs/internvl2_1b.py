"""internvl2-1b [vlm]: 24L d=896 14H (GQA kv=2) d_ff=4864 vocab=151655.

Vocab padded 151655 -> 151680 (multiple of 128) for TP sharding — standard
TPU practice; padded ids are never targeted.

InternViT frontend is a STUB (input_specs provides patch embeddings);
backbone is the Qwen2-0.5B-style LM. [arXiv:2404.16821; hf]
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b", family="vlm",
        n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, head_dim=64,
        d_ff=4864, vocab=151680,
        qkv_bias=True, activation="silu", gated_mlp=True,
        rope_theta=1e6, max_seq=32768, vision_tokens=256,
        param_dtype="bfloat16", compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return config().scaled(
        n_layers=2, d_model=56, n_heads=7, n_kv_heads=1, head_dim=8,
        d_ff=112, vocab=256, max_seq=128, vision_tokens=8,
        param_dtype="float32", compute_dtype="float32",
    )
