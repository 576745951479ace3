"""whisper-small [audio]: 12+12L d=768 12H d_ff=3072 vocab=51865, enc-dec.

Vocab padded 51865 -> 51872 (multiple of 32/16) for TP sharding — standard
TPU practice; padded ids are never targeted.

Conv/audio frontend is a STUB (input_specs provides frame embeddings).
[arXiv:2212.04356; unverified]
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small", family="encdec",
        n_layers=12, enc_layers=12, dec_layers=12, cross_attention=True,
        d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072, vocab=51872,
        activation="gelu", gated_mlp=False,
        positions="learned", max_seq=32768,
        param_dtype="bfloat16", compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return config().scaled(
        n_layers=2, enc_layers=2, dec_layers=2,
        d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256, max_seq=128,
        param_dtype="float32", compute_dtype="float32",
    )
