"""rhapsody-demo: small LM used by examples/benchmarks as the service model."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rhapsody-demo", family="dense",
        n_layers=4, d_model=256, n_heads=8, n_kv_heads=4, head_dim=32,
        d_ff=1024, vocab=2048,
        activation="silu", gated_mlp=True,
        rope_theta=1e4, max_seq=2048,
        param_dtype="float32", compute_dtype="float32",
    )


def smoke_config() -> ModelConfig:
    return config().scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                           head_dim=16, d_ff=128, vocab=256)
