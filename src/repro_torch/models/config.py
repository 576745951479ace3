"""Model configuration shared by every assigned architecture.

The same fields and defaults as the JAX package's ``ModelConfig``; only
``DTYPES`` maps to torch dtypes, so a reference config converts field by
field (``ModelConfig(**dataclasses.asdict(ref_cfg))``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


@dataclasses.dataclass
class ModelConfig:
    name: str = "model"
    family: str = "dense"  # dense | moe | hybrid | ssm | encdec | vlm

    # Core transformer dims
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 256
    vocab: int = 256
    head_dim: int = 0  # 0 -> d_model // n_heads

    # Attention
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e4
    attention_impl: str = "auto"  # auto | full | chunked | pallas
    attn_chunk_q: int = 1024
    attn_chunk_k: int = 1024
    positions: str = "rope"  # rope | learned | sinusoidal | none

    # MLP
    activation: str = "silu"
    gated_mlp: bool = True

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    first_dense_layers: int = 0  # deepseek-style: first N layers use dense FFN
    dense_ff: int = 0  # d_ff of the dense layers (0 -> n_experts * d_ff heuristics)
    capacity_factor: float = 1.25
    decode_capacity_factor: float = 4.0  # decode batches are small; drops hurt
    moe_impl: str = "auto"  # auto | dense | ep (shard_map + ragged_dot)
    router_aux_weight: float = 0.01

    # SSM (mamba2) / hybrid (zamba2)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    attn_every: int = 0  # hybrid: shared attention block after every N ssm blocks

    # RWKV6
    rwkv_head_dim: int = 64
    rwkv_lora_decay: int = 64
    rwkv_lora_mix: int = 32
    rwkv_chunk: int = 32

    # Encoder-decoder (whisper)
    enc_layers: int = 0
    dec_layers: int = 0
    cross_attention: bool = False

    # VLM
    vision_tokens: int = 0

    # Embedding / sequence
    tie_embeddings: bool = False
    max_seq: int = 4096
    norm_eps: float = 1e-6
    final_logit_softcap: float = 0.0

    # Compute / memory policy
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    scan_layers: bool = True
    remat: str = "full"  # none | full | dots
    use_pallas: bool = False  # TPU target; CPU tests use interpret/jnp paths
    # distribution optimizations (hillclimb; baseline = False)
    pad_heads_to: int = 0  # pad q-heads per kv-group for clean TP sharding
    explicit_tp: bool = False  # Megatron-style shard_map TP linears (bf16 AR)
    fsdp_params: bool = False  # explicit bf16 FSDP gathers inside TP linears
    seq_shard_activations: bool = False  # Megatron-SP residual sharding

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            self.head_dim = self.d_model // self.n_heads
        if self.family == "encdec" and self.enc_layers == 0:
            self.enc_layers = self.n_layers
            self.dec_layers = self.n_layers
            self.cross_attention = True

    # -- dtype helpers ------------------------------------------------------
    @property
    def pdtype(self):
        return DTYPES[self.param_dtype]

    @property
    def cdtype(self):
        return DTYPES[self.compute_dtype]

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(1, self.n_kv_heads)

    @property
    def padded_heads(self) -> int:
        """Effective q-head count incl. TP padding (zero-output heads)."""
        return self.pad_heads_to or self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def decode_state_kind(self) -> str:
        """What per-request state decoding carries."""
        if self.family == "ssm":
            return "recurrent"
        if self.family == "hybrid":
            return "mixed"  # ssm state + (small) attention KV for shared blocks
        return "kv"

    def scaled(self, **overrides) -> "ModelConfig":
        return dataclasses.replace(self, **overrides)

    # -- analytical param count (for roofline MODEL_FLOPS) -------------------
    def param_count_analytical(self) -> int:
        """Rough analytical parameter count (embedding + blocks)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        hd, nh, nkv = self.head_dim, self.n_heads, self.n_kv_heads
        emb = v * d * (1 if self.tie_embeddings else 2)
        attn = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
        mlp_dense = d * ff * (3 if self.gated_mlp else 2)
        if self.family == "ssm":  # rwkv6
            att = 4 * d * d + d * d  # r,k,v,g,o approx
            ffn = 2 * d * ff
            return emb + self.n_layers * (att + ffn)
        if self.family == "hybrid":
            d_in = self.ssm_expand * d
            ssm = d * (2 * d_in + 2 * self.ssm_state) + d_in * d
            n_attn = self.n_layers // max(1, self.attn_every)
            shared = attn + mlp_dense  # one shared block, reused
            return emb + self.n_layers * ssm + shared
        if self.is_moe:
            expert = d * ff * (3 if self.gated_mlp else 2)
            moe_layers = self.n_layers - self.first_dense_layers
            router = d * self.n_experts
            total = emb + self.n_layers * attn
            total += moe_layers * (
                (self.n_experts + self.n_shared_experts) * expert + router
            )
            dense_ff = self.dense_ff or ff
            total += self.first_dense_layers * d * dense_ff * (3 if self.gated_mlp else 2)
            return total
        n_blocks = (
            self.enc_layers + self.dec_layers
            if self.family == "encdec"
            else self.n_layers
        )
        cross = attn if self.cross_attention else 0
        return emb + n_blocks * (attn + mlp_dense + cross)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed top-k + shared only)."""
        if not self.is_moe:
            return self.param_count_analytical()
        d, ff = self.d_model, self.d_ff
        expert = d * ff * (3 if self.gated_mlp else 2)
        total = self.param_count_analytical()
        moe_layers = self.n_layers - self.first_dense_layers
        inactive = moe_layers * (self.n_experts - self.top_k) * expert
        return total - inactive
