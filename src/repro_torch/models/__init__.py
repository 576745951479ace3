"""Model registry: the uniform API that training and serving drive.

Every family of the JAX package is ported, and each serves and trains:
the transformer families (``transformer.py``: dense, MoE with ``moe.py``
as its FFN, the encoder-decoder ``encdec`` and the vision-prefix ``vlm``),
rwkv6 (``ssm``) and zamba2 (``hybrid``).  ``init(..., with_axes=True)``
gives ``(params, axes)``, the axes tree equal to the reference's
``nn.split(api.init(...))[1]``; ``loss`` and ``forward`` take the
reference's ``mesh``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.device import resolve_device

from . import mamba2, rwkv6
from . import transformer as tfm
from .config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ModelApi:
    """Uniform model surface used by training and serving."""

    init: Callable  # (generator, cfg, *, device, with_axes=False) -> params or (params, axes)
    loss: Callable  # (params, batch, cfg, *, mesh=None) -> (loss, metrics)
    forward: Callable  # (params, batch, cfg, *, mesh=None) -> (logits, aux)
    prefill: Callable  # (params, batch, cfg, *, max_len[, last_only: dense]) -> (cache, logits)
    decode: Callable  # (params, cache, tokens [B], cfg) -> (cache, logits [B,V])
    extend: Optional[Callable] = None  # (params, cache, tokens [B,T], cfg) -> (cache, logits [B,T,V])
    decode_paged: Optional[Callable] = None  # (params, store, block_tables, lens, tokens [B], write_phys, write_off, cfg) -> (store, logits [B,V])


def get_model(cfg: ModelConfig) -> ModelApi:
    if cfg.family == "hybrid":
        return ModelApi(
            init=mamba2.hybrid_init,
            loss=mamba2.hybrid_loss,
            forward=mamba2.hybrid_forward,
            prefill=mamba2.hybrid_prefill,
            decode=mamba2.hybrid_decode_step,
        )
    if cfg.family == "ssm":
        return ModelApi(
            init=rwkv6.rwkv_init,
            loss=rwkv6.rwkv_loss,
            forward=rwkv6.rwkv_forward,
            prefill=rwkv6.rwkv_prefill,
            decode=rwkv6.rwkv_decode_step,
        )
    # dense / moe / encdec / vlm all run through the transformer stack
    # (decode_paged is for dense/moe only: the paged engine takes no
    # cross-attention or vision prefix, as in the reference)
    return ModelApi(
        init=tfm.lm_init,
        loss=tfm.loss_fn,
        forward=tfm.forward,
        prefill=tfm.prefill,
        decode=tfm.decode_step,
        extend=tfm.extend_step,
        decode_paged=tfm.paged_decode_step,
    )


# ---------------------------------------------------------------------------
# Synthetic batches (smoke tests / examples)
# ---------------------------------------------------------------------------


def make_batch(cfg: ModelConfig, batch: int, seq: int,
               gen: Optional[torch.Generator] = None, device=None, *,
               frontend_len: Optional[int] = None) -> dict[str, Any]:
    """Random token batch drawn from ``gen`` on ``device`` (the CUDA card
    unless the caller asks for the CPU): tokens, next-token targets
    (tokens rolled left by one) and an all-ones loss mask.  An
    encoder-decoder also gets stubbed audio frames ``frame_embeds`` [batch,
    frontend_len or seq, d], a vision-prefix model stubbed patches
    ``patch_embeds`` [batch, frontend_len or vision_tokens or 16, d], both
    standard normal x 0.02 (the modality frontends are stubs, as in the
    reference)."""
    device = resolve_device(device)
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                           device=device, dtype=torch.int32)
    out = {
        "tokens": tokens,
        "targets": torch.roll(tokens, -1, dims=1),
        "loss_mask": torch.ones((batch, seq), dtype=torch.float32,
                                device=device),
    }
    stubs = {"encdec": ("frame_embeds", seq),
             "vlm": ("patch_embeds", cfg.vision_tokens or 16)}
    if cfg.family in stubs:
        name, n = stubs[cfg.family]
        n = frontend_len if frontend_len is not None else n
        out[name] = torch.randn((batch, n, cfg.d_model), generator=gen,
                                device=device) * 0.02
    return out
