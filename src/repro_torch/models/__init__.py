"""Model registry: the uniform API that training and serving drive.

The dense and MoE families (one transformer, ``transformer.py`` with
``moe.py`` as its FFN), rwkv6 (``ssm``) and zamba2 (``hybrid``) are
ported, and each serves and trains; encoder-decoder and VLM raise, naming
the ROADMAP item that ports them.
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

    init: Callable  # (generator, cfg, *, device) -> params
    loss: Callable  # (params, batch, cfg) -> (loss, metrics)
    forward: Callable  # (params, batch, cfg) -> (logits, aux)
    prefill: Callable  # (params, batch, cfg, *, max_len[, last_only: dense]) -> (cache, logits)
    decode: Callable  # (params, cache, tokens [B], cfg) -> (cache, logits [B,V])
    extend: Optional[Callable] = None  # (params, cache, tokens [B,T], cfg) -> (cache, logits [B,T,V])
    decode_paged: Optional[Callable] = None  # (params, store, block_tables, lens, tokens [B], write_phys, write_off, cfg) -> (store, logits [B,V])


_NOT_PORTED = {
    "encdec": "ROADMAP Queue 1 item 9 (encoder-decoder and VLM)",
    "vlm": "ROADMAP Queue 1 item 9 (encoder-decoder and VLM)",
}


def _require_ported(cfg: ModelConfig):
    if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
        item = _NOT_PORTED.get(cfg.family, "the ROADMAP")
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported to PyTorch "
            f"yet: {item}")


def get_model(cfg: ModelConfig) -> ModelApi:
    _require_ported(cfg)
    if cfg.positions not in ("rope", "none"):
        raise NotImplementedError(
            f"positions={cfg.positions!r} is not ported yet: ROADMAP Queue 1 "
            f"item 9 (encoder-decoder and VLM)")
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
               gen: Optional[torch.Generator] = None,
               device=None) -> dict[str, Any]:
    """Random token batch drawn from ``gen`` on ``device`` (the CUDA card
    unless the caller asks for the CPU): tokens, next-token targets
    (tokens rolled left by one) and an all-ones loss mask.  The ported
    families only; the frontend stubs of encdec/vlm come with their
    families."""
    _require_ported(cfg)
    device = resolve_device(device)
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                           device=device, dtype=torch.int32)
    return {
        "tokens": tokens,
        "targets": torch.roll(tokens, -1, dims=1),
        "loss_mask": torch.ones((batch, seq), dtype=torch.float32,
                                device=device),
    }
