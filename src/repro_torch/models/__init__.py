"""Model registry: the uniform API the serving engine drives.

Only the dense family is ported so far; the others raise, naming the
ROADMAP item that ports them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from . import transformer as tfm
from .config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ModelApi:
    """Uniform model surface used by serving."""

    init: Callable  # (generator, cfg, *, device) -> params
    prefill: Callable  # (params, batch, cfg, *, max_len, last_only) -> (cache, logits)
    decode: Callable  # (params, cache, tokens [B], cfg) -> (cache, logits [B,V])
    extend: Optional[Callable] = None  # (params, cache, tokens [B,T], cfg) -> (cache, logits [B,T,V])
    decode_paged: Optional[Callable] = None  # (params, store, block_tables, lens, tokens [B], write_phys, write_off, cfg) -> (store, logits [B,V])


_NOT_PORTED = {
    "moe": "ROADMAP Queue 1 item 7 (MoE)",
    "encdec": "ROADMAP Queue 1 item 9 (encoder-decoder and VLM)",
    "vlm": "ROADMAP Queue 1 item 9 (encoder-decoder and VLM)",
    "hybrid": "ROADMAP Queue 1 item 11 (state-carrying families)",
    "ssm": "ROADMAP Queue 1 item 11 (state-carrying families)",
}


def get_model(cfg: ModelConfig) -> ModelApi:
    if cfg.family != "dense" or cfg.is_moe:
        item = _NOT_PORTED.get("moe" if cfg.is_moe else cfg.family,
                               "the ROADMAP")
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported to PyTorch "
            f"yet: {item}")
    if cfg.positions not in ("rope", "none"):
        raise NotImplementedError(
            f"positions={cfg.positions!r} is not ported yet: ROADMAP Queue 1 "
            f"item 9 (encoder-decoder and VLM)")
    return ModelApi(
        init=tfm.lm_init,
        prefill=tfm.prefill,
        decode=tfm.decode_step,
        extend=tfm.extend_step,
        decode_paged=tfm.paged_decode_step,
    )
