"""LM data pipeline: sharded, deterministic, checkpoint-resumable.

The port's own copy of the JAX package's ``substrate/data.py``: the same
reproducible token corpus (a mixture of Zipfian "documents" with repeated
motifs, so losses actually decrease, drawn from numpy's ``RandomState``),
packed into fixed-length sequences and sharded across data-parallel ranks,
with ``state()``/``restore()`` so a restarted job continues from the exact
batch where it left off.  The tokens equal the reference's for the same
config; batches come out as torch tensors on the pipeline's device.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass
class DataConfig:
    vocab: int = 2048
    seq_len: int = 128
    global_batch: int = 8
    seed: int = 0
    n_docs: int = 512
    doc_len: int = 384
    dp_rank: int = 0  # this host's data-parallel shard
    dp_size: int = 1


class SyntheticCorpus:
    """Deterministic Zipf-mixture corpus with local n-gram structure."""

    def __init__(self, cfg: DataConfig):
        rng = np.random.RandomState(cfg.seed)
        self.cfg = cfg
        base = rng.zipf(1.5, size=(cfg.n_docs, cfg.doc_len)) % cfg.vocab
        shift = rng.randint(0, cfg.vocab, size=(cfg.n_docs, 1))
        docs = (base + shift) % cfg.vocab
        # inject repeated motifs (learnable structure)
        motif = rng.randint(0, cfg.vocab, size=(cfg.n_docs, 8))
        for i in range(cfg.n_docs):
            for start in range(16, cfg.doc_len - 8, 48):
                docs[i, start:start + 8] = motif[i]
        self.tokens = docs.reshape(-1).astype(np.int32)

    def __len__(self):
        return len(self.tokens)


class DataPipeline:
    """Packs the corpus into [batch, seq] with a resumable cursor; batches
    land on ``device`` (the CUDA card unless the caller asks for the
    CPU)."""

    def __init__(self, cfg: DataConfig,
                 corpus: Optional[SyntheticCorpus] = None, device=None):
        self.cfg = cfg
        self.corpus = corpus or SyntheticCorpus(cfg)
        self.device = resolve_device(device)
        self.step = 0

    # -- checkpoint integration ------------------------------------------
    def state(self) -> dict:
        return {"step": self.step, "seed": self.cfg.seed}

    def restore(self, state: dict):
        if state.get("seed") != self.cfg.seed:
            raise ValueError("data pipeline seed mismatch on restore")
        self.step = int(state["step"])

    # -- iteration ----------------------------------------------------------
    def _slice(self, step: int) -> np.ndarray:
        cfg = self.cfg
        toks = self.corpus.tokens
        n = len(toks)
        per_rank = cfg.global_batch // cfg.dp_size
        out = np.empty((per_rank, cfg.seq_len + 1), np.int32)
        for b in range(per_rank):
            gb = cfg.dp_rank * per_rank + b
            start = (step * cfg.global_batch + gb) * cfg.seq_len % (
                n - cfg.seq_len - 1)
            out[b] = toks[start:start + cfg.seq_len + 1]
        return out

    def next_batch(self) -> dict:
        chunk = torch.from_numpy(self._slice(self.step)).to(self.device)
        self.step += 1
        return {
            "tokens": chunk[:, :-1],
            "targets": chunk[:, 1:],
            "loss_mask": torch.ones((chunk.shape[0], self.cfg.seq_len),
                                    dtype=torch.float32, device=self.device),
        }

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()
