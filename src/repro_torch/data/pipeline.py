"""Deterministic LM data pipeline — port of ``src/repro/data/pipeline.py``.

Synthetic token streams with the system properties of a production
loader: deterministic per (seed, step), so restarts resume mid-epoch
without duplication.  The stream is a learnable synthetic language (Zipf
unigrams plus a copy structure) rather than pure noise, so train loss
visibly drops.  ``batch_at`` is the reference's numpy code unchanged, so
both packages draw bit-equal batches; ``device`` takes the place of the
reference's ``sharding``.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from ..models.config import ModelConfig


class TokenPipeline:
    def __init__(self, cfg: ModelConfig, batch: int, seq: int,
                 seed: int = 0, device: Optional[Any] = None):
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.device = device
        v = cfg.vocab_size
        # Zipf unigram table + shift-structured bigram mixing
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self.unigram = (1.0 / ranks ** 1.1)
        self.unigram /= self.unigram.sum()

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        v = self.cfg.vocab_size
        toks = rng.choice(v, size=(self.batch, self.seq),
                          p=self.unigram).astype(np.int32)
        # inject copy structure: second half of each row repeats the first
        # half shifted by one (gives the LM something learnable)
        half = self.seq // 2
        toks[:, half:half * 2] = (toks[:, :half] + 1) % v
        out: Dict[str, Any] = {"tokens": toks}
        if self.cfg.frontend == "vision_stub":
            out["patch_embeds"] = rng.standard_normal(
                (self.batch, self.cfg.num_patches, self.cfg.d_model)
                ).astype(np.float32) * 0.02
        if self.cfg.is_encoder_decoder:
            out["frames"] = rng.standard_normal(
                (self.batch, self.seq, self.cfg.d_model)
                ).astype(np.float32) * 0.02
            out["tokens"] = toks[:, :min(self.cfg.max_decode_len, self.seq)]
        return out

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        """Batches from step 0 on: numpy, or tensors on ``device``."""
        step = 0
        while True:
            b = self.batch_at(step)
            if self.device is not None:
                b = {k: torch.as_tensor(x, device=self.device)
                     for k, x in b.items()}
            yield b
            step += 1


__all__ = ["TokenPipeline"]
