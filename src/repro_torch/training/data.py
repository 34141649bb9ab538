"""Synthetic LM data pipeline: deterministic, seeded, batched token
streams (zipfian unigram + short-range induction structure so the loss
actually decreases)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    copy_period: int = 64  # induction: token repeats with this period


def batches(cfg: DataConfig) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(cfg.seed)
    ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
    probs = ranks ** -cfg.zipf_a
    probs /= probs.sum()
    while True:
        toks = rng.choice(cfg.vocab_size, p=probs,
                          size=(cfg.global_batch, cfg.seq_len + 1))
        # induction structure: second half repeats the first half shifted
        half = cfg.copy_period
        for i in range(half, cfg.seq_len + 1):
            mask = rng.random(cfg.global_batch) < 0.5
            toks[mask, i] = toks[mask, i - half]
        yield {"tokens": toks[:, :-1].astype(np.int32),
               "labels": toks[:, 1:].astype(np.int32)}
