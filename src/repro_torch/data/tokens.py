"""Deterministic synthetic LM data pipeline, the reference's
``repro/data/tokens.py`` in numpy alone (the reference's module imports
jax, so the port keeps its own copy; its batches are bit-identical).

Every (shard, step) pair maps to an independent PRNG stream, so the pipeline
is (a) deterministic under restart — resuming at step k regenerates exactly
the batches a failed run would have seen — and (b) heterogeneity-aware:
per-device batch shares come from the MB-scheduler plan
(``repro_torch.data.sharding``), not a fixed equal split.

The synthetic distribution is a Zipf mixture with Markov bigram structure so
the loss actually decreases during the example training runs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class TokenPipelineConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    n_modes: int = 8            # bigram mixture modes


class TokenPipeline:
    def __init__(self, cfg: TokenPipelineConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        V = cfg.vocab_size
        # low-rank bigram structure: next ~ Zipf permuted by mode
        self.perms = np.stack([rng.permutation(V) for _ in range(cfg.n_modes)])
        zipf_p = 1.0 / (np.arange(1, V + 1) ** 1.1)
        self.zipf_p = zipf_p / zipf_p.sum()

    def batch(self, step: int, batch_size: Optional[int] = None,
              offset: int = 0) -> Dict[str, np.ndarray]:
        """Deterministic batch for (step, offset) — offset selects the slice
        of the global batch (device/microbatch addressing)."""
        cfg = self.cfg
        bs = batch_size or cfg.global_batch
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, offset]))
        mode = rng.integers(cfg.n_modes, size=(bs, 1))
        base = rng.choice(cfg.vocab_size, p=self.zipf_p,
                          size=(bs, cfg.seq_len))
        toks = self.perms[mode[:, 0]][np.arange(bs)[:, None],
                                      np.minimum(base, cfg.vocab_size - 1)]
        return {"tokens": toks.astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
