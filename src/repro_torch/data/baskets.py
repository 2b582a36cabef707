"""Synthetic transactional database (IBM Quest–style) for Market Basket
Analysis, plus bitmap packing.

Generates transactions from a pool of "purchase patterns" (correlated
itemsets) mixed with Zipf-distributed noise, which yields the non-trivial
association rules the paper mines.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class BasketConfig:
    n_tx: int = 4096
    n_items: int = 128          # padded to a multiple of 128 for the kernel
    n_patterns: int = 12
    pattern_len: int = 4
    pattern_prob: float = 0.35  # probability a tx includes a pattern
    noise_items: int = 3
    zipf_a: float = 1.5
    seed: int = 0


def generate_baskets(cfg: BasketConfig) -> np.ndarray:
    """Returns T ∈ uint8[n_tx, n_items] with 0/1 entries."""
    rng = np.random.default_rng(cfg.seed)
    patterns = [rng.choice(cfg.n_items, size=cfg.pattern_len, replace=False)
                for _ in range(cfg.n_patterns)]
    T = np.zeros((cfg.n_tx, cfg.n_items), dtype=np.uint8)
    for t in range(cfg.n_tx):
        if rng.random() < cfg.pattern_prob:
            pat = patterns[rng.integers(cfg.n_patterns)]
            keep = rng.random(len(pat)) < 0.9          # occasionally drop one
            T[t, pat[keep]] = 1
        noise = rng.zipf(cfg.zipf_a, size=cfg.noise_items) % cfg.n_items
        T[t, noise] = 1
    return T


def stationary_baskets(n_tx: int, n_items: int, n_patterns: int = 6,
                       pattern_len: int = 3, seed: int = 0) -> np.ndarray:
    """A stationary, wide-margin stream for the incremental-mining plane.

    Every transaction is one of ``n_patterns`` *disjoint* purchase patterns
    plus a single uniform noise item, so itemset supports concentrate far
    from any reasonable min_support threshold (pattern itemsets ≈
    ``window / n_patterns``, noise ≈ ``window / n_items``).  Under such a
    stream the frequent-set lattice is stable across micro-batches and the
    streaming miner's delta path never needs a full re-validation — the
    steady state the B10 benchmark measures.  ``generate_baskets`` with its
    Zipf noise is the opposite regime: many itemsets hover at the
    threshold and cross it every batch.
    """
    if n_patterns * pattern_len > n_items:
        raise ValueError(f"{n_patterns} disjoint patterns of length "
                         f"{pattern_len} need more than {n_items} items")
    rng = np.random.default_rng(seed)
    ids = rng.permutation(n_items)[:n_patterns * pattern_len]
    patterns = ids.reshape(n_patterns, pattern_len)
    T = np.zeros((n_tx, n_items), dtype=np.uint8)
    for t in range(n_tx):
        T[t, patterns[rng.integers(n_patterns)]] = 1
        T[t, rng.integers(n_items)] = 1
    return T


def sparse_baskets(n_tx: int, n_items: int, basket_len: int = 8,
                   max_item_freq: float = 0.01, n_patterns: int = 20,
                   pattern_len: int = 3, seed: int = 0
                   ) -> List[List[int]]:
    """A wide-universe, low-frequency corpus (SNIPPET 2's retail regime:
    1559 items, 0.42% max item frequency) as raw id lists — the input the
    sparse slab path consumes *without* ever building the dense bitmap.

    Each transaction draws one of ``n_patterns`` correlated patterns with
    probability ``max_item_freq * n_patterns`` (a uniform pattern choice
    then caps every pattern item's frequency near ``max_item_freq``) plus
    ``basket_len`` uniform noise items from the full universe, whose
    individual frequencies sit near ``basket_len / n_items`` — far below
    the cap for production-sized universes.
    """
    if n_patterns * pattern_len > n_items:
        raise ValueError(f"{n_patterns} patterns of length {pattern_len} "
                         f"do not fit in a {n_items}-item universe")
    rng = np.random.default_rng(seed)
    ids = rng.permutation(n_items)[:n_patterns * pattern_len]
    patterns = ids.reshape(n_patterns, pattern_len)
    p_pattern = min(max_item_freq * n_patterns, 1.0)
    baskets: List[List[int]] = []
    for _ in range(n_tx):
        tx = set(rng.choice(n_items, size=basket_len, replace=False).tolist())
        if rng.random() < p_pattern:
            tx.update(patterns[rng.integers(n_patterns)].tolist())
        baskets.append(sorted(tx))
    return baskets


def pack_transactions(transactions: Sequence[Sequence[int]],
                      n_items: Optional[int] = None) -> np.ndarray:
    """Pack variable-length transactions (sequences of item ids) into the
    dense 0/1 bitmap the data plane consumes.  Duplicate items within one
    transaction collapse to a single bit (set semantics)."""
    if n_items is None:
        n_items = 1 + max((max(tx) for tx in transactions if len(tx)),
                          default=-1)
    T = np.zeros((len(transactions), max(n_items, 1)), dtype=np.uint8)
    for t, tx in enumerate(transactions):
        if not len(tx):
            continue
        idx = np.asarray(list(tx))
        if idx.min() < 0 or idx.max() >= n_items:
            raise ValueError(
                f"item ids must be in [0, {n_items}) — negative or oversized "
                "ids would land in the wrong bitmap column")
        T[t, idx] = 1
    return T


def pad_items(T: np.ndarray, multiple: int = 128) -> np.ndarray:
    """Pad the item axis to a lane-aligned multiple (kernel requirement)."""
    n_tx, n_items = T.shape
    pad = (-n_items) % multiple
    if pad == 0:
        return T
    return np.pad(T, ((0, 0), (0, pad)))


def pad_rows(T: np.ndarray, multiple: int = 8) -> np.ndarray:
    n_tx, _ = T.shape
    pad = (-n_tx) % multiple
    if pad == 0:
        return T
    return np.pad(T, ((0, pad), (0, 0)))
