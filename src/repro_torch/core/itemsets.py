"""Bitmap Apriori — the paper's Market Basket Analysis steps 1–2 over a
packed transaction bitmap.

Data plane: transactions are a dense 0/1 matrix ``T ∈ uint8[n_tx, n_items]``
(item-minor, padded to 128 lanes); support of a candidate bitmask row c is
``Σ_t 1[T_t ∧ c = c]`` — see ``repro_torch.kernels.support_count``.

Control plane (host): level-k candidate *generation* (the classic
F_{k-1}⋈F_{k-1} join + downward-closure prune) is tiny serial work — the
paper's "single-threaded task", which the MB Scheduler routes to one core
while gating the rest (power model hook).  The production driver with full
scheduling/energy accounting is ``repro_torch.pipeline.MarketBasketPipeline``,
which shares this module's candidate generation; ``apriori_bruteforce`` is
the oracle both packages are held to.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.kernels.support_count.ref import support_count_ref

# The plain support count ([N, I] x [M, I] 0/1 -> [M] int32), under the
# reference module's name.
support_counts_ref = support_count_ref


# ---------------------------------------------------------------------------
# candidate generation (control plane, classic Apriori)
# ---------------------------------------------------------------------------

def generate_candidates(frequent: List[Tuple[int, ...]]) -> List[Tuple[int, ...]]:
    """F_{k-1} ⋈ F_{k-1} join + downward-closure prune.  Itemsets are sorted
    tuples of item ids."""
    if not frequent:
        return []
    k = len(frequent[0]) + 1
    fset = set(frequent)
    out: List[Tuple[int, ...]] = []
    by_prefix: Dict[Tuple[int, ...], List[int]] = {}
    for t in frequent:
        by_prefix.setdefault(t[:-1], []).append(t[-1])
    for prefix, lasts in by_prefix.items():
        lasts = sorted(lasts)
        for i, a in enumerate(lasts):
            for b in lasts[i + 1:]:
                cand = prefix + (a, b)
                # prune: every (k-1)-subset must be frequent
                if all(cand[:j] + cand[j + 1:] in fset for j in range(k)):
                    out.append(cand)
    return sorted(out)


def itemsets_to_bitmap(itemsets: Sequence[Tuple[int, ...]], n_items: int) -> np.ndarray:
    C = np.zeros((len(itemsets), n_items), dtype=np.uint8)
    for i, s in enumerate(itemsets):
        C[i, list(s)] = 1
    return C


# ---------------------------------------------------------------------------
# the level-wise Apriori driver (paper §V steps 1-2)
# ---------------------------------------------------------------------------

def frequent_itemsets(supports: Dict[Tuple[int, ...], int],
                      k: Optional[int] = None) -> List[Tuple[int, ...]]:
    """Sorted frequent itemsets from a supports dict, optionally one level."""
    items = supports.keys()
    if k is not None:
        items = (s for s in items if len(s) == k)
    return sorted(items)


@dataclass
class AprioriResult:
    supports: Dict[Tuple[int, ...], int]      # itemset -> absolute support
    n_tx: int
    levels: int
    reports: list = field(default_factory=list)

    def frequent(self, k: Optional[int] = None) -> List[Tuple[int, ...]]:
        return frequent_itemsets(self.supports, k)


# ---------------------------------------------------------------------------
# brute-force oracle for tests
# ---------------------------------------------------------------------------

def apriori_bruteforce(T: np.ndarray, min_support: int, max_k: int = 4) -> Dict[Tuple[int, ...], int]:
    n_tx, n_items = T.shape
    out: Dict[Tuple[int, ...], int] = {}
    frequent_items = [i for i in range(n_items) if T[:, i].sum() >= min_support]
    for k in range(1, max_k + 1):
        any_f = False
        for comb in itertools.combinations(frequent_items, k):
            s = int(np.all(T[:, list(comb)] == 1, axis=1).sum())
            if s >= min_support:
                out[tuple(comb)] = s
                any_f = True
        if not any_f:
            break
    return out
