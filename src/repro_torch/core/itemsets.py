"""Bitmap Apriori — the paper's Market Basket Analysis steps 1–2 over a
packed transaction bitmap.

Data plane: transactions are a dense 0/1 matrix ``T ∈ uint8[n_tx, n_items]``
(item-minor, padded to 128 lanes); support of a candidate bitmask row c is
``Σ_t 1[T_t ∧ c = c]`` — see ``repro_torch.kernels.support_count``.

Control plane (host): level-k candidate *generation* (the classic
F_{k-1}⋈F_{k-1} join + downward-closure prune) is tiny serial work — the
paper's "single-threaded task", which the MB Scheduler routes to one core
while gating the rest (power model hook).

``apriori`` below is the minimal driver (MapReduce rounds on a
:class:`SimulatedCluster`, one upload a tile for the whole mine and one
read back a level); the production path with full scheduling/energy
accounting, data-plane batching and rule extraction is
``repro_torch.pipeline.MarketBasketPipeline``, which shares this module's
candidate generation.  Both are pinned to ``apriori_bruteforce``.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.hetero import HeterogeneityProfile
from repro_torch.core.mapreduce import (FailureEvent, MapReduceJob,
                                        SimulatedCluster)
from repro_torch.kernels.support_count.ref import support_count_ref
from repro_torch.runtime.transfers import TransferMeter

# The plain support count ([N, I] x [M, I] 0/1 -> [M] int32), under the
# reference module's name.
support_counts_ref = support_count_ref


def support_counts(T: torch.Tensor, C: torch.Tensor,
                   use_kernel: bool = False) -> torch.Tensor:
    """Support counts [M] int32 of candidate masks C [M, I] over
    transactions T [N, I] (0/1, one device): the support-count kernel the
    autotune cache picks (``use_kernel``), else the plain count."""
    if use_kernel:
        from repro_torch.kernels.support_count.ops import support_count
        return support_count(T, C)
    return support_counts_ref(T, C)


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


def _tile_rows(T: np.ndarray, n_tiles: int) -> List[np.ndarray]:
    return [np.ascontiguousarray(t) for t in np.array_split(T, n_tiles) if len(t)]


def apriori(T: np.ndarray, min_support: int, *,
            cluster: Optional[SimulatedCluster] = None,
            n_tiles: int = 8,
            max_k: int = 0,
            use_kernel: bool = False,
            failures: Optional[List[FailureEvent]] = None,
            device: str = "cuda",
            meter: Optional[TransferMeter] = None) -> AprioriResult:
    """Level-wise frequent-itemset mining over a transaction bitmap.

    Each level is one MapReduce round: the map phase counts candidate
    supports on row-tiles of T on ``device`` (the card unless the caller
    asks for the CPU), the reduce phase sums the count vectors.
    min_support is absolute.  Every upload and read back goes through
    ``meter`` (a fresh one when none is given): one upload a tile and a
    candidate batch, and exactly one read back (sync) a level.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"apriori(device={str(device)!r}) but no CUDA "
                           "device is available; pass device='cpu' to mine "
                           "on the CPU")
    meter = meter or TransferMeter(device)
    n_tx, n_items = T.shape
    if cluster is None:
        cluster = SimulatedCluster(HeterogeneityProfile.paper())
    # one upload a tile for the whole mine, as uint8 at the bitmap's shape
    # (the cluster prices a tile by its nbytes); every per-tile map result
    # stays on the device until the level's one read back below
    tiles = [meter.h2d(t) for t in _tile_rows(T, n_tiles)]
    supports: Dict[Tuple[int, ...], int] = {}
    reports = []

    # ---- step 1: item frequency (<item, count>) ----
    job1 = MapReduceJob(
        name="mba-step1-item-counts",
        map_fn=lambda tile: tile.sum(0, dtype=torch.int32),
        combine_fn=lambda a, b: a + b,
        zero_fn=lambda: torch.zeros(n_items, dtype=torch.int32,
                                    device=device),
    )
    counts, rep = cluster.run(job1, tiles, failures=failures)
    counts = meter.d2h(counts).astype(np.int64)
    reports.append(("k=1", rep))
    frequent = [(int(i),) for i in np.nonzero(counts >= min_support)[0]]
    for (i,) in frequent:
        supports[(i,)] = int(counts[i])

    # ---- step 2 loop: candidate generation + support counting ----
    k = 2
    while frequent and (max_k == 0 or k <= max_k):
        cands = generate_candidates(frequent)
        if not cands:
            break
        Cd = meter.h2d(itemsets_to_bitmap(cands, n_items))

        def map_fn(tile, Cd=Cd):
            return support_counts(tile, Cd, use_kernel=use_kernel)

        job = MapReduceJob(
            name=f"mba-step2-support-k{k}",
            map_fn=map_fn,
            combine_fn=lambda a, b: a + b,
            zero_fn=lambda m=len(cands): torch.zeros(
                m, dtype=torch.int32, device=device),
        )
        sup, rep = cluster.run(job, tiles, failures=failures)
        sup = meter.d2h(sup).astype(np.int64)   # the level's one read back
        reports.append((f"k={k}", rep))
        frequent = []
        for c, s in zip(cands, sup):
            if s >= min_support:
                supports[c] = int(s)
                frequent.append(c)
        k += 1

    return AprioriResult(supports=supports, n_tx=n_tx, levels=k - 1,
                         reports=reports)


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
