"""Algorithm auto-selection — ``CostModelPolicy`` extended with measured
density/sparsity features.

The paper's pitch is heterogeneous cores running *the right work*; the
survey line (Singh et al.) adds that the right work is also the right
*formulation*: Apriori's horizontal bitmap pays O(n_tx × n_items) per
candidate level regardless of density, the vertical (Eclat) formulation
pays O(candidates × n_tx/32) words after a one-time columnization.
Which wins depends on the dataset, so ``auto`` prices both formulations'
dominant k=2 round on the measured :class:`repro_torch.data.sparse.DensityStats`
and picks the cheaper one.

Rate seeding follows the same ladder as the switching policies: per
kernel, effective peak/bandwidth come from the autotune cache's walls
measured on the device the mine runs on
(``CostModelPolicy.from_autotune``); a cold/corrupt/other-device cache, or
a card that is not there, degrades that kernel to the H100 data-sheet
roofline (``repro_torch.launch.roofline``) — never raises.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.data.sparse import BasketsLike, DensityStats, density_stats
from repro_torch.launch.roofline import HBM_BW, PEAK_FLOPS
from repro_torch.launch.tuning import shape_flops_bytes
from repro_torch.runtime.policies import CostModelPolicy

WORD_BITS = 32

# the kernel each formulation's map rounds dispatch to — the rates that
# decide the algorithm must be the rates the chosen plan will then run at
ALGORITHM_KERNELS = {"apriori": "support_count", "eclat": "intersect_count"}


def _pad_up(n: int, multiple: int = 128) -> int:
    return max(n, 1) + (-max(n, 1)) % multiple


@dataclass(frozen=True)
class AlgorithmChoice:
    """One auto-selection decision, with its full evidence trail."""

    algorithm: str                       # "apriori" | "eclat"
    est_cost_s: Dict[str, float]         # per-algorithm modeled seconds
    features: Dict[str, float]           # density stats + derived counts
    cost_source: Dict[str, str]          # per-kernel: "autotune"|"roofline"

    def summary(self) -> str:
        costs = ", ".join(f"{a}={s:.2e}s" for a, s in
                          sorted(self.est_cost_s.items()))
        src = ", ".join(f"{k}:{v}" for k, v in sorted(self.cost_source.items()))
        return (f"auto-selected {self.algorithm} ({costs}; "
                f"density={self.features['density']:.4f}, "
                f"f1={int(self.features['n_frequent_items'])}; rates {src})")


class AlgorithmCostModel:
    """Per-kernel effective (peak, bw) rates + the formulation cost model.

    ``kernel_rates`` maps kernel name → ``(peak_flops, hbm_bw)``; tests
    inject scripted rates here to pin the decision logic.  Absent kernels
    price at the data-sheet roofline constants.
    """

    def __init__(self, kernel_rates: Optional[Dict[str, Tuple[float, float]]]
                 = None,
                 cost_source: Optional[Dict[str, str]] = None):
        self.kernel_rates = dict(kernel_rates or {})
        self.cost_source = dict(cost_source or {})

    @classmethod
    def from_autotune(cls, cache=None, device="cuda") -> "AlgorithmCostModel":
        """Seed every formulation's kernel from its measured cache walls
        on ``device``; per-kernel roofline fallback on a cold cache or
        without the card (never raises)."""
        from repro_torch.kernels.autotune.cache import default_cache
        cache = cache if cache is not None else default_cache()
        rates: Dict[str, Tuple[float, float]] = {}
        source: Dict[str, str] = {}
        for kernel in set(ALGORITHM_KERNELS.values()):
            try:
                pol = CostModelPolicy.from_autotune(cache, kernel, device)
                rates[kernel] = (pol.peak_flops, pol.hbm_bw)
                source[kernel] = pol.cost_source          # "autotune"
            except (ValueError, RuntimeError):
                source[kernel] = "roofline"
        return cls(kernel_rates=rates, cost_source=source)

    # ------------------------------------------------------------------
    def _seconds(self, kernel: str, shape: Tuple[int, ...]) -> float:
        peak, bw = self.kernel_rates.get(kernel, (PEAK_FLOPS, HBM_BW))
        flops, bytes_ = shape_flops_bytes(kernel, shape)
        return max(flops / peak, bytes_ / bw)

    def estimate(self, stats: DensityStats,
                 min_sup_abs: int) -> AlgorithmChoice:
        """Price both formulations' dominant work on measured features.

        The k=1 pass is format-native for both; the fork is the k=2 round
        (almost always the widest candidate level): Apriori counts
        f1·(f1−1)/2 pair candidates against the full padded bitmap, Eclat
        pays a one-time columnization then intersects the same pairs as
        packed tid words.  f1 comes from the *measured* per-item counts —
        not an independence guess — so a dataset whose wide universe is
        mostly infrequent (the sparse regime) prices tiny for both, and
        the dense regime's kernel-rate gap decides."""
        f1 = int((stats.item_counts >= min_sup_abs).sum())
        m2 = f1 * (f1 - 1) // 2
        n_pad = _pad_up(stats.n_tx, 8)
        i_pad = _pad_up(stats.n_items, 128)
        m2_pad = _pad_up(m2, 128)
        w_pad = _pad_up((stats.n_tx + WORD_BITS - 1) // WORD_BITS, 128)

        apriori_s = self._seconds("support_count", (n_pad, m2_pad, i_pad))
        # columnize: one pass over the nnz cells plus the packed slab write,
        # priced at the intersect kernel's effective bandwidth
        _, bw = self.kernel_rates.get("intersect_count", (PEAK_FLOPS, HBM_BW))
        columnize_s = (4.0 * stats.nnz + 4.0 * i_pad * w_pad) / bw
        eclat_s = columnize_s + self._seconds("intersect_count",
                                              (m2_pad, w_pad))
        costs = {"apriori": apriori_s, "eclat": eclat_s}
        pick = min(costs, key=lambda a: (costs[a], a))
        return AlgorithmChoice(
            algorithm=pick, est_cost_s=costs,
            features={"n_tx": float(stats.n_tx),
                      "n_items": float(stats.n_items),
                      "nnz": float(stats.nnz),
                      "density": float(stats.density),
                      "max_item_frequency": float(stats.max_item_frequency),
                      "n_frequent_items": float(f1),
                      "n_pair_candidates": float(m2)},
            cost_source={k: self.cost_source.get(k, "roofline")
                         for k in set(ALGORITHM_KERNELS.values())})


def select_algorithm(baskets: BasketsLike, min_sup_abs: int,
                     model: Optional[AlgorithmCostModel] = None,
                     stats: Optional[DensityStats] = None,
                     device="cuda") -> AlgorithmChoice:
    """Measure the dataset's density features and pick a formulation
    (priced, without a ``model``, at the rates measured on ``device``)."""
    if stats is None:
        stats = density_stats(baskets)
    model = model or AlgorithmCostModel.from_autotune(device=device)
    return model.estimate(stats, min_sup_abs)


# ---------------------------------------------------------------------------
# SON out-of-core partition scaling
# ---------------------------------------------------------------------------

def local_min_support(min_sup_abs: int, partition_rows: int, n_tx: int) -> int:
    """SON's per-partition absolute threshold: ``floor(G * p / n)``, clamped
    to >= 1.  The *floor* is load-bearing: if an itemset misses this bound
    in every partition, its global count is strictly below
    ``sum_p floor(G * p_rows / n) <= G`` — so no globally frequent itemset
    can be absent from every local result (SON's no-false-negative
    guarantee)."""
    if n_tx <= 0:
        return 1
    return max(1, (min_sup_abs * partition_rows) // n_tx)


def partition_stats(stats: DensityStats, partition_rows: int) -> DensityStats:
    """Corpus-level density stats scaled down to one SON partition.

    Item frequencies scale ~linearly with rows for the synthetic and retail
    corpora in tree (items are iid across transactions), so the partition's
    feature vector is the corpus's at ``partition_rows / n_tx``.  Using the
    same scaled stats for *every* partition keeps the auto-selection a
    single global decision — one formulation for every partition, and a
    resume that cannot flip algorithms mid-mine."""
    rows = max(1, min(int(partition_rows), stats.n_tx or 1))
    frac = rows / stats.n_tx if stats.n_tx else 0.0
    counts = np.floor(stats.item_counts.astype(np.float64) * frac
                      ).astype(np.int64)
    nnz = int(counts.sum())
    cells = rows * stats.n_items
    return DensityStats(
        n_tx=rows, n_items=stats.n_items, nnz=nnz,
        density=nnz / cells if cells else 0.0,
        item_counts=counts,
        max_item_frequency=(float(counts.max()) / rows
                            if rows and stats.n_items else 0.0))


def select_partition_algorithm(stats: DensityStats, partition_rows: int,
                               min_sup_abs: int,
                               model: Optional[AlgorithmCostModel] = None,
                               device="cuda") -> AlgorithmChoice:
    """Auto-selection for the SON plane: price both formulations on the
    *partition-sized* problem (that is where the map rounds actually run)
    at the partition-scaled local threshold, and pick once for all
    partitions."""
    ps = partition_stats(stats, partition_rows)
    model = model or AlgorithmCostModel.from_autotune(device=device)
    return model.estimate(ps, local_min_support(min_sup_abs, ps.n_tx,
                                                stats.n_tx))
