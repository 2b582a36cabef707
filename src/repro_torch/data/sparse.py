"""Sparse CSR transaction slab — the format that lets production item
universes skip the dense bitmap.

The dense layout is O(n_tx × n_items) regardless of how empty it is;
SNIPPET 2's retail dataset (1559 items, 0.42% max item frequency) spends
99.5%+ of those bytes on zeros.  :class:`SparseSlab` stores the same
transactions as CSR (row pointers + sorted item ids per transaction) and
converts in three directions:

* ``to_dense()``       — the Apriori tiling path (explicit, never implicit);
* ``tid_columns()``    — straight to the Eclat vertical layout: one packed
  uint32 tid-list word row per item, built by scattering bits from the
  CSR indices **without** materializing the dense [n_tx, n_items] matrix;
* ``from_dense()``     — round-trip back for parity tests.

``density_stats`` measures the features the algorithm auto-selector
feeds the cost model (density, per-item frequencies) from either format.

Bit convention (shared with ``kernels.support_count.fused.pack_words``):
bit b of word w holds transaction ``w * 32 + b`` (LSB-first).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Union

import numpy as np

WORD_BITS = 32


def _pad_up(n: int, multiple: int) -> int:
    return n + (-n) % multiple


@dataclass(frozen=True)
class SparseSlab:
    """CSR transactions: row t holds sorted unique item ids
    ``indices[indptr[t]:indptr[t+1]]``."""

    indptr: np.ndarray            # int64 [n_tx + 1], monotone, [0] == 0
    indices: np.ndarray           # int32 [nnz], sorted + deduped per row
    n_items: int

    @property
    def n_tx(self) -> int:
        return len(self.indptr) - 1

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    @property
    def density(self) -> float:
        cells = self.n_tx * self.n_items
        return self.nnz / cells if cells else 0.0

    # ------------------------------------------------------------------
    @classmethod
    def from_baskets(cls, baskets: Sequence[Sequence[int]],
                     n_items: int = 0) -> "SparseSlab":
        """Variable-length id lists → CSR (set semantics: duplicates in one
        basket collapse, ids sorted per row — same as ``pack_transactions``)."""
        rows: List[np.ndarray] = []
        max_id = -1
        for tx in baskets:
            ids = np.unique(np.asarray(list(tx), dtype=np.int64)) \
                if len(tx) else np.zeros(0, np.int64)
            if len(ids):
                if ids[0] < 0:
                    raise ValueError("item ids must be non-negative")
                max_id = max(max_id, int(ids[-1]))
            rows.append(ids)
        if n_items <= 0:
            n_items = max_id + 1 if max_id >= 0 else 1
        elif max_id >= n_items:
            raise ValueError(f"item id {max_id} out of range [0, {n_items})")
        indptr = np.zeros(len(rows) + 1, dtype=np.int64)
        np.cumsum([len(r) for r in rows], out=indptr[1:])
        indices = (np.concatenate(rows).astype(np.int32) if rows
                   else np.zeros(0, np.int32))
        return cls(indptr=indptr, indices=indices, n_items=int(n_items))

    @classmethod
    def from_dense(cls, T: np.ndarray) -> "SparseSlab":
        """0/1 bitmap [n_tx, n_items] → CSR (exact round-trip partner of
        ``to_dense``)."""
        T = np.asarray(T)
        if T.ndim != 2:
            raise ValueError(f"bitmap must be 2-D, got {T.shape}")
        if T.size and not ((T == 0) | (T == 1)).all():
            raise ValueError("bitmap must contain only 0/1")
        rows, cols = np.nonzero(T)
        indptr = np.zeros(T.shape[0] + 1, dtype=np.int64)
        np.cumsum(np.bincount(rows, minlength=T.shape[0]), out=indptr[1:])
        # np.nonzero is row-major, so cols are already sorted per row
        return cls(indptr=indptr, indices=cols.astype(np.int32),
                   n_items=int(T.shape[1]))

    # ------------------------------------------------------------------
    def to_dense(self) -> np.ndarray:
        """CSR → 0/1 uint8 bitmap [n_tx, n_items] (the Apriori layout)."""
        T = np.zeros((self.n_tx, self.n_items), dtype=np.uint8)
        rows = np.repeat(np.arange(self.n_tx), np.diff(self.indptr))
        T[rows, self.indices] = 1
        return T

    def item_counts(self) -> np.ndarray:
        """Per-item transaction frequency [n_items] int64 — the k=1 supports
        and the auto-selector's sparsity feature, no densification."""
        return np.bincount(self.indices, minlength=self.n_items
                           ).astype(np.int64)

    def tid_columns(self, row_pad: int = 128,
                    word_pad: int = 128) -> np.ndarray:
        """Packed uint32 tid-list columns [n_items→row_pad·, W→word_pad·]:
        bit b of word w in row i set iff transaction ``32w + b`` contains
        item i.  Built by scattering bits straight from the CSR triplets —
        the dense [n_tx, n_items] matrix is never formed, which is the
        whole point of the sparse path."""
        n_rows = _pad_up(max(self.n_items, 1), row_pad)
        n_words = _pad_up(max((self.n_tx + WORD_BITS - 1) // WORD_BITS, 1),
                          word_pad)
        cols = np.zeros((n_rows, n_words), dtype=np.uint32)
        if self.nnz:
            tids = np.repeat(np.arange(self.n_tx, dtype=np.int64),
                             np.diff(self.indptr))
            np.bitwise_or.at(
                cols, (self.indices.astype(np.int64), tids >> 5),
                np.uint32(1) << (tids & 31).astype(np.uint32))
        return cols


@dataclass(frozen=True)
class DensityStats:
    """The measured features the algorithm auto-selector feeds the cost
    model — computed from either slab format without densifying."""

    n_tx: int
    n_items: int
    nnz: int
    density: float                   # nnz / (n_tx * n_items)
    item_counts: np.ndarray          # [n_items] int64 tx frequency per item
    max_item_frequency: float        # max item_counts / n_tx

    def summary(self) -> str:
        return (f"{self.n_tx} tx x {self.n_items} items, nnz={self.nnz} "
                f"(density {self.density:.4f}, max item freq "
                f"{self.max_item_frequency:.4f})")


BasketsLike = Union[np.ndarray, SparseSlab, Sequence[Sequence[int]]]


def density_stats(baskets: BasketsLike) -> DensityStats:
    """Measure density features from a dense bitmap, a :class:`SparseSlab`,
    or raw id lists — the sparse path never builds the dense matrix."""
    if isinstance(baskets, SparseSlab):
        slab = baskets
    elif isinstance(baskets, np.ndarray):
        counts = np.asarray(baskets, dtype=np.int64).sum(axis=0)
        n_tx, n_items = baskets.shape
        nnz = int(counts.sum())
        return DensityStats(
            n_tx=n_tx, n_items=n_items, nnz=nnz,
            density=nnz / (n_tx * n_items) if baskets.size else 0.0,
            item_counts=counts,
            max_item_frequency=(float(counts.max()) / n_tx
                                if n_tx and n_items else 0.0))
    else:
        slab = SparseSlab.from_baskets(baskets)
    counts = slab.item_counts()
    return DensityStats(
        n_tx=slab.n_tx, n_items=slab.n_items, nnz=slab.nnz,
        density=slab.density, item_counts=counts,
        max_item_frequency=(float(counts.max()) / slab.n_tx
                            if slab.n_tx and slab.n_items else 0.0))


def pack_tid_columns(T: np.ndarray, row_pad: int = 128,
                     word_pad: int = 128) -> np.ndarray:
    """Dense 0/1 bitmap [n_tx, n_items] → packed tid columns (the dense-
    input twin of ``SparseSlab.tid_columns``, same bit convention)."""
    return SparseSlab.from_dense(np.asarray(T)).tid_columns(
        row_pad=row_pad, word_pad=word_pad)
