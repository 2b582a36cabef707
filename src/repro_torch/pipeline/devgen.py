"""On-device candidate generation — the Apriori lattice without host tuples.

The classic control plane decodes every level's frequent itemsets to host
tuples, runs the F_{k-1}⋈F_{k-1} join/prune in Python, re-packs the result
with ``itemsets_to_bitmap`` and uploads it — a d2h + h2d round-trip per
level that serializes the mining loop.  :class:`DeviceLattice` keeps the
frequent-set matrix device-resident instead and runs the join, the
downward-closure prune and the frequent-set compaction as tensor ops on the
device, so a round's only host crossing is one packed count vector:

  ``join()``      F[f_cap, k] ──prefix-join + prune──▶ C[m_cap, k+1] +
                  candidate bitmap (all device; no transfer)
  ``_finalize``   count accumulator ──▶ packed [m_cap+1] int32 vector:
                  per-candidate counts (−1 sentinel for padding) and J,
                  the next level's join-pair count — the **one d2h** the
                  pipelined round makes
  ``advance()``   host bookkeeping off the packed vector; the compacted
                  frequent matrix stays on device for the next join

Host code sees itemset *tuples* exactly once, in ``decode_supports()`` at
rule-generation time.

Correctness relies on an order invariant: the frequent matrix is kept
lexicographically sorted (valid rows first), and the join enumerates pairs
(i, j), i < j, in row-major order — which emits candidates in exactly the
sorted order the host ``generate_candidates`` returns, so count vectors
line up positionally with the host path.  The prune checks dropped
positions 0..k−2 only: dropping position k−1 or k yields the two join
parents, frequent by construction — identical semantics to checking all
subsets.  Subset membership tests encode each (k−1)-subset as a base-
``n_items`` polynomial key and binary-search the frequent keys; levels
whose keys would overflow int32 (or whose frequent set outgrows the
quadratic join mask) fall back to the host join, metered.

Every vector that reaches the host is int32, as in the reference (which
runs with 64-bit types disabled): torch reductions widen to int64, so sums
are cast back before they are read, or the ledger's byte counts would
differ.  Ops that would synchronize on the device (``nonzero``, boolean
mask indexing) are avoided: compaction scatters through a dump slot.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.itemsets import generate_candidates, itemsets_to_bitmap
from repro_torch.pipeline.dataplane import pad_candidates
from repro_torch.runtime.transfers import TransferMeter

# padding rows sort after every real key; valid keys stay below it because
# the device join is gated on n_items**(k-1) < _INVALID_KEY — levels whose
# keys need more than 31 bits take the host fallback instead.
_INVALID_KEY = int(np.iinfo(np.int32).max)


def _encode(rows: torch.Tensor, base: int) -> torch.Tensor:
    """Lexicographic-order-preserving int32 key per row (fixed length)."""
    key = torch.zeros(rows.shape[0], dtype=torch.int32, device=rows.device)
    for i in range(rows.shape[1]):
        key = key * base + rows[:, i]
    return key


def _stable_front(mask: torch.Tensor) -> torch.Tensor:
    """Permutation moving the True rows to the front, order kept within
    both groups (a stable sort of the integer cast of ``~mask``)."""
    return torch.sort((~mask).to(torch.int32), stable=True).indices


def _join_prune(F: torch.Tensor, valid: torch.Tensor, *, m_cap: int,
                n_items: int):
    """F_{k-1}⋈F_{k-1} join + downward-closure prune, all on device.

    F: [f_cap, k] int32 lexicographically sorted, valid rows first.
    Returns (C [m_cap, k+1] int32 compacted sorted candidates,
    valid_c [m_cap] bool, bitmap [m_cap, n_items] uint8).
    """
    f_cap, km1 = F.shape
    kc = km1 + 1
    dev = F.device
    # join: equal (k-1)-prefix, i < j — over empty prefixes (k=1) every
    # ordered pair of frequent items joins, as in the host path
    prefix_eq = (F[:, None, :-1] == F[None, :, :-1]).all(dim=-1)
    rows = torch.arange(f_cap, device=dev)
    pair_ok = (prefix_eq & (rows[:, None] < rows[None, :])
               & valid[:, None] & valid[None, :])
    flat = pair_ok.reshape(-1)
    n_join = flat.sum()
    # compact the surviving pair indices to the front of an [m_cap] slot
    # array (m_cap = bucketed J is exact, so nothing ever drops); the
    # others are masked onto a dump slot past the end
    dest = torch.where(flat, torch.cumsum(flat, 0) - 1, m_cap).clamp_(
        max=m_cap)
    p = torch.arange(f_cap * f_cap, dtype=torch.int32, device=dev)
    pair_idx = torch.zeros(m_cap + 1, dtype=torch.int32,
                           device=dev).scatter_(0, dest, p)[:m_cap]
    ii, jj = pair_idx // f_cap, pair_idx % f_cap
    C = torch.cat([F[ii], F[jj][:, -1:]], dim=1)             # [m_cap, kc]
    valid_c = torch.arange(m_cap, device=dev) < n_join

    if kc > 2:
        fkeys = torch.where(valid, _encode(F, n_items), _INVALID_KEY)
        for d in range(kc - 2):          # positions kc-2, kc-1 are parents
            sub = torch.cat([C[:, :d], C[:, d + 1:]], dim=1)
            skey = _encode(sub, n_items)
            pos = torch.searchsorted(fkeys, skey).clamp_(0, f_cap - 1)
            valid_c = valid_c & (fkeys[pos] == skey)
        # re-compact: the host path drops pruned candidates, so survivors
        # must be contiguous (stable sort keeps them in sorted order)
        order = _stable_front(valid_c)
        C, valid_c = C[order], valid_c[order]

    bitmap = torch.zeros(m_cap, n_items, dtype=torch.uint8, device=dev)
    bitmap.scatter_(1, C.long(),
                    valid_c[:, None].expand(-1, kc).to(torch.uint8))
    return C, valid_c, bitmap


def _finalize(acc: torch.Tensor, C: torch.Tensor, valid_c: torch.Tensor,
              min_sup: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Close a counting round on device: sentinel the padding counts,
    compact the frequent rows to the front (next level's F) and compute J,
    the next join's pair count, so the host can size round k+1 without a
    second readback.  Returns (packed [m_cap+1] int32, Fn, valid_n)."""
    counts = torch.where(valid_c, acc.to(torch.int32), -1)
    freq = counts >= min_sup            # sentinel −1 < min_sup (>= 1)
    order = _stable_front(freq)
    Fn, vn = C[order], freq[order]
    # J = Σ_g s_g·(s_g−1)/2 over equal-prefix runs of the frequent rows;
    # padding rows sit compacted at the end with zero weight, so a run
    # they extend never changes size
    pre = Fn[:, :-1]
    newgrp = torch.cat([torch.ones(1, dtype=torch.bool, device=C.device),
                        (pre[1:] != pre[:-1]).any(dim=-1)])
    gid = torch.cumsum(newgrp, 0) - 1
    # a group's frequent rows share a prefix and differ in the last item,
    # so s <= n_items and the pair arithmetic stays well inside int32
    sizes = torch.zeros(Fn.shape[0], dtype=torch.int32,
                        device=C.device).index_add_(0, gid,
                                                    vn.to(torch.int32))
    J = (sizes * (sizes - 1) // 2).sum().to(torch.int32)
    packed = torch.cat([counts, J[None]])
    return packed, Fn, vn


@dataclass
class _Level:
    """One mined level kept for rule-time decode: the device matrix with
    frequent rows first, how many are real, and their (host) counts."""
    F: torch.Tensor
    f_true: int
    counts: np.ndarray


class DeviceLattice:
    """Device-resident frequent-itemset state across Apriori levels.

    Protocol per level k >= 2 (driven by the pipeline):

    1. ``join()`` in the serial candgen phase — returns ``(C, valid_c,
       bitmap, m_cap)`` on device, or ``None`` when no pairs join (the
       round is dry, as when the host join returns ``[]``).
    2. the map phase folds tile counts into a device accumulator, then
       calls ``finalize``; its packed vector is the round's single d2h.
    3. ``advance()`` — host bookkeeping; frequent rows stay on device.
    4. after the loop, ``decode_supports()`` reads each level's frequent
       matrix back once for rule generation.

    The lattice lives on ``meter.device``, and every transfer it makes
    goes through ``meter``.
    """

    def __init__(self, n_items: int, m_bucket: int = 128,
                 meter: Optional[TransferMeter] = None,
                 max_join_rows: int = 4096,
                 max_candidates: int = 1 << 17):
        self.n_items = n_items
        self.m_bucket = m_bucket
        self.meter = meter if meter is not None else TransferMeter()
        self.device = self.meter.device
        self.max_join_rows = max_join_rows
        self.max_candidates = max_candidates
        self.F: Optional[torch.Tensor] = None       # [f_cap, k] int32
        self.valid: Optional[torch.Tensor] = None   # [f_cap] bool
        self.k = 0
        self.f_true = 0
        self.join_pairs = 0                         # J for the next join
        self.levels: List[_Level] = []              # k >= 2 only

    # ------------------------------------------------------------------
    def _bucket(self, m: int) -> int:
        return max(self.m_bucket, -(-m // self.m_bucket) * self.m_bucket)

    def _first(self, n: int, cap: int) -> torch.Tensor:
        """[cap] bool, True on the first n slots (made on device)."""
        return torch.arange(cap, device=self.device) < n

    def seed_items(self, item_ids: np.ndarray) -> None:
        """Install the level-1 frequent items (host-known from the k=1
        count readback) as the first device frequent matrix."""
        self.k = 1
        self.f_true = int(len(item_ids))
        f_cap = self._bucket(self.f_true)
        ids = np.zeros((f_cap, 1), np.int32)
        ids[:self.f_true, 0] = np.sort(np.asarray(item_ids))
        self.F = self.meter.h2d(ids)
        self.valid = self._first(self.f_true, f_cap)
        self.join_pairs = self.f_true * (self.f_true - 1) // 2

    def _device_join_ok(self) -> bool:
        kc = self.k + 1
        return (int(self.F.shape[0]) <= self.max_join_rows
                and self.join_pairs <= self.max_candidates
                and self.n_items ** (kc - 1) < _INVALID_KEY)

    # ------------------------------------------------------------------
    def join(self):
        """Produce level k+1 candidates.  Device path moves at most one
        scalar (the post-prune survivor count, k >= 3) so the counting
        round is sized to the survivors, not the raw join width; the
        (guarded) host fallback decodes once and re-uploads, metered."""
        if self.join_pairs <= 0 or self.f_true == 0:
            return None
        if self._device_join_ok():
            m_cap = self._bucket(self.join_pairs)
            C, valid_c, bitmap = _join_prune(
                self.F, self.valid, m_cap=m_cap, n_items=self.n_items)
            if self.k >= 2:
                # the prune can drop most join pairs; counting over the
                # pre-prune J-sized block would redo their work every
                # tile.  One scalar readback (in the serial candgen phase —
                # the map round keeps its single sync) shrinks the round
                # to the post-prune bucket: survivors are compacted at the
                # front, so slicing is exact.
                n_surv = int(self.meter.d2h(
                    valid_c.sum(dtype=torch.int32)))
                if n_surv == 0:        # everything pruned: dry round, as
                    self.join_pairs = 0  # when the host join returns []
                    return None
                m_post = self._bucket(n_surv)
                if m_post < m_cap:
                    C, valid_c, bitmap = (C[:m_post], valid_c[:m_post],
                                          bitmap[:m_post])
                    m_cap = m_post
            return C, valid_c, bitmap, m_cap
        # fallback: frequent set too wide (quadratic join mask) or keys
        # would overflow — run the reference host join on decoded tuples
        rows = self.meter.d2h(self.F[:self.f_true])
        cands = generate_candidates(
            [tuple(int(v) for v in r) for r in rows])
        if not cands:
            self.join_pairs = 0
            return None
        m_cap = self._bucket(len(cands))
        Ch = np.zeros((m_cap, self.k + 1), np.int32)
        Ch[:len(cands)] = np.asarray(cands, np.int32)
        bitmap = self.meter.h2d(pad_candidates(
            itemsets_to_bitmap(cands, self.n_items), m_cap))
        return (self.meter.h2d(Ch), self._first(len(cands), m_cap),
                bitmap, m_cap)

    # ------------------------------------------------------------------
    def finalize(self, acc: torch.Tensor, C: torch.Tensor,
                 valid_c: torch.Tensor, min_sup: int):
        """Device-side round close — see :func:`_finalize`."""
        return _finalize(acc, C, valid_c, min_sup)

    def advance(self, packed: np.ndarray, Fn: torch.Tensor,
                vn: torch.Tensor, min_sup: int) -> Tuple[int, int]:
        """Consume a round's packed readback; returns (n_candidates,
        n_frequent) for the round report."""
        counts, J = packed[:-1], int(packed[-1])
        m_true = int((counts >= 0).sum())
        freq_counts = counts[counts >= min_sup].astype(np.int64)
        f_true = int(freq_counts.size)
        self.k += 1
        self.f_true = f_true
        if f_true:
            f_cap = self._bucket(f_true)       # shrink to the small bucket
            self.F, self.valid = Fn[:f_cap], vn[:f_cap]
            self.join_pairs = J
            self.levels.append(_Level(self.F, f_true, freq_counts))
        else:
            self.join_pairs = 0
        return m_true, f_true

    # ------------------------------------------------------------------
    @property
    def n_frequent_total(self) -> int:
        """Frequent itemsets mined at levels >= 2 (sizes the rules phase
        without decoding anything)."""
        return sum(lv.f_true for lv in self.levels)

    def decode_supports(self) -> Dict[Tuple[int, ...], int]:
        """The one place itemset tuples reach the host: one d2h per mined
        level, at rule-generation time."""
        out: Dict[Tuple[int, ...], int] = {}
        for lv in self.levels:
            rows = self.meter.d2h(lv.F[:lv.f_true])
            for r, c in zip(rows, lv.counts):
                out[tuple(int(v) for v in r)] = int(c)
        return out
