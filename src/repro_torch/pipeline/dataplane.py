"""Data plane for the pipeline: candidate support counting with stable shapes.

The paper's hot spot (Apriori step 2) runs on one of two backends:

* ``cuda`` — the hand-written kernels in
  :mod:`repro_torch.kernels.support_count` (the default on a CUDA device;
  ``tuning`` picks the ``packed`` or ``mxu`` variant: the autotune cache,
  the roofline-seeded default or a pin).
* ``ref`` — the plain PyTorch count (the default on the CPU).

Shape discipline keeps every round's launches alike: the pipeline splits
the transaction bitmap into *uniform* row tiles and pads every level's
candidate matrix up to a multiple of ``m_bucket`` rows, so levels whose
candidate counts land in the same bucket reuse one accumulator slab.

Padded candidate rows are all-zero; an all-zero mask would match every
transaction (``dot == |c| == 0``), so counts are always sliced back to the
true candidate count rather than trusting zeros.
"""
from __future__ import annotations

from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.kernels.support_count.ops import check_tuning
from repro_torch.kernels.support_count.ops import support_count as _kernel_count
from repro_torch.kernels.support_count.ref import support_count_ref as _ref_count
from repro_torch.runtime.transfers import TransferMeter

BACKENDS = ("cuda", "ref")


def resolve_backend(kind: str, device: torch.device) -> str:
    """'auto' → the kernels on a CUDA device, the plain count elsewhere;
    'cuda'/'ref' force (and 'cuda' needs a CUDA device)."""
    if kind == "auto":
        return "cuda" if device.type == "cuda" else "ref"
    if kind not in BACKENDS:
        raise ValueError(f"unknown data plane {kind!r} "
                         f"(expected 'auto', 'cuda' or 'ref')")
    if kind == "cuda" and device.type != "cuda":
        raise ValueError(f"data plane 'cuda' runs the CUDA kernels and "
                         f"needs a CUDA device, got {device}")
    return kind


def pad_candidates(C: np.ndarray, m_bucket: int) -> np.ndarray:
    """Pad the candidate axis up to a multiple of m_bucket with zero rows."""
    m = C.shape[0]
    pad = (-m) % m_bucket
    if pad == 0:
        return C
    return np.pad(C, ((0, pad), (0, 0)))


def uniform_tiles(T: np.ndarray, n_tiles: int,
                  row_multiple: int = 8) -> List[np.ndarray]:
    """Split T into n_tiles row tiles of identical shape (zero-row padded).

    All-zero padding rows are inert: they contain no items, so they can
    only support the empty itemset, which Apriori never emits (k >= 1).
    """
    n_tx = T.shape[0]
    n_tiles = max(1, min(n_tiles, n_tx))
    rows = -(-n_tx // n_tiles)                    # ceil
    rows += (-rows) % row_multiple                # kernel row alignment
    padded = np.pad(T, ((0, rows * n_tiles - n_tx), (0, 0)))
    return [np.ascontiguousarray(padded[i * rows:(i + 1) * rows])
            for i in range(n_tiles)]


class DataPlane:
    """Per-level candidate batch + per-tile support counting.

    Usage: ``prepare(C)`` once per Apriori level, then ``tile_counts(tile)``
    for every transaction tile (this is the MapReduceJob's map_fn).  Every
    transfer goes through ``meter``, on whose device the plane runs.
    """

    def __init__(self, kind: str = "auto", m_bucket: int = 128,
                 tuning: Any = None,
                 meter: Optional[TransferMeter] = None):
        if m_bucket <= 0 or m_bucket % 128:
            raise ValueError(
                "m_bucket must be a positive multiple of 128 (kernel lanes)")
        self.meter = meter if meter is not None else TransferMeter()
        self.backend = resolve_backend(kind, self.meter.device)
        self.m_bucket = m_bucket
        check_tuning(tuning)             # reject a bad pin before any round
        self.tuning = tuning
        self._C: Optional[torch.Tensor] = None
        self._m_true = 0

    @property
    def m_padded(self) -> int:
        return int(self._C.shape[0]) if self._C is not None else 0

    # ------------------------------------------------------------------
    def prepare(self, C: np.ndarray) -> None:
        """Stage a level's candidate bitmap (padded to the bucket shape)."""
        self._m_true = C.shape[0]
        self._C = self.meter.h2d(pad_candidates(C, self.m_bucket))

    def prepare_device(self, C: torch.Tensor) -> None:
        """Stage an already-device-resident candidate bitmap (the
        pipelined path: padding rows are zeroed, so no re-pad and no
        transfer — the generator built it in place)."""
        if C.shape[0] % self.m_bucket:
            raise ValueError(
                f"device candidate bitmap rows {C.shape[0]} not a multiple "
                f"of m_bucket={self.m_bucket}")
        self._m_true = int(C.shape[0])
        self._C = C

    def _counts(self, tile) -> torch.Tensor:
        Tj = self.meter.h2d(tile)
        if self.backend == "cuda":
            return _kernel_count(Tj, self._C, tuning=self.tuning)
        return _ref_count(Tj, self._C)

    def tile_counts(self, tile) -> np.ndarray:
        """Support counts [m_true] int64 for one transaction tile.

        The per-tile readback is a device sync: launches serialize on it,
        which is exactly what ``round_execution="per_tile"`` measures.
        """
        if self._C is None:
            raise RuntimeError("prepare() before tile_counts()")
        return self.meter.d2h(self._counts(tile)[:self._m_true],
                              dtype=np.int64)

    def tile_counts_device(self, tile) -> torch.Tensor:
        """Device-resident counts [m_padded] int32 for one tile — no slice,
        no readback, no sync: the pipelined round combines these on device
        and reads one packed vector back at round close."""
        if self._C is None:
            raise RuntimeError("prepare() before tile_counts_device()")
        return self._counts(tile)
