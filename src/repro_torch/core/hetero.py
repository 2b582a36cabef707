"""Heterogeneity profiles — the paper's "cores with different processing
powers" generalized to per-device effective-throughput vectors.

The paper's running example (§V) is a four-core system with processing powers
80, 120, 200 and 400 (MB/s of transaction data).  At pod scale the same
abstraction captures stragglers, multi-tenant hosts and mixed-generation
slices; throughputs are *measured* (EWMA over observed shard times) rather
than assumed.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

# The paper's §V example system.
PAPER_CORES = (80.0, 120.0, 200.0, 400.0)


@dataclass
class HeterogeneityProfile:
    """Per-device effective throughput (work units / second)."""

    speeds: np.ndarray                       # [n_devices] > 0
    names: Optional[List[str]] = None
    ewma_alpha: float = 0.3

    def __post_init__(self):
        self.speeds = np.asarray(self.speeds, dtype=np.float64)
        if (self.speeds <= 0).any():
            raise ValueError("speeds must be positive")
        if self.names is None:
            self.names = [f"core{i}" for i in range(len(self.speeds))]

    # ------------------------------------------------------------------
    @classmethod
    def paper(cls) -> "HeterogeneityProfile":
        return cls(np.array(PAPER_CORES), names=["c80", "c120", "c200", "c400"])

    @classmethod
    def homogeneous(cls, n: int, speed: float = 1.0) -> "HeterogeneityProfile":
        return cls(np.full(n, speed))

    @classmethod
    def straggler(cls, n: int, n_slow: int = 1, slowdown: float = 4.0) -> "HeterogeneityProfile":
        s = np.ones(n)
        s[:n_slow] = 1.0 / slowdown
        return cls(s)

    @classmethod
    def mixed_generation(cls, n_old: int, n_new: int, ratio: float = 2.35) -> "HeterogeneityProfile":
        """e.g. v5e (197 Tf) next to v4 (~275/3.3≈84% ... ) — ratio is new/old."""
        return cls(np.concatenate([np.ones(n_old), np.full(n_new, ratio)]))

    # ------------------------------------------------------------------
    @property
    def n(self) -> int:
        return len(self.speeds)

    @property
    def total_speed(self) -> float:
        return float(self.speeds.sum())

    def shares(self) -> np.ndarray:
        return self.speeds / self.speeds.sum()

    def fastest(self) -> int:
        return int(np.argmax(self.speeds))

    # ------------------------------------------------------------------
    def observe(self, device: int, work_done: float, seconds: float) -> None:
        """EWMA throughput update from a measured shard execution (the
        'dynamic' mode of the paper's core switching)."""
        if seconds <= 0:
            return
        rate = work_done / seconds
        a = self.ewma_alpha
        self.speeds[device] = (1 - a) * self.speeds[device] + a * rate

    def copy(self) -> "HeterogeneityProfile":
        return HeterogeneityProfile(self.speeds.copy(), list(self.names), self.ewma_alpha)
