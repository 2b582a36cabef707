"""Fault-tolerance policy layer: failure events, restart decisions, straggler
detection, elastic resize plans.

A :class:`FaultPlan` scripts the failures a run sees (``device_loss``,
``straggler``, ``preemption`` events at a step or mining round): the
sharded mining plane (:mod:`repro_torch.distributed.mining`) consumes them
round by round and re-plans its shards, which exercises the code paths a
real failure takes: detect → (optionally) shrink the device set → re-plan
shards via the MB scheduler → continue.  Every rank of a mesh reads the
same plan, so every rank takes the same branches.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from repro_torch.core.hetero import HeterogeneityProfile


@dataclass
class FaultEvent:
    step: int
    kind: str                  # "device_loss" | "straggler" | "preemption"
    device: int
    severity: float = 1.0      # straggler slowdown factor


@dataclass
class FaultPlan:
    """Scripted fault injection for tests/examples."""
    events: List[FaultEvent] = field(default_factory=list)

    def at(self, step: int) -> List[FaultEvent]:
        return [e for e in self.events if e.step == step]


@dataclass
class RestartPolicy:
    max_restarts: int = 3
    checkpoint_every: int = 50
    straggler_threshold: float = 2.0   # ×median step time → re-plan
    elastic: bool = True               # shrink vs abort on device loss

    restarts_used: int = 0

    def on_device_loss(self, profile: HeterogeneityProfile,
                       device: int) -> Optional[HeterogeneityProfile]:
        """Returns the shrunken profile (elastic) or None (abort+restart)."""
        self.restarts_used += 1
        if self.restarts_used > self.max_restarts:
            raise RuntimeError("restart budget exhausted")
        if not self.elastic:
            return None
        speeds = np.delete(profile.speeds, device)
        names = [n for i, n in enumerate(profile.names) if i != device]
        return HeterogeneityProfile(speeds, names, profile.ewma_alpha)

    def on_straggler(self, profile: HeterogeneityProfile, device: int,
                     slowdown: float) -> HeterogeneityProfile:
        """EWMA the slowdown into the profile → the next re-plan gives the
        straggler proportionally less work (paper: dynamic core switching)."""
        p = profile.copy()
        p.observe(device, work_done=1.0, seconds=slowdown)
        return p


def detect_stragglers(step_times: np.ndarray, threshold: float = 2.0) -> List[int]:
    """Indices of devices whose step time exceeds threshold × median."""
    med = float(np.median(step_times))
    return [int(i) for i in np.nonzero(step_times > threshold * med)[0]]
