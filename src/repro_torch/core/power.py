"""Power / core-switching model (paper §VI).

The paper's claims: (a) switching off unused cores reduces power; (b) the
cost of core switching must not exceed the heterogeneity benefit; (c)
switching is static (known order) or dynamic (MB Scheduler decides online).

We model per-core active/idle/gated wattage plus a per-switch energy charge,
and expose the comparisons the paper argues for.  Two built-in calibrations:
``cpu`` (a heterogeneous 4-core CPU, watts ∝ speed) and ``tpu_v5e`` (public
~200 W active per chip estimate).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core.hetero import HeterogeneityProfile
from repro_torch.core.scheduler import Assignment


@dataclass
class PowerModel:
    p_active: np.ndarray       # [n] W while executing
    p_idle: np.ndarray         # [n] W while on but idle
    p_gated: np.ndarray        # [n] W while switched off
    switch_joules: float = 0.5  # energy charged per core switch / migration

    @classmethod
    def cpu(cls, profile: HeterogeneityProfile, w_per_speed: float = 0.05,
            idle_frac: float = 0.35, gated_w: float = 0.2) -> "PowerModel":
        act = profile.speeds * w_per_speed
        return cls(act, act * idle_frac, np.full(profile.n, gated_w))

    @classmethod
    def tpu_v5e(cls, n: int) -> "PowerModel":
        return cls(np.full(n, 200.0), np.full(n, 90.0), np.full(n, 15.0),
                   switch_joules=50.0)

    # ------------------------------------------------------------------
    def energy(self, busy_s: np.ndarray, makespan: float,
               gated: Optional[list] = None, switches: int = 0,
               gate_idle: bool = True) -> float:
        """Total joules for one job execution.

        busy_s[d]: seconds device d actually computed; devices in `gated`
        are off for the whole job; non-gated devices idle (makespan - busy).
        """
        busy_s = np.asarray(busy_s, dtype=np.float64)
        gated = set(gated or [])
        total = 0.0
        for d in range(len(busy_s)):
            if d in gated and gate_idle:
                total += self.p_gated[d] * makespan
            else:
                total += self.p_active[d] * busy_s[d]
                total += self.p_idle[d] * max(makespan - busy_s[d], 0.0)
        return total + switches * self.switch_joules

    # ------------------------------------------------------------------
    def energy_of(self, asg: Assignment, tile_costs: np.ndarray,
                  profile: HeterogeneityProfile, switches: int = 0,
                  gate_idle: bool = True) -> float:
        load = np.array([tile_costs[ts].sum() if ts else 0.0
                         for ts in asg.tiles_of])
        busy = load / profile.speeds
        return self.energy(busy, asg.makespan, asg.gated if gate_idle else [],
                           switches=switches, gate_idle=gate_idle)
