"""Unified phase accounting — the single source of truth for time/energy.

Every phase any plane executes (a serial driver phase, a simulated map
round, a shard_map round, a serving batch) flows through
:meth:`repro_torch.runtime.Runtime.run_phase` / :meth:`run_serial`, which emit
exactly one :class:`PhaseRecord` into an :class:`ExecLedger`.  The plane
reports (``PipelineReport``, ``ServingReport``) hold a ledger slice and
derive their totals from it, so the three planes cannot drift on what a
second or a joule means (PR 3 had to patch a silently-None ``energy_j``
on the sharded path — this module is the structural fix).

Semantics, identical for every plane:

* ``sim_time_s`` — modeled seconds on the work-unit clock: a serial
  phase's ``cost / speed[device]``; a map phase's makespan.
* ``energy_j`` — active watts for busy seconds, idle watts for the tail a
  core waits on the makespan, gated watts for cores that ran nothing, and
  ``switch_joules`` per *migration* — every core switch AND every
  speculative re-issue moves work, so both are priced.
* ``switches`` / ``reissued`` — planner moves (policy rebalancing, shard
  re-plans) plus execution moves (failure re-planning) for this phase
  only; the scheduler keeps its own lifetime counter.
* ``constraint_violated`` — ``assign_serial`` could not satisfy the
  task's ``min_speed`` and fell back to the fastest core (surfaced, never
  silent).
* ``kind`` — ``"serial"`` (one core runs, the rest gate off), ``"map"``
  (tiled across the profile), or ``"shed"`` (the async serving plane's
  SLO governor rejected a request: the triage work is still scheduled on
  one core and priced, so load shedding shows up in the energy/time
  totals like every other phase instead of vanishing).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class PhaseRecord:
    """One scheduled phase: placement, modeled time, measured wall, energy."""

    name: str
    kind: str                     # "serial" | "map" | "shed"
    policy: str = "static"        # switching policy that planned the phase
    cost_source: str = "bytes"    # where planning costs came from:
    #                               bytes | roofline | autotune
    cost: float = 0.0             # work units the scheduler planned for
    sim_time_s: float = 0.0       # serial run time / map makespan (modeled)
    host_time_s: float = 0.0      # measured host wall (0 = not measured)
    energy_j: float = 0.0
    switches: int = 0
    reissued: int = 0
    busy_s: List[float] = field(default_factory=list)
    gated: List[int] = field(default_factory=list)
    device: Optional[int] = None  # serial phases: the core that ran
    n_tiles: int = 0
    tiles_done: List[int] = field(default_factory=list)
    failed_devices: List[int] = field(default_factory=list)
    constraint_violated: bool = False
    # host/device data movement attributed to this phase (metered by the
    # Runtime's TransferMeter; staging between phases lands on the phase
    # that consumes it).  ``syncs`` counts device->host synchronization
    # points — the pipelined round contract is exactly 1 per map round.
    h2d_bytes: int = 0
    d2h_bytes: int = 0
    syncs: int = 0


@dataclass
class ExecLedger:
    """Append-only sequence of phase records with derived totals."""

    phases: List[PhaseRecord] = field(default_factory=list)

    def add(self, rec: PhaseRecord) -> PhaseRecord:
        self.phases.append(rec)
        return rec

    # ------------------------------------------------------------------
    # slicing: one Runtime serves many runs; each run reports its own slice
    # ------------------------------------------------------------------
    def mark(self) -> int:
        return len(self.phases)

    def since(self, mark: int) -> "ExecLedger":
        return ExecLedger(self.phases[mark:])

    def take_since(self, mark: int) -> "ExecLedger":
        """Slice everything since `mark` into a new ledger (a run's report)
        and drop it from the live one — long-lived planes (the serving
        engine, a reused pipeline) would otherwise accumulate records
        without bound across runs."""
        taken = ExecLedger(self.phases[mark:])
        del self.phases[mark:]
        return taken

    def by_kind(self, kind: str) -> List[PhaseRecord]:
        return [p for p in self.phases if p.kind == kind]

    # ------------------------------------------------------------------
    @property
    def n_phases(self) -> int:
        return len(self.phases)

    @property
    def total_time_s(self) -> float:
        return sum(p.sim_time_s for p in self.phases)

    @property
    def total_energy_j(self) -> float:
        return sum(p.energy_j for p in self.phases)

    @property
    def total_switches(self) -> int:
        return sum(p.switches for p in self.phases)

    @property
    def total_reissued(self) -> int:
        return sum(p.reissued for p in self.phases)

    @property
    def total_h2d_bytes(self) -> int:
        return sum(p.h2d_bytes for p in self.phases)

    @property
    def total_d2h_bytes(self) -> int:
        return sum(p.d2h_bytes for p in self.phases)

    @property
    def total_syncs(self) -> int:
        return sum(p.syncs for p in self.phases)

    def constraint_violations(self) -> List[PhaseRecord]:
        return [p for p in self.phases if p.constraint_violated]

    def summary(self) -> str:
        return (f"ExecLedger: {self.n_phases} phases | "
                f"{self.total_time_s:.4f}s, {self.total_energy_j:.1f}J, "
                f"{self.total_switches} switches, "
                f"{self.total_reissued} re-issues, "
                f"{len(self.constraint_violations())} constraint violations | "
                f"{self.total_h2d_bytes}B h2d, {self.total_d2h_bytes}B d2h, "
                f"{self.total_syncs} syncs")
