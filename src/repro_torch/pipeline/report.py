"""Structured accounting for one end-to-end pipeline run.

Every pipeline phase produces a record here; nothing is printed as a side
effect.  Since the unified-runtime refactor, every phase is a
:class:`repro_torch.runtime.PhaseRecord` emitted by ``Runtime.run_phase`` /
``run_serial``, and the report's totals are derived from the attached
:class:`repro_torch.runtime.ExecLedger` slice — the same ledger semantics the
serving and sharded planes use, so the planes cannot drift on what a
second or a joule means.  ``RoundReport`` remains the per-Apriori-level
view (candidate counts, tile histograms, kernel batch shapes) assembled
from those records.

Time/energy semantics: ``serial`` phases run on one core chosen by
``MBScheduler.assign_serial`` with every other core power-gated; ``map``
phases are tiled across the heterogeneity profile, and their energy charges
active watts for busy seconds, idle watts for the tail each core waits on
the makespan, gated watts for cores that ran nothing, plus the per-move
joule cost of dynamic core switching (switches and speculative re-issues
both migrate work, so both are priced).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from repro_torch.runtime.ledger import ExecLedger, PhaseRecord

# A single-threaded phase routed to one core (paper §V function 3) is just
# a serial PhaseRecord; the old name stays exported for callers/tests.
SerialPhase = PhaseRecord


@dataclass
class RoundReport:
    """One Apriori level: serial candidate generation + tiled support count."""

    k: int
    n_candidates: int
    n_frequent: int
    n_tiles: int
    tiles_per_device: List[int]   # Σ == n_tiles (invariant, tested)
    map_makespan_s: float
    map_busy_s: List[float]
    switches: int
    reissued: int
    energy_j: float
    serial: Optional[PhaseRecord] = None    # None for k=1 (no candidate gen)
    m_padded: int = 0             # data-plane candidate batch (0 = host path)
    failed_devices: List[int] = field(default_factory=list)

    @property
    def time_s(self) -> float:
        return self.map_makespan_s + (self.serial.sim_time_s if self.serial else 0.0)

    @classmethod
    def from_phases(cls, k: int, n_candidates: int, n_frequent: int,
                    map_phase: Optional[PhaseRecord],
                    serial: Optional[PhaseRecord] = None,
                    m_padded: int = 0, n_devices: int = 0) -> "RoundReport":
        """Assemble the per-round view from the runtime's phase records."""
        if map_phase is None:                # candidate generation came up dry
            return cls(k=k, n_candidates=n_candidates, n_frequent=n_frequent,
                       n_tiles=0, tiles_per_device=[0] * n_devices,
                       map_makespan_s=0.0, map_busy_s=[0.0] * n_devices,
                       switches=0, reissued=0, energy_j=0.0, serial=serial,
                       m_padded=m_padded)
        return cls(k=k, n_candidates=n_candidates, n_frequent=n_frequent,
                   n_tiles=map_phase.n_tiles,
                   tiles_per_device=list(map_phase.tiles_done),
                   map_makespan_s=map_phase.sim_time_s,
                   map_busy_s=list(map_phase.busy_s),
                   switches=map_phase.switches, reissued=map_phase.reissued,
                   energy_j=map_phase.energy_j, serial=serial,
                   m_padded=m_padded,
                   failed_devices=list(map_phase.failed_devices))


@dataclass
class PipelineReport:
    """The full run: config echo, per-round records, and ledger totals."""

    backend: str                  # "cuda" | "ref"
    policy: str                   # switching policy: static|dynamic
    profile_speeds: List[float]
    n_tx: int
    n_items: int
    n_tiles: int
    min_support: int              # absolute, after fraction resolution
    algorithm: str = "apriori"    # mining backend: "apriori" | "eclat"
    split: str = "lpt"            # tile split: lpt | proportional | equal
    rounds: List[RoundReport] = field(default_factory=list)
    rules_phase: Optional[PhaseRecord] = None
    n_itemsets: int = 0
    n_rules: int = 0
    wall_time_s: float = 0.0      # host wall clock for the whole run
    ledger: Optional[ExecLedger] = None   # this run's phase records
    # distributed mining plane (execution == "sharded"):
    execution: str = "simulated"  # "simulated" | "sharded" | "out_of_core"
    n_shards: int = 0             # mesh axis size (0 = single-device plane)
    shard_rows: List[int] = field(default_factory=list)  # final plan, per rank
    replans: int = 0              # failure-triggered shard re-plans
    # out-of-core SON plane (execution == "out_of_core"):
    n_partitions: int = 0         # disk-resident chunks the corpus split into
    partition_rows: int = 0       # configured rows per chunk
    partitions_resumed: int = 0   # partition passes skipped via checkpoint
    checkpoint_saves: int = 0     # son_state boundary checkpoints written
    checkpoint_bytes: int = 0     # total bytes across those saves

    # ------------------------------------------------------------------
    @property
    def n_rounds(self) -> int:
        return len(self.rounds)

    @property
    def map_time_s(self) -> float:
        """Sum of map-phase makespans only — the policy-sensitive part (the
        serial phases are schedule-invariant), comparable to the paper's
        analytic speedup bound."""
        return sum(r.map_makespan_s for r in self.rounds)

    @property
    def total_time_s(self) -> float:
        if self.ledger is not None:
            return self.ledger.total_time_s
        t = sum(r.time_s for r in self.rounds)
        if self.rules_phase:
            t += self.rules_phase.sim_time_s
        return t

    @property
    def total_energy_j(self) -> float:
        if self.ledger is not None:
            return self.ledger.total_energy_j
        e = sum(r.energy_j + (r.serial.energy_j if r.serial else 0.0)
                for r in self.rounds)
        if self.rules_phase:
            e += self.rules_phase.energy_j
        return e

    @property
    def total_switches(self) -> int:
        if self.ledger is not None:
            return self.ledger.total_switches
        return sum(r.switches for r in self.rounds)

    @property
    def total_reissued(self) -> int:
        if self.ledger is not None:
            return self.ledger.total_reissued
        return sum(r.reissued for r in self.rounds)

    @property
    def constraint_violations(self) -> int:
        """Serial phases whose min_speed no core could satisfy (flagged by
        assign_serial instead of silently falling back)."""
        if self.ledger is None:
            return 0
        return len(self.ledger.constraint_violations())

    @property
    def kernel_batches(self) -> List[int]:
        """Distinct data-plane candidate batch shapes (bucketed ``m_padded``)."""
        return sorted({r.m_padded for r in self.rounds if r.m_padded})

    # ------------------------------------------------------------------
    def summary(self) -> str:
        lines = [
            f"MarketBasketPipeline: algorithm={self.algorithm} "
            f"backend={self.backend} "
            f"policy={self.policy} split={self.split} "
            f"cores={self.profile_speeds}",
        ]
        if self.execution == "sharded":
            lines.append(
                f"  sharded: {self.n_shards} mesh ranks, rows/rank "
                f"{'/'.join(map(str, self.shard_rows))}, "
                f"{self.replans} re-plans")
        if self.execution == "out_of_core":
            lines.append(
                f"  out-of-core: {self.n_partitions} partitions x "
                f"{self.partition_rows} rows, "
                f"{self.partitions_resumed} resumed from checkpoint, "
                f"{self.checkpoint_saves} checkpoints "
                f"({self.checkpoint_bytes} B), {self.replans} re-plans")
        lines += [
            f"  data: {self.n_tx} tx x {self.n_items} items, "
            f"{self.n_tiles} tiles, min_support={self.min_support}",
            f"  {'round':>7s} {'cands':>6s} {'freq':>6s} {'serial_s':>9s} "
            f"{'map_s':>9s} {'energy_J':>9s} {'sw':>3s} {'re':>3s} "
            f"{'tiles/core':>14s} {'Mpad':>5s}",
        ]
        for r in self.rounds:
            ser = r.serial.sim_time_s if r.serial else 0.0
            e = r.energy_j + (r.serial.energy_j if r.serial else 0.0)
            lines.append(
                f"  {('k=' + str(r.k)):>7s} {r.n_candidates:6d} {r.n_frequent:6d} "
                f"{ser:9.4f} {r.map_makespan_s:9.4f} {e:9.1f} "
                f"{r.switches:3d} {r.reissued:3d} "
                f"{'/'.join(map(str, r.tiles_per_device)):>14s} {r.m_padded:5d}")
        if self.rules_phase:
            lines.append(f"  rules: {self.n_rules} rules on core "
                         f"{self.rules_phase.device} "
                         f"({self.rules_phase.sim_time_s:.4f}s, "
                         f"{self.rules_phase.energy_j:.1f}J, others gated)")
        lines.append(
            f"  totals: {self.n_rounds} rounds, {self.n_itemsets} frequent "
            f"itemsets, {self.n_rules} rules | simulated "
            f"{self.total_time_s:.4f}s, {self.total_energy_j:.1f}J, "
            f"{self.total_switches} core switches, "
            f"{self.total_reissued} speculative re-issues | "
            f"wall {self.wall_time_s:.2f}s, kernel batches {self.kernel_batches}")
        if self.constraint_violations:
            lines.append(f"  WARNING: {self.constraint_violations} serial "
                         f"phase(s) ran on a core below their min_speed")
        return "\n".join(lines)

    def tiles_invariant_ok(self) -> bool:
        """Every map round's per-device tile counts must sum to the job size."""
        return all(sum(r.tiles_per_device) == r.n_tiles for r in self.rounds)
