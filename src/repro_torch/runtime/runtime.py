"""The shared execution substrate the planes run on.

One :class:`Runtime` owns one ``MBScheduler`` + ``PowerModel`` + phase
ledger and performs assignment, policy feedback and time/energy/switch
accounting **exactly once**, for every phase of every plane.  The
``MarketBasketPipeline`` runs simulated map rounds and serial driver
phases through it; the serving and sharded planes are to follow.

The plane supplies *execution* (an ``execute(assignment, costs)`` callback
returning a :class:`MeasuredPhase`); the runtime supplies *scheduling*
(via the :class:`~repro_torch.runtime.policies.SwitchingPolicy`) and
*accounting* (one :class:`~repro_torch.runtime.ledger.PhaseRecord` per phase).
Anything the executor does not measure is modeled from the plan: busy
seconds default to ``load / believed_speed`` and the makespan to their
maximum, so simulated, sharded and serving phases share one time axis.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Union

import numpy as np

from repro_torch.core.hetero import HeterogeneityProfile
from repro_torch.core.power import PowerModel
from repro_torch.core.scheduler import Assignment, MBScheduler, TaskSpec
from repro_torch.runtime.ledger import ExecLedger, PhaseRecord
from repro_torch.runtime.policies import SwitchingPolicy, resolve_policy
from repro_torch.runtime.transfers import TransferMeter


@dataclass
class MeasuredPhase:
    """What an executor observed.  ``None`` fields are modeled by the
    runtime from the assignment and the believed speed profile."""

    result: Any = None
    busy_s: Optional[np.ndarray] = None    # [n] seconds per device
    makespan: Optional[float] = None
    switches: int = 0                      # execution-time owner changes
    reissued: int = 0
    failed_devices: List[int] = field(default_factory=list)
    tiles_done: Optional[List[int]] = None
    work_done: Optional[np.ndarray] = None  # [n] executed work units (feeds
    #                                         DynamicPolicy's EWMA loop)
    wall_s: float = 0.0                    # measured host wall
    # transfers the executor measured *outside* the runtime's meter (e.g.
    # a shard_map barrier counted as one sync); added on top of the meter
    # delta when the phase is recorded
    h2d_bytes: int = 0
    d2h_bytes: int = 0
    syncs: int = 0


def resolve_power(power: Union[str, PowerModel, None],
                  profile: HeterogeneityProfile) -> Optional[PowerModel]:
    """Name, instance or None -> PowerModel instance (or None = unpriced)."""
    if power is None or isinstance(power, PowerModel):
        return power
    if power == "cpu":
        return PowerModel.cpu(profile)
    if power == "tpu_v5e":
        return PowerModel.tpu_v5e(profile.n)
    if power == "none":
        return None
    raise ValueError(f"unknown power model {power!r}")


class Runtime:
    """Scheduler + power + ledger + switching policy, shared per plane."""

    def __init__(self, profile: HeterogeneityProfile,
                 policy: Union[str, SwitchingPolicy, None] = "static",
                 split: str = "lpt",
                 power: Union[str, PowerModel, None] = "cpu",
                 scheduler: Optional[MBScheduler] = None,
                 ledger: Optional[ExecLedger] = None,
                 meter: Optional[TransferMeter] = None):
        self.profile = profile
        self.scheduler = scheduler or MBScheduler(profile, policy=split)
        self.policy = resolve_policy(policy)
        self.power = resolve_power(power, profile)
        self.ledger = ledger if ledger is not None else ExecLedger()
        # per-runtime transfer meter: every phase record absorbs whatever
        # crossed the host/device boundary since the previous phase ended,
        # so inter-phase staging (tile uploads) lands on its consumer
        self.meter = meter if meter is not None else TransferMeter()
        self._transfer_mark = self.meter.stats()

    def _take_transfers(self):
        delta = self.meter.since(self._transfer_mark)
        self._transfer_mark = self.meter.stats()
        return delta

    @property
    def split(self) -> str:
        """Tile-split strategy (lpt | proportional | equal)."""
        return self.scheduler.policy

    # ------------------------------------------------------------------
    # serial phases: one core runs, the rest gate off (paper function 3)
    # ------------------------------------------------------------------
    def run_serial(self, name: str, cost: float,
                   fn: Optional[Callable[[], Any]] = None,
                   device: Optional[int] = None,
                   min_speed: float = 0.0,
                   kind: str = "serial"):
        """Model (and optionally execute) a single-threaded phase.

        ``fn`` runs on the host and its wall time is recorded; ``device``
        pins the core (the sharded plane routes driver phases to rank 0).
        ``kind`` stamps the ledger record — serial-shaped work that is not
        a plain driver phase (the async serving plane's SLO sheds) stays
        distinguishable without a second accounting path.  Returns
        ``(fn result or None, PhaseRecord)``.
        """
        task = TaskSpec(name, cost, parallel=False, min_speed=min_speed)
        asg = self.scheduler.assign_serial(task, device=device)
        dev = asg.serial_device
        sim_t = float(asg.est_finish[dev])
        result, host_t = None, 0.0
        if fn is not None:
            t0 = time.perf_counter()
            result = fn()
            host_t = time.perf_counter() - t0
        energy = 0.0
        busy = np.zeros(self.profile.n)
        busy[dev] = sim_t
        if self.power is not None:
            energy = self.power.energy(busy, sim_t, gated=asg.gated)
        xfer = self._take_transfers()
        rec = self.ledger.add(PhaseRecord(
            name=name, kind=kind, policy=self.policy.name,
            cost_source=getattr(self.policy, "cost_source", "bytes"),
            cost=cost,
            sim_time_s=sim_t, host_time_s=host_t, energy_j=energy,
            busy_s=[float(b) for b in busy], gated=list(asg.gated),
            device=dev, constraint_violated=asg.constraint_violated,
            h2d_bytes=xfer.h2d_bytes, d2h_bytes=xfer.d2h_bytes,
            syncs=xfer.syncs))
        return result, rec

    # ------------------------------------------------------------------
    # parallel phases: policy plan -> execute -> feedback -> accounting
    # ------------------------------------------------------------------
    def run_phase(self, task: TaskSpec,
                  execute: Callable[[Assignment, np.ndarray], MeasuredPhase],
                  tile_costs: Optional[np.ndarray] = None,
                  tile_flops: Optional[np.ndarray] = None,
                  assignment: Optional[Assignment] = None,
                  extra_switches: int = 0,
                  extra_reissued: int = 0,
                  spinup_from: Optional[int] = None):
        """Run one parallel phase end to end; returns ``(result, record)``.

        ``assignment`` pins the plan (the sharded plane's shard layout *is*
        the assignment — the policy still gets measurement feedback, but
        planning is the plane's shard planner).  ``extra_switches`` /
        ``extra_reissued`` charge planner moves made outside the policy
        (shard re-plans).  ``spinup_from`` charges one switch per core
        activated away from the given device (the serving plane's
        admission-core semantics).
        """
        n_tiles = task.n_tiles or 1
        if tile_costs is None:
            costs = np.full(n_tiles, task.tile_cost(), dtype=np.float64)
        else:
            costs = np.asarray(tile_costs, dtype=np.float64)
        if assignment is None:
            costs = self.policy.tile_costs(self, task, costs, tile_flops)
            asg, plan_sw, plan_re = self.policy.plan(self, task, costs)
        else:
            asg, plan_sw, plan_re = assignment, 0, 0

        measured = execute(asg, costs)

        # model whatever the executor did not measure
        load = np.array([costs[ts].sum() if ts else 0.0
                         for ts in asg.tiles_of])
        if measured.busy_s is None:
            busy = load / self.profile.speeds
        else:
            busy = np.asarray(measured.busy_s, dtype=np.float64)
        makespan = (float(busy.max()) if len(busy) else 0.0) \
            if measured.makespan is None else float(measured.makespan)

        self.policy.feedback(self, task, asg, costs, measured)

        switches = plan_sw + measured.switches + extra_switches
        if spinup_from is not None:
            switches += sum(1 for d, ts in enumerate(asg.tiles_of)
                            if ts and d != spinup_from)
        reissued = plan_re + measured.reissued + extra_reissued

        # energy: gate by what actually ran, not the planned assignment —
        # after a failure re-plan a planned-empty core may have executed
        # orphans (billed active) and a dead core ran nothing (gated)
        gated = [d for d in range(self.profile.n) if busy[d] == 0.0]
        energy = 0.0
        if self.power is not None:
            energy = self.power.energy(busy, makespan, gated=gated,
                                       switches=switches + reissued)
            # a core that died mid-phase worked (active) then powered off:
            # convert its post-death idle tail to gated watts
            for d in measured.failed_devices:
                if busy[d] > 0.0:
                    tail = max(makespan - busy[d], 0.0)
                    energy += (self.power.p_gated[d]
                               - self.power.p_idle[d]) * tail

        xfer = self._take_transfers()
        rec = self.ledger.add(PhaseRecord(
            name=task.name, kind="map", policy=self.policy.name,
            cost_source=getattr(self.policy, "cost_source", "bytes"),
            cost=task.cost, sim_time_s=makespan,
            host_time_s=measured.wall_s, energy_j=energy,
            switches=switches, reissued=reissued,
            busy_s=[float(b) for b in busy], gated=gated,
            n_tiles=n_tiles,
            tiles_done=(list(measured.tiles_done)
                        if measured.tiles_done is not None
                        else [len(ts) for ts in asg.tiles_of]),
            failed_devices=list(measured.failed_devices),
            h2d_bytes=xfer.h2d_bytes + measured.h2d_bytes,
            d2h_bytes=xfer.d2h_bytes + measured.d2h_bytes,
            syncs=xfer.syncs + measured.syncs))
        return measured.result, rec

    # ------------------------------------------------------------------
    def charge_moves(self, rec: PhaseRecord, switches: int = 0,
                     reissued: int = 0) -> PhaseRecord:
        """Attach planner moves to an already-recorded phase and price them
        through the power model — for moves consumed by a round that ran no
        map phase to carry them (a shard re-plan whose candidate generation
        came up dry)."""
        rec.switches += switches
        rec.reissued += reissued
        if self.power is not None and (switches or reissued):
            rec.energy_j += self.power.energy(
                np.zeros(self.profile.n), 0.0,
                gated=list(range(self.profile.n)),
                switches=switches + reissued)
        return rec

    # ------------------------------------------------------------------
    def pinned_assignment(self, costs: np.ndarray) -> Assignment:
        """One tile per device with the given cost — the sharded plane's
        shard layout expressed as an Assignment (rank d owns tile d)."""
        costs = np.asarray(costs, dtype=np.float64)
        tiles_of = [[d] if costs[d] > 0 else [] for d in range(len(costs))]
        finish = costs / self.profile.speeds
        gated = [d for d in range(len(costs)) if not tiles_of[d]]
        return Assignment(tiles_of, finish, gated=gated)
