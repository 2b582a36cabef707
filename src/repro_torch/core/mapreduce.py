"""MapReduce engine — Hadoop semantics, executed or simulated.

Two runtimes share one :class:`MapReduceJob` definition:

* :class:`SimulatedCluster` — deterministic event simulation over a
  :class:`HeterogeneityProfile` (the paper's 4-core system, a
  straggler-laden pod, ...).  It computes the *real* result (every tile
  mapped exactly once, combined associatively) and a timing/energy report
  under the MB Scheduler, including failures (tiles of a dead device
  re-planned — "dynamic core switching") and speculative re-issue.
* :func:`run_sharded` — SPMD execution over a ``torch.distributed`` device
  mesh, one process a rank: each rank maps its own shard on its device and
  the partial results reduce with ``all_reduce(SUM)`` over the mesh axis.

``tile_cost`` prices a tile by its ``nbytes``: the pipeline's tiles are
``uint8`` tensors, so their planned costs (and with them every ledger
time and joule) equal the numpy bitmap's.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.hetero import HeterogeneityProfile
from repro_torch.core.power import PowerModel
from repro_torch.core.scheduler import Assignment, MBScheduler, TaskSpec


@dataclass(frozen=True)
class MapReduceJob:
    """map: tile -> value; combine: value × value -> value (associative)."""

    name: str
    map_fn: Callable[[Any], Any]
    combine_fn: Callable[[Any, Any], Any]
    zero_fn: Callable[[], Any]
    cost_fn: Optional[Callable[[Any], float]] = None   # work units per tile

    def tile_cost(self, tile) -> float:
        if self.cost_fn is not None:
            return float(self.cost_fn(tile))
        if hasattr(tile, "nbytes"):
            return float(tile.nbytes)
        return 1.0


@dataclass
class ExecReport:
    makespan: float
    busy_s: np.ndarray
    waves: int = 1
    switches: int = 0
    reissued: int = 0
    failed_devices: List[int] = field(default_factory=list)
    energy_j: Optional[float] = None
    assignment: Optional[Assignment] = None
    tiles_done: Optional[List[int]] = None   # tiles *executed* per device
    # (differs from assignment.tiles_of after failures: orphaned tiles are
    # counted at the survivor that re-ran them)


@dataclass
class FailureEvent:
    device: int
    at_time: float


class SimulatedCluster:
    """Event-driven simulation of a heterogeneous cluster executing a job."""

    def __init__(self, profile: HeterogeneityProfile,
                 scheduler: Optional[MBScheduler] = None,
                 power: Optional[PowerModel] = None):
        self.profile = profile
        self.scheduler = scheduler or MBScheduler(profile)
        self.power = power

    # ------------------------------------------------------------------
    def run(self, job: MapReduceJob, tiles: Sequence[Any],
            failures: Optional[List[FailureEvent]] = None,
            speculate: bool = True,
            assignment: Optional[Assignment] = None) -> Tuple[Any, ExecReport]:
        """`assignment` pins a pre-planned placement (the shared Runtime
        plans through its SwitchingPolicy and passes the result here);
        otherwise this cluster's scheduler plans statically."""
        tile_costs = np.array([job.tile_cost(t) for t in tiles], dtype=np.float64)
        if assignment is not None:
            asg = assignment
        else:
            task = TaskSpec(job.name, float(tile_costs.sum()), parallel=True,
                            n_tiles=len(tiles))
            asg = self.scheduler.assign_parallel(task, tile_costs)
        report = self._simulate(asg, tile_costs, failures or [], speculate)
        report.assignment = asg
        if self.power is not None:
            # same joule definition as Runtime.run_phase: cores that ran
            # nothing are gated, and every migration (switch OR re-issue)
            # is priced
            gated = [d for d in range(self.profile.n)
                     if report.busy_s[d] == 0.0]
            report.energy_j = self.power.energy(
                report.busy_s, report.makespan, gated=gated,
                switches=report.switches + report.reissued)
        # --- actual computation: every tile exactly once, combiner tree ---
        result = job.zero_fn()
        for t in tiles:
            result = job.combine_fn(result, job.map_fn(t))
        return result, report

    # ------------------------------------------------------------------
    def _simulate(self, asg: Assignment, tile_costs: np.ndarray,
                  failures: List[FailureEvent], speculate: bool) -> ExecReport:
        D = self.profile.n
        speeds = self.profile.speeds
        fail_at = {f.device: f.at_time for f in failures}
        queues: List[List[int]] = [list(ts) for ts in asg.tiles_of]
        busy = np.zeros(D)
        clock = np.zeros(D)                      # per-device current time
        done: set = set()
        alive = [d for d in range(D)]
        switches, reissued = 0, 0
        pending = {t for q in queues for t in q}
        done_by = [0] * D

        def run_queue(d: int):
            nonlocal switches
            q = queues[d]
            while q:
                t = q[0]
                dt = tile_costs[t] / speeds[d]
                if d in fail_at and clock[d] + dt > fail_at[d]:
                    return False                  # dies mid-tile
                q.pop(0)
                clock[d] += dt
                busy[d] += dt
                done.add(t)
                done_by[d] += 1
                pending.discard(t)
            return True

        # first pass
        dead: List[int] = []
        for d in list(alive):
            ok = run_queue(d)
            if not ok:
                dead.append(d)
                alive.remove(d)
                clock[d] = fail_at[d]
        # dynamic re-planning of orphaned tiles (paper: dynamic switching)
        orphans = sorted(pending)
        while orphans:
            if not alive:
                raise RuntimeError("all devices failed")
            # LPT over survivors, starting at their current clocks
            for t in sorted(orphans, key=lambda t: -tile_costs[t]):
                d = min(alive, key=lambda d: clock[d] + tile_costs[t] / speeds[d])
                dt = tile_costs[t] / speeds[d]
                clock[d] += dt
                busy[d] += dt
                done.add(t)
                done_by[d] += 1
                switches += 1
            pending.difference_update(orphans)
            orphans = []
        makespan = float(clock.max())
        # speculative re-issue: if one device dominates the tail, clone its
        # last tile onto the fastest idle device and take the min finish.
        if speculate and alive:
            slowest = int(np.argmax(clock))
            others = [d for d in alive if d != slowest]
            if others and asg.tiles_of[slowest]:
                helper = max(others, key=lambda d: speeds[d])
                t = asg.tiles_of[slowest][-1]
                alt = clock[helper] + tile_costs[t] / speeds[helper]
                orig = clock[slowest]
                if alt < orig - 1e-12:
                    reissued += 1
                    makespan = float(max(np.delete(clock, slowest).max() if D > 1 else 0.0,
                                         min(orig, alt),
                                         clock[slowest] - tile_costs[t] / speeds[slowest]))
        # switches is per-run (this job's re-planned tiles only); the
        # scheduler keeps its own lifetime counter for rebalance/speculate
        return ExecReport(makespan=makespan, busy_s=busy,
                          switches=switches,
                          reissued=reissued, failed_devices=dead,
                          tiles_done=done_by)


# ---------------------------------------------------------------------------
# Real distributed execution: one process a rank, all_reduce combiner
# ---------------------------------------------------------------------------

def run_sharded(job: MapReduceJob, data: torch.Tensor, mesh,
                axis: str = "data", *,
                extra_args: Tuple[Any, ...] = (),
                profile: Optional[HeterogeneityProfile] = None,
                shard_costs: Optional[np.ndarray] = None,
                ) -> Tuple[torch.Tensor, ExecReport]:
    """Map this rank's shard and sum the result over the mesh axis.
    Returns ``(result, ExecReport)`` like ``SimulatedCluster.run`` so
    simulated and sharded executions are report-comparable.

    SPMD: every rank of ``mesh`` (a ``torch.distributed`` ``DeviceMesh``)
    calls this with its *own* shard ``data`` (the reference takes the
    global array and splits it); ``job.map_fn(data, *extra_args)`` runs on
    the shard's device and must return one tensor whose shape does not
    depend on the shard, which ``all_reduce(SUM)`` over
    ``mesh.get_group(axis)`` turns into the whole result on every rank.
    ``extra_args`` are the same on every rank (e.g. a candidate bitmap).
    Every rank must call this for every job in the same order: a rank that
    skips a collective hangs the others.

    Timing: with a `profile` (and per-rank `shard_costs` in the same work
    units the scheduler uses — defaults to one shard's ``data.nbytes`` per
    rank, the shards being equal), busy seconds are ``cost / speed`` per
    rank; without a profile the report carries this rank's measured wall
    only, taken after the device has finished.  Energy and switch pricing
    live in ``repro_torch.runtime.Runtime.run_phase`` — the one place every
    plane's accounting happens — not here.
    """
    import torch.distributed as dist

    n_shards = mesh.size(mesh.mesh_dim_names.index(axis))
    t0 = time.perf_counter()
    result = job.map_fn(data, *extra_args).contiguous()
    dist.all_reduce(result, op=dist.ReduceOp.SUM, group=mesh.get_group(axis))
    if result.is_cuda:
        torch.cuda.synchronize(result.device)
    wall_s = time.perf_counter() - t0

    if profile is not None:
        if profile.n != n_shards:
            raise ValueError(f"profile has {profile.n} ranks but mesh axis "
                             f"{axis!r} has {n_shards}")
        if shard_costs is None:
            shard_costs = np.full(n_shards, float(data.nbytes))
        shard_costs = np.asarray(shard_costs, dtype=np.float64)
        busy = shard_costs / profile.speeds
        makespan = float(busy.max()) if len(busy) else 0.0
        rep = ExecReport(makespan=makespan, busy_s=busy,
                         tiles_done=[int(c > 0) for c in shard_costs])
    else:
        rep = ExecReport(makespan=wall_s, busy_s=np.zeros(n_shards),
                         tiles_done=[1] * n_shards)
    return result, rep
