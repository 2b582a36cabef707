"""MB Scheduler — the paper's contribution (§V functions 1–5).

Responsibilities (paper wording → implementation):

1. "Collect the tasks submitted to the task tracker"   → :class:`TaskSpec`
   queue with explicit cost estimates (bytes / FLOPs per map shard).
2. "Analyse single- vs multi-threaded"                 → ``TaskSpec.parallel``.
3. Single-threaded → most appropriate core, others off → :meth:`assign_serial`
   (returns the chosen device + the gating set for the power model).
4. Multi-threaded → split across cores, run simultaneously, combine
   → :meth:`assign_parallel`: tile-level **proportional split** (largest
   remainder) or **LPT** (earliest-finish-time greedy) over heterogeneous
   speeds.
5. Reducer collects and combines                        → the MapReduce
   engine consumes the :class:`Assignment`; combiners are associative so
   re-issued (speculative) shards merge idempotently.

Dynamic core switching = :meth:`rebalance` (re-plan from EWMA-updated
speeds, reporting which tiles moved — each move is a "core switch" whose
cost the power model charges).  Straggler mitigation = :meth:`speculate`.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.hetero import HeterogeneityProfile


@dataclass(frozen=True)
class TaskSpec:
    """A schedulable task (one MapReduce phase or a serial driver phase)."""

    name: str
    cost: float                    # work units (e.g. bytes of transaction data)
    parallel: bool = True          # paper: multi- vs single-threaded
    n_tiles: int = 0               # parallel tasks are pre-split into tiles
    min_speed: float = 0.0         # serial tasks: required core capability
    # phases with the same family and tile arity recur over the same tile
    # set (mining rounds over one tiled bitmap, serving batches of one
    # bucket) — dynamic switching tracks plan drift within a family
    family: str = ""               # defaults to `name`

    def tile_cost(self) -> float:
        return self.cost / max(self.n_tiles, 1)

    @property
    def family_key(self) -> str:
        return self.family or self.name


@dataclass
class Assignment:
    """tiles_of[d] = tile ids owned by device d; device -1 = dropped."""

    tiles_of: List[List[int]]
    est_finish: np.ndarray                 # [n_devices] seconds
    gated: List[int] = field(default_factory=list)   # powered-off devices
    serial_device: Optional[int] = None
    # assign_serial could not satisfy the task's min_speed and fell back to
    # the fastest core — surfaced in the phase record, never hidden
    constraint_violated: bool = False

    @property
    def makespan(self) -> float:
        return float(self.est_finish.max()) if len(self.est_finish) else 0.0

    def owner_of(self) -> Dict[int, int]:
        return {t: d for d, ts in enumerate(self.tiles_of) for t in ts}


class MBScheduler:
    """Heterogeneity-aware scheduler over a device profile."""

    def __init__(self, profile: HeterogeneityProfile, policy: str = "lpt"):
        if policy not in ("lpt", "proportional", "equal"):
            raise ValueError(policy)
        self.profile = profile
        self.policy = policy
        self.switches = 0                 # core-switch counter (power model)

    # ------------------------------------------------------------------
    # paper function 3: single-threaded task -> best core, gate the rest
    # ------------------------------------------------------------------
    def assign_serial(self, task: TaskSpec,
                      device: Optional[int] = None) -> Assignment:
        """`device` pins the task (the sharded runtime routes driver-side
        phases to rank 0, where the host process lives); otherwise the most
        capable core meeting `min_speed` wins."""
        speeds = self.profile.speeds
        violated = False
        if device is not None:
            dev = int(device)
            violated = speeds[dev] < task.min_speed
        else:
            ok = np.where(speeds >= task.min_speed)[0]
            if len(ok):
                dev = int(ok[np.argmax(speeds[ok])])
            else:               # no core qualifies: fastest core, flagged
                dev = int(np.argmax(speeds))
                violated = True
        finish = np.zeros(self.profile.n)
        finish[dev] = task.cost / speeds[dev]
        gated = [d for d in range(self.profile.n) if d != dev]
        return Assignment([[0] if d == dev else [] for d in range(self.profile.n)],
                          finish, gated=gated, serial_device=dev,
                          constraint_violated=bool(violated))

    # ------------------------------------------------------------------
    # paper function 4: multi-threaded task -> proportional / LPT split
    # ------------------------------------------------------------------
    def assign_parallel(self, task: TaskSpec,
                        tile_costs: Optional[np.ndarray] = None) -> Assignment:
        n_tiles = task.n_tiles or 1
        if tile_costs is None:
            tile_costs = np.full(n_tiles, task.tile_cost())
        tile_costs = np.asarray(tile_costs, dtype=np.float64)
        assert len(tile_costs) == n_tiles
        if self.policy == "equal":
            return self._equal_split(tile_costs)
        if self.policy == "proportional":
            return self._proportional(tile_costs)
        return self._lpt(tile_costs)

    # -- naive Hadoop-style equal split (the paper's baseline) ----------
    def _equal_split(self, tile_costs: np.ndarray) -> Assignment:
        n, D = len(tile_costs), self.profile.n
        tiles_of: List[List[int]] = [[] for _ in range(D)]
        for t in range(n):
            tiles_of[t % D].append(t)
        return self._finish(tiles_of, tile_costs)

    # -- proportional split (largest-remainder, paper §V function 4) ----
    def _proportional(self, tile_costs: np.ndarray) -> Assignment:
        n, D = len(tile_costs), self.profile.n
        shares = self.profile.shares() * n
        base = np.floor(shares).astype(int)
        rem = n - base.sum()
        order = np.argsort(-(shares - base))
        base[order[:rem]] += 1
        tiles_of: List[List[int]] = [[] for _ in range(D)]
        t = 0
        for d in range(D):
            tiles_of[d] = list(range(t, t + base[d]))
            t += base[d]
        return self._finish(tiles_of, tile_costs)

    # -- LPT / earliest-finish-time greedy (heterogeneous machines) -----
    def _lpt(self, tile_costs: np.ndarray) -> Assignment:
        D = self.profile.n
        speeds = self.profile.speeds
        tiles_of: List[List[int]] = [[] for _ in range(D)]
        load = np.zeros(D)
        for t in np.argsort(-tile_costs):
            d = int(np.argmin((load + tile_costs[t]) / speeds))
            tiles_of[d].append(int(t))
            load[d] += tile_costs[t]
        return self._finish(tiles_of, tile_costs)

    def _finish(self, tiles_of: List[List[int]], tile_costs: np.ndarray) -> Assignment:
        load = np.array([tile_costs[ts].sum() if ts else 0.0 for ts in tiles_of])
        finish = load / self.profile.speeds
        gated = [d for d in range(self.profile.n) if not tiles_of[d]]
        return Assignment(tiles_of, finish, gated=gated)

    # ------------------------------------------------------------------
    # dynamic core switching (paper §VI): re-plan after EWMA updates
    # ------------------------------------------------------------------
    def rebalance(self, task: TaskSpec, old: Assignment,
                  tile_costs: Optional[np.ndarray] = None) -> Tuple[Assignment, int]:
        """Returns (new assignment, #tiles that changed owner)."""
        new = self.assign_parallel(task, tile_costs)
        before, after = old.owner_of(), new.owner_of()
        moved = sum(1 for t, d in after.items() if before.get(t, d) != d)
        self.switches += moved
        return new, moved

    # ------------------------------------------------------------------
    # straggler mitigation: speculative re-issue (Hadoop heritage)
    # ------------------------------------------------------------------
    def speculate(self, assignment: Assignment, progress: np.ndarray,
                  threshold: float = 0.7) -> List[Tuple[int, int]]:
        """progress[d] in [0,1] per device.  Devices whose progress lags the
        median by `threshold` get their remaining tiles re-issued to the
        fastest under-loaded devices.  Returns [(tile, new_device)]."""
        med = float(np.median(progress))
        if med <= 0:
            return []
        lagging = [d for d in range(self.profile.n)
                   if progress[d] < threshold * med and assignment.tiles_of[d]]
        idle = sorted((d for d in range(self.profile.n)
                       if progress[d] >= 0.999 or not assignment.tiles_of[d]),
                      key=lambda d: -self.profile.speeds[d])
        moves: List[Tuple[int, int]] = []
        for straggler, helper in zip(lagging, idle):
            n_rem = max(1, int(len(assignment.tiles_of[straggler])
                               * (1 - progress[straggler])))
            for t in assignment.tiles_of[straggler][-n_rem:]:
                moves.append((t, helper))
        self.switches += len(moves)
        return moves

    # ------------------------------------------------------------------
    # commit speculative moves: without this, the straggler still owns the
    # re-issued tiles and a repeated speculate() re-issues the very same
    # ones — the assignment must be mutated for the loop to close
    # ------------------------------------------------------------------
    def apply_moves(self, assignment: Assignment,
                    moves: Sequence[Tuple[int, int]],
                    tile_costs: np.ndarray) -> Assignment:
        """Re-home each ``(tile, new_device)`` and re-derive finish times.

        Returns a fresh :class:`Assignment` (est_finish / gated recomputed
        from the moved tile sets); the input assignment is not mutated.
        """
        if not moves:
            return assignment
        tiles_of = [list(ts) for ts in assignment.tiles_of]
        owner = {t: d for d, ts in enumerate(tiles_of) for t in ts}
        for t, dst in moves:
            src = owner.get(t)
            if src is None:
                raise ValueError(f"move of unassigned tile {t}")
            if src == dst:
                continue
            tiles_of[src].remove(t)
            tiles_of[dst].append(t)
            owner[t] = dst
        new = self._finish(tiles_of, np.asarray(tile_costs, dtype=np.float64))
        new.serial_device = assignment.serial_device
        new.constraint_violated = assignment.constraint_violated
        return new

    # ------------------------------------------------------------------
    # lower bound for tests: makespan >= max(total/Σspeed, max_tile/fastest)
    # ------------------------------------------------------------------
    def makespan_lower_bound(self, tile_costs: np.ndarray) -> float:
        total = float(np.sum(tile_costs))
        return max(total / self.profile.total_speed,
                   float(np.max(tile_costs)) / float(np.max(self.profile.speeds)))


def simulate_makespan(assignment: Assignment, tile_costs: np.ndarray,
                      profile: HeterogeneityProfile) -> float:
    """Deterministic execution-time simulation of an assignment."""
    load = np.array([tile_costs[ts].sum() if ts else 0.0
                     for ts in assignment.tiles_of])
    return float((load / profile.speeds).max())
