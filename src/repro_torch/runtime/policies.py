"""Switching policies — the paper §VI pivot, as a pluggable interface.

"Switching between the cores can be made static or dynamic": a
:class:`SwitchingPolicy` decides how each parallel phase is planned and
what happens to the plan as measurements arrive.

* :class:`StaticPolicy` — plan once per phase from the believed speed
  profile and never revisit it (the paper's static mode).
* :class:`DynamicPolicy` — the paper's dynamic mode, closed-loop: measured
  per-device walls EWMA-update the believed speeds
  (``HeterogeneityProfile.observe``), plan drift versus the previous
  same-shape phase is charged as core switches (``MBScheduler.rebalance``
  semantics), and a planned-progress checkpoint detects stragglers and
  speculatively re-issues their tail tiles (``speculate`` +
  ``apply_moves``) before execution commits.
* :class:`CostModelPolicy` — seeds tile costs from roofline estimates
  instead of raw byte counts: a tile's planning cost is
  ``max(flops / peak_flops, bytes / hbm_bw)``, renormalized to the byte
  work-unit scale so time/energy stay on one axis.  The rates are the H100
  data sheet's (``launch/roofline``) or, through :meth:`from_autotune`,
  the effective rates of the kernel walls the autotuner measured on the
  card.

Policies are deliberately stateless about *execution*: they see the task,
the costs, the assignment and the measurement, and talk only to the
scheduler/profile the :class:`repro_torch.runtime.Runtime` owns.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np

from repro_torch.core.scheduler import Assignment, MBScheduler, TaskSpec


class SwitchingPolicy:
    """Interface: cost seeding, phase planning, post-phase feedback."""

    name = "abstract"
    # where this policy's planning costs come from — stamped onto every
    # PhaseRecord so a ledger reader can tell constant-seeded plans from
    # roofline- or autotune-fed ones ("bytes" = the raw byte estimates)
    cost_source = "bytes"

    # -- cost seeding ---------------------------------------------------
    def tile_costs(self, runtime, task: TaskSpec, tile_costs: np.ndarray,
                   tile_flops: Optional[np.ndarray] = None) -> np.ndarray:
        """Planning costs per tile (default: the byte-flavored estimates)."""
        return tile_costs

    # -- planning -------------------------------------------------------
    def plan(self, runtime, task: TaskSpec, tile_costs: np.ndarray
             ) -> Tuple[Assignment, int, int]:
        """Returns ``(assignment, switches, reissued)`` — planner moves
        charged to this phase (0/0 for a static plan)."""
        raise NotImplementedError

    # -- measurement feedback -------------------------------------------
    def feedback(self, runtime, task: TaskSpec, assignment: Assignment,
                 tile_costs: np.ndarray, measured) -> None:
        """Called once per phase with the :class:`MeasuredPhase`."""


class StaticPolicy(SwitchingPolicy):
    """Plan once per phase; no feedback loop (paper static mode)."""

    name = "static"

    def plan(self, runtime, task, tile_costs):
        return runtime.scheduler.assign_parallel(task, tile_costs), 0, 0

    def feedback(self, runtime, task, assignment, tile_costs, measured):
        return None


class DynamicPolicy(StaticPolicy):
    """Closed-loop dynamic core switching (paper dynamic mode).

    ``checkpoint_frac`` — the planned-progress instant (fraction of the
    planned makespan) at which stragglers are tested; mid-phase (0.5) by
    default, where fast cores under a skewed plan have already finished
    (progress clipped at 1) while a straggler sits visibly below the
    median.  ``straggler_threshold`` — a device lags when its planned
    progress is below ``threshold × median`` (same contract as
    ``MBScheduler.speculate``).
    """

    name = "dynamic"

    def __init__(self, checkpoint_frac: float = 0.5,
                 straggler_threshold: float = 0.7):
        if not 0.0 < checkpoint_frac <= 1.0:
            raise ValueError(f"checkpoint_frac must be in (0, 1]: "
                             f"{checkpoint_frac}")
        self.checkpoint_frac = checkpoint_frac
        self.straggler_threshold = straggler_threshold
        # last owner map per (task family, tile arity): tile ids are
        # positional and recur within a family (mining rounds over one
        # tiled bitmap, serving batches of one bucket), so drift between
        # same-family phases is the paper's dynamic core switching,
        # charged per move — unrelated phases that merely share a tile
        # count are never compared
        self._last_owner: Dict[Tuple[str, int], Dict[int, int]] = {}

    def plan(self, runtime, task, tile_costs):
        sched: MBScheduler = runtime.scheduler
        asg = sched.assign_parallel(task, tile_costs)
        n_tiles = task.n_tiles or 1
        key = (task.family_key, n_tiles)

        # rebalance accounting: EWMA-updated speeds moved tiles since the
        # previous same-family phase -> each move is a core switch
        switches = 0
        prev = self._last_owner.get(key)
        if prev is not None:
            now = asg.owner_of()
            switches = sum(1 for t, d in now.items() if prev.get(t, d) != d)
            sched.switches += switches

        # speculative re-issue at the planned-progress checkpoint
        reissued = 0
        if n_tiles > 1 and asg.makespan > 0:
            t_cp = self.checkpoint_frac * asg.makespan
            load = np.array([tile_costs[ts].sum() if ts else 0.0
                             for ts in asg.tiles_of])
            speeds = runtime.profile.speeds
            progress = np.where(load > 0,
                                np.minimum(1.0, t_cp * speeds
                                           / np.maximum(load, 1e-30)),
                                1.0)
            moves = sched.speculate(asg, progress,
                                    threshold=self.straggler_threshold)
            if moves:
                asg = sched.apply_moves(asg, moves, tile_costs)
                reissued = len(moves)

        self._last_owner[key] = asg.owner_of()
        return asg, switches, reissued

    def feedback(self, runtime, task, assignment, tile_costs, measured):
        """EWMA speed update from measured per-device walls.

        Only measurements that carry ``work_done`` feed the loop — modeled
        busy seconds are ``load / believed_speed`` by construction and
        carry no information about the true rates.
        """
        if measured.work_done is None or measured.busy_s is None:
            return
        busy = np.asarray(measured.busy_s, dtype=np.float64)
        work = np.asarray(measured.work_done, dtype=np.float64)
        for d in range(min(len(busy), runtime.profile.n)):
            if busy[d] > 0 and work[d] > 0:
                runtime.profile.observe(d, float(work[d]), float(busy[d]))


class CostModelPolicy(StaticPolicy):
    """Static planning over roofline-seeded tile costs.

    Tile planning cost = ``max(flops / peak_flops, bytes / hbm_bw)``
    seconds at peak, rescaled so the total equals the byte total (the
    scheduler's speeds are byte-flavored work units per second).  Per-tile
    flops come from the caller's ``tile_flops`` estimate; without one,
    ``flops_per_byte`` is applied uniformly — which degenerates to the
    byte seeding, exactly as it should when no intensity skew is known.

    Peak/bandwidth default to the H100 data-sheet roofline constants
    (``cost_source = "roofline"``); :meth:`from_autotune` replaces them
    with *measured* effective rates from an autotune cache
    (``cost_source = "autotune"`` — the feedback loop: the scheduler plans
    on what the card actually did, not on constants).
    """

    name = "costmodel"
    cost_source = "roofline"

    def __init__(self, peak_flops: Optional[float] = None,
                 hbm_bw: Optional[float] = None,
                 flops_per_byte: float = 0.0):
        from repro_torch.launch.roofline import HBM_BW, PEAK_FLOPS
        self.peak_flops = PEAK_FLOPS if peak_flops is None else peak_flops
        self.hbm_bw = HBM_BW if hbm_bw is None else hbm_bw
        self.flops_per_byte = flops_per_byte

    @classmethod
    def from_hlo(cls, hlo_text: str, **kwargs) -> "CostModelPolicy":
        """The reference seeds the intensity from a compiled XLA module's
        HLO, which has no CUDA counterpart: not ported."""
        raise NotImplementedError(
            "CostModelPolicy.from_hlo reads XLA HLO, which a CUDA program "
            "does not have (see repro_torch/launch/hlo_cost.py); seed the "
            "policy with from_autotune or explicit rates")

    @classmethod
    def from_autotune(cls, cache, kernel: str, device=None,
                      **kwargs) -> "CostModelPolicy":
        """Seed effective peak/bandwidth from measured autotune entries.

        Each cache entry carries the shape it was tuned at and the
        winner's measured wall; the task-intrinsic (flops, bytes) of that
        shape (``launch.tuning.shape_flops_bytes``) turn the wall into an
        achieved flops/s and bytes/s — the median over entries replaces
        the data-sheet constants, and the median arithmetic intensity
        seeds ``flops_per_byte``.  ``device`` is the one the plane runs on
        (``None``: the card).  Raises ``ValueError`` when the cache has no
        measured entries for this (kernel, device): the caller decides
        whether to fall back to constants, never silently.
        """
        from repro_torch.launch.tuning import shape_flops_bytes
        entries = [e for e in cache.entries_for(kernel, device)
                   if e.get("cost_us", 0) > 0 and e.get("shape")]
        if not entries:
            raise ValueError(
                f"autotune cache has no measured entries for {kernel!r} on "
                f"device {device or 'cuda'} — cannot seed measured costs")
        peaks, bws, intens = [], [], []
        for e in entries:
            flops, bytes_ = shape_flops_bytes(kernel, tuple(e["shape"]))
            wall_s = float(e["cost_us"]) * 1e-6
            peaks.append(flops / wall_s)
            bws.append(bytes_ / wall_s)
            intens.append(flops / bytes_)
        policy = cls(peak_flops=float(np.median(peaks)),
                     hbm_bw=float(np.median(bws)),
                     flops_per_byte=float(np.median(intens)), **kwargs)
        policy.cost_source = "autotune"
        return policy

    def tile_costs(self, runtime, task, tile_costs, tile_flops=None):
        bytes_ = np.asarray(tile_costs, dtype=np.float64)
        total = float(bytes_.sum())
        if total <= 0:
            return bytes_
        if tile_flops is None:
            flops = bytes_ * self.flops_per_byte
        else:
            flops = np.asarray(tile_flops, dtype=np.float64)
        roofline_s = np.maximum(flops / self.peak_flops,
                                bytes_ / self.hbm_bw)
        rs = float(roofline_s.sum())
        if rs <= 0:
            return bytes_
        # renormalize to the byte work-unit scale: same total work,
        # redistributed by roofline intensity
        return roofline_s * (total / rs)


def autotuned_costmodel(kernel: str, cache=None,
                        device="cuda") -> CostModelPolicy:
    """Costmodel policy seeded from the autotune cache when it can be.

    The planes call this when their config asks for the ``costmodel``
    policy by name with autotuning on: measured entries for *kernel* on
    *device* replace the data-sheet constants (``cost_source =
    "autotune"``); a cold/corrupt/other-device cache, or a card that is
    not there, degrades to the roofline-constant policy — autotuning may
    only make planning better-informed, never take a plane down."""
    if cache is None:
        from repro_torch.kernels.autotune.cache import default_cache
        cache = default_cache()
    try:
        return CostModelPolicy.from_autotune(cache, kernel, device)
    except (ValueError, RuntimeError):
        return CostModelPolicy()


_POLICIES = {
    "static": StaticPolicy,
    "dynamic": DynamicPolicy,
    "costmodel": CostModelPolicy,
}

POLICY_NAMES = tuple(sorted(_POLICIES))


def check_policy_name(policy: str) -> None:
    """Raise ``ValueError`` unless ``policy`` names a known policy."""
    if policy not in _POLICIES:
        raise ValueError(f"unknown switching policy {policy!r} "
                         f"(known: {', '.join(POLICY_NAMES)})")


def resolve_policy(policy: Union[str, SwitchingPolicy, None]
                   ) -> SwitchingPolicy:
    """Name or instance -> instance (None = static)."""
    if policy is None:
        return StaticPolicy()
    if isinstance(policy, SwitchingPolicy):
        return policy
    check_policy_name(policy)
    return _POLICIES[policy]()
