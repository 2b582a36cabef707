"""Heterogeneity-aware shard-size planning — the MB Scheduler applied to
data-parallel ranks (the paper's "multi-threaded task → split ∝ core
power").

Given a device profile and a global batch, the planner assigns each
data-parallel rank a microbatch *count* proportional to its measured
throughput (counts, not sizes: every microbatch keeps the same shape, so
every rank launches the same kernels at the same shapes — re-planning is a
new integer vector, not a new layout).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core.hetero import HeterogeneityProfile
from repro_torch.core.scheduler import MBScheduler, TaskSpec


@dataclass
class BatchPlan:
    microbatch: int                 # tokens dimension kept static
    counts: np.ndarray              # [n_ranks] microbatches per rank per step
    global_batch: int

    @property
    def step_batches(self) -> int:
        return int(self.counts.sum())


def plan_batches(profile: HeterogeneityProfile, global_batch: int,
                 microbatch: int) -> BatchPlan:
    """Split `global_batch` into microbatches of size `microbatch` and
    assign counts ∝ speed (largest remainder, exact sum)."""
    if global_batch % microbatch != 0:
        raise ValueError(f"global_batch {global_batch} % microbatch {microbatch} != 0")
    n_micro = global_batch // microbatch
    sched = MBScheduler(profile, policy="proportional")
    asg = sched.assign_parallel(
        TaskSpec("batch-plan", float(n_micro), parallel=True, n_tiles=n_micro))
    counts = np.array([len(ts) for ts in asg.tiles_of])
    assert counts.sum() == n_micro
    return BatchPlan(microbatch=microbatch, counts=counts,
                     global_batch=global_batch)


def replan(profile: HeterogeneityProfile, plan: BatchPlan) -> BatchPlan:
    """Dynamic re-plan after EWMA throughput updates (core switching)."""
    return plan_batches(profile, plan.global_batch, plan.microbatch)


def plan_shard_rows(profile: HeterogeneityProfile, n_rows: int,
                    row_block: int = 8,
                    alive: Optional[np.ndarray] = None) -> np.ndarray:
    """Per-rank *real* row counts for a sharded bitmap: blocks of `row_block`
    rows split ∝ speed over the alive ranks (dead ranks get 0), Σ equal to
    `n_rows` rounded up to a block multiple.

    This is the mining plane's version of `plan_batches`: every shard keeps
    one padded shape, so heterogeneity (and failure re-plans) change only
    this integer vector, never the shape the kernels see.
    """
    if n_rows <= 0:
        raise ValueError(f"n_rows must be positive, got {n_rows}")
    alive = (np.ones(profile.n, dtype=bool) if alive is None
             else np.asarray(alive, dtype=bool))
    if alive.shape != (profile.n,):
        raise ValueError(f"alive mask shape {alive.shape} != ({profile.n},)")
    if not alive.any():
        raise RuntimeError("all ranks dead — nothing can hold the bitmap")
    n_blocks = -(-n_rows // row_block)             # ceil
    sub = HeterogeneityProfile(profile.speeds[alive])
    plan = plan_batches(sub, n_blocks * row_block, row_block)
    rows = np.zeros(profile.n, dtype=np.int64)
    rows[np.nonzero(alive)[0]] = plan.counts * row_block
    return rows
