"""Distributed mining plane — Apriori and Eclat over a heterogeneous mesh.

The single-device pipeline *simulates* the paper's cluster; this module
*executes* it: the packed transaction bitmap is partitioned across a
data-parallel mesh axis, support counting runs on each rank's shard as the
map phase, and partial support vectors reduce through ``all_reduce`` in
:func:`repro_torch.core.mapreduce.run_sharded`.

The plane runs SPMD, one process a rank: start a process group on every
rank (``torch.distributed.init_process_group``), build the mesh with
:func:`make_shard_mesh`, then call :meth:`ShardedMiner.run` on every rank
with the same baskets.  Candidate generation, fault consumption, re-plans,
the algorithm choice and rule generation run on every rank's host from the
same inputs, and no decision reads a measured wall (busy times are
modelled from the plan), so every rank takes the same branches, joins
every collective and returns the same result.

Heterogeneity shows up as shard *composition*, not shard shape: every rank
owns one ``[width, n_items]`` slab, but the number of *real* transaction
rows inside it is planned ∝ core speed by
:func:`repro_torch.data.sharding.plan_shard_rows` — padding rows are
all-zero and therefore inert for support counting.  A failure
(``device_loss``) or straggler observation re-plans that integer vector
mid-mine (the paper's dynamic core switching): the dead rank's slab becomes
pure padding (gated watts in the power model) and its row blocks re-issue
to survivors, with the move counts surfaced in the :class:`PipelineReport`.
A dead rank still joins every ``all_reduce`` with its all-padding slab.

Scheduling and accounting run on the shared
:class:`repro_torch.runtime.Runtime`: the shard layout is handed to ``run_phase`` as a *pinned* assignment (rank
d owns tile d with its planned row bytes), shard-re-plan moves are charged
as this phase's switches/re-issues, and time/energy come off the same
ledger the simulated and serving planes use.  Serial phases (candidate
generation, rule extraction) are modelled on rank 0 via
``Runtime.run_serial(device=0)``.  Counting runs on
``PipelineConfig.device``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.hetero import HeterogeneityProfile
from repro_torch.core.itemsets import (AprioriResult, generate_candidates,
                                       itemsets_to_bitmap)
from repro_torch.core.mapreduce import MapReduceJob, run_sharded
from repro_torch.core.power import PowerModel
from repro_torch.core.rules import generate_rules
from repro_torch.core.scheduler import MBScheduler, TaskSpec
from repro_torch.data.sharding import plan_shard_rows
from repro_torch.data.sparse import (SparseSlab, density_stats,
                                     pack_tid_columns)
from repro_torch.distributed.fault import FaultPlan
from repro_torch.kernels.autotune.cache import plane_tuning
from repro_torch.kernels.support_count.fused import popcount32
from repro_torch.kernels.support_count.ops import (check_tuning,
                                                   support_count)
from repro_torch.kernels.support_count.ref import support_count_ref
from repro_torch.pipeline.dataplane import pad_candidates, resolve_backend
from repro_torch.pipeline.pipeline import (Baskets, PipelineConfig,
                                           PipelineResult, ingest_baskets)
from repro_torch.pipeline.report import PipelineReport, RoundReport
from repro_torch.runtime import (MeasuredPhase, Runtime, SwitchingPolicy,
                                 TransferMeter, autotuned_costmodel)

DEFAULT_AXIS = "shards"


# ---------------------------------------------------------------------------
# mesh + profile helpers
# ---------------------------------------------------------------------------

def make_shard_mesh(n_shards: Optional[int] = None, axis: str = DEFAULT_AXIS):
    """1-D ``DeviceMesh`` over ranks ``0..n_shards-1`` of the initialised
    default process group (default: every rank).  Call it on every rank.

    The mesh's device type follows the group's backend: ``cuda`` under
    NCCL, ``cpu`` otherwise (gloo reduces CPU and CUDA tensors alike, so
    gloo ranks may still count on a card).  It never starts a group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_shard_mesh needs a process group: call torch.distributed"
            ".init_process_group(backend, init_method='file:///path/to/"
            "store', rank=r, world_size=n) on every rank first (or start "
            "the ranks with torchrun and call init_process_group(backend))")
    world = dist.get_world_size()
    n = world if n_shards is None else n_shards
    if not 1 <= n <= world:
        raise ValueError(f"n_shards={n} but the process group has {world} "
                         "ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n,), mesh_dim_names=(axis,))


def mesh_profile(n: int,
                 base: Optional[HeterogeneityProfile] = None
                 ) -> HeterogeneityProfile:
    """Cycle a base profile's speeds (default: the paper's 80/120/200/400)
    out to an n-rank mesh — the paper's core mix at pod scale."""
    base = base or HeterogeneityProfile.paper()
    speeds = np.resize(base.speeds, n)
    names = [f"{base.names[i % base.n]}.{i // base.n}" for i in range(n)]
    return HeterogeneityProfile(speeds, names=names,
                                ewma_alpha=base.ewma_alpha)


def partition_miner(mesh=None,
                    config: Optional[PipelineConfig] = None,
                    base_profile: Optional[HeterogeneityProfile] = None,
                    policy: Union[str, "SwitchingPolicy", None] = None,
                    row_block: int = 8,
                    verify_rounds: bool = False) -> "ShardedMiner":
    """Per-partition entry point for the SON out-of-core plane: one
    :class:`ShardedMiner` sized to ``mesh`` (profile cycled from
    ``base_profile``) that the SON plane reuses across every partition
    sharing a local config.  ``config.algorithm`` must already be resolved
    (SON decides ``auto`` once, globally, before the first partition)."""
    mesh = mesh if mesh is not None else make_shard_mesh()
    n = mesh.size(0)
    return ShardedMiner(mesh=mesh, profile=mesh_profile(n, base_profile),
                        config=config, policy=policy, row_block=row_block,
                        verify_rounds=verify_rounds)


# ---------------------------------------------------------------------------
# shard planning
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShardPlan:
    """Equal-shape shard layout: rank d owns rows[d] real rows inside a
    zero-padded ``[width, n_items]`` slab."""

    rows: np.ndarray          # [n_shards] real rows per rank (row_block ·)
    width: int                # padded rows per shard (= max rows)
    row_block: int
    alive: np.ndarray         # [n_shards] bool

    @property
    def n_shards(self) -> int:
        return len(self.rows)

    @property
    def n_blocks(self) -> int:
        return int(self.rows.sum()) // self.row_block

    def block_owners(self) -> np.ndarray:
        """owner rank of each row block, in global block order (blocks are
        assigned contiguously, so a re-plan is comparable block-by-block)."""
        return np.repeat(np.arange(self.n_shards),
                         self.rows // self.row_block)

    def shard_costs(self, n_items: int) -> np.ndarray:
        """Per-rank work units (bytes of *real* transaction data) — the same
        units the simulated pipeline's tile costs use."""
        return self.rows.astype(np.float64) * n_items


def plan_shards(profile: HeterogeneityProfile, n_rows: int,
                row_block: int = 8,
                alive: Optional[np.ndarray] = None) -> ShardPlan:
    """Heterogeneity-aware shard plan over the alive ranks."""
    alive = (np.ones(profile.n, dtype=bool) if alive is None
             else np.asarray(alive, dtype=bool))
    rows = plan_shard_rows(profile, n_rows, row_block=row_block, alive=alive)
    width = int(rows.max())
    return ShardPlan(rows=rows, width=width, row_block=row_block,
                     alive=alive.copy())


def shard_bitmap(T: np.ndarray, plan: ShardPlan) -> np.ndarray:
    """Lay T out rank-major per the plan: rank d's slab holds its contiguous
    row range zero-padded to `width`.  Shape [n_shards * width, n_items]."""
    return np.concatenate([rank_slab(T, plan, d)
                           for d in range(plan.n_shards)])


def rank_slab(T: np.ndarray, plan: ShardPlan, rank: int) -> np.ndarray:
    """Rank ``rank``'s ``[width, n_items]`` slab of :func:`shard_bitmap`'s
    layout, built without the other ranks' slabs."""
    n_tx, n_items = T.shape
    out = np.zeros((plan.width, n_items), dtype=T.dtype)
    start = int(plan.rows[:rank].sum())
    r = min(int(plan.rows[rank]), max(n_tx - start, 0))
    out[:r] = T[start:start + r]
    return out


def count_moves(old: ShardPlan, new: ShardPlan) -> Tuple[int, int]:
    """(switches, reissued) between two plans over the same bitmap:
    `switches` = row blocks that changed owner between two live ranks,
    `reissued` = row blocks re-issued away from a rank that died."""
    a, b = old.block_owners(), new.block_owners()
    if len(a) != len(b):
        raise ValueError("plans cover different bitmaps")
    moved = a != b
    from_dead = moved & ~new.alive[a]
    return int((moved & ~from_dead).sum()), int(from_dead.sum())


# ---------------------------------------------------------------------------
# map bodies: each takes a rank's slab and returns a vector whose shape
# does not depend on the slab (run_sharded sums it over the mesh)
# ---------------------------------------------------------------------------

def _item_counts_map(slab: torch.Tensor) -> torch.Tensor:
    return slab.sum(dim=0, dtype=torch.int32)


def _eclat_item_counts_map(slab: torch.Tensor) -> torch.Tensor:
    """slab: [width, n_items] word-major packed tid matrix (int32 bit
    patterns) — per-item counts are plain column popcount sums; padding
    words are 0."""
    return popcount32(slab.to(torch.int64) & 0xFFFFFFFF).sum(
        dim=0, dtype=torch.int32)


def _eclat_support_map(slab: torch.Tensor, Cidx: torch.Tensor) -> torch.Tensor:
    """Stateless k-way AND over base item columns, per shard.

    ``Cidx [M, k] int32`` holds each candidate's item ids.  Unlike the
    single-device Eclat plane's pairwise (k-1)-slab cascade, the sharded
    round recomputes each candidate's tidset from the *base* columns —
    carrying per-rank intermediate slabs through shard re-plans would
    couple the fault path to mining state; k is small (≤ a handful of
    levels) so the extra ANDs are cheap and every round stays a pure
    function of (data, Cidx).  Both formulations count identical bits.
    The reference computes this in plain array ops outside any kernel, and
    so does the port.
    """
    g = slab.index_select(1, Cidx[:, 0])                # [width, M]
    for j in range(1, Cidx.shape[1]):
        g = g & slab.index_select(1, Cidx[:, j])
    return _eclat_item_counts_map(g)


# ---------------------------------------------------------------------------
# the miner
# ---------------------------------------------------------------------------

class ShardedMiner:
    """MarketBasketPipeline semantics, executed over a real device mesh.

    Produces the same ``PipelineResult`` (bit-identical supports and rules —
    tested against the single-device plane) with a report whose map phases
    were *executed* on the mesh's ranks rather than event-simulated.  Every
    rank of the mesh constructs one and calls :meth:`run` with the same
    arguments.
    """

    def __init__(self, mesh=None,
                 profile: Optional[HeterogeneityProfile] = None,
                 config: Optional[PipelineConfig] = None,
                 scheduler: Optional[MBScheduler] = None,
                 power: Optional[PowerModel] = None,
                 policy: Union[str, SwitchingPolicy, None] = None,
                 row_block: int = 8,
                 verify_rounds: bool = False):
        self.mesh = mesh if mesh is not None else make_shard_mesh()
        self.axis = self.mesh.mesh_dim_names[0]
        n = self.mesh.size(0)
        coord = self.mesh.get_coordinate()
        if coord is None:
            raise ValueError("this process's rank is not in the mesh: only "
                             f"ranks 0..{n - 1} mine on it")
        self.rank = coord[0]
        self.profile = profile or mesh_profile(n)
        if self.profile.n != n:
            raise ValueError(f"profile has {self.profile.n} ranks but mesh "
                             f"axis {self.axis!r} has {n}")
        self.config = config or PipelineConfig()
        cfg = self.config
        policy = policy if policy is not None else cfg.policy
        if policy == "costmodel" and cfg.autotune:
            # measured kernel walls replace the datasheet constants (the
            # kernel the chosen formulation actually dispatches to)
            policy = autotuned_costmodel(
                "intersect_count" if cfg.algorithm == "eclat"
                else "support_count", device=cfg.device)
        self.runtime = Runtime(
            self.profile,
            policy=policy,
            split=cfg.split,
            power=power if power is not None else cfg.power,
            scheduler=scheduler,
            meter=TransferMeter(cfg.device))
        self.scheduler = self.runtime.scheduler
        self.power = self.runtime.power
        self.device = self.runtime.meter.device
        self.backend = resolve_backend(cfg.data_plane, self.device)
        self.tuning = plane_tuning(cfg.tuning, cfg.autotune)
        check_tuning(self.tuning)        # reject a bad pin before any round
        self.row_block = row_block
        self.verify_rounds = verify_rounds
        # one job object per round shape, as the reference keeps them for
        # its program cache: the phase names stay the reference's
        self._item_jobs: dict = {}
        self._support_jobs: dict = {}
        self._eclat_jobs: dict = {}
        # the auto-selector's decision for the last run() (None when the
        # algorithm was explicit)
        self.algorithm_choice = None

    # ------------------------------------------------------------------
    def _item_job(self, n_items: int) -> MapReduceJob:
        job = self._item_jobs.get(n_items)
        if job is None:
            job = MapReduceJob(
                name=f"sharded-round1-item-counts-{n_items}",
                map_fn=_item_counts_map,
                combine_fn=lambda a, b: a + b,
                zero_fn=lambda m=n_items: torch.zeros(m, dtype=torch.int32))
            self._item_jobs[n_items] = job
        return job

    def _support_map(self, slab: torch.Tensor, C: torch.Tensor
                     ) -> torch.Tensor:
        """The support-count body: the CUDA kernels (the variant
        ``tuning`` picks) on the ``cuda`` plane, the plain count on
        ``ref``."""
        if self.backend == "cuda":
            return support_count(slab, C, tuning=self.tuning)
        return support_count_ref(slab, C)

    def _support_job(self, m_padded: int) -> MapReduceJob:
        job = self._support_jobs.get(m_padded)
        if job is None:
            job = MapReduceJob(
                name=f"sharded-support-m{m_padded}",
                map_fn=self._support_map,
                combine_fn=lambda a, b: a + b,
                zero_fn=lambda m=m_padded: torch.zeros(m, dtype=torch.int32))
            self._support_jobs[m_padded] = job
        return job

    def _eclat_job(self, m_padded: int, k: int) -> MapReduceJob:
        """One job per (candidate bucket, level arity)."""
        job = self._eclat_jobs.get((m_padded, k))
        if job is None:
            job = MapReduceJob(
                name=f"eclat-sharded-intersect-m{m_padded}-k{k}",
                map_fn=(_eclat_item_counts_map if k == 1
                        else _eclat_support_map),
                combine_fn=lambda a, b: a + b,
                zero_fn=lambda m=m_padded: torch.zeros(m, dtype=torch.int32))
            self._eclat_jobs[(m_padded, k)] = job
        return job

    # ------------------------------------------------------------------
    def _upload(self, rows: np.ndarray, plan: ShardPlan) -> torch.Tensor:
        """This rank's slab of the plan's rank-major layout, on the device.

        The meter is charged for the whole layout: this rank uploads its
        own slab and is charged for the ``n_shards - 1`` equal slabs the
        other ranks upload, so every rank's ledger reads the bytes the mesh
        moved — what the reference's single controller uploads."""
        slab = rank_slab(rows, plan, self.rank)
        if slab.dtype == np.uint32:
            # tid words travel as int32 bit patterns (same bytes): torch
            # has no uint32 gather or AND
            slab = slab.view(np.int32)
        meter = self.runtime.meter
        out = meter.h2d(slab)
        meter.charge_h2d((plan.n_shards - 1) * out.nbytes)
        return out

    def _sharded_round(self, job: MapReduceJob, data: torch.Tensor,
                       plan: ShardPlan, n_items: int,
                       extra_args: Tuple = (),
                       switches: int = 0, reissued: int = 0):
        """One sharded round through the shared runtime.  The shard plan
        *is* the assignment (rank d owns tile d, cost = its real-row bytes);
        re-plan moves are charged to this phase; busy/energy are modelled on
        the ledger exactly as for the other planes."""
        costs = plan.shard_costs(n_items)
        task = TaskSpec(job.name, float(costs.sum()), parallel=True,
                        n_tiles=self.profile.n)

        def execute(_asg, _costs):
            result, rep = run_sharded(job, data, self.mesh, self.axis,
                                      extra_args=extra_args)
            # the reduced vector comes back host-side here, inside the
            # phase, so the round's single sync lands on this map record
            result = self.runtime.meter.d2h(result, dtype=np.int64)
            return MeasuredPhase(result=result, wall_s=rep.makespan)

        return self.runtime.run_phase(
            task, execute, tile_costs=costs,
            assignment=self.runtime.pinned_assignment(costs),
            extra_switches=switches, extra_reissued=reissued)

    def _serial(self, name: str, cost: float, fn=None):
        # serial phases are modelled on rank 0's core
        return self.runtime.run_serial(name, cost, fn=fn, device=0)

    # ------------------------------------------------------------------
    def _apply_faults(self, k: int, faults: Optional[FaultPlan],
                      alive: np.ndarray, plan: ShardPlan, T: np.ndarray,
                      report: PipelineReport,
                      row_block: Optional[int] = None
                      ) -> Tuple[ShardPlan, Optional[torch.Tensor],
                                 int, int, List[int]]:
        """Consume round-k fault events; returns the (possibly new) plan,
        this rank's re-laid-out slab (or None if unchanged), and this
        round's (switches, reissued, newly_dead).  ``T`` is whatever row
        matrix the plane shards (transaction rows for Apriori, packed tid
        words for Eclat — ``row_block`` overrides the transaction-row
        blocking for the latter, where one row already covers 32
        transactions)."""
        row_block = self.row_block if row_block is None else row_block
        events = faults.at(k) if faults else []
        newly_dead: List[int] = []
        replan = False
        for e in events:
            if e.kind == "device_loss" and alive[e.device]:
                alive[e.device] = False
                newly_dead.append(e.device)
                replan = True
            elif e.kind == "straggler":
                # observed rate = current speed / slowdown, EWMA'd into the
                # profile -> the re-plan gives the straggler proportionally
                # fewer row blocks (severity 1.0 = no slowdown, no change)
                self.profile.observe(
                    e.device,
                    work_done=float(self.profile.speeds[e.device]),
                    seconds=float(e.severity))
                replan = True
        if not replan:
            return plan, None, 0, 0, newly_dead
        new_plan = plan_shards(self.profile, T.shape[0],
                               row_block=row_block, alive=alive)
        switches, reissued = count_moves(plan, new_plan)
        self.scheduler.switches += switches + reissued
        report.replans += 1
        report.shard_rows = [int(r) for r in new_plan.rows]
        return (new_plan, self._upload(T, new_plan),
                switches, reissued, newly_dead)

    def _check_round(self, k: int, T: np.ndarray,
                     C_padded: Optional[np.ndarray],
                     counts: np.ndarray) -> None:
        """Cross-shard invariant: the all-reduced global support vector must
        equal the single-device oracle on the unsharded bitmap."""
        if C_padded is None:                       # k=1 column sums
            want = T.sum(axis=0, dtype=np.int64)[:len(counts)]
        else:
            want = support_count_ref(
                torch.from_numpy(T).to(self.device),
                torch.from_numpy(C_padded).to(self.device)
            ).cpu().numpy().astype(np.int64)[:len(counts)]
        if not np.array_equal(counts, want):
            bad = int(np.flatnonzero(counts != want)[0])
            raise RuntimeError(
                f"cross-shard invariant violated at round k={k}: "
                f"candidate {bad} counted {counts[bad]} sharded vs "
                f"{want[bad]} single-device")

    # ------------------------------------------------------------------
    @staticmethod
    def _round_view(rec, plan: ShardPlan, k: int, n_candidates: int,
                    n_frequent: int, dead: List[int],
                    serial=None, m_padded: int = 0) -> RoundReport:
        """Per-round view with shard-plan tile semantics: "tiles" are row
        blocks (Σ blocks == n_tiles invariant), not the per-rank slabs the
        pinned assignment schedules."""
        return RoundReport(
            k=k, n_candidates=n_candidates, n_frequent=n_frequent,
            n_tiles=plan.n_blocks,
            tiles_per_device=[int(b) for b in plan.rows // plan.row_block],
            map_makespan_s=rec.sim_time_s, map_busy_s=list(rec.busy_s),
            switches=rec.switches, reissued=rec.reissued,
            energy_j=rec.energy_j, serial=serial, m_padded=m_padded,
            failed_devices=dead)

    def _dry_round(self, k: int, serial, sw: int, re: int,
                   dead: List[int]) -> RoundReport:
        """A round whose candidate generation came up dry: a re-plan it
        consumed has no map phase to carry its moves, so they are charged
        (counts AND joules) to the serial record — the ledger still
        accounts every migration exactly once."""
        self.runtime.charge_moves(serial, sw, re)
        view = RoundReport.from_phases(
            k=k, n_candidates=0, n_frequent=0, map_phase=None,
            serial=serial, n_devices=self.profile.n)
        view.switches, view.reissued = sw, re
        view.failed_devices = dead
        return view

    def _rules(self, supports: dict, n_tx: int, levels: int, report):
        rules, report.rules_phase = self._serial(
            "mba-rules",
            cost=max(1.0, len(supports) * self.config.serial_unit_cost),
            fn=lambda: generate_rules(
                AprioriResult(supports=supports, n_tx=n_tx, levels=levels),
                self.config.min_confidence, min_lift=self.config.min_lift))
        return rules

    def run(self, baskets: Baskets,
            faults: Optional[FaultPlan] = None) -> PipelineResult:
        """Dispatch on ``config.algorithm`` (apriori | eclat | auto) —
        every formulation produces bit-identical supports and rules."""
        algorithm = self.config.algorithm
        self.algorithm_choice = None
        if algorithm == "auto":
            from repro_torch.mining.select import select_algorithm
            stats = density_stats(baskets)
            self.algorithm_choice = select_algorithm(
                baskets, self.config.abs_support(stats.n_tx), stats=stats,
                device=self.config.device)
            algorithm = self.algorithm_choice.algorithm
        if algorithm == "eclat":
            return self._run_eclat(baskets, faults)
        if algorithm != "apriori":
            raise ValueError(f"unknown mining algorithm {algorithm!r}")
        return self._run_apriori(baskets, faults)

    def _run_apriori(self, baskets: Baskets,
                     faults: Optional[FaultPlan] = None) -> PipelineResult:
        cfg = self.config
        rt = self.runtime
        t_start = time.perf_counter()
        # a run that raised mid-way (invariant check, scoring error) leaves
        # orphaned records; this plane owns its runtime, so anything still
        # live belongs to no report — drop it before marking
        rt.ledger.take_since(0)
        mark = rt.ledger.mark()

        T, n_items_raw, n_tx_raw = ingest_baskets(baskets)
        n_tx, n_items = T.shape                    # lane-padded (internal)
        min_sup = cfg.abs_support(n_tx_raw)
        n = self.profile.n

        alive = np.ones(n, dtype=bool)
        plan = plan_shards(self.profile, n_tx, row_block=self.row_block,
                           alive=alive)
        data = self._upload(T, plan)

        report = PipelineReport(
            backend=self.backend, policy=rt.policy.name, split=rt.split,
            profile_speeds=[float(s) for s in self.profile.speeds],
            n_tx=n_tx_raw, n_items=n_items_raw,
            n_tiles=plan.n_blocks, min_support=min_sup,
            execution="sharded", n_shards=n,
            shard_rows=[int(r) for r in plan.rows])
        supports = {}

        # ---- round k=1: item frequency (<item, count>) ----------------
        plan, new_data, sw, re, dead = self._apply_faults(
            1, faults, alive, plan, T, report)
        if new_data is not None:
            data = new_data
        counts, rec = self._sharded_round(
            self._item_job(n_items), data, plan, n_items,
            switches=sw, reissued=re)
        if self.verify_rounds:
            self._check_round(1, T, None, counts)
        frequent = [(int(i),) for i in np.nonzero(
            counts[:n_items_raw] >= min_sup)[0]]
        for (i,) in frequent:
            supports[(i,)] = int(counts[i])
        report.rounds.append(self._round_view(
            rec, plan, k=1, n_candidates=n_items_raw,
            n_frequent=len(frequent), dead=dead))

        # ---- rounds k>=2: serial candidate-gen + sharded counting -----
        k = 2
        while frequent and (cfg.max_k == 0 or k <= cfg.max_k):
            plan, new_data, sw, re, dead = self._apply_faults(
                k, faults, alive, plan, T, report)
            if new_data is not None:
                data = new_data
            cands, serial = self._serial(
                f"mba-candgen-k{k}",
                cost=max(1.0, len(frequent) * k * cfg.serial_unit_cost),
                fn=lambda fr=frequent: generate_candidates(fr))
            if not cands:
                report.rounds.append(self._dry_round(k, serial, sw, re, dead))
                break

            C = pad_candidates(itemsets_to_bitmap(cands, n_items),
                               cfg.m_bucket)
            # every rank uploads the candidates; each rank's meter counts
            # its own upload, once, as the reference's controller does
            Cj = rt.meter.h2d(C)
            sup_all, rec = self._sharded_round(
                self._support_job(C.shape[0]), data, plan, n_items,
                extra_args=(Cj,), switches=sw, reissued=re)
            # padded candidate rows are all-zero masks and would match every
            # transaction — slice to the true count, never trust padding
            sup = sup_all[:len(cands)]
            if self.verify_rounds:
                self._check_round(k, T, C, sup)
            frequent = []
            for c, s in zip(cands, sup):
                if s >= min_sup:
                    supports[c] = int(s)
                    frequent.append(c)
            report.rounds.append(self._round_view(
                rec, plan, k=k, n_candidates=len(cands),
                n_frequent=len(frequent), dead=dead, serial=serial,
                m_padded=int(C.shape[0])))
            k += 1

        # ---- step 3: association rules (serial, on rank 0's core) ------
        rules = self._rules(supports, n_tx_raw, k - 1, report)
        report.n_itemsets = len(supports)
        report.n_rules = len(rules)
        report.wall_time_s = time.perf_counter() - t_start
        report.ledger = rt.ledger.take_since(mark)
        return PipelineResult(supports=supports, rules=rules, report=report,
                              n_tx=n_tx_raw)

    # ------------------------------------------------------------------
    # vertical (Eclat) execution: the packed tid matrix sharded over the
    # WORD axis — each rank owns a contiguous band of 32-transaction word
    # rows, every round is a stateless k-way AND over base item columns
    # ------------------------------------------------------------------
    def _run_eclat(self, baskets: Baskets,
                   faults: Optional[FaultPlan] = None) -> PipelineResult:
        cfg = self.config
        rt = self.runtime
        t_start = time.perf_counter()
        rt.ledger.take_since(0)
        mark = rt.ledger.mark()
        n = self.profile.n

        # ---- columnize on every rank's host, then shard word-major -----
        def columnize():
            if isinstance(baskets, SparseSlab):
                return (baskets.tid_columns(), baskets.n_items,
                        baskets.n_tx)
            T, ni, ntx = ingest_baskets(baskets)
            return pack_tid_columns(T), ni, ntx

        stats = density_stats(baskets)
        (cols, n_items_raw, n_tx_raw), _ = self._serial(
            "eclat-columnize", cost=max(1.0, 4.0 * stats.nnz), fn=columnize)
        min_sup = cfg.abs_support(n_tx_raw)
        n_items_pad = cols.shape[0]
        # word-major [W_pad, n_items_pad]: the shardable leading axis is
        # words (32 tx each); one "row block" is one word row
        Tw = np.ascontiguousarray(cols.T)
        # the verifying path re-counts every round against the dense
        # oracle; only then is the dense bitmap ever materialized here
        T_dense = (ingest_baskets(baskets)[0] if self.verify_rounds
                   else None)

        alive = np.ones(n, dtype=bool)
        plan = plan_shards(self.profile, Tw.shape[0], row_block=1,
                           alive=alive)
        data = self._upload(Tw, plan)
        word_bytes = 4 * n_items_pad              # cost units: real-row bytes

        report = PipelineReport(
            backend=self.backend, policy=rt.policy.name,
            algorithm="eclat", split=rt.split,
            profile_speeds=[float(s) for s in self.profile.speeds],
            n_tx=n_tx_raw, n_items=n_items_raw,
            n_tiles=plan.n_blocks, min_support=min_sup,
            execution="sharded", n_shards=n,
            shard_rows=[int(r) for r in plan.rows])
        supports = {}

        # ---- round k=1: per-item column popcounts ----------------------
        plan, new_data, sw, re, dead = self._apply_faults(
            1, faults, alive, plan, Tw, report, row_block=1)
        if new_data is not None:
            data = new_data
        counts, rec = self._sharded_round(
            self._eclat_job(n_items_pad, 1), data, plan, word_bytes,
            switches=sw, reissued=re)
        if self.verify_rounds:
            self._check_round(1, T_dense, None, counts[:n_items_raw])
        frequent = [(int(i),) for i in np.nonzero(
            counts[:n_items_raw] >= min_sup)[0]]
        for (i,) in frequent:
            supports[(i,)] = int(counts[i])
        report.rounds.append(self._round_view(
            rec, plan, k=1, n_candidates=n_items_raw,
            n_frequent=len(frequent), dead=dead))

        # ---- rounds k>=2: serial join + sharded k-way AND-popcount -----
        k = 2
        while frequent and (cfg.max_k == 0 or k <= cfg.max_k):
            plan, new_data, sw, re, dead = self._apply_faults(
                k, faults, alive, plan, Tw, report, row_block=1)
            if new_data is not None:
                data = new_data
            cands, serial = self._serial(
                f"eclat-candgen-k{k}",
                cost=max(1.0, len(frequent) * k * cfg.serial_unit_cost),
                fn=lambda fr=frequent: generate_candidates(fr))
            if not cands:
                report.rounds.append(self._dry_round(k, serial, sw, re, dead))
                break

            # candidate item-id matrix, zero-padded to the bucket shape
            # (padding rows AND item 0's column with itself — junk counts
            # that are sliced away, never trusted)
            Cidx = np.zeros((-(-len(cands) // cfg.m_bucket) * cfg.m_bucket,
                             k), dtype=np.int32)
            Cidx[:len(cands)] = np.asarray(cands, dtype=np.int32)
            sup_all, rec = self._sharded_round(
                self._eclat_job(Cidx.shape[0], k), data, plan, word_bytes,
                extra_args=(rt.meter.h2d(Cidx),), switches=sw, reissued=re)
            sup = sup_all[:len(cands)]
            if self.verify_rounds:
                self._check_round(
                    k, T_dense,
                    itemsets_to_bitmap(cands, T_dense.shape[1]), sup)
            frequent = []
            for c, s in zip(cands, sup):
                if s >= min_sup:
                    supports[c] = int(s)
                    frequent.append(c)
            report.rounds.append(self._round_view(
                rec, plan, k=k, n_candidates=len(cands),
                n_frequent=len(frequent), dead=dead, serial=serial,
                m_padded=int(Cidx.shape[0])))
            k += 1

        # ---- association rules (serial, on rank 0's core) --------------
        rules = self._rules(supports, n_tx_raw, k - 1, report)
        report.n_itemsets = len(supports)
        report.n_rules = len(rules)
        report.wall_time_s = time.perf_counter() - t_start
        report.ledger = rt.ledger.take_since(mark)
        return PipelineResult(supports=supports, rules=rules, report=report,
                              n_tx=n_tx_raw)
