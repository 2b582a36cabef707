"""SON out-of-core two-pass mining with crash-safe checkpointed resume.

The paper's Hadoop framing is disk-backed: Map/Reduce over HDFS partitions,
with the Job Tracker reassigning work when a Task Tracker dies.  The in-tree
planes all hold the corpus in (device) memory; this module adds the standard
answer from the Singh et al. MapReduce-frequent-itemset survey (arXiv
1702.06284) — partitioned two-pass SON (Savasere–Omiecinski–Navathe):

  pass 0 (spill):  slice the corpus into disk-resident CSR chunks of
                   ``partition_rows`` transactions (checkpoint/store is the
                   spill format — one step per partition);
  pass 1 (local):  mine each chunk independently through the existing
                   MiningBackend planes (MarketBasketPipeline / EclatMiner,
                   or a per-partition ShardedMiner when a mesh is given) at
                   the scaled threshold ``floor(G * p_rows / n_tx)``; the
                   union of local winners is a superset of the global
                   frequent set (no false negatives — see
                   :func:`repro_torch.mining.select.local_min_support`);
  pass 2 (count):  re-count the whole union against every chunk, streamed
                   chunk by chunk through the ``support_count`` data plane
                   on ``PipelineConfig.device``, then filter at the true
                   global threshold.

Because pass 2 counts exactly and the union can only over-approximate, the
surviving ``supports`` dict equals the single-shot pipeline's bit for bit,
and ``generate_rules`` sorts on a total order — so rules match too.

Every partition boundary writes a ``son_state`` checkpoint (completed-
partition bitmaps, the candidate union as per-level id matrices, partial
global counts) through :mod:`repro_torch.checkpoint.store` with
``keep_last`` retention; a killed job restarts from the last completed
partition and finishes bit-identical to an uninterrupted run.  The
candidate order is *recomputed* canonically (sorted by level, then
lexicographically) rather than stored, so a resumed pass 2 indexes its
counts identically by construction.  The workdir layout, the checkpoints
and the corpus fingerprint are the reference package's, so a mine spilled
or killed under one package resumes under the other.  ``FaultPlan``
events routed to a partition trigger the sharded plane's shard re-plan
inside that partition's local pass.

With a ``mesh`` the miner runs SPMD like the sharded plane it drives:
every rank of the mesh calls :meth:`SONMiner.run` with the same arguments.
Only the mesh's rank 0 writes the workdir (the spill, ``corpus.json`` and
the checkpoints); the other ranks wait at a barrier on the mesh's group
before they read it, every rank reads rank 0's checkpoint on resume, a
kill (``abort_after``) raises :class:`SONKilled` on every rank at the same
boundary, and pass 2 re-counts on every rank's own device, as the
single-device plane does; every rank returns rank 0's result.

All phases — spill writes, chunk loads, local-pass sub-phases (absorbed
with a ``son-p<i>/`` prefix), re-count map rounds, checkpoint writes, rule
extraction — are priced through the shared :class:`repro_torch.runtime.Runtime`
ledger like every other plane.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import store
from repro_torch.core.hetero import HeterogeneityProfile
from repro_torch.core.itemsets import AprioriResult, itemsets_to_bitmap
from repro_torch.core.mapreduce import MapReduceJob, SimulatedCluster
from repro_torch.core.power import PowerModel
from repro_torch.core.rules import generate_rules
from repro_torch.core.scheduler import MBScheduler, TaskSpec
from repro_torch.data.baskets import pad_items
from repro_torch.data.sparse import DensityStats, SparseSlab, density_stats
from repro_torch.kernels.autotune.cache import plane_tuning
from repro_torch.mining.select import (AlgorithmChoice, local_min_support,
                                       select_partition_algorithm)
from repro_torch.pipeline.dataplane import DataPlane, uniform_tiles
from repro_torch.pipeline.pipeline import (Baskets, PipelineConfig,
                                           PipelineResult, support_flops)
from repro_torch.pipeline.report import PipelineReport
from repro_torch.runtime import (MeasuredPhase, Runtime, SlabPool,
                                 SwitchingPolicy, TransferMeter,
                                 autotuned_costmodel, donated_add)

_META_FILE = "corpus.json"


class SONKilled(RuntimeError):
    """Raised by the ``abort_after`` test hook after N completed partition
    boundaries — the state on disk is exactly a mid-job kill's."""

    def __init__(self, boundary: int):
        super().__init__(f"SON mine aborted after partition boundary "
                         f"{boundary} (checkpoint saved)")
        self.boundary = boundary


@dataclass(frozen=True)
class SONConfig:
    """Out-of-core knobs, separate from :class:`PipelineConfig` (which keeps
    describing *what* to mine; this describes how to stage it on disk)."""

    workdir: str                  # spill chunks + son_state checkpoints
    partition_rows: int = 4096    # transactions per disk-resident chunk
    resume: bool = False          # restart from the last completed boundary
    keep_last: int = 2            # boundary-checkpoint retention
    codec: Optional[str] = None   # checkpoint/spill codec (None = best)
    # test hook: raise SONKilled once this many partition boundaries have
    # committed their checkpoint — the kill-at-every-boundary resume tests
    # and the card's kill-and-resume check drive it
    abort_after: Optional[int] = None

    def __post_init__(self):
        if not self.workdir:
            raise ValueError("SONConfig.workdir is required (spill target)")
        if self.partition_rows < 1:
            raise ValueError(
                f"partition_rows must be >= 1, got {self.partition_rows}")


def partition_slices(n_tx: int, partition_rows: int) -> List[Tuple[int, int]]:
    """Row ranges [lo, hi) of each disk chunk (last one may be short)."""
    return [(lo, min(lo + partition_rows, n_tx))
            for lo in range(0, max(n_tx, 1), partition_rows)]


def _slice_slab(baskets: Baskets, lo: int, hi: int, n_items: int) -> SparseSlab:
    """Rows [lo, hi) of any accepted input form, as a CSR chunk."""
    if isinstance(baskets, SparseSlab):
        base = int(baskets.indptr[lo])
        indptr = (baskets.indptr[lo:hi + 1] - base).astype(np.int64)
        indices = baskets.indices[base:int(baskets.indptr[hi])]
        return SparseSlab(indptr=indptr, indices=np.ascontiguousarray(indices),
                          n_items=baskets.n_items)
    if isinstance(baskets, np.ndarray):
        return SparseSlab.from_dense(baskets[lo:hi])
    return SparseSlab.from_baskets(list(baskets)[lo:hi], n_items=n_items)


def corpus_fingerprint(stats: DensityStats, cfg: PipelineConfig,
                       partition_rows: int) -> str:
    """Identity of (corpus, mining problem, partitioning) — a resumed run
    must match it exactly, or its checkpoints describe a different job.
    The same hash as the reference package's, so either resumes the
    other's workdir."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(stats.item_counts).tobytes())
    h.update(repr((stats.n_tx, stats.n_items, stats.nnz, int(partition_rows),
                   cfg.abs_support(stats.n_tx), cfg.min_confidence,
                   cfg.min_lift, cfg.max_k, cfg.algorithm)).encode())
    return h.hexdigest()[:16]


class SONMiner:
    """Two-pass out-of-core mining behind the :class:`MiningBackend`
    protocol — same ``run(baskets, faults)`` shape, same
    :class:`PipelineResult`, bit-identical supports and rules.

    ``faults`` maps partition index → the fault argument of the local plane
    (a :class:`repro_torch.distributed.fault.FaultPlan` when a ``mesh``
    makes the local pass sharded, a list of :class:`FailureEvent` for the
    simulated planes) — device loss mid-partition re-plans *inside* that
    partition, surfaced as ``report.replans``.  Counting runs on
    ``config.device``: the card by default.
    """

    def __init__(self, profile: Optional[HeterogeneityProfile] = None,
                 config: Optional[PipelineConfig] = None,
                 son: Optional[SONConfig] = None,
                 scheduler: Optional[MBScheduler] = None,
                 power: Optional[PowerModel] = None,
                 policy: "SwitchingPolicy | str | None" = None,
                 mesh=None, row_block: int = 8):
        if son is None:
            raise ValueError("SONMiner requires a SONConfig (workdir, "
                             "partition_rows)")
        self.son = son
        self.profile = profile or HeterogeneityProfile.paper()
        self.config = config or PipelineConfig()
        cfg = self.config
        # sub-miners resolve their own policy from this (a shared resolved
        # DynamicPolicy instance would leak EWMA state across planes)
        self._policy_arg = policy if policy is not None else cfg.policy
        policy = self._policy_arg
        if policy == "costmodel" and cfg.autotune:
            policy = autotuned_costmodel("support_count", device=cfg.device)
        self.runtime = Runtime(
            self.profile, policy=policy, split=cfg.split,
            power=power if power is not None else cfg.power,
            scheduler=scheduler, meter=TransferMeter(cfg.device))
        self.scheduler = self.runtime.scheduler
        self.power = self.runtime.power
        self.cluster = SimulatedCluster(self.profile, self.scheduler,
                                        power=None)  # ledger prices energy
        self.data_plane = DataPlane(cfg.data_plane, m_bucket=cfg.m_bucket,
                                    tuning=plane_tuning(cfg.tuning,
                                                        cfg.autotune),
                                    meter=self.runtime.meter)
        self.slabs = SlabPool(self.runtime.meter.device)
        self.mesh = mesh
        self.row_block = row_block
        # the one process that writes the workdir: the mesh's rank 0
        self._writes = mesh is None or dist.get_rank(mesh.get_group(0)) == 0
        self.algorithm_choice: Optional[AlgorithmChoice] = None
        # local-pass backends keyed by (rows, local_abs_support): at most
        # two distinct keys per corpus (full + ragged last partition), so
        # each local plane is built once a mine, not once per partition
        self._locals: Dict[Tuple[int, int], Any] = {}

    # ------------------------------------------------------------------
    # workdir layout
    # ------------------------------------------------------------------
    @property
    def _spill_dir(self) -> str:
        return os.path.join(self.son.workdir, "spill")

    @property
    def _state_dir(self) -> str:
        return os.path.join(self.son.workdir, "state")

    @property
    def _meta_path(self) -> str:
        return os.path.join(self.son.workdir, _META_FILE)

    # ------------------------------------------------------------------
    # local pass plumbing
    # ------------------------------------------------------------------
    def _local_backend(self, rows: int, local_abs: int, algorithm: str):
        key = (rows, local_abs)
        backend = self._locals.get(key)
        if backend is None:
            # abs_support treats min_support <= 1.0 as a fraction, so an
            # absolute threshold of 1 is encoded as fraction 0.0 (which
            # abs_support clamps back up to 1)
            ms = float(local_abs) if local_abs > 1 else 0.0
            lcfg = dataclasses.replace(self.config, algorithm=algorithm,
                                       min_support=ms)
            if self.mesh is not None:
                from repro_torch.distributed.mining import partition_miner
                backend = partition_miner(mesh=self.mesh, config=lcfg,
                                          base_profile=self.profile,
                                          policy=self._policy_arg,
                                          row_block=self.row_block)
            else:
                from repro_torch.mining.backend import make_miner
                backend, _ = make_miner(None, profile=self.profile,
                                        config=lcfg,
                                        policy=self._policy_arg)
            self._locals[key] = backend
        return backend

    def _absorb_ledger(self, p: int, sub_report: PipelineReport) -> None:
        """Fold a local pass's phase records into SON's ledger, prefixed by
        partition — one time/energy axis across the whole mine."""
        if sub_report.ledger is None:
            return
        for rec in sub_report.ledger.phases:
            rec.name = f"son-p{p}/{rec.name}"
            self.runtime.ledger.add(rec)

    # ------------------------------------------------------------------
    # spill + chunk I/O (priced serial phases)
    # ------------------------------------------------------------------
    def _spill_partition(self, p: int, chunk: SparseSlab) -> None:
        nbytes = chunk.indptr.nbytes + chunk.indices.nbytes

        def write():
            store.save(self._spill_dir, p,
                       {"indptr": chunk.indptr, "indices": chunk.indices},
                       extra={"n_items": chunk.n_items, "rows": chunk.n_tx},
                       codec=self.son.codec)

        self.runtime.run_serial(f"son-spill-p{p}", cost=float(max(1, nbytes)),
                                fn=write if self._writes else None)

    def _load_partition(self, p: int, cost_est: float) -> SparseSlab:
        def load():
            flat, extra = store.load_arrays(self._spill_dir, p)
            return SparseSlab(indptr=flat["indptr"].astype(np.int64),
                              indices=flat["indices"].astype(np.int32),
                              n_items=int(extra["n_items"]))

        slab, _ = self.runtime.run_serial(f"son-load-p{p}",
                                          cost=float(max(1.0, cost_est)),
                                          fn=load)
        return slab

    # ------------------------------------------------------------------
    # boundary checkpoints
    # ------------------------------------------------------------------
    def _checkpoint(self, boundary: int, p1: np.ndarray, p2: np.ndarray,
                    union: Dict[int, Set[tuple]],
                    counts: Optional[np.ndarray], extra: Dict,
                    report: PipelineReport) -> None:
        tree: Dict[str, np.ndarray] = {"pass1_done": p1, "pass2_done": p2}
        for k in sorted(union):
            tree[f"cand_k{k}"] = np.array(sorted(union[k]),
                                          dtype=np.int32).reshape(-1, k)
        if counts is not None:
            tree["counts"] = counts
        nbytes = sum(int(a.nbytes) for a in tree.values())

        def write():
            store.save(self._state_dir, boundary, tree,
                       extra=dict(extra, boundary=boundary),
                       codec=self.son.codec, keep_last=self.son.keep_last)

        self.runtime.run_serial(f"son-ckpt-b{boundary}",
                                cost=float(max(1, nbytes)),
                                fn=write if self._writes else None)
        report.checkpoint_saves += 1
        report.checkpoint_bytes += nbytes
        if (self.son.abort_after is not None
                and boundary >= self.son.abort_after):
            raise SONKilled(boundary)

    def _barrier(self) -> None:
        """With a mesh: wait until every rank of it gets here."""
        if self.mesh is not None:
            dist.barrier(group=self.mesh.get_group(0))

    def _restore_state(self, P: int, fingerprint: str):
        """(pass1_done, pass2_done, union, counts, boundary, algorithm) from
        the last committed boundary, or fresh zeros when the state store is
        empty."""
        p1 = np.zeros(P, dtype=np.uint8)
        p2 = np.zeros(P, dtype=np.uint8)
        union: Dict[int, Set[tuple]] = {}
        counts: Optional[np.ndarray] = None
        boundary = 0
        algorithm = None
        step = store.latest_step(self._state_dir)
        if step is not None:
            flat, extra = store.load_arrays(self._state_dir, step)
            if extra.get("fingerprint") != fingerprint:
                raise ValueError(
                    "resume rejected: son_state checkpoint was written for "
                    f"a different job (fingerprint {extra.get('fingerprint')}"
                    f" != {fingerprint}) — corpus, thresholds and "
                    "partitioning must match the original run")
            p1 = flat["pass1_done"].astype(np.uint8)
            p2 = flat["pass2_done"].astype(np.uint8)
            for key, arr in flat.items():
                if key.startswith("cand_k"):
                    k = int(key[len("cand_k"):])
                    union[k] = {tuple(int(x) for x in row) for row in arr}
            if "counts" in flat:
                counts = flat["counts"].astype(np.int64)
            boundary = int(extra["boundary"])
            algorithm = extra.get("algorithm")
        return p1, p2, union, counts, boundary, algorithm

    # ------------------------------------------------------------------
    # pass 2: streamed global re-count of one chunk
    # ------------------------------------------------------------------
    def _recount_chunk(self, p: int, slab: SparseSlab, M: int,
                       m_padded: int) -> np.ndarray:
        rt = self.runtime
        t_chunk = time.perf_counter()
        T_p = pad_items(slab.to_dense())
        tiles = [rt.meter.h2d(t) for t in uniform_tiles(T_p,
                                                        self.config.n_tiles)]
        tile_rows = np.array([t.shape[0] for t in tiles], dtype=np.float64)
        job = MapReduceJob(
            name=f"son-recount-p{p}",
            map_fn=self.data_plane.tile_counts_device,
            combine_fn=donated_add,
            zero_fn=lambda m=m_padded: self.slabs.take((m,), torch.int32))

        def finalize(acc):
            # the chunk's one sync: the int32 accumulator, widened on the host
            host = rt.meter.d2h(acc, dtype=np.int64)[:M]
            self.slabs.give(acc)
            return host

        tile_costs = np.array([job.tile_cost(t) for t in tiles],
                              dtype=np.float64)
        # one family across chunks: every re-count phase has the same tile
        # geometry, so dynamic switching carries speed feedback chunk to
        # chunk exactly like the in-core rounds do
        task = TaskSpec(job.name, float(tile_costs.sum()), parallel=True,
                        n_tiles=len(tiles), family="son-recount")

        def execute(asg, _costs):
            result, rep = self.cluster.run(job, tiles, failures=None,
                                           speculate=self.config.speculate,
                                           assignment=asg)
            counts = finalize(result)
            # the chunk's host wall, densify and uploads to its one sync:
            # pass 2's time in the ledger (host_time_s)
            return MeasuredPhase(result=counts, busy_s=rep.busy_s,
                                 makespan=rep.makespan,
                                 switches=rep.switches,
                                 reissued=rep.reissued,
                                 failed_devices=list(rep.failed_devices),
                                 tiles_done=rep.tiles_done,
                                 wall_s=time.perf_counter() - t_chunk)

        chunk_counts, _ = rt.run_phase(
            task, execute, tile_costs=tile_costs,
            tile_flops=support_flops(tile_rows, T_p.shape[1], m_padded))
        return chunk_counts

    # ------------------------------------------------------------------
    def run(self, baskets: Baskets,
            faults: Optional[Dict[int, Any]] = None) -> PipelineResult:
        cfg, son, rt = self.config, self.son, self.runtime
        t_start = time.perf_counter()
        rt.ledger.take_since(0)     # drop orphans from a raised prior run
        mark = rt.ledger.mark()
        faults = faults or {}

        stats = density_stats(baskets)
        n_tx, n_items = stats.n_tx, stats.n_items
        min_sup = cfg.abs_support(n_tx)
        parts = partition_slices(n_tx, son.partition_rows)
        P = len(parts)
        fingerprint = corpus_fingerprint(stats, cfg, son.partition_rows)
        # mean chunk size — the deterministic I/O cost estimate for loads
        chunk_cost = (son.partition_rows * 8.0
                      + (stats.nnz / max(n_tx, 1)) * son.partition_rows * 4.0)

        # ---- algorithm: one global decision for every partition --------
        self.algorithm_choice = None
        algorithm = cfg.algorithm
        if algorithm == "auto":
            self.algorithm_choice = select_partition_algorithm(
                stats, son.partition_rows, min_sup, device=cfg.device)
            algorithm = self.algorithm_choice.algorithm

        # ---- pass 0: spill (fresh) / validate the workdir (resume) -----
        if son.resume:
            if not os.path.exists(self._meta_path):
                raise FileNotFoundError(
                    f"nothing to resume under {son.workdir}: no completed "
                    "spill (corpus.json missing) — rerun without resume")
            with open(self._meta_path) as f:
                meta = json.load(f)
            if meta.get("fingerprint") != fingerprint:
                raise ValueError(
                    "resume rejected: spilled corpus fingerprint "
                    f"{meta.get('fingerprint')} != {fingerprint} — the "
                    "workdir holds a different job")
        else:
            if self._writes:
                os.makedirs(son.workdir, exist_ok=True)
                for d in (self._spill_dir, self._state_dir):
                    if os.path.exists(d):
                        shutil.rmtree(d)
                if os.path.exists(self._meta_path):
                    os.remove(self._meta_path)
            for p, (lo, hi) in enumerate(parts):
                self._spill_partition(p, _slice_slab(baskets, lo, hi,
                                                     n_items))
            # written only once every chunk is durable: its presence is the
            # resume path's spill-complete marker
            if self._writes:
                with open(self._meta_path, "w") as f:
                    json.dump({"fingerprint": fingerprint, "n_partitions": P,
                               "partition_rows": son.partition_rows,
                               "algorithm": algorithm}, f)

        # ---- restore (or initialize) the boundary state ----------------
        # with a mesh, every rank reads what rank 0 spilled and
        # checkpointed, and rank 0 writes its next checkpoint only once
        # every rank has read the last one
        self._barrier()
        p1, p2, union, counts, boundary, ckpt_algo = self._restore_state(
            P, fingerprint)
        self._barrier()
        if ckpt_algo is not None:
            algorithm = ckpt_algo    # a resumed auto decision never flips
        resumed = int(p1.sum() + p2.sum()) if son.resume else 0

        report = PipelineReport(
            backend=self.data_plane.backend, policy=rt.policy.name,
            split=rt.split,
            profile_speeds=[float(s) for s in self.profile.speeds],
            n_tx=n_tx, n_items=n_items, n_tiles=cfg.n_tiles,
            min_support=min_sup, algorithm=algorithm,
            execution="out_of_core", n_partitions=P,
            partition_rows=son.partition_rows, partitions_resumed=resumed)
        ckpt_extra = {"fingerprint": fingerprint, "algorithm": algorithm,
                      "min_sup": min_sup, "n_partitions": P}

        # ---- pass 1: local frequent itemsets per partition --------------
        for p, (lo, hi) in enumerate(parts):
            if p1[p]:
                continue
            rows = hi - lo
            chunk = self._load_partition(p, chunk_cost)
            local_abs = local_min_support(min_sup, rows, n_tx)
            backend = self._local_backend(rows, local_abs, algorithm)
            local = backend.run(chunk, faults.get(p))
            self._absorb_ledger(p, local.report)
            report.replans += local.report.replans
            for itemset in local.supports:
                union.setdefault(len(itemset), set()).add(itemset)
            p1[p] = 1
            boundary += 1
            self._checkpoint(boundary, p1, p2, union, counts, ckpt_extra,
                             report)

        # ---- canonical global candidate order ---------------------------
        # recomputed (never stored): sorted by level then lexicographically,
        # so a resumed pass 2 aligns its restored counts by construction
        cand_list = [t for k in sorted(union) for t in sorted(union[k])]
        M = len(cand_list)
        if counts is None:
            counts = np.zeros(M, dtype=np.int64)

        # ---- pass 2: stream every chunk through the global re-count -----
        if M and not p2.all():
            ni_pad = n_items + (-n_items) % 128
            self.data_plane.prepare(itemsets_to_bitmap(cand_list, ni_pad))
            m_padded = self.data_plane.m_padded
            for p in range(P):
                if p2[p]:
                    continue
                slab = self._load_partition(p, chunk_cost)
                counts = counts + self._recount_chunk(p, slab, M, m_padded)
                p2[p] = 1
                boundary += 1
                self._checkpoint(boundary, p1, p2, union, counts, ckpt_extra,
                                 report)

        # ---- filter at the true global threshold + rules ----------------
        supports: Dict[Tuple[int, ...], int] = {}
        for c, s in zip(cand_list, counts):
            if s >= min_sup:
                supports[c] = int(s)
        levels = max((len(c) for c in supports), default=1)
        rules, rules_rec = rt.run_serial(
            "mba-rules",
            cost=max(1.0, len(supports) * cfg.serial_unit_cost),
            fn=lambda: generate_rules(
                AprioriResult(supports=supports, n_tx=n_tx, levels=levels),
                cfg.min_confidence, min_lift=cfg.min_lift),
            min_speed=cfg.serial_min_speed)
        report.rules_phase = rules_rec

        report.n_itemsets = len(supports)
        report.n_rules = len(rules)
        report.wall_time_s = time.perf_counter() - t_start
        report.ledger = rt.ledger.take_since(mark)
        return PipelineResult(supports=supports, rules=rules, report=report,
                              n_tx=n_tx)
