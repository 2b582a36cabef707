"""MarketBasketPipeline — the paper end-to-end, as one object.

Composition (paper §V):

  baskets ──pack──▶ bitmap T[n_tx, n_items]
     │
     ├─ round k=1: item-frequency MapReduceJob (tiled over the profile)
     ├─ round k≥2: serial candidate generation  → Runtime.run_serial
     │             (one core runs, the rest are power-gated)
     │             tiled support counting       → Runtime.run_phase
     │             (DataPlane: CUDA kernel on the card, plain count on CPU)
     ├─ rules: confidence/lift pruning, serial phase on the fastest core
     ▼
  PipelineResult(supports, rules, PipelineReport)

The control plane (candidate generation, rule enumeration) is host Python
— the paper's "single-threaded tasks"; its scheduling/energy is *modeled*
through the shared :class:`repro.runtime.Runtime`, which owns the
MBScheduler + PowerModel + phase ledger and performs assignment, policy
feedback and accounting exactly once per phase.  The switching policy
(``static`` | ``dynamic`` | ``costmodel``) is a config knob; execution stays in
:class:`SimulatedCluster`, which honors whatever assignment the policy
planned.  Counting runs on ``PipelineConfig.device``: the card by default,
the CPU when the caller asks for it.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.hetero import HeterogeneityProfile
from repro_torch.core.itemsets import (AprioriResult, frequent_itemsets,
                                       generate_candidates,
                                       itemsets_to_bitmap)
from repro_torch.core.mapreduce import (FailureEvent, MapReduceJob,
                                        SimulatedCluster)
from repro_torch.core.power import PowerModel
from repro_torch.core.rules import Rule, generate_rules
from repro_torch.core.scheduler import MBScheduler, TaskSpec
from repro_torch.data.baskets import pack_transactions, pad_items
from repro_torch.data.sparse import SparseSlab, is_binary
from repro_torch.kernels.autotune.cache import plane_tuning
from repro_torch.pipeline.dataplane import DataPlane, uniform_tiles
from repro_torch.pipeline.devgen import DeviceLattice
from repro_torch.pipeline.report import PipelineReport, RoundReport
from repro_torch.runtime import (MeasuredPhase, Runtime, SlabPool,
                                 SwitchingPolicy, TransferMeter,
                                 autotuned_costmodel, donated_add)
from repro_torch.runtime.policies import check_policy_name

Baskets = Union[np.ndarray, SparseSlab, Sequence[Sequence[int]]]

# mining formulations ``PipelineConfig.algorithm`` may name (resolved by
# repro_torch.mining.make_miner)
ALGORITHMS = ("apriori", "eclat", "auto")


def ingest_baskets(baskets: Baskets) -> Tuple[np.ndarray, int, int]:
    """Validate + pack baskets into the kernel bitmap layout.

    Returns ``(lane-padded bitmap, raw item count, raw tx count)``.  Shared
    by the single-device pipeline and the sharded miner so both planes agree
    byte-for-byte on what they mine.  A :class:`SparseSlab` densifies here
    *explicitly* — the horizontal (Apriori) formulation needs the dense
    bitmap; the Eclat plane columnizes the slab without it.
    """
    if isinstance(baskets, SparseSlab):
        baskets = baskets.to_dense()
    if isinstance(baskets, np.ndarray):
        if baskets.ndim != 2:
            raise ValueError(f"bitmap must be 2-D, got {baskets.shape}")
        # validate BEFORE the uint8 cast: casting would truncate floats
        # (0.9 -> 0) and wrap negatives, hiding bad input behind an
        # empty-but-plausible mining result
        if not is_binary(baskets):
            raise ValueError("bitmap must contain only 0/1 — pass "
                             "transaction lists for count-style data")
        T = baskets.astype(np.uint8, copy=False)
    else:
        T = pack_transactions(baskets)
    return pad_items(T), T.shape[1], T.shape[0]


@dataclass(frozen=True)
class PipelineConfig:
    """Knobs for one mining run.  min_support <= 1 is a fraction of n_tx
    (1.0 = present in every transaction); values above 1 are absolute
    transaction counts."""

    min_support: float = 0.02
    min_confidence: float = 0.6
    min_lift: float = 0.0
    max_k: int = 0                  # 0 = mine until no candidates survive
    # Mining backend: "apriori" (horizontal bitmap rounds), "eclat"
    # (vertical tid-list intersections), or "auto" (the algorithm cost
    # model picks per dataset from measured density/sparsity features —
    # see repro_torch.mining.select).  Read by make_miner; the pipeline
    # itself always runs Apriori.
    algorithm: str = "apriori"
    # Round execution: "pipelined" (default) enqueues every tile kernel
    # eagerly, folds partial counts into an in-place device accumulator and
    # reads back one packed vector per round (single sync point; candidate
    # generation stays on device — see repro_torch.pipeline.devgen).
    # "per_tile" is the legacy sync-per-tile path, kept as the A/B baseline.
    round_execution: str = "pipelined"
    n_tiles: int = 32
    policy: str = "static"          # switching: static | dynamic | costmodel
    split: str = "lpt"              # tile split: equal | proportional | lpt
    data_plane: str = "auto"        # auto | cuda | ref
    m_bucket: int = 128             # candidate-batch rounding (kernel lanes)
    # support_count variant on the cuda data plane: {"variant": "packed"}
    # or {"variant": "mxu"} pins a kernel; None leaves it to autotune
    tuning: Optional[dict] = None
    # Kernel autotuning: True = the checked-in winner cache picks the
    # variant (and, under the costmodel policy, its measured walls replace
    # the data-sheet roofline constants); False = roofline-seeded defaults
    # everywhere.  A tuning pin wins over either.
    autotune: bool = True
    # where counting runs: the card unless the caller asks for "cpu"
    device: str = "cuda"
    power: str = "cpu"              # cpu | tpu_v5e | none
    speculate: bool = True
    # Serial-phase cost model: work units charged per (itemset, level) pair
    # examined by the join/prune (same units as tile bytes, so serial and
    # map phases share one time axis).  Calibrated so candidate generation
    # is small-but-visible next to counting, as in the paper.
    serial_unit_cost: float = 64.0
    # Required core speed for serial phases: when no core satisfies it,
    # assign_serial falls back to the fastest core and flags the phase
    # (surfaced as PipelineReport.constraint_violations, never silent).
    serial_min_speed: float = 0.0

    def __post_init__(self):
        check_policy_name(self.policy)
        if self.algorithm not in ALGORITHMS:
            raise ValueError(f"unknown mining algorithm {self.algorithm!r} "
                             f"(known: {', '.join(ALGORITHMS)})")
        if (torch.device(self.device).type == "cuda"
                and not torch.cuda.is_available()):
            raise RuntimeError(
                f"PipelineConfig(device={self.device!r}) but no CUDA device "
                "is available; pass device='cpu' to mine on the CPU")

    def abs_support(self, n_tx: int) -> int:
        if self.min_support <= 1.0:
            return max(1, int(self.min_support * n_tx))
        return int(self.min_support)


def candgen_cost(n_frequent: int, k: int, unit_cost: float) -> float:
    """Work units for the serial F_{k-1}⋈F_{k-1} join/prune phase.

    Shared by the batch pipeline and the streaming plane's re-validation
    pass — the two Apriori drivers must price (and therefore schedule)
    identical rounds identically, or their ledgers drift."""
    return max(1.0, n_frequent * k * unit_cost)


def support_flops(tile_rows: np.ndarray, n_items: int,
                  m_padded: int) -> np.ndarray:
    """Roofline seed for a support-count map phase: the int8 kernel's work
    is 2·rows·items·candidates per tile (bytes are rows·items).  Shared
    across the Apriori drivers for the same reason as candgen_cost."""
    return 2.0 * tile_rows * n_items * max(m_padded, 1)


@dataclass
class PipelineResult:
    supports: Dict[Tuple[int, ...], int]
    rules: List[Rule]
    report: PipelineReport
    n_tx: int

    def frequent(self, k: Optional[int] = None) -> List[Tuple[int, ...]]:
        return frequent_itemsets(self.supports, k)


class MarketBasketPipeline:
    """Orchestrates the full mining run over a heterogeneity profile."""

    def __init__(self, profile: Optional[HeterogeneityProfile] = None,
                 config: Optional[PipelineConfig] = None,
                 scheduler: Optional[MBScheduler] = None,
                 power: Optional[PowerModel] = None,
                 policy: Union[str, SwitchingPolicy, None] = None):
        self.profile = profile or HeterogeneityProfile.paper()
        self.config = config or PipelineConfig()
        cfg = self.config
        policy = policy if policy is not None else cfg.policy
        if policy == "costmodel" and cfg.autotune:
            # measured kernel walls replace the data-sheet constants
            policy = autotuned_costmodel("support_count", device=cfg.device)
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
        self.cluster = SimulatedCluster(self.profile, self.scheduler,
                                        power=None)  # ledger prices energy
        if cfg.round_execution not in ("pipelined", "per_tile"):
            raise ValueError(
                f"unknown round_execution {cfg.round_execution!r} "
                "(expected 'pipelined' or 'per_tile')")
        self.data_plane = DataPlane(cfg.data_plane,
                                    m_bucket=cfg.m_bucket,
                                    tuning=plane_tuning(cfg.tuning,
                                                        cfg.autotune),
                                    meter=self.runtime.meter)
        # round-persistent count accumulators, keyed by bucket shape
        self.slabs = SlabPool(self.device)

    # ------------------------------------------------------------------
    # phases
    # ------------------------------------------------------------------
    def _ingest(self, baskets: Baskets) -> Tuple[np.ndarray, int, int]:
        """Returns (lane-padded bitmap, raw item count, raw tx count)."""
        return ingest_baskets(baskets)

    def _map_round(self, job: MapReduceJob, tiles: List,
                   failures: Optional[List[FailureEvent]],
                   tile_flops: Optional[np.ndarray] = None,
                   finalize=None):
        """One tiled map phase through the shared runtime: the policy plans
        the assignment, the simulated cluster executes it, the runtime does
        the time/energy/switch accounting exactly once.  ``finalize`` runs
        on the combined result *inside* the phase — the pipelined path's
        single d2h readback happens there, so the sync lands on this
        phase's ledger record, not the next one's."""
        tile_costs = np.array([job.tile_cost(t) for t in tiles],
                              dtype=np.float64)
        # one family: every round maps the same device-resident tiles, so
        # dynamic switching tracks owner drift across rounds
        task = TaskSpec(job.name, float(tile_costs.sum()), parallel=True,
                        n_tiles=len(tiles), family="mba-map")

        def execute(asg, _costs):
            result, rep = self.cluster.run(job, tiles, failures=failures,
                                           speculate=self.config.speculate,
                                           assignment=asg)
            if finalize is not None:
                result = finalize(result)
            return MeasuredPhase(result=result, busy_s=rep.busy_s,
                                 makespan=rep.makespan,
                                 switches=rep.switches, reissued=rep.reissued,
                                 failed_devices=list(rep.failed_devices),
                                 tiles_done=rep.tiles_done)

        return self.runtime.run_phase(task, execute, tile_costs=tile_costs,
                                      tile_flops=tile_flops)

    # ------------------------------------------------------------------
    def run(self, baskets: Baskets,
            failures: Optional[List[FailureEvent]] = None) -> PipelineResult:
        if self.config.round_execution == "pipelined":
            return self._run_pipelined(baskets, failures)
        return self._run_per_tile(baskets, failures)

    # ------------------------------------------------------------------
    # legacy sync-per-tile rounds — the A/B baseline
    # ------------------------------------------------------------------
    def _run_per_tile(self, baskets: Baskets,
                      failures: Optional[List[FailureEvent]] = None
                      ) -> PipelineResult:
        cfg = self.config
        rt = self.runtime
        t_start = time.perf_counter()
        # a run that raised mid-way (invariant check, scoring error) leaves
        # orphaned records; this plane owns its runtime, so anything still
        # live belongs to no report — drop it before marking
        rt.ledger.take_since(0)
        mark = rt.ledger.mark()

        T, n_items_raw, n_tx_raw = self._ingest(baskets)
        n_tx, n_items = T.shape                     # lane-padded (internal)
        min_sup = cfg.abs_support(n_tx_raw)
        # device-resident once: every round's map phase reuses these tiles,
        # so uploading per round would redo the same host->device transfers
        tiles = [rt.meter.h2d(t) for t in uniform_tiles(T, cfg.n_tiles)]
        tile_rows = np.array([t.shape[0] for t in tiles], dtype=np.float64)

        report = PipelineReport(
            backend=self.data_plane.backend, policy=rt.policy.name,
            split=rt.split,
            profile_speeds=[float(s) for s in self.profile.speeds],
            n_tx=n_tx_raw, n_items=n_items_raw,
            n_tiles=len(tiles), min_support=min_sup)
        supports: Dict[Tuple[int, ...], int] = {}

        # ---- round k=1: item frequency (<item, count>) ----------------
        job1 = MapReduceJob(
            name="mba-round1-item-counts",
            # sum on device, transfer n_items ints — not the whole tile back
            # (still one readback *per tile*: that sync is this path's
            # defining cost, which the pipelined path removes)
            map_fn=lambda tile: rt.meter.d2h(
                tile.sum(dim=0, dtype=torch.int32), dtype=np.int64),
            combine_fn=lambda a, b: a + b,
            zero_fn=lambda: np.zeros(n_items, dtype=np.int64),
        )
        counts, rec = self._map_round(job1, tiles, failures,
                                      tile_flops=tile_rows * n_items)
        frequent = [(int(i),) for i in np.nonzero(counts >= min_sup)[0]]
        for (i,) in frequent:
            supports[(i,)] = int(counts[i])
        report.rounds.append(RoundReport.from_phases(
            k=1, n_candidates=n_items_raw, n_frequent=len(frequent),
            map_phase=rec))

        # ---- rounds k>=2: serial candidate-gen + tiled counting -------
        k = 2
        while frequent and (cfg.max_k == 0 or k <= cfg.max_k):
            cands, serial = rt.run_serial(
                f"mba-candgen-k{k}",
                cost=candgen_cost(len(frequent), k, cfg.serial_unit_cost),
                fn=lambda fr=frequent: generate_candidates(fr),
                min_speed=cfg.serial_min_speed)
            if not cands:
                report.rounds.append(RoundReport.from_phases(
                    k=k, n_candidates=0, n_frequent=0, map_phase=None,
                    serial=serial, n_devices=self.profile.n))
                break

            self.data_plane.prepare(itemsets_to_bitmap(cands, n_items))
            job = MapReduceJob(
                name=f"mba-round{k}-support",
                map_fn=self.data_plane.tile_counts,
                combine_fn=lambda a, b: a + b,
                zero_fn=lambda m=len(cands): np.zeros(m, dtype=np.int64),
            )
            m_padded = self.data_plane.m_padded
            sup, rec = self._map_round(
                job, tiles, failures,
                tile_flops=support_flops(tile_rows, n_items, m_padded))
            frequent = []
            for c, s in zip(cands, sup):
                if s >= min_sup:
                    supports[c] = int(s)
                    frequent.append(c)
            report.rounds.append(RoundReport.from_phases(
                k=k, n_candidates=len(cands), n_frequent=len(frequent),
                map_phase=rec, serial=serial, m_padded=m_padded))
            k += 1

        # ---- step 3: association rules (serial control plane) ---------
        rules, rules_rec = rt.run_serial(
            "mba-rules",
            cost=max(1.0, len(supports) * cfg.serial_unit_cost),
            fn=lambda: generate_rules(
                AprioriResult(supports=supports, n_tx=n_tx_raw, levels=k - 1),
                cfg.min_confidence, min_lift=cfg.min_lift),
            min_speed=cfg.serial_min_speed)
        report.rules_phase = rules_rec

        report.n_itemsets = len(supports)
        report.n_rules = len(rules)
        report.wall_time_s = time.perf_counter() - t_start
        report.ledger = rt.ledger.take_since(mark)
        return PipelineResult(supports=supports, rules=rules, report=report,
                              n_tx=n_tx_raw)

    # ------------------------------------------------------------------
    # pipelined device-resident rounds (the default)
    # ------------------------------------------------------------------
    def _run_pipelined(self, baskets: Baskets,
                       failures: Optional[List[FailureEvent]] = None
                       ) -> PipelineResult:
        """Same mining semantics as :meth:`_run_per_tile`, with rounds held
        on device: all tile kernels of a round dispatch eagerly (nothing in
        the map fan-out synchronizes), partial counts fold in place into a
        slab accumulator, candidate generation for the next level runs as a
        device join on the compacted frequent matrix, and the only
        device→host crossing per counting round is one packed
        ``[m_cap + 1]`` vector (counts + next join size) read inside the
        map phase.  Itemset tuples reach the host once, at rule time."""
        cfg = self.config
        rt = self.runtime
        t_start = time.perf_counter()
        rt.ledger.take_since(0)
        mark = rt.ledger.mark()

        T, n_items_raw, n_tx_raw = self._ingest(baskets)
        n_tx, n_items = T.shape                     # lane-padded (internal)
        min_sup = cfg.abs_support(n_tx_raw)
        tiles = [rt.meter.h2d(t) for t in uniform_tiles(T, cfg.n_tiles)]
        tile_rows = np.array([t.shape[0] for t in tiles], dtype=np.float64)

        report = PipelineReport(
            backend=self.data_plane.backend, policy=rt.policy.name,
            split=rt.split,
            profile_speeds=[float(s) for s in self.profile.speeds],
            n_tx=n_tx_raw, n_items=n_items_raw,
            n_tiles=len(tiles), min_support=min_sup)
        supports: Dict[Tuple[int, ...], int] = {}
        lattice = DeviceLattice(n_items, m_bucket=cfg.m_bucket,
                                meter=rt.meter)

        # ---- round k=1: item frequency, one readback ------------------
        job1 = MapReduceJob(
            name="mba-round1-item-counts",
            map_fn=lambda tile: tile.sum(dim=0, dtype=torch.int32),
            combine_fn=donated_add,
            zero_fn=lambda: torch.zeros(n_items, dtype=torch.int32,
                                        device=self.device),
        )
        counts, rec = self._map_round(
            job1, tiles, failures, tile_flops=tile_rows * n_items,
            finalize=lambda acc: rt.meter.d2h(acc, dtype=np.int64))
        frequent_items = np.nonzero(counts >= min_sup)[0]
        for i in frequent_items:
            supports[(int(i),)] = int(counts[i])
        report.rounds.append(RoundReport.from_phases(
            k=1, n_candidates=n_items_raw, n_frequent=len(frequent_items),
            map_phase=rec))
        f_count = len(frequent_items)
        if f_count:
            # seeded between phases, so the (tiny) upload is attributed to
            # the phase that consumes it — the k=2 candgen
            lattice.seed_items(frequent_items)

        # ---- rounds k>=2: device candgen + device-combined counting ---
        k = 2
        while f_count and (cfg.max_k == 0 or k <= cfg.max_k):
            gen, serial = rt.run_serial(
                f"mba-candgen-k{k}",
                cost=candgen_cost(f_count, k, cfg.serial_unit_cost),
                fn=lattice.join,
                min_speed=cfg.serial_min_speed)
            if gen is None:
                report.rounds.append(RoundReport.from_phases(
                    k=k, n_candidates=0, n_frequent=0, map_phase=None,
                    serial=serial, n_devices=self.profile.n))
                break
            C, valid_c, bitmap, m_cap = gen
            self.data_plane.prepare_device(bitmap)
            job = MapReduceJob(
                name=f"mba-round{k}-support",
                map_fn=self.data_plane.tile_counts_device,
                combine_fn=donated_add,
                zero_fn=lambda m=m_cap: self.slabs.take((m,), torch.int32),
            )

            def finalize(acc, C=C, valid_c=valid_c):
                packed, Fn, vn = lattice.finalize(acc, C, valid_c, min_sup)
                host = rt.meter.d2h(packed)    # the round's single sync
                self.slabs.give(acc)           # accumulator back to the pool
                return host, Fn, vn

            (packed, Fn, vn), rec = self._map_round(
                job, tiles, failures,
                tile_flops=support_flops(tile_rows, n_items, m_cap),
                finalize=finalize)
            m_true, f_count = lattice.advance(packed, Fn, vn, min_sup)
            report.rounds.append(RoundReport.from_phases(
                k=k, n_candidates=m_true, n_frequent=f_count,
                map_phase=rec, serial=serial, m_padded=m_cap))
            k += 1

        # ---- step 3: rules — tuples decode here, once -----------------
        n_supports = len(supports) + lattice.n_frequent_total

        def rules_fn():
            supports.update(lattice.decode_supports())
            return generate_rules(
                AprioriResult(supports=supports, n_tx=n_tx_raw,
                              levels=k - 1),
                cfg.min_confidence, min_lift=cfg.min_lift)

        rules, rules_rec = rt.run_serial(
            "mba-rules",
            cost=max(1.0, n_supports * cfg.serial_unit_cost),
            fn=rules_fn,
            min_speed=cfg.serial_min_speed)
        report.rules_phase = rules_rec

        report.n_itemsets = len(supports)
        report.n_rules = len(rules)
        report.wall_time_s = time.perf_counter() - t_start
        report.ledger = rt.ledger.take_since(mark)
        return PipelineResult(supports=supports, rules=rules, report=report,
                              n_tx=n_tx_raw)
