"""EclatMiner — the vertical tid-list formulation of the mining plane.

Where :class:`repro_torch.pipeline.MarketBasketPipeline` keeps transactions
horizontal (bitmap rows) and re-scans the whole bitmap every level, this
plane transposes once — each item owns a packed tid-list *column* (bit b of
word w ⇔ transaction ``32w + b``, the ``pack_words`` convention, held as
int32 bit patterns on the device) — and every later level is pure
row-aligned work:

  k=1   support(i)        = popcount(col_i)
  k>=2  support(prefix+(a,b)) = popcount(slab[prefix+(a,)] & slab[prefix+(b,)])

because ``generate_candidates`` builds each k-candidate by joining two
(k-1)-siblings that differ only in the last item — so the candidate's
tidset is exactly the AND of two rows the previous level already
materialized.  The transaction axis is paid for once at columnization;
each round then touches ``candidates × n_tx/32`` words instead of
``n_tx × n_items`` lanes.

Everything around the formulation is identical to the Apriori plane: same
``generate_candidates``/``generate_rules`` control plane, same min-support
semantics, same ``Runtime`` phase routing (serial candgen/columnize/rules +
tiled map rounds under ``policy=static|dynamic|costmodel``), same
``PipelineReport`` shape.  Counting runs on ``PipelineConfig.device``:
the ``intersect_count`` CUDA kernel on the card by default, its plain
version on the CPU.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.hetero import HeterogeneityProfile
from repro_torch.core.itemsets import AprioriResult, generate_candidates
from repro_torch.core.mapreduce import (FailureEvent, MapReduceJob,
                                        SimulatedCluster)
from repro_torch.core.power import PowerModel
from repro_torch.core.rules import generate_rules
from repro_torch.core.scheduler import MBScheduler, TaskSpec
from repro_torch.data.sparse import SparseSlab, pack_tid_columns
from repro_torch.kernels.autotune.cache import plane_tuning
from repro_torch.kernels.support_count.ops import intersect_count
from repro_torch.kernels.support_count.ref import intersect_count_ref
from repro_torch.pipeline.dataplane import resolve_backend
from repro_torch.pipeline.pipeline import (Baskets, PipelineConfig,
                                           PipelineResult, candgen_cost,
                                           ingest_baskets)
from repro_torch.pipeline.report import PipelineReport, RoundReport
from repro_torch.runtime import (MeasuredPhase, Runtime, SlabPool,
                                 SwitchingPolicy, TransferMeter,
                                 autotuned_costmodel, donated_add,
                                 donated_and)

WORD_BITS = 32

# ops per packed word-pair in flop-equivalents (matches
# shape_flops_bytes("intersect_count", ...): 2 bit-ops per item, 32
# items per word) — the roofline seed for the map phases' tile_flops
_FLOPS_PER_WORD = 64.0


def columnize_cost(nnz: int, n_rows: int, n_words: int) -> float:
    """Work units for the serial transpose/pack phase: one touch per nnz
    cell plus the packed slab write, in the same byte-flavored units the
    map tiles use (so serial and map phases share one time axis)."""
    return max(1.0, 4.0 * nnz + 4.0 * n_rows * n_words)


class EclatMiner:
    """Vertical mining over a heterogeneity profile (Apriori's twin)."""

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
            # this plane's hot loop is the intersect kernel, so the cost
            # model plans on *its* measured walls, not support_count's
            policy = autotuned_costmodel("intersect_count",
                                         device=cfg.device)
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
        self.backend = resolve_backend(cfg.data_plane, self.device)
        # the intersect kernel has one variant: no pin, only the cache
        self.tuning = plane_tuning(None, cfg.autotune)
        # round-persistent count accumulators (pipelined rounds)
        self.slabs = SlabPool(self.device)

    # ------------------------------------------------------------------
    # vertical data plane
    # ------------------------------------------------------------------
    def _columnize(self, baskets: Baskets) -> Tuple[np.ndarray, int, int, int]:
        """Returns ``(tid columns [rows_pad128, W_pad128] uint32, raw item
        count, raw tx count, nnz)``.  A :class:`SparseSlab` columnizes
        straight from CSR — the dense bitmap is never materialized on the
        sparse path; dense bitmaps / id lists share ``ingest_baskets``'s
        validation so all input forms agree byte-for-byte."""
        if isinstance(baskets, SparseSlab):
            return (baskets.tid_columns(), baskets.n_items, baskets.n_tx,
                    baskets.nnz)
        T, n_items_raw, n_tx_raw = ingest_baskets(baskets)
        # T is 0/1 (validated by ingest): its nonzeros are its sum
        return (pack_tid_columns(T), n_items_raw, n_tx_raw,
                np.count_nonzero(T))

    def _count(self, A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
        """Row-aligned intersection counts [M] int32 (backend-dispatched)."""
        if self.backend == "cuda":
            return intersect_count(A, B, tuning=self.tuning)
        return intersect_count_ref(A, B)

    def _pair_tiles(self, A: torch.Tensor, B: torch.Tensor
                    ) -> List[Tuple[int, torch.Tensor, torch.Tensor]]:
        """Split two aligned [M, W] slabs into uniform row-tile pairs
        ``(row offset, A tile, B tile)``.  Identical tile shapes keep every
        launch of a round alike, as the horizontal plane's
        ``uniform_tiles`` does; all-zero padding rows popcount to 0
        (inert)."""
        m = A.shape[0]
        n_tiles = max(1, min(self.config.n_tiles, m))
        rows = -(-m // n_tiles)
        rows += (-rows) % 128                     # kernel lane alignment
        n_tiles = -(-m // rows)
        pad = rows * n_tiles - m
        if pad:
            z = torch.zeros((pad, A.shape[1]), dtype=A.dtype, device=A.device)
            A = torch.cat([A, z])
            B = torch.cat([B, z])
        return [(i * rows, A[i * rows:(i + 1) * rows],
                 B[i * rows:(i + 1) * rows]) for i in range(n_tiles)]

    def _map_round(self, name: str, A: torch.Tensor, B: torch.Tensor,
                   m_true: int, failures: Optional[List[FailureEvent]]):
        """One tiled intersection phase through the shared runtime.

        Pipelined (default): every tile writes its device counts into a
        tile-offset window of an [m_pad] int32 vector, partials fold in
        place into a slab accumulator, and the round reads back one sliced
        vector — one sync.  ``per_tile`` keeps the legacy readback per
        tile (the A/B baseline)."""
        tiles = self._pair_tiles(A, B)
        n_words = A.shape[1]
        meter = self.runtime.meter
        pipelined = self.config.round_execution == "pipelined"

        if pipelined:
            rows = int(tiles[0][1].shape[0])
            m_pad = rows * len(tiles)

            def map_fn(tile):
                off, Aj, Bj = tile
                out = torch.zeros(m_pad, dtype=torch.int32,
                                  device=self.device)
                out[off:off + rows] = self._count(Aj, Bj)
                return out

            def finalize(acc):
                out = meter.d2h(acc[:m_true], dtype=np.int64)
                self.slabs.give(acc)
                return out

            job = MapReduceJob(
                name=name,
                map_fn=map_fn,
                combine_fn=donated_add,
                zero_fn=lambda: self.slabs.take((m_pad,), torch.int32),
                cost_fn=lambda t: float(t[1].nbytes + t[2].nbytes),
            )
        else:
            finalize = None

            def tile_counts(tile) -> np.ndarray:
                off, Aj, Bj = tile
                counts = meter.d2h(self._count(Aj, Bj), dtype=np.int64)
                out = np.zeros(m_true, dtype=np.int64)
                seg = counts[:max(0, min(len(counts), m_true - off))]
                out[off:off + len(seg)] = seg
                return out

            job = MapReduceJob(
                name=name,
                map_fn=tile_counts,
                combine_fn=lambda a, b: a + b,  # disjoint segments
                zero_fn=lambda m=m_true: np.zeros(m, dtype=np.int64),
                cost_fn=lambda t: float(t[1].nbytes + t[2].nbytes),
            )
        tile_costs = np.array([job.tile_cost(t) for t in tiles],
                              dtype=np.float64)
        tile_rows = np.array([t[1].shape[0] for t in tiles], dtype=np.float64)
        # one family across rounds, like the horizontal plane's "mba-map":
        # dynamic switching tracks owner drift over same-arity rounds
        task = TaskSpec(name, float(tile_costs.sum()), parallel=True,
                        n_tiles=len(tiles), family="eclat-map")

        def execute(asg, _costs):
            result, rep = self.cluster.run(job, tiles, failures=failures,
                                           speculate=self.config.speculate,
                                           assignment=asg)
            if finalize is not None:
                result = finalize(result)   # the round's single sync
            return MeasuredPhase(result=result, busy_s=rep.busy_s,
                                 makespan=rep.makespan,
                                 switches=rep.switches, reissued=rep.reissued,
                                 failed_devices=list(rep.failed_devices),
                                 tiles_done=rep.tiles_done)

        return self.runtime.run_phase(
            task, execute, tile_costs=tile_costs,
            tile_flops=_FLOPS_PER_WORD * tile_rows * n_words)

    # ------------------------------------------------------------------
    def run(self, baskets: Baskets,
            failures: Optional[List[FailureEvent]] = None) -> PipelineResult:
        cfg = self.config
        rt = self.runtime
        t_start = time.perf_counter()
        rt.ledger.take_since(0)                  # drop orphans (plane-owned)
        mark = rt.ledger.mark()

        # ---- columnize: the one serial pass over the transaction axis --
        if isinstance(baskets, SparseSlab):
            nnz0, ni0, ntx0 = baskets.nnz, baskets.n_items, baskets.n_tx
        elif isinstance(baskets, np.ndarray):
            # equal to the sum for a 0/1 bitmap; any other raises in
            # columnize
            nnz0 = np.count_nonzero(baskets)
            ntx0, ni0 = baskets.shape
        else:
            nnz0 = sum(len(set(tx)) for tx in baskets)
            ntx0, ni0 = len(baskets), 0     # universe unknown until packed
        (cols, n_items_raw, n_tx_raw, nnz), col_rec = rt.run_serial(
            "eclat-columnize",
            cost=columnize_cost(nnz0, max(ni0, 1),
                                1 + max(ntx0 - 1, 0) // WORD_BITS),
            fn=lambda: self._columnize(baskets),
            min_speed=cfg.serial_min_speed)
        min_sup = cfg.abs_support(n_tx_raw)
        # device-resident once; the uint32 words travel as int32 bit
        # patterns (same bytes), since torch has no uint32 gather or AND
        # on the card
        cols = rt.meter.h2d(cols.view(np.int32))

        report = PipelineReport(
            backend=self.backend, policy=rt.policy.name,
            algorithm="eclat", split=rt.split,
            profile_speeds=[float(s) for s in self.profile.speeds],
            n_tx=n_tx_raw, n_items=n_items_raw,
            n_tiles=cfg.n_tiles, min_support=min_sup)
        supports: Dict[Tuple[int, ...], int] = {}

        # ---- round k=1: popcount of each item's own column -------------
        counts, rec = self._map_round("eclat-round1-item-counts",
                                      cols, cols, n_items_raw, failures)
        frequent = [(int(i),) for i in np.nonzero(counts >= min_sup)[0]]
        # the (k-1)-level slab: one tid-list row per frequent itemset
        row_of = {(int(i),): int(i) for (i,) in frequent}
        slab = cols
        for (i,) in frequent:
            supports[(i,)] = int(counts[i])
        report.rounds.append(RoundReport.from_phases(
            k=1, n_candidates=n_items_raw, n_frequent=len(frequent),
            map_phase=rec))

        # ---- rounds k>=2: serial join + tiled AND-popcount -------------
        k = 2
        while frequent and (cfg.max_k == 0 or k <= cfg.max_k):
            cands, serial = rt.run_serial(
                f"eclat-candgen-k{k}",
                cost=candgen_cost(len(frequent), k, cfg.serial_unit_cost),
                fn=lambda fr=frequent: generate_candidates(fr),
                min_speed=cfg.serial_min_speed)
            if not cands:
                report.rounds.append(RoundReport.from_phases(
                    k=k, n_candidates=0, n_frequent=0, map_phase=None,
                    serial=serial, n_devices=self.profile.n))
                break

            # stage the join's two (k-1)-parents per candidate: c joins
            # c[:-1] with c[:-2]+(c[-1],) — both frequent by construction
            left = np.array([row_of[c[:-1]] for c in cands], dtype=np.int32)
            right = np.array([row_of[c[:-2] + (c[-1],)] for c in cands],
                             dtype=np.int32)
            A = slab.index_select(0, rt.meter.h2d(left))
            B = slab.index_select(0, rt.meter.h2d(right))

            sup, rec = self._map_round(f"eclat-round{k}-intersect",
                                       A, B, len(cands), failures)
            frequent = []
            surv_rows: List[int] = []
            for row, (c, s) in enumerate(zip(cands, sup)):
                if s >= min_sup:
                    supports[c] = int(s)
                    frequent.append(c)
                    surv_rows.append(row)
            # next level's slab: materialize survivors' tidsets only
            # (uncharged staging, like the horizontal plane's
            # itemsets_to_bitmap + prepare)
            if frequent:
                surv = rt.meter.h2d(np.array(surv_rows, dtype=np.int32))
                # in-place AND: the two gathered parent slabs die here, so
                # the survivor tidsets are written in place of one of them
                slab = donated_and(A.index_select(0, surv),
                                   B.index_select(0, surv))
                row_of = {c: r for r, c in enumerate(frequent)}
            m_padded = -(-len(cands) // 128) * 128
            report.rounds.append(RoundReport.from_phases(
                k=k, n_candidates=len(cands), n_frequent=len(frequent),
                map_phase=rec, serial=serial, m_padded=m_padded))
            k += 1

        # ---- association rules (identical serial phase) ----------------
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
