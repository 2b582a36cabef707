"""StreamingMiner — incremental Apriori over a sliding transaction window.

The paper's system is continuously operating: transactions keep arriving,
the mining job refreshes, and the recommendation layer consumes fresh
rules.  Re-mining the window from scratch on every micro-batch repeats
work proportional to the *window*; this plane does work proportional to
the *batch*:

  micro-batch ──▶ SlidingWindow.push ──▶ (arrived, evicted) slabs
     │
     ├─ delta phase (map): support_count on just the slabs —
     │    supp += count(arrived) - count(evicted)   for every tracked
     │    itemset, plus the item-frequency vector (support over the
     │    window is linear in rows, so the update is exact)
     ├─ check phase (serial): recompute the frequent/infrequent status
     │    of every tracked itemset under the new window's min_support
     ├─ re-validation (only when the lattice can change): if any tracked
     │    itemset crossed the frequency boundary, candidate sets are no
     │    longer trustworthy — run a full Apriori pass over the window
     │    and rebuild the tracked set
     ├─ rules phase (serial, only when supports moved): regenerate rules
     │    and hot-swap them into the live RecommendationEngine via the
     │    engine's atomic ``refresh()``
     ▼
  StreamingReport (per-batch records + the shared-runtime ledger slice)

Exactness argument (why the final state is bit-identical to a one-shot
``MarketBasketPipeline`` over the same window): the *tracked set* is the
full candidate set of the last validation — every frequent itemset plus
the negative border (candidates that failed min_support).  Item (k=1)
counts are maintained exactly for every item.  If the window's frequent
set changes at all, downward closure implies some minimal changed itemset
has all proper subsets frequent before and after — so it was a candidate,
hence tracked, and its boundary crossing is detected, which triggers the
full re-validation.  Between re-validations the lattice is provably
unchanged and the delta-maintained counters are exact, so supports (and
the rules derived from them) match the from-scratch mine bit for bit.

All phases are routed through the shared :class:`repro_torch.runtime.Runtime`
(``run_serial`` / ``run_phase``), so the ledger prices streaming time,
energy and core switches exactly like the other planes, and the
``policy=`` knob (static | dynamic | costmodel) is honored: the delta and
validation map phases are planned by the switching policy over the
heterogeneity profile.  Counting runs on ``StreamingConfig.device``
through the same ``support_count`` data plane as the pipeline: the
card's kernels by default, the plain count on the CPU when the caller
asks for it.  The
delta and validation map phases record their host wall in the ledger
(``PhaseRecord.host_time_s``), so a run shows where a batch's time went.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.hetero import HeterogeneityProfile
from repro_torch.core.itemsets import (AprioriResult, generate_candidates,
                                       itemsets_to_bitmap)
from repro_torch.core.power import PowerModel
from repro_torch.core.rules import Rule, generate_rules
from repro_torch.core.scheduler import MBScheduler, TaskSpec
from repro_torch.kernels.autotune.cache import plane_tuning
from repro_torch.pipeline.dataplane import DataPlane, uniform_tiles
from repro_torch.pipeline.pipeline import (PipelineConfig, candgen_cost,
                                           support_flops)
from repro_torch.runtime import (ExecLedger, LedgerTotals, MeasuredPhase,
                                 Runtime, SlabPool, SwitchingPolicy,
                                 TransferMeter, autotuned_costmodel,
                                 donated_add)
from repro_torch.runtime.policies import check_policy_name
from repro_torch.serving.engine import RecommendationEngine
from repro_torch.serving.index import RuleIndex
from repro_torch.streaming.source import SlidingWindow

Itemset = Tuple[int, ...]


@dataclass(frozen=True)
class StreamingConfig:
    """Knobs for the streaming plane (superset of the mining thresholds).

    ``window`` / ``batch_size`` shape the arrival process; the mining
    thresholds (``min_support`` as a fraction of the *current window
    fill*, ``min_confidence``, ``min_lift``, ``max_k``) carry the exact
    :class:`repro_torch.pipeline.PipelineConfig` semantics so incremental
    and one-shot mining agree bit for bit.  ``refresh_every`` rate-limits
    the rules/index refresh (1 = refresh whenever supports moved; a
    re-validation always refreshes); ``revalidate_every`` forces a
    periodic full Apriori pass on top of the boundary-crossing trigger
    (0 = trigger-only, which is already exact).
    """

    window: int = 2048
    batch_size: int = 128
    min_support: float = 0.02
    min_confidence: float = 0.6
    min_lift: float = 0.0
    max_k: int = 0                  # 0 = mine until no candidates survive
    n_tiles: int = 8                # validation-pass map tiles
    round_execution: str = "pipelined"  # pipelined | per_tile (see PipelineConfig)
    policy: str = "static"          # switching: static | dynamic | costmodel
    split: str = "lpt"              # tile split: equal | proportional | lpt
    data_plane: str = "auto"        # auto | cuda | ref
    m_bucket: int = 128             # candidate-batch rounding (kernel lanes)
    # support_count variant pin on the cuda data plane (see PipelineConfig)
    tuning: Optional[dict] = None
    autotune: bool = True           # winner cache on (see PipelineConfig)
    # where counting runs: the card unless the caller asks for "cpu"
    device: str = "cuda"
    power: str = "cpu"              # cpu | tpu_v5e | none
    refresh_every: int = 1          # batches between rule/index refreshes
    revalidate_every: int = 0       # 0 = only when the lattice can change
    serial_unit_cost: float = 64.0  # same work units as PipelineConfig
    serial_min_speed: float = 0.0   # min core speed for serial phases

    def __post_init__(self):
        # the same refusals as the pipeline's, before any state is built
        check_policy_name(self.policy)
        if (torch.device(self.device).type == "cuda"
                and not torch.cuda.is_available()):
            raise RuntimeError(
                f"StreamingConfig(device={self.device!r}) but no CUDA device "
                "is available; pass device='cpu' to mine on the CPU")

    def abs_support(self, n_tx: int) -> int:
        return PipelineConfig(min_support=self.min_support,
                              device=self.device).abs_support(n_tx)

    def pipeline_config(self, **overrides) -> PipelineConfig:
        """The equivalent one-shot config (parity smokes mine with this)."""
        kw = dict(min_support=self.min_support,
                  min_confidence=self.min_confidence,
                  min_lift=self.min_lift, max_k=self.max_k,
                  n_tiles=self.n_tiles,
                  round_execution=self.round_execution,
                  policy=self.policy, split=self.split,
                  data_plane=self.data_plane, m_bucket=self.m_bucket,
                  tuning=self.tuning, autotune=self.autotune,
                  device=self.device,
                  power=self.power,
                  serial_unit_cost=self.serial_unit_cost,
                  serial_min_speed=self.serial_min_speed)
        kw.update(overrides)
        return PipelineConfig(**kw)


@dataclass
class BatchReport:
    """Accounting for one micro-batch through the streaming plane."""

    idx: int
    n_arrived: int
    n_evicted: int
    window_n: int
    min_support: int               # absolute, under the new window fill
    revalidated: bool = False
    rules_refreshed: bool = False
    index_swapped: bool = False
    n_frequent: int = 0
    n_rules: int = 0
    index_version: int = 0
    n_phases: int = 0              # PhaseRecords this batch emitted
    time_s: float = 0.0            # simulated seconds (ledger slice)
    refresh_latency_s: float = 0.0  # host wall: rules regen -> index visible
    wall_s: float = 0.0


@dataclass
class StreamingReport(LedgerTotals):
    """The streaming twin of PipelineReport: per-batch records + ledger
    (a :class:`repro_torch.runtime.PlaneReport`; the totals are the
    ledger slice's)."""

    backend: str
    policy: str
    split: str
    window: int
    batch_size: int
    n_items: int = 0
    batches: List[BatchReport] = field(default_factory=list)
    wall_time_s: float = 0.0
    ledger: Optional[ExecLedger] = None

    @property
    def n_batches(self) -> int:
        return len(self.batches)

    @property
    def n_revalidations(self) -> int:
        return sum(1 for b in self.batches if b.revalidated)

    @property
    def n_refreshes(self) -> int:
        return sum(1 for b in self.batches if b.rules_refreshed)

    @property
    def mean_refresh_latency_s(self) -> float:
        lats = [b.refresh_latency_s for b in self.batches
                if b.rules_refreshed]
        return float(np.mean(lats)) if lats else 0.0

    def summary(self) -> str:
        last = self.batches[-1] if self.batches else None
        lines = [
            f"StreamingMiner: backend={self.backend} policy={self.policy} "
            f"split={self.split} window={self.window} "
            f"batch={self.batch_size}",
            f"  {self.n_batches} micro-batches | "
            f"{self.n_revalidations} re-validations, "
            f"{self.n_refreshes} rule refreshes "
            f"(mean refresh-to-visible {self.mean_refresh_latency_s * 1e3:.2f}ms)",
            f"  totals: simulated {self.total_time_s:.4f}s, "
            f"{self.total_energy_j:.1f}J, {self.total_switches} core "
            f"switches, {self.total_reissued} re-issues | "
            f"wall {self.wall_time_s:.3f}s",
        ]
        if last is not None:
            lines.append(
                f"  live state: {last.window_n} tx in window, "
                f"{last.n_frequent} frequent itemsets, {last.n_rules} rules, "
                f"index v{last.index_version}")
        if self.constraint_violations:
            lines.append(f"  WARNING: {self.constraint_violations} serial "
                         f"phase(s) ran on a core below their min_speed")
        return "\n".join(lines)


class StreamingMiner:
    """Incremental miner over a sliding window, feeding a live rule index.

    ``n_items`` fixes the item universe up front (streams cannot grow it:
    the kernel layouts and the serving index are shape-stable).  Attach a
    live :class:`RecommendationEngine` with ``engine=`` or
    :meth:`attach_engine`; every rule refresh then hot-swaps the compiled
    index into it via ``engine.refresh()``.
    """

    def __init__(self, n_items: int,
                 profile: Optional[HeterogeneityProfile] = None,
                 config: Optional[StreamingConfig] = None,
                 engine: Optional[RecommendationEngine] = None,
                 scheduler: Optional[MBScheduler] = None,
                 power: Optional[PowerModel] = None,
                 policy: Union[str, SwitchingPolicy, None] = None):
        self.profile = profile or HeterogeneityProfile.paper()
        self.config = config or StreamingConfig()
        cfg = self.config
        if cfg.round_execution not in ("pipelined", "per_tile"):
            raise ValueError(
                f"round_execution must be 'pipelined' or 'per_tile', "
                f"got {cfg.round_execution!r}")
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
        self.device = self.runtime.meter.device
        self.data_plane = DataPlane(cfg.data_plane, m_bucket=cfg.m_bucket,
                                    tuning=plane_tuning(cfg.tuning,
                                                        cfg.autotune),
                                    meter=self.runtime.meter)
        self.slabs = SlabPool(self.device)
        self.window = SlidingWindow(cfg.window, n_items)
        self.engine = engine

        # incremental state -------------------------------------------------
        Ip = self.window.n_items_padded
        self._item_counts = np.zeros(Ip, dtype=np.int64)
        self._tracked: List[Itemset] = []     # last validation's candidates
        self._tracked_supp = np.zeros(0, dtype=np.int64)  # aligned counts
        self._levels = 1                      # deepest level the lattice has
        self._freq_items: Optional[frozenset] = None   # None = no lattice yet
        self._freq_tracked: frozenset = frozenset()
        # rules/index state
        self.rules: List[Rule] = []
        self.index: Optional[RuleIndex] = None
        self._rules_state: Optional[Tuple[Dict[Itemset, int], int]] = None
        self._batch_idx = 0
        self._batches: List[BatchReport] = []
        self._wall_s = 0.0

    # ------------------------------------------------------------------
    @property
    def n_items(self) -> int:
        return self.window.n_items

    def attach_engine(self, engine: RecommendationEngine) -> None:
        """Attach (or replace) the live serving engine; the next refresh
        swaps the current index in immediately if one exists."""
        self.engine = engine
        if self.index is not None:
            self.index = engine.refresh(self.index)

    # ------------------------------------------------------------------
    # current mined state (exact between re-validations, see module doc)
    # ------------------------------------------------------------------
    def min_support_abs(self) -> int:
        return self.config.abs_support(max(self.window.n, 1))

    @property
    def supports(self) -> Dict[Itemset, int]:
        """Frequent itemsets -> exact window support (the pipeline dict)."""
        min_sup = self.min_support_abs()
        sup: Dict[Itemset, int] = {
            (int(i),): int(self._item_counts[i])
            for i in np.nonzero(self._item_counts >= min_sup)[0]}
        for c, s in zip(self._tracked, self._tracked_supp):
            if s >= min_sup:
                sup[c] = int(s)
        return sup

    # ------------------------------------------------------------------
    # phase helpers (everything prices through the shared runtime)
    # ------------------------------------------------------------------
    def _run_serial(self, name: str, cost: float, fn=None):
        return self.runtime.run_serial(
            name, cost=cost, fn=fn,
            min_speed=self.config.serial_min_speed)

    def _delta_phase(self, arrived: np.ndarray, evicted: np.ndarray):
        """One map phase over the arrive/evict slabs: item-count vector
        delta plus tracked-candidate support deltas, computed with the
        same support_count data plane the batch pipeline uses."""
        Ip = self.window.n_items_padded
        m_padded = self.data_plane.m_padded if self._tracked else 0
        slabs = [s for s in (arrived, evicted) if s.shape[0]]
        rows = np.array([s.shape[0] for s in slabs], dtype=np.float64)
        tile_costs = rows * Ip * (1.0 + m_padded)
        task = TaskSpec(f"stream-delta-{self._batch_idx}",
                        float(tile_costs.sum()), parallel=True,
                        n_tiles=len(slabs), family="stream-delta")

        meter = self.runtime.meter
        pipelined = self.config.round_execution == "pipelined"

        def execute(_asg, _costs):
            t0 = time.perf_counter()
            if not pipelined:           # legacy: host math + per-slab syncs
                d_items = (arrived.sum(axis=0, dtype=np.int64)
                           - evicted.sum(axis=0, dtype=np.int64))
                d_supp = np.zeros(len(self._tracked), dtype=np.int64)
                if self._tracked:
                    if arrived.shape[0]:
                        d_supp += self.data_plane.tile_counts(arrived)
                    if evicted.shape[0]:
                        d_supp -= self.data_plane.tile_counts(evicted)
                return MeasuredPhase(result=(d_items, d_supp),
                                     wall_s=time.perf_counter() - t0)
            # pipelined: both slabs' item deltas and tracked-support deltas
            # compute on device; one packed [Ip + m] readback is the batch's
            # single sync point (a zero-row slab launches nothing)
            m = len(self._tracked)
            d_items = torch.zeros(Ip, dtype=torch.int32, device=self.device)
            d_supp = torch.zeros(m, dtype=torch.int32, device=self.device)
            for sign, slab in ((1, arrived), (-1, evicted)):
                if not slab.shape[0]:
                    continue
                dev = meter.h2d(slab)
                d_items.add_(dev.sum(dim=0, dtype=torch.int32), alpha=sign)
                if m:
                    d_supp.add_(self.data_plane.tile_counts_device(dev)[:m],
                                alpha=sign)
            packed = meter.d2h(torch.cat([d_items, d_supp]), dtype=np.int64)
            return MeasuredPhase(result=(packed[:Ip], packed[Ip:]),
                                 wall_s=time.perf_counter() - t0)

        (d_items, d_supp), rec = self.runtime.run_phase(
            task, execute, tile_costs=tile_costs,
            tile_flops=support_flops(rows, Ip, m_padded))
        self._item_counts += d_items
        if len(d_supp):
            self._tracked_supp += d_supp
        return rec

    # ------------------------------------------------------------------
    def _validate(self) -> None:
        """Full Apriori pass over the window: rebuild the tracked set
        (all candidates, frequent AND the negative border) and its exact
        supports.  Runs only when the lattice can have changed."""
        cfg = self.config
        min_sup = self.min_support_abs()
        Ip = self.window.n_items_padded
        W = self.window.rows()
        meter = self.runtime.meter
        pipelined = cfg.round_execution == "pipelined"
        tiles = [meter.h2d(t) for t in uniform_tiles(W, cfg.n_tiles)]
        tile_rows = np.array([t.shape[0] for t in tiles], dtype=np.float64)

        frequent: List[Itemset] = [
            (int(i),) for i in np.nonzero(self._item_counts >= min_sup)[0]]
        tracked: List[Itemset] = []
        tracked_supp: List[int] = []
        k = 2
        # NOTE: this loop mirrors the pipeline's per-tile rounds k>=2
        # (shared candgen_cost/support_flops pricing, same DataPlane and
        # generate_candidates) but additionally RETAINS the infrequent
        # candidates — the negative border the delta path tracks.  A
        # semantic change to the pipeline's round loop must land here too;
        # the parity smoke and the streaming property tests enforce that.
        while frequent and (cfg.max_k == 0 or k <= cfg.max_k):
            cands, _ = self._run_serial(
                f"stream-validate-candgen-k{k}",
                cost=candgen_cost(len(frequent), k, cfg.serial_unit_cost),
                fn=lambda fr=frequent: generate_candidates(fr))
            if not cands:
                break
            self.data_plane.prepare(itemsets_to_bitmap(cands, Ip))
            m_padded = self.data_plane.m_padded
            task = TaskSpec(f"stream-validate-k{k}",
                            float(tile_rows.sum() * Ip * m_padded),
                            parallel=True, n_tiles=len(tiles),
                            family="stream-validate")

            def execute(_asg, _costs, tiles=tiles, m=len(cands),
                        m_pad=m_padded):
                t0 = time.perf_counter()
                if pipelined:   # in-place device accumulate, one sync/level
                    acc = self.slabs.take((m_pad,), torch.int32)
                    for t in tiles:
                        acc = donated_add(
                            acc, self.data_plane.tile_counts_device(t))
                    counts = meter.d2h(acc[:m], dtype=np.int64)
                    self.slabs.give(acc)
                else:
                    counts = np.zeros(m, dtype=np.int64)
                    for t in tiles:
                        counts += self.data_plane.tile_counts(t)
                return MeasuredPhase(result=counts,
                                     wall_s=time.perf_counter() - t0)

            counts, _ = self.runtime.run_phase(
                task, execute, tile_costs=tile_rows * Ip * m_padded,
                tile_flops=support_flops(tile_rows, Ip, m_padded))
            tracked.extend(cands)
            tracked_supp.extend(int(s) for s in counts)
            frequent = [c for c, s in zip(cands, counts) if s >= min_sup]
            k += 1

        self._tracked = tracked
        self._tracked_supp = np.array(tracked_supp, dtype=np.int64)
        self._levels = k - 1
        if tracked:
            self.data_plane.prepare(itemsets_to_bitmap(tracked, Ip))
        self._snapshot_lattice(min_sup)

    def _snapshot_lattice(self, min_sup: int) -> None:
        self._freq_items = frozenset(
            int(i) for i in np.nonzero(self._item_counts >= min_sup)[0])
        self._freq_tracked = frozenset(
            c for c, s in zip(self._tracked, self._tracked_supp)
            if s >= min_sup)

    def _lattice_stale(self, min_sup: int) -> bool:
        """True when a tracked itemset (or an item) crossed the frequency
        boundary — the only way the window's frequent set can differ from
        the last validation's (downward closure; see module docstring)."""
        if self._freq_items is None:
            return True
        freq_items = frozenset(
            int(i) for i in np.nonzero(self._item_counts >= min_sup)[0])
        if freq_items != self._freq_items:
            return True
        freq_tracked = frozenset(
            c for c, s in zip(self._tracked, self._tracked_supp)
            if s >= min_sup)
        return freq_tracked != self._freq_tracked

    # ------------------------------------------------------------------
    def _refresh_rules(self, report: BatchReport,
                       sup: Optional[Dict[Itemset, int]] = None) -> None:
        """Regenerate rules from the current supports and hot-swap the
        compiled index into the live engine (atomic ``refresh()``)."""
        cfg = self.config
        t0 = time.perf_counter()
        if sup is None:
            sup = self.supports
        state = (sup, self.window.n)
        if state == self._rules_state:      # supports did not move: no-op
            return
        rules, _ = self._run_serial(
            f"stream-rules-{self._batch_idx}",
            cost=max(1.0, len(sup) * cfg.serial_unit_cost),
            fn=lambda: generate_rules(
                AprioriResult(supports=sup, n_tx=self.window.n,
                              levels=self._levels),
                cfg.min_confidence, min_lift=cfg.min_lift))
        self._rules_state = state
        report.rules_refreshed = True
        if rules != self.rules or self.index is None:
            self.rules = rules
            version = (self.index.version + 1) if self.index else 0
            index, _ = self._run_serial(
                f"stream-refresh-{self._batch_idx}",
                cost=max(1.0, (len(rules) + 1) * cfg.serial_unit_cost),
                fn=lambda: RuleIndex.build(rules, self.n_items,
                                           version=version))
            if self.engine is not None:
                index = self.engine.refresh(index)
            self.index = index
            report.index_swapped = True
        report.refresh_latency_s = time.perf_counter() - t0
        report.n_rules = len(self.rules)
        report.index_version = self.index.version if self.index else 0

    # ------------------------------------------------------------------
    def process_batch(self, batch: np.ndarray) -> BatchReport:
        """Consume one micro-batch end to end; returns its BatchReport."""
        cfg = self.config
        t0 = time.perf_counter()
        ledger_mark = self.runtime.ledger.mark()
        sim_mark = self.runtime.ledger.total_time_s

        arrived, evicted = self.window.push(batch)
        report = BatchReport(idx=self._batch_idx,
                             n_arrived=int(arrived.shape[0]),
                             n_evicted=int(evicted.shape[0]),
                             window_n=self.window.n,
                             min_support=self.min_support_abs())
        self._delta_phase(arrived, evicted)

        min_sup = self.min_support_abs()
        due = (cfg.revalidate_every > 0
               and (self._batch_idx + 1) % cfg.revalidate_every == 0)
        stale, _ = self._run_serial(
            f"stream-check-{self._batch_idx}",
            cost=max(1.0, (len(self._tracked) + 1) * cfg.serial_unit_cost),
            fn=lambda: self._lattice_stale(min_sup))
        if stale or due:
            self._validate()
            report.revalidated = True

        sup = self.supports             # built once per batch (hot path)
        if (self._batch_idx % max(cfg.refresh_every, 1) == 0
                or report.revalidated):
            self._refresh_rules(report, sup)
        report.n_frequent = len(sup)
        report.n_rules = len(self.rules)
        report.index_version = self.index.version if self.index else 0

        report.n_phases = self.runtime.ledger.mark() - ledger_mark
        report.time_s = self.runtime.ledger.total_time_s - sim_mark
        report.wall_s = time.perf_counter() - t0
        self._wall_s += report.wall_s
        self._batches.append(report)
        self._batch_idx += 1
        return report

    # ------------------------------------------------------------------
    def flush(self) -> None:
        """Force a rules/index refresh if supports moved since the last
        one (closes a ``refresh_every`` gap at end of stream)."""
        if not self._batches:
            return
        report = self._batches[-1]
        # flush-time phases are charged to the last batch so the per-batch
        # phase counts still sum to the ledger slice exactly
        ledger_mark = self.runtime.ledger.mark()
        sim_mark = self.runtime.ledger.total_time_s
        t0 = time.perf_counter()
        self._refresh_rules(report)
        report.n_phases += self.runtime.ledger.mark() - ledger_mark
        report.time_s += self.runtime.ledger.total_time_s - sim_mark
        wall = time.perf_counter() - t0
        report.wall_s += wall
        self._wall_s += wall
        report.n_rules = len(self.rules)
        report.index_version = self.index.version if self.index else 0

    def take_report(self) -> StreamingReport:
        """Slice this miner's accumulated accounting into a report (and
        reset it, mirroring the other planes' per-run ledger slices)."""
        report = StreamingReport(
            backend=self.data_plane.backend, policy=self.runtime.policy.name,
            split=self.runtime.split, window=self.config.window,
            batch_size=self.config.batch_size, n_items=self.n_items,
            batches=self._batches, wall_time_s=self._wall_s,
            ledger=self.runtime.ledger.take_since(0))
        self._batches = []
        self._wall_s = 0.0
        return report

    def run(self, stream, max_batches: Optional[int] = None
            ) -> StreamingReport:
        """Consume a stream (any iterable of row slabs), flush, report."""
        for i, batch in enumerate(stream):
            if max_batches is not None and i >= max_batches:
                break
            self.process_batch(batch)
        self.flush()
        return self.take_report()
