"""Micro-batching recommendation engine — the query side of the paper.

The mining pipeline's framing (serial phases to the best core, parallel
phases tiled over the heterogeneity profile, power charged for gating and
core switches) applies unchanged to serving:

  requests ──admission queue──▶ fixed batch buckets (pad-to-bucket)
     │            └─ serial dispatch phase  → Runtime.run_serial
     ├─ result cache probe (LRU on the canonical basket bitmap)
     ├─ batched scoring of the misses       → Runtime.run_phase
     │  (rule_match: CUDA kernel on the card, plain scores on the CPU)
     ▼
  per-request top-k + ServingReport (QPS, p50/p99, batch fill, cache,
  energy, switches) — the serving twin of PipelineReport

Pad-to-bucket is the same shape discipline as the mining data plane's
candidate bucketing: every batch is rounded up to a fixed bucket size, so
the kernels see one launch shape per bucket, not one per traffic pattern.
The simulated clock advances by (admission serial time + scoring makespan)
per batch, so queueing delay, batching gain and the scheduler policy all
show up in the latency percentiles.

Scheduling/accounting run on the shared
:class:`repro_torch.runtime.Runtime`: each batch is one serial admission
phase plus one parallel scoring phase (every padded slot a schedulable
tile), and the report's energy/switch totals are read off the ledger
slice — the same semantics as the mining planes, including the spin-up
rule that every core activated away from the admission core is a core
switch.

There is one serving loop: the continuous-batching
:class:`~repro_torch.serving.server.AsyncServer`.
``submit``/``poll``/``drain`` expose it directly for open-loop traffic;
``serve(queries)`` is a compat shim that replays a closed trace through a
transient session on the same loop (virtual clock, slots = the largest
bucket, SLO off) — which is why its results, ledger slices and latency
percentiles are bit-identical to the reference package's engine.

Scoring runs on ``ServingConfig.device``: the card by default, the CPU
when the caller asks for it.  The index arrays are placed there once per
``refresh``; each batch uploads its query block once and reads its items
and scores back in one transfer.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.hetero import HeterogeneityProfile
from repro_torch.core.power import PowerModel
from repro_torch.core.scheduler import MBScheduler
from repro_torch.kernels.rule_match.ops import rule_topk
from repro_torch.kernels.autotune.cache import plane_tuning
from repro_torch.kernels.support_count.ops import check_tuning
from repro_torch.pipeline.dataplane import resolve_backend
from repro_torch.runtime import (ExecLedger, Runtime, SwitchingPolicy,
                                 autotuned_costmodel)
from repro_torch.runtime.policies import check_policy_name
from repro_torch.serving.admission import Handle, Query
from repro_torch.serving.cache import Recommendation, ResultCache
from repro_torch.serving.index import RuleIndex

# Any accepted request form: a Query object or a dict with an "items" key.
# Bare item-id sequences / bitmap rows must be wrapped through Query.of —
# the positional raw-basket form was removed from serve()/submit().
QueryLike = Union[Query, Dict]


@dataclass(frozen=True)
class ServingConfig:
    """Knobs for the online engine (mirrors PipelineConfig for mining)."""

    k: int = 5                      # recommendations per query
    batch_buckets: Tuple[int, ...] = (1, 8, 64)   # admission coalescing sizes
    data_plane: str = "auto"        # auto | cuda | ref
    # rule_match variant on the cuda data plane: {"variant": "packed"} or
    # {"variant": "mxu"} pins a kernel; None leaves it to autotune
    tuning: Optional[dict] = None
    # rule-match variant from the winner cache (and, under the costmodel
    # policy, its measured walls replace the data-sheet constants)
    autotune: bool = True
    # where scoring runs: the card unless the caller asks for "cpu"
    device: str = "cuda"
    cache_size: int = 4096          # LRU entries; 0 disables caching
    policy: str = "static"          # switching: static | dynamic | costmodel
    split: str = "lpt"              # tile split for the scoring phase
    power: str = "cpu"              # cpu | tpu_v5e | none
    # Work-unit cost model (same byte-flavored units as the mining phases):
    # admission charges per batch slot, scoring per slot scaled by index
    # size (each query is matched against every rule row).
    admission_unit_cost: float = 8.0
    score_unit_cost: float = 1.0 / 128.0
    # Required core speed for the serial admission phase: when no core
    # satisfies it, assign_serial falls back to the fastest core and flags
    # the phase (surfaced as ServingReport.constraint_violations).
    admission_min_speed: float = 0.0
    # Async serving (the submit/poll/drain surface and `recommend --async`):
    # slots bounds how many queued requests one drain-loop step admits
    # (None = the largest bucket); slo_ms > 0 arms the SLO governor, which
    # sheds requests whose projected completion misses the budget;
    # coalesce_wait_s bounds how long the threaded drain loop lets a burst
    # accumulate before scoring a partial batch (never strands a request).
    slots: Optional[int] = None
    slo_ms: float = 0.0
    coalesce_wait_s: float = 0.002

    def __post_init__(self):
        check_policy_name(self.policy)
        check_tuning(self.tuning, "rule_match")  # reject a bad pin early
        if (torch.device(self.device).type == "cuda"
                and not torch.cuda.is_available()):
            raise RuntimeError(
                f"ServingConfig(device={self.device!r}) but no CUDA device "
                "is available; pass device='cpu' to serve on the CPU")


@dataclass
class ServingReport:
    """Accounting for one ``serve()`` call (the serving PipelineReport)."""

    backend: str
    policy: str                     # switching policy name
    k: int
    split: str = "lpt"
    n_queries: int = 0
    n_batches: int = 0
    bucket_counts: Dict[int, int] = field(default_factory=dict)
    batch_fill: float = 0.0         # mean true-requests / bucket-size, <= 1
    cache_hits: int = 0
    cache_misses: int = 0
    sim_time_s: float = 0.0         # simulated clock at last completion
    wall_time_s: float = 0.0
    p50_latency_s: float = 0.0
    p99_latency_s: float = 0.0
    energy_j: float = 0.0
    switches: int = 0
    index_rows: int = 0
    index_version: int = 0
    constraint_violations: int = 0  # admission phases below their min_speed
    ledger: Optional[ExecLedger] = None   # this call's phase records

    # PlaneReport totals, read off the attached ledger slice.  Note
    # total_time_s sums phase time only; sim_time_s additionally spans the
    # arrival gaps the admission queue sat idle.
    @property
    def total_time_s(self) -> float:
        return self.ledger.total_time_s if self.ledger else 0.0

    @property
    def total_energy_j(self) -> float:
        return self.ledger.total_energy_j if self.ledger else 0.0

    @property
    def total_switches(self) -> int:
        return self.ledger.total_switches if self.ledger else 0

    @property
    def qps(self) -> float:
        """Simulated queries/second (work-unit clock, policy-sensitive)."""
        return self.n_queries / self.sim_time_s if self.sim_time_s > 0 else 0.0

    @property
    def wall_qps(self) -> float:
        return (self.n_queries / self.wall_time_s
                if self.wall_time_s > 0 else 0.0)

    @property
    def hit_rate(self) -> float:
        total = self.cache_hits + self.cache_misses
        return self.cache_hits / total if total else 0.0

    def summary(self) -> str:
        buckets = "/".join(f"{b}:{c}" for b, c in
                           sorted(self.bucket_counts.items()))
        text = (
            f"RecommendationEngine: backend={self.backend} "
            f"policy={self.policy} split={self.split} k={self.k} "
            f"index_rows={self.index_rows} v{self.index_version}\n"
            f"  {self.n_queries} queries in {self.n_batches} batches "
            f"(buckets {buckets}, fill {self.batch_fill:.2f}) | cache "
            f"{self.cache_hits} hit / {self.cache_misses} miss "
            f"({self.hit_rate:.0%})\n"
            f"  simulated {self.sim_time_s:.4f}s = {self.qps:.1f} QPS "
            f"(p50 {self.p50_latency_s:.4f}s, p99 {self.p99_latency_s:.4f}s) "
            f"| {self.energy_j:.1f} J, {self.switches} core switches | "
            f"wall {self.wall_time_s:.3f}s = {self.wall_qps:.0f} QPS")
        if self.constraint_violations:
            text += (f"\n  WARNING: {self.constraint_violations} admission "
                     f"phase(s) ran on a core below their min_speed")
        return text


class RecommendationEngine:
    """Serves "given this basket, which items next?" from a compiled index."""

    def __init__(self, index: RuleIndex,
                 profile: Optional[HeterogeneityProfile] = None,
                 config: Optional[ServingConfig] = None,
                 scheduler: Optional[MBScheduler] = None,
                 power: Optional[PowerModel] = None,
                 policy: Union[str, SwitchingPolicy, None] = None):
        self.config = config or ServingConfig()
        cfg = self.config
        if not cfg.batch_buckets or any(b <= 0 for b in cfg.batch_buckets):
            raise ValueError(f"batch_buckets must be positive: "
                             f"{cfg.batch_buckets}")
        self._buckets = tuple(sorted(set(int(b) for b in cfg.batch_buckets)))
        if not 0 < cfg.k <= index.n_items:
            raise ValueError(f"k={cfg.k} must be in [1, n_items="
                             f"{index.n_items}]")
        self.profile = profile or HeterogeneityProfile.paper()
        policy = policy if policy is not None else cfg.policy
        if policy == "costmodel" and cfg.autotune:
            # measured rule-match walls replace the data-sheet constants
            policy = autotuned_costmodel("rule_match", device=cfg.device)
        self.runtime = Runtime(
            self.profile,
            policy=policy,
            split=cfg.split,
            power=power if power is not None else cfg.power,
            scheduler=scheduler)
        self.scheduler = self.runtime.scheduler
        self.power = self.runtime.power
        self.device = torch.device(cfg.device)
        self.backend = resolve_backend(cfg.data_plane, self.device)
        self.cache = ResultCache(cfg.cache_size)
        self._server = None           # persistent AsyncServer, built lazily
        self.index: RuleIndex = None  # set by refresh()
        self.refresh(index)

    # ------------------------------------------------------------------
    def refresh(self, index: RuleIndex) -> RuleIndex:
        """Atomically swap in a (re)built index and invalidate the cache.

        The version is bumped past the live index's if the new build does
        not already exceed it, so cache generations are totally ordered.
        """
        if self.index is not None and index.version <= self.index.version:
            index = dataclasses.replace(index,
                                        version=self.index.version + 1)
        # device-resident once: every batch reuses these arrays
        self._dev = {f: torch.from_numpy(getattr(index, f)).to(self.device)
                     for f in ("ante", "sizes", "conf", "cons")}
        self.index = index          # single assignment = the atomic swap
        self.cache.clear()
        return index

    # ------------------------------------------------------------------
    def _as_bits(self, query: QueryLike) -> np.ndarray:
        """Canonical 0/1 vector over the true item universe.

        Array inputs (numpy rows, torch tensors on any device) of full
        basket length are bitmaps;
        Python sequences (list/tuple/set) are always item-id collections —
        a list of 0/1 values is NOT treated as a bitmap, since a two-item
        basket [0, 1] would be indistinguishable from one.  ``Query``
        objects and ``{"items": ...}`` dicts are unwrapped first.
        """
        if isinstance(query, (Query, dict)):
            query = Query.of(query).payload
        n_items = self.index.n_items
        if isinstance(query, torch.Tensor):
            query = query.detach().cpu().numpy()   # device -> host bitmap
        if not isinstance(query, (list, tuple, set, frozenset, range)):
            query = np.asarray(query)
        if isinstance(query, np.ndarray) and query.ndim == 1 and \
                query.shape[0] in (n_items, self.index.n_items_padded):
            if query.size and not ((query == 0) | (query == 1)).all():
                raise ValueError("bitmap queries must contain only 0/1")
            if query[n_items:].any():
                raise ValueError(f"bitmap query sets items beyond the index "
                                 f"universe [0, {n_items})")
            return query[:n_items].astype(np.uint8)
        bits = np.zeros(n_items, dtype=np.uint8)
        ids = list(query)
        if ids:
            idx = np.asarray(ids, dtype=np.int64)
            if idx.min() < 0 or idx.max() >= n_items:
                raise ValueError(f"query item ids must be in [0, {n_items})")
            bits[idx] = 1
        return bits

    def _score_batch(self, rows: List[np.ndarray],
                     bucket: int) -> List[Recommendation]:
        """Run the rule-match data plane on a pad-to-bucket query block:
        built on the host, uploaded once, items and scores read back in
        one transfer."""
        cfg = self.config
        Q = np.zeros((bucket, self.index.n_items_padded), dtype=np.uint8)
        for r, bits in enumerate(rows):
            Q[r, :self.index.n_items] = bits
        items, scores = rule_topk(
            torch.from_numpy(Q).to(self.device), self._dev["ante"],
            self._dev["sizes"], self._dev["conf"], self._dev["cons"],
            k=cfg.k, n_items=self.index.n_items, backend=self.backend,
            tuning=plane_tuning(cfg.tuning, cfg.autotune))
        both = torch.stack([items, scores.view(torch.int32)]).cpu().numpy()
        items, scores = both[0], both[1].view(np.float32)
        return [[(int(i), float(s)) for i, s in zip(items[r], scores[r])
                 if s > 0.0] for r in range(len(rows))]

    # ------------------------------------------------------------------
    # the async surface: submit / poll / drain on a persistent open loop
    # ------------------------------------------------------------------
    @property
    def server(self):
        """The engine's persistent
        :class:`~repro_torch.serving.server.AsyncServer`.

        Created lazily in inline virtual-clock mode (``poll``/``drain``
        advance the loop deterministically); call ``.start()`` on it — or
        use it as a context manager — for threaded wall-clock serving.
        """
        if self._server is None:
            from repro_torch.serving.server import AsyncServer
            self._server = AsyncServer(self)
        return self._server

    def submit(self, query: QueryLike,
               arrival_s: Optional[float] = None) -> Handle:
        """Enqueue one request on the open loop; returns its Handle."""
        return self.server.submit(query, arrival_s=arrival_s)

    def poll(self, handle: Handle) -> Optional[Recommendation]:
        """Progress the open loop; the handle's result when done, else None."""
        return self.server.poll(handle)

    def drain(self, timeout: Optional[float] = None) -> List[Handle]:
        """Run the open loop dry; handles completed since the last drain."""
        return self.server.drain(timeout=timeout)

    # ------------------------------------------------------------------
    # the closed-loop surface (a replay session on the same loop)
    # ------------------------------------------------------------------
    def recommend(self, query: QueryLike) -> Recommendation:
        """Single-query convenience path (cached, batch of one)."""
        results, _ = self.serve([query])
        return results[0]

    def serve(self, queries: Sequence[QueryLike],
              arrival_s: Optional[Sequence[float]] = None
              ) -> Tuple[List[Recommendation], ServingReport]:
        """Replay a query trace through the admission queue.

        arrival_s (optional, non-decreasing, simulated seconds) drives the
        queueing model; default is all-at-once.  Returns per-request top-k
        recommendations (input order) and the ServingReport.

        Compat shim: the trace runs through a transient
        :class:`~repro_torch.serving.server.AsyncServer` session (virtual
        clock, slots = largest bucket, SLO governor off, no warmup) whose step
        semantics match the original closed loop exactly — per-row scoring
        is batch-independent, so results and accounting are bit-identical.
        """
        cfg = self.config
        rt = self.runtime
        t_wall = time.perf_counter()
        # a run that raised mid-way (invariant check, scoring error) leaves
        # orphaned records; this plane owns its runtime, so anything still
        # live belongs to no report — drop it before marking
        rt.ledger.take_since(0)
        n = len(queries)
        if arrival_s is None:
            arrival = np.zeros(n)
        else:
            arrival = np.asarray(arrival_s, dtype=np.float64)
            if arrival.shape != (n,):
                raise ValueError(f"arrival_s must have one entry per query: "
                                 f"{arrival.shape} vs {n}")
            if n and (np.diff(arrival) < 0).any():
                raise ValueError("arrival_s must be non-decreasing")

        from repro_torch.serving.server import AsyncServer
        session = AsyncServer(self, slots=self._buckets[-1], slo_ms=0.0,
                              coalesce_wait_s=0.0, warm=False)
        # submit everything up front (validation happens here, before any
        # phase runs — same all-or-nothing contract as the original loop),
        # then run the session dry on the virtual clock
        handles = [session.submit(q, arrival_s=float(arrival[j]))
                   for j, q in enumerate(queries)]
        session.drain()
        arep = session.take_report()

        results = [h.result() for h in handles]
        report = ServingReport(
            backend=self.backend, policy=rt.policy.name, split=rt.split,
            k=cfg.k, n_queries=n, index_rows=self.index.n_rows,
            index_version=self.index.version, n_batches=arep.n_steps,
            bucket_counts=dict(arep.bucket_counts),
            batch_fill=arep.batch_fill, cache_hits=arep.cache_hits,
            cache_misses=arep.cache_misses,
            sim_time_s=session.clock.now(), ledger=arep.ledger)
        report.energy_j = report.ledger.total_energy_j
        report.switches = report.ledger.total_switches
        report.constraint_violations = \
            len(report.ledger.constraint_violations())
        if n:
            latencies = np.array([h.latency_s for h in handles])
            report.p50_latency_s = float(np.percentile(latencies, 50))
            report.p99_latency_s = float(np.percentile(latencies, 99))
        report.wall_time_s = time.perf_counter() - t_wall
        return results, report
