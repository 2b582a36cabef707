"""AsyncServer — continuous-batching open-loop serving (MaxText pattern).

The closed-loop ``RecommendationEngine.serve(list_of_queries)`` sweep
measures batch throughput; it cannot measure what concurrent users
experience, because a live caller holds one request, not the trace.  This
module rebuilds the serving plane around an *open* request loop:

  submit(query) ──▶ RequestQueue (thread-safe, FIFO, arrival-gated)
                        │
        drain loop:     ▼
          slot-based admission — up to ``slots`` arrived requests are
          taken; a partial batch runs on the smallest covering bucket of
          the warmed :class:`~repro_torch.serving.admission.BucketLadder`
          (coalescing: no request ever waits for a full batch)
                        │
          SLO governor — with ``slo_ms`` set, requests whose projected
          completion (queue delay + EWMA of measured step walls) misses
          the budget are shed at admission, as first-class ``kind="shed"``
          ledger phases
                        │
          admission (serial phase) + batched scoring (map phase) on the
          shared Runtime — identical accounting to every other plane,
          with measured step walls fed back to the switching policy
                        ▼
  Handle._finish ──▶ poll(handle) / drain() / Handle.result()

Two drive modes share the loop body:

* **inline / virtual clock** (default) — deterministic: ``poll``/``drain``
  advance the loop on the simulated axis; the closed-loop ``serve()``
  shim replays a trace through exactly this path, which is why it stays
  bit-identical to the pre-redesign engine.
* **threaded / wall clock** — ``start()`` spawns the background
  result-drain thread; ``submit`` is then safe from any thread and
  latencies are host wall seconds.

Scoring a query is row-independent (each basket's top-k never depends on
its batch neighbors), so async results are bit-identical to the
closed-loop oracle no matter how arrivals happen to batch — the property
``tests/test_torch_serving.py`` pins under both switching policies.
"""
from __future__ import annotations

import threading
import time
from collections.abc import Mapping
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

import numpy as np

from repro_torch.core.scheduler import TaskSpec
from repro_torch.runtime import ExecLedger, LedgerTotals, MeasuredPhase
from repro_torch.serving.admission import (BucketLadder, Handle, Query,
                                           RequestQueue, SloGovernor,
                                           VirtualClock, WallClock)
from repro_torch.serving.cache import Recommendation, basket_key


@dataclass
class StepStats:
    """One drain-loop iteration (admission + scoring or a shed-only step)."""

    t_start: float
    t_done: float
    bucket: int = 0                 # 0 = shed-only step (nothing scored)
    batch_n: int = 0
    n_hits: int = 0
    n_misses: int = 0
    n_shed: int = 0


@dataclass
class AsyncServingReport(LedgerTotals):
    """Open-loop serving accounting: what sustained load actually costs.

    The async twin of ``ServingReport`` and a
    :class:`repro_torch.runtime.PlaneReport`: the ledger slice is the
    source of truth for time/energy/switches; on top of it sit the
    open-loop numbers a closed-loop sweep cannot produce — sustained QPS
    over the arrival span, latency percentiles *under load*, shed count
    and slot occupancy.
    """

    backend: str = "ref"
    policy: str = "static"
    k: int = 0
    clock: str = "sim"              # latency domain: sim | wall
    slots: int = 0
    buckets: tuple = ()
    n_submitted: int = 0
    n_completed: int = 0
    n_shed: int = 0
    n_steps: int = 0
    bucket_counts: Dict[int, int] = field(default_factory=dict)
    slot_occupancy: float = 0.0     # mean admitted / slots per scoring step
    batch_fill: float = 0.0         # mean admitted / bucket per scoring step
    cache_hits: int = 0
    cache_misses: int = 0
    warm_wall_s: float = 0.0        # ladder warmup (paid once, upfront)
    span_s: float = 0.0             # first arrival -> last completion
    p50_latency_s: float = 0.0
    p99_latency_s: float = 0.0
    wall_time_s: float = 0.0
    index_version: int = 0
    constraint_flags: int = 0
    ledger: Optional[ExecLedger] = None

    @property
    def sustained_qps(self) -> float:
        """Completed requests per second over the open-loop span."""
        return self.n_completed / self.span_s if self.span_s > 0 else 0.0

    @property
    def shed_rate(self) -> float:
        return self.n_shed / self.n_submitted if self.n_submitted else 0.0

    @property
    def hit_rate(self) -> float:
        total = self.cache_hits + self.cache_misses
        return self.cache_hits / total if total else 0.0

    def summary(self) -> str:
        buckets = "/".join(f"{b}:{c}" for b, c in
                           sorted(self.bucket_counts.items()))
        text = (
            f"AsyncServer: backend={self.backend} policy={self.policy} "
            f"k={self.k} clock={self.clock} slots={self.slots} "
            f"ladder={list(self.buckets)} index v{self.index_version}\n"
            f"  {self.n_completed}/{self.n_submitted} served "
            f"(+{self.n_shed} shed) in {self.n_steps} steps "
            f"(buckets {buckets or '-'}, fill {self.batch_fill:.2f}, "
            f"slot occupancy {self.slot_occupancy:.2f}) | cache "
            f"{self.cache_hits} hit / {self.cache_misses} miss "
            f"({self.hit_rate:.0%})\n"
            f"  sustained {self.sustained_qps:.1f} QPS over "
            f"{self.span_s:.4f}s (p50 {self.p50_latency_s:.4f}s, "
            f"p99 {self.p99_latency_s:.4f}s under load) | "
            f"{self.total_energy_j:.1f} J, {self.total_switches} core "
            f"switches | warmup {self.warm_wall_s:.3f}s, "
            f"wall {self.wall_time_s:.3f}s")
        if self.n_shed:
            text += (f"\n  SLO: shed {self.n_shed} request(s) "
                     f"({self.shed_rate:.1%}) at admission")
        if self.constraint_flags:
            text += (f"\n  WARNING: {self.constraint_flags} admission "
                     f"phase(s) ran on a core below their min_speed")
        return text


class AsyncServer:
    """Open request loop over a ``RecommendationEngine``'s data plane.

    The server owns admission; the engine contributes the compiled index,
    the result cache and the shared
    :class:`~repro_torch.runtime.Runtime`.  One engine may back one live
    server plus any number of transient replay sessions (the ``serve()``
    shim) — they serialize on the engine's single-threaded runtime, which
    only the drain side ever touches.
    """

    def __init__(self, engine, *, slots: Optional[int] = None,
                 slo_ms: Optional[float] = None,
                 coalesce_wait_s: Optional[float] = None,
                 clock: Union[VirtualClock, WallClock, None] = None,
                 warm: bool = True, name: str = "serve"):
        cfg = engine.config
        self.engine = engine
        self.name = name
        self.ladder = BucketLadder(engine._buckets)
        slots = cfg.slots if slots is None else slots
        if slots is None:
            slots = self.ladder.max_bucket
        if not 0 < slots <= self.ladder.max_bucket:
            raise ValueError(f"slots={slots} must be in [1, max bucket="
                             f"{self.ladder.max_bucket}]")
        self.slots = int(slots)
        slo_ms = cfg.slo_ms if slo_ms is None else slo_ms
        self.governor = SloGovernor(slo_ms / 1e3, self.ladder)
        self.coalesce_wait_s = (cfg.coalesce_wait_s if coalesce_wait_s is None
                                else coalesce_wait_s)
        self.clock = clock or VirtualClock()
        self.queue = RequestQueue()
        self._handles: List[Handle] = []      # submission order
        self._drained_upto = 0                # drain() exactly-once cursor
        self._steps: List[StepStats] = []
        self._rid = 0
        self._n_steps_taken = 0               # report-slice cursor
        self._hits0 = engine.cache.hits
        self._misses0 = engine.cache.misses
        self._ledger = ExecLedger()           # harvested per step
        self._warm_version = -1
        self.warm_wall_s = 0.0
        self._submit_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._wall0 = time.perf_counter()
        if warm:
            self._warm_ladder()

    # ------------------------------------------------------------------
    # bucket ladder warmup
    # ------------------------------------------------------------------
    def _warm_ladder(self) -> None:
        """Warm every rung before the first request.

        One zero-basket execution per bucket pays each batch shape's
        first-run costs (on the card: loading the kernel library, sizing
        the allocator's blocks), so the open loop never pays them
        mid-traffic.  Re-runs when the engine's index is refreshed (the
        shapes may have changed)."""
        eng = self.engine
        zero = np.zeros(eng.index.n_items, dtype=np.uint8)
        self.warm_wall_s += self.ladder.warm(
            lambda b: eng._score_batch([zero], b), time.perf_counter)
        self._warm_version = eng.index.version

    # ------------------------------------------------------------------
    # the submit / poll / drain surface
    # ------------------------------------------------------------------
    def submit(self, query, arrival_s: Optional[float] = None) -> Handle:
        """Enqueue one request; returns its :class:`Handle` immediately.

        Accepts :class:`Query` objects and ``{"items": ...}`` dicts.
        ``arrival_s`` defaults to the server clock's *now* (live
        traffic); replay callers pass explicit non-decreasing arrivals.
        Validation (id range, bitmap form) happens here, so a malformed
        request fails its caller at submit instead of poisoning the
        drain loop."""
        if not isinstance(query, (Query, Mapping)):
            raise TypeError(
                f"submit()/serve() take Query objects or dicts, not bare "
                f"{type(query).__name__} payloads — wrap the basket with "
                f"Query.of(...)")
        q = Query.of(query, arrival_s=arrival_s)
        bits = self.engine._as_bits(q.payload)
        with self._submit_lock:
            rid = q.rid if q.rid is not None else self._rid
            self._rid = max(self._rid, rid) + 1
            arrival = q.arrival_s
            if arrival is None:
                arrival = self.clock.now()
            handle = Handle(rid=rid, query=q, arrival_s=float(arrival),
                            bits=bits, key=basket_key(bits))
            self._handles.append(handle)
        self.queue.append(handle)
        return handle

    def poll(self, handle: Handle) -> Optional[Recommendation]:
        """Non-destructive progress check: the result when done, else None.

        On an inline (non-threaded) server, polling drives the loop until
        the handle resolves or the queue runs dry.  Raises
        :class:`ShedError` for a shed request — a dropped request must
        never read as "still computing"."""
        while not handle.done() and self._thread is None:
            if not self.step():
                break
        if handle.status == "shed":
            handle.result()                   # raises ShedError
        return handle._result if handle.done() else None

    def drain(self, timeout: Optional[float] = None) -> List[Handle]:
        """Deliver every outstanding request exactly once.

        Runs the loop to completion (inline) or waits for the drain
        thread (threaded, bounded by ``timeout`` per request), then
        returns the handles completed since the previous ``drain()`` in
        submission order.  Every submitted request appears in exactly one
        drain's return — the exactly-once delivery contract."""
        if self._thread is None:
            while self.step():
                pass
        else:
            for h in self._handles[self._drained_upto:]:
                h._event.wait(timeout)
        out = [h for h in self._handles[self._drained_upto:] if h.done()]
        self._drained_upto += len(out)
        return out

    # ------------------------------------------------------------------
    # the drain loop body
    # ------------------------------------------------------------------
    def step(self) -> bool:
        """One admission+scoring iteration; False when there is no work.

        Virtual clock: jumps to the next arrival when idle, then advances
        by the modeled admission + scoring time.  Wall clock: processes
        whatever has arrived by now."""
        nxt = self.queue.next_arrival()
        if nxt is None:
            return False
        now = self.clock.now()
        if now < nxt:
            if self.clock.domain != "sim":
                return False          # live mode: the future stays future
            now = self.clock.advance(nxt)
        ready = self.queue.take_ready(now, self.slots)
        if not ready:
            return False
        eng = self.engine
        if self._warm_version != eng.index.version:
            self._warm_ladder()       # index refresh invalidated the rungs

        admit, shed = self.governor.split(now, ready)
        rt = eng.runtime
        mark = rt.ledger.mark()
        step_i = len(self._steps)
        sim = self.clock.domain == "sim"
        t = now                       # simulated-axis step time
        if shed:
            # triage is real serial work: one phase covering this step's
            # rejects, priced through the scheduler like any admission
            _, rec = rt.run_serial(
                f"{self.name}-shed-{step_i}",
                cost=max(1.0, len(shed) * eng.config.admission_unit_cost),
                min_speed=eng.config.admission_min_speed, kind="shed")
            t += rec.sim_time_s
            # completion instants live in the clock's own domain: the
            # modeled axis when simulating, host wall when live
            t_shed = t if sim else self.clock.now()
            for h in shed:
                h._finish("shed", None, t_shed)

        stats = StepStats(t_start=now, t_done=t, n_shed=len(shed))
        if admit:
            t_wall0 = time.perf_counter()
            bucket = self.ladder.pick(len(admit))
            miss: List[Handle] = []
            hits = 0
            for h in admit:
                cached = eng.cache.get(h.key)
                if cached is not None:
                    h._result = cached        # finished below at t_done
                    hits += 1
                else:
                    miss.append(h)

            # serial admission/dispatch: best core runs, the rest gate off
            _, adm = rt.run_serial(
                f"{self.name}-admit-{step_i}",
                cost=max(1.0, bucket * eng.config.admission_unit_cost),
                min_speed=eng.config.admission_min_speed)
            t += adm.sim_time_s

            if miss:
                per_query_cost = (eng.config.score_unit_cost
                                  * eng.index.n_rows_padded
                                  * eng.index.n_items_padded)
                task = TaskSpec(f"{self.name}-score-{step_i}",
                                cost=bucket * per_query_cost, parallel=True,
                                n_tiles=bucket, family="serve-score")

                def execute(_asg, _costs, rows=miss, b=bucket):
                    t0 = time.perf_counter()
                    recs = eng._score_batch([h.bits for h in rows], b)
                    # measured step wall -> policy feedback + SLO EWMA
                    return MeasuredPhase(result=recs,
                                         wall_s=time.perf_counter() - t0)

                # each core spun up away from the admission core is a switch
                recs, score_rec = rt.run_phase(task, execute,
                                               spinup_from=adm.device)
                t += score_rec.sim_time_s
                for h, rec in zip(miss, recs):
                    h._result = rec
                    eng.cache.put(h.key, rec)

            t_done = t if sim else self.clock.now()
            for h in admit:
                h._finish("done", h._result, t_done)
            # the governor projects from what steps actually took, in the
            # clock's own domain (sim seconds or measured wall)
            self.ladder.observe(bucket, (t - now) if sim
                                else time.perf_counter() - t_wall0)
            stats.bucket = bucket
            stats.batch_n = len(admit)
            stats.n_hits = hits
            stats.n_misses = len(miss)
            stats.t_done = t_done

        self.clock.advance(t)
        for rec in rt.ledger.take_since(mark).phases:
            self._ledger.add(rec)     # harvest into this server's slice
        self._steps.append(stats)
        return True

    # ------------------------------------------------------------------
    # background result-drain thread (live mode)
    # ------------------------------------------------------------------
    def start(self) -> "AsyncServer":
        """Spawn the background drain thread (wall-clock live mode)."""
        if self._thread is not None:
            raise RuntimeError("drain thread already running")
        if self.clock.domain == "sim":
            self.clock = WallClock()
        self._stop.clear()
        self._thread = threading.Thread(target=self._drain_loop,
                                        name=f"{self.name}-drain",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the drain thread after it finishes the current step."""
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join()
        self._thread = None

    def _drain_loop(self) -> None:
        while not self._stop.is_set():
            if not self.queue.wait_nonempty(timeout=0.02):
                continue
            # bounded coalescing wait: let a concurrent burst fill the
            # slots, but never make a lone request wait for a full bucket
            if self.coalesce_wait_s > 0 and len(self.queue) < self.slots:
                self.queue.wait_depth(self.slots, self.coalesce_wait_s)
            self.step()

    def __enter__(self) -> "AsyncServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------------
    # reporting
    # ------------------------------------------------------------------
    def take_report(self) -> AsyncServingReport:
        """Report over everything since the previous ``take_report()``.

        Takes ownership of the accumulated ledger slice and step stats
        (the long-lived server would otherwise grow without bound — same
        contract as ``ExecLedger.take_since``)."""
        eng = self.engine
        steps = self._steps[self._n_steps_taken:]
        self._n_steps_taken = len(self._steps)
        done = [h for h in self._handles if h.status == "done"]
        shed = [h for h in self._handles if h.status == "shed"]
        report = AsyncServingReport(
            backend=eng.backend, policy=eng.runtime.policy.name,
            k=eng.config.k, clock=self.clock.domain, slots=self.slots,
            buckets=self.ladder.buckets,
            n_submitted=len(self._handles), n_completed=len(done),
            n_shed=len(shed), n_steps=len(steps),
            warm_wall_s=self.warm_wall_s,
            index_version=eng.index.version,
            wall_time_s=time.perf_counter() - self._wall0)
        scored = [s for s in steps if s.batch_n]
        for s in scored:
            report.bucket_counts[s.bucket] = \
                report.bucket_counts.get(s.bucket, 0) + 1
        if scored:
            report.slot_occupancy = float(np.mean(
                [s.batch_n / self.slots for s in scored]))
            report.batch_fill = float(np.mean(
                [s.batch_n / s.bucket for s in scored]))
        report.cache_hits = eng.cache.hits - self._hits0
        report.cache_misses = eng.cache.misses - self._misses0
        self._hits0, self._misses0 = eng.cache.hits, eng.cache.misses
        finished = done + shed
        if finished:
            t0 = min(h.arrival_s for h in finished)
            t1 = max(h.done_s for h in finished)
            report.span_s = t1 - t0
        if done:
            lat = np.array([h.latency_s for h in done])
            report.p50_latency_s = float(np.percentile(lat, 50))
            report.p99_latency_s = float(np.percentile(lat, 99))
        report.ledger = self._ledger
        self._ledger = ExecLedger()
        report.constraint_flags = len(report.ledger.constraint_violations())
        return report
