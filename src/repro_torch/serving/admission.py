"""Admission side of the async serving plane: requests, queue, ladder, SLO.

The continuous-batching loop (:mod:`repro_torch.serving.server`) is assembled
from the pieces here, each one small enough to unit-test with a scripted
clock:

  :class:`Query`        — a request with a *stable id*: accepts plain
                          item-id lists, dicts and bitmap rows
  :class:`Handle`       — the Future-style receipt ``submit()`` returns
  :class:`RequestQueue` — thread-safe FIFO with arrival-time gating
  :class:`BucketLadder` — the warmed-up batch-size ladder, plus
                          EWMA of *measured* step walls per bucket
  :class:`SloGovernor`  — projects each candidate's completion time from
                          the ladder's measured walls and sheds requests
                          that cannot meet the latency budget
  :class:`VirtualClock` / :class:`WallClock` — the two time domains: the
                          deterministic simulated axis every plane's
                          ledger uses, and host wall time for the
                          background drain thread

Admission states a request moves through (see docs/architecture.md):

  submitted ──▶ queued ──▶ admitted ──▶ scored ──▶ done
                   └──────▶ shed  (SLO governor, only when slo_ms is set)
"""
from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass
from typing import (Any, Dict, List, Mapping, Optional, Sequence, Tuple,
                    Union)

import numpy as np

from repro_torch.serving.cache import Recommendation


class ShedError(RuntimeError):
    """The SLO governor rejected this request at admission time."""


# ---------------------------------------------------------------------------
# requests
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Query:
    """One recommendation request with a stable request id.

    ``payload`` is the basket in any accepted form — a plain item-id
    sequence (``[3, 7]``), a 0/1 bitmap row over the item universe, or a
    dict ``{"items": [...], "id": ..., "arrival_s": ...}``.  The engine
    canonicalizes it exactly as before; ``Query`` adds identity (``rid``)
    and arrival time so a request can be tracked through the open loop.

    ``serve()``/``submit()`` accept only ``Query`` objects and dicts —
    the old positional form (a bare list/array straight to the server)
    was removed; wrap such payloads explicitly with :meth:`of`, which
    remains the one constructor for every accepted shape.
    """

    payload: Any
    rid: Optional[int] = None       # stable request id (server-assigned
    #                                 at submit when the caller sets none)
    arrival_s: Optional[float] = None

    @classmethod
    def of(cls, obj: Union["Query", Mapping, Sequence[int], np.ndarray],
           arrival_s: Optional[float] = None) -> "Query":
        """Coerce any accepted request form into a ``Query``."""
        if isinstance(obj, Query):
            if arrival_s is not None and obj.arrival_s is None:
                return Query(obj.payload, obj.rid, arrival_s)
            return obj
        if isinstance(obj, Mapping):
            extra = set(obj) - {"items", "id", "arrival_s"}
            if "items" not in obj or extra:
                raise ValueError(
                    f"dict queries need an 'items' key and allow only "
                    f"'id'/'arrival_s' besides it, got {sorted(obj)}")
            arr = obj.get("arrival_s", arrival_s)
            return cls(payload=obj["items"], rid=obj.get("id"),
                       arrival_s=arr)
        return cls(payload=obj, arrival_s=arrival_s)


class Handle:
    """Future-style receipt for one submitted request.

    ``status`` walks ``pending -> done | shed``; the terminal transition
    happens exactly once, on the server's drain loop.  ``result()`` blocks
    (threaded server) or raises if still pending (inline server — use
    ``server.poll(handle)``/``drain()`` to advance the loop first).
    """

    __slots__ = ("rid", "query", "arrival_s", "bits", "key", "status",
                 "done_s", "_result", "_event", "_delivered")

    def __init__(self, rid: int, query: Query, arrival_s: float,
                 bits: np.ndarray, key: bytes):
        self.rid = rid
        self.query = query
        self.arrival_s = arrival_s
        self.bits = bits            # canonical 0/1 vector (validated early)
        self.key = key              # cache key for the canonical basket
        self.status = "pending"
        self.done_s = 0.0           # completion instant on the server clock
        self._result: Optional[Recommendation] = None
        self._event = threading.Event()
        self._delivered = False     # consumed by drain() exactly once

    # -- server side ---------------------------------------------------
    def _finish(self, status: str, result: Optional[Recommendation],
                t_done: float) -> None:
        assert self.status == "pending", f"request {self.rid} finished twice"
        self._result = result
        self.done_s = t_done
        self.status = status
        self._event.set()

    # -- caller side ---------------------------------------------------
    def done(self) -> bool:
        return self.status != "pending"

    @property
    def latency_s(self) -> float:
        """Completion minus arrival on the server clock (0 while pending)."""
        return self.done_s - self.arrival_s if self.done() else 0.0

    def result(self, timeout: Optional[float] = None) -> Recommendation:
        if self.status == "pending" and timeout is not None:
            self._event.wait(timeout)
        if self.status == "shed":
            raise ShedError(f"request {self.rid} was shed by the SLO "
                            f"governor at t={self.done_s:.4f}s")
        if self.status != "done":
            raise RuntimeError(
                f"request {self.rid} is still pending — poll()/drain() the "
                f"server (inline mode) or pass a timeout (threaded mode)")
        return self._result


# ---------------------------------------------------------------------------
# queue
# ---------------------------------------------------------------------------

class RequestQueue:
    """Thread-safe FIFO of pending handles with arrival-time gating.

    Submission order is service order; ``take_ready`` pops the contiguous
    head whose arrival times are ``<= now`` (up to ``limit`` — the slot
    count), which is exactly the closed-loop engine's admission scan, so
    the replay shim and the live loop share one discipline.
    """

    def __init__(self):
        self._q: "deque[Handle]" = deque()
        self._cond = threading.Condition()

    def __len__(self) -> int:
        with self._cond:
            return len(self._q)

    def append(self, handle: Handle) -> None:
        with self._cond:
            self._q.append(handle)
            self._cond.notify_all()

    def next_arrival(self) -> Optional[float]:
        """Arrival instant of the FIFO head (None when empty)."""
        with self._cond:
            return self._q[0].arrival_s if self._q else None

    def take_ready(self, now: float, limit: int) -> List[Handle]:
        """Pop up to ``limit`` head requests whose arrival is ``<= now``."""
        out: List[Handle] = []
        with self._cond:
            while self._q and len(out) < limit \
                    and self._q[0].arrival_s <= now:
                out.append(self._q.popleft())
        return out

    def wait_nonempty(self, timeout: float) -> bool:
        """Block until the queue has work (or timeout); True when it has."""
        with self._cond:
            return self._cond.wait_for(lambda: bool(self._q), timeout)

    def wait_depth(self, depth: int, timeout: float) -> bool:
        """Coalescing wait: give concurrent arrivals a bounded chance to
        fill the batch; returns as soon as ``depth`` requests are queued.
        The bound is what guarantees no request waits for a full bucket."""
        with self._cond:
            return self._cond.wait_for(lambda: len(self._q) >= depth,
                                       timeout)


# ---------------------------------------------------------------------------
# the warmed bucket ladder
# ---------------------------------------------------------------------------

@dataclass
class BucketState:
    """Per-bucket executable + measurement state."""

    warm_wall_s: float = 0.0        # wall of the warmup execution (the
    #                                 first-run cost paid upfront)
    ewma_step_s: float = 0.0        # EWMA of measured step durations
    n_steps: int = 0


class BucketLadder:
    """The ladder of warmed-up batch buckets.

    ``warm()`` executes the scoring step once per bucket at startup so
    every rung's first-run costs (loading the kernel library, sizing the
    allocator's blocks) are paid before the first real request — no
    request ever pays them.  ``pick()`` coalesces: a partial batch runs on
    the smallest covering bucket instead of waiting to fill the largest.
    ``observe()`` keeps an EWMA of *measured* step durations per bucket —
    the SLO governor's projection source.
    """

    def __init__(self, buckets: Sequence[int], ewma_alpha: float = 0.3):
        if not buckets or any(b <= 0 for b in buckets):
            raise ValueError(f"buckets must be positive: {buckets}")
        if not 0.0 < ewma_alpha <= 1.0:
            raise ValueError(f"ewma_alpha must be in (0, 1]: {ewma_alpha}")
        self.buckets: Tuple[int, ...] = tuple(sorted(set(int(b)
                                                         for b in buckets)))
        self.alpha = ewma_alpha
        self.state: Dict[int, BucketState] = {b: BucketState()
                                              for b in self.buckets}
        self.warmed = False

    @property
    def max_bucket(self) -> int:
        return self.buckets[-1]

    def pick(self, batch_n: int) -> int:
        """Smallest bucket covering ``batch_n`` (bucket coalescing)."""
        if batch_n <= 0:
            raise ValueError(f"batch_n must be positive: {batch_n}")
        if batch_n > self.max_bucket:
            raise ValueError(f"batch of {batch_n} exceeds the ladder's "
                             f"largest bucket {self.max_bucket}")
        return next(b for b in self.buckets if b >= batch_n)

    def warm(self, step_fn, timer) -> float:
        """Warm every rung: ``step_fn(bucket)`` once per bucket.

        ``timer`` is a zero-arg wall-seconds callable (injectable for
        tests).  Returns the total warmup wall and marks the ladder warm.
        """
        total = 0.0
        for b in self.buckets:
            t0 = timer()
            step_fn(b)
            wall = timer() - t0
            self.state[b].warm_wall_s = wall
            total += wall
        self.warmed = True
        return total

    def observe(self, bucket: int, step_s: float) -> None:
        """Feed one measured step duration into the bucket's EWMA."""
        st = self.state[bucket]
        st.ewma_step_s = (step_s if st.n_steps == 0 else
                          self.alpha * step_s
                          + (1 - self.alpha) * st.ewma_step_s)
        st.n_steps += 1

    def projected_step_s(self, bucket: int) -> float:
        """Best estimate of one step on this bucket (0 = nothing measured
        yet — the governor admits until the loop has real measurements)."""
        st = self.state[bucket]
        if st.n_steps:
            return st.ewma_step_s
        # fall back to the nearest measured rung, scaled by bucket ratio
        for b in self.buckets:
            if self.state[b].n_steps:
                return self.state[b].ewma_step_s * (bucket / b)
        return 0.0


# ---------------------------------------------------------------------------
# SLO-aware admission
# ---------------------------------------------------------------------------

class SloGovernor:
    """Shed-or-admit decisions from measured step walls.

    For each candidate the projected completion is ``(now - arrival)`` —
    the queueing delay already incurred — plus one projected scoring step
    on the chosen bucket.  A projection past ``slo_s`` sheds the request
    *at admission* (fail fast beats missing the budget after burning a
    slot).  ``slo_s <= 0`` disables shedding; with no measurements yet the
    ladder projects 0 and everything is admitted — the governor only ever
    acts on evidence.
    """

    def __init__(self, slo_s: float, ladder: BucketLadder):
        self.slo_s = slo_s
        self.ladder = ladder
        self.n_shed = 0

    def split(self, now: float, ready: List[Handle]
              ) -> Tuple[List[Handle], List[Handle]]:
        """Partition admitted-vs-shed, preserving FIFO order."""
        if self.slo_s <= 0 or not ready:
            return ready, []
        bucket = self.ladder.pick(len(ready))
        step = self.ladder.projected_step_s(bucket)
        admit, shed = [], []
        for h in ready:
            if (now - h.arrival_s) + step > self.slo_s:
                shed.append(h)
            else:
                admit.append(h)
        self.n_shed += len(shed)
        return admit, shed


# ---------------------------------------------------------------------------
# clocks
# ---------------------------------------------------------------------------

class VirtualClock:
    """The deterministic simulated axis (same units as the phase ledger).

    The server advances it by each step's modeled admission + scoring
    time, so queueing delay and batching gain show up in the latency
    percentiles exactly as in the closed-loop engine — and scripted tests
    control time completely.
    """

    domain = "sim"

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance(self, t: float) -> float:
        """Move forward to ``t`` (never backwards)."""
        self._t = max(self._t, float(t))
        return self._t


class WallClock:
    """Host wall time, zeroed at construction (threaded server mode)."""

    domain = "wall"

    def __init__(self):
        import time
        self._perf = time.perf_counter
        self._t0 = self._perf()

    def now(self) -> float:
        return self._perf() - self._t0

    def advance(self, t: float) -> float:
        """Wall time advances itself; this is a no-op returning now()."""
        return self.now()
