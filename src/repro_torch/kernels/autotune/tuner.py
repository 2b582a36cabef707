"""The autotune sweep: measure every candidate config, verify it
bit-identical, cache the argmin.

Measurement discipline: the warm-up call is synced so that building and
loading a kernel never leaks into the first rep, then the config's cost
is the **median of >= 3 synced reps**.  On a CUDA tensor each rep is
timed by CUDA events around the call, with the card first spinning on
``torch.cuda._sleep`` so that the whole call is queued before it starts:
the events then time the call's kernels on the card, not the host's
enqueueing or a synchronise (10-20 µs, more than most of these kernels
take).  Elsewhere, or with a ``timer`` injected (tests script it), the
host clock times each rep around a synchronised call.

What a rep calls is what the ops wrappers call for that variant: the
packed kernels take their operands packed 32 items to a word, so the
``packed`` rep packs them (``pack_words``) and the ``mxu`` rep hands the
int8 kernels the bitmaps as they are.

Correctness discipline: a config may only win if its output is exactly
equal to the plain oracle's (int32 counts / float32 confidence-weighted
scores — both exact, so equality is bit-equality).  Mismatching configs
are recorded (``matched=False``) and excluded from the argmin.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.autotune.cache import (AutotuneCache, DeviceLike,
                                                device_kind)
from repro_torch.kernels.rule_match.fused import rule_scores_fused
from repro_torch.kernels.rule_match.kernel import rule_scores_int8
from repro_torch.kernels.rule_match.ref import rule_scores_ref
from repro_torch.kernels.support_count.fused import (pack_words,
                                                     support_count_packed)
from repro_torch.kernels.support_count.intersect import intersect_count_words
from repro_torch.kernels.support_count.kernel import support_count_int8
from repro_torch.kernels.support_count.ref import (intersect_count_ref,
                                                   support_count_ref)
from repro_torch.launch.tuning import kernel_candidates, seed_order

# clocks the card spins before each timed rep, so that the rep's launches
# are all queued before the first one starts (about 5 ms at 1,980 MHz),
# and the times a rep is taken again when the host was slower than that
QUEUE_SLEEP_CYCLES = 10_000_000
QUEUE_RETRIES = 3


@dataclass
class SweptConfig:
    config: Dict[str, Any]
    cost_us: float
    matched: bool                     # bit-identical to the oracle


@dataclass
class TuneResult:
    kernel: str
    shape: Tuple[int, ...]
    device: str
    best: Dict[str, Any]
    cost_us: float
    swept: List[SweptConfig] = field(default_factory=list)

    def summary(self) -> str:
        return (f"{self.kernel} {self.shape} [{self.device}]: "
                f"{self.best} @ {self.cost_us:.1f}us "
                f"({len(self.swept)} configs swept)")


# ---------------------------------------------------------------------------
# synthetic inputs + per-kernel runners (kernel entry points, not the ops
# wrappers — the tuner must pin the variant, not re-enter the resolver)
# ---------------------------------------------------------------------------

def make_inputs(kernel: str, shape: Tuple[int, ...], seed: int = 0,
                device: DeviceLike = "cpu") -> Dict[str, torch.Tensor]:
    """Padded synthetic inputs at the sweep shape, density matched to the
    planes (sparse transactions/baskets, 1-4 item candidates/antecedents,
    a tail of never-match padding rows on the serving side).  The numpy
    draws are the reference tuner's, in its order, so a (kernel, shape,
    seed) gives the reference's bytes; tid words travel as int32 bit
    patterns."""
    rng = np.random.default_rng(seed)
    if kernel == "intersect_count":
        # two random packed tid-slabs (every bit pattern is a legal
        # tid-list, so uniform uint32 words exercise the full popcount)
        m, w = shape
        bits = rng.integers(0, 2**32, size=(2, m, w), dtype=np.uint32)
        words = torch.from_numpy(bits.view(np.int32)).to(device)
        return {"A": words[0], "B": words[1]}
    n, m, i = shape
    X = (rng.random((n, i)) < 0.3).astype(np.int8)
    A = np.zeros((m, i), np.int8)
    for r in range(m):
        A[r, rng.choice(i, size=1 + r % 4, replace=False)] = 1
    if kernel == "support_count":
        sizes = A.astype(np.float32).sum(axis=1)[None, :]
        arrays = {"T": X, "C": A, "sizes": sizes}
    else:
        # rule_match: last eighth of the rows are index padding (sizes=-1)
        pad_from = m - max(m // 8, 1)
        sizes = A.astype(np.float32).sum(axis=1)
        conf = rng.random(m).astype(np.float32) * 0.9 + 0.1
        A[pad_from:] = 0
        sizes[pad_from:] = -1.0
        conf[pad_from:] = 0.0
        arrays = {"Q": X, "A": A, "sizes": sizes[None, :],
                  "conf": conf[None, :]}
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def run_config(kernel: str, config: Dict[str, Any],
               inputs: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One call of the config's kernel on ``inputs`` (its plain version
    on a CPU tensor); counts come back ``[1, M]`` int32 and scores
    ``[B, R]`` float32, as the oracle gives them."""
    variant = config["variant"]
    if kernel == "intersect_count":
        return intersect_count_words(inputs["A"], inputs["B"])[None, :]
    if kernel == "support_count":
        T, C = inputs["T"], inputs["C"]
        sizes = inputs["sizes"][0].to(torch.int32)
        if variant == "packed":
            out = support_count_packed(pack_words(T), pack_words(C), sizes)
        else:
            out = support_count_int8(T, C, sizes)
        return out[None, :]
    Q, A = inputs["Q"], inputs["A"]
    sizes, conf = inputs["sizes"][0], inputs["conf"][0]
    if variant == "packed":
        return rule_scores_fused(Q, A, sizes, conf)
    return rule_scores_int8(Q, A, sizes, conf)


def oracle(kernel: str, inputs: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The plain PyTorch answer (``ref.py``) in ``run_config``'s form."""
    if kernel == "intersect_count":
        return intersect_count_ref(inputs["A"], inputs["B"])[None, :]
    if kernel == "support_count":
        return support_count_ref(inputs["T"], inputs["C"])[None, :]
    return rule_scores_ref(inputs["Q"], inputs["A"], inputs["sizes"][0],
                           inputs["conf"][0])


# ---------------------------------------------------------------------------
# measurement + the sweep
# ---------------------------------------------------------------------------

def _sync(out: Any) -> None:
    if isinstance(out, torch.Tensor) and out.device.type == "cuda":
        torch.cuda.synchronize(out.device)


def _queued_seconds(fn: Callable[[], Any]) -> float:
    """One call of ``fn`` timed on the card by CUDA events, the card
    spinning first so that the call is queued whole before it starts;
    taken again (at most ``QUEUE_RETRIES`` times) when the host took
    longer to enqueue it than the card spun."""
    for _ in range(QUEUE_RETRIES + 1):
        spin, start, end = (torch.cuda.Event(enable_timing=True)
                            for _ in range(3))
        spin.record()
        torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
        start.record()
        t0 = time.perf_counter()
        fn()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        if enqueue_ms < spin.elapsed_time(start):
            return start.elapsed_time(end) * 1e-3
    raise RuntimeError(f"enqueueing one call took {enqueue_ms:.3f} ms, longer "
                       "than the card spun, every time: its time would "
                       "include host gaps")


def measure_us(fn: Callable[[], Any], reps: int = 3,
               timer: Optional[Callable[[], float]] = None) -> float:
    """Median µs over ``reps`` (at least 3) synced calls of ``fn``, after
    a synced warm-up.  A call that returns a CUDA tensor is timed on the
    card by CUDA events (the card queued ahead by a spin, see the module
    docstring) unless ``timer`` is given; otherwise ``timer`` (default
    ``time.perf_counter``) times it on the host."""
    reps = max(int(reps), 3)
    out = fn()                                  # build, load, warm
    _sync(out)
    walls = []
    if (timer is None and isinstance(out, torch.Tensor)
            and out.device.type == "cuda"):
        with torch.cuda.device(out.device):
            for _ in range(reps):
                walls.append(_queued_seconds(fn))
    else:
        timer = timer or time.perf_counter
        for _ in range(reps):
            t0 = timer()
            _sync(fn())
            walls.append(timer() - t0)
    return float(np.median(walls)) * 1e6


def tune(kernel: str, shape: Tuple[int, ...], *,
         configs: Optional[Sequence[Dict[str, Any]]] = None,
         max_configs: int = 0, reps: int = 3, seed: int = 0,
         timer: Optional[Callable[[], float]] = None,
         device: DeviceLike = "cuda") -> TuneResult:
    """Sweep one (kernel, shape) on ``device``: returns the measured
    argmin config.

    ``max_configs > 0`` truncates the roofline-ordered candidate list —
    the smoke mode still measures the config the seed model believes
    in.  Raises if *no* config reproduces the oracle (a correctness bug,
    not a tuning failure).
    """
    cands = list(configs) if configs is not None \
        else seed_order(kernel, shape, kernel_candidates(kernel, shape))
    if max_configs > 0:
        cands = cands[:max_configs]
    inputs = make_inputs(kernel, shape, seed=seed, device=device)
    want = oracle(kernel, inputs)

    swept: List[SweptConfig] = []
    for cfg in cands:
        out = run_config(kernel, cfg, inputs)
        matched = out.shape == want.shape and bool(torch.equal(out, want))
        cost = measure_us(
            lambda c=cfg: run_config(kernel, c, inputs),
            reps=reps, timer=timer) if matched else float("inf")
        swept.append(SweptConfig(config=dict(cfg), cost_us=cost,
                                 matched=matched))
    ok = [s for s in swept if s.matched]
    if not ok:
        raise RuntimeError(f"autotune {kernel} {shape}: no candidate "
                           f"matched the oracle ({len(swept)} swept)")
    best = min(ok, key=lambda s: s.cost_us)
    return TuneResult(kernel=kernel, shape=tuple(shape),
                      device=device_kind(device), best=best.config,
                      cost_us=best.cost_us, swept=swept)


# the dense mine's support-count rounds: a [3,128 x 1,024] tile of the
# 100,000 x 1,000 corpus against its k = 2 batch and later rounds
_ROUND_TILE, _ROUND_M = 3128, (2176, 256, 128)
# the streaming plane's delta slabs (1-8 rows pad to 8; 1,000-1,024 rows)
# against the stationary and the churning windows' tracked sets
_DELTA_N, _DELTA_M = (8, 1024), (256, 2432)
# serving: batches of 8 and 64 against the dense mine's index (896 rows)
# and a 16,384-rule index
_BUCKETS, _INDEX_R = (8, 64), (896, 16384)
# Eclat: a dense-corpus tile and its whole k = 2 slab (3,200 tid words),
# and a retail-scale k = 1 tile (2,816 words)
_INTERSECT = ((128, 3200), (2176, 3200), (640, 2816))


def standard_shapes(kernel: str, smoke: bool = False
                    ) -> List[Tuple[int, ...]]:
    """The sweep lattice: one shape per bucket the port's planes hit on
    the card at the scale ``chip_smoke.py`` drives them (items padded to
    1,024); nearest-bucket lookup covers the rest.  ``smoke`` shrinks to
    one tiny shape per kernel."""
    if kernel == "support_count":
        if smoke:
            return [(64, 128, 128)]
        return ([(_ROUND_TILE, m, 1024) for m in _ROUND_M]
                + [(n, m, 1024) for n in _DELTA_N for m in _DELTA_M])
    if kernel == "intersect_count":
        return [(128, 128)] if smoke else list(_INTERSECT)
    if smoke:
        return [(8, 128, 128)]
    return [(b, r, 1024) for b in _BUCKETS for r in _INDEX_R]


def tune_into(cache: AutotuneCache, kernel: str,
              shapes: Optional[Sequence[Tuple[int, ...]]] = None,
              log: Optional[Callable[[str], None]] = None,
              **tune_kwargs) -> List[TuneResult]:
    """Sweep a shape list into a cache (entries keyed per shape bucket)."""
    results = []
    for shape in shapes if shapes is not None else standard_shapes(kernel):
        res = tune(kernel, shape, **tune_kwargs)
        cache.put(kernel, res.shape, res.best, res.cost_us,
                  swept=[{"config": s.config, "cost_us":
                          (None if s.cost_us == float("inf")
                           else round(s.cost_us, 3)),
                          "matched": s.matched} for s in res.swept],
                  device=res.device)
        if log:
            log(res.summary())
        results.append(res)
    return results
