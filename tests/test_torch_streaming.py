"""The port's streaming plane, held against the reference's.

Mirrors ``tests/test_streaming.py`` case for case, and the two streaming
cases of ``tests/test_system.py`` (the closed loop under ``dynamic`` and
the min-speed violation): the same seeded corpora go through
``repro.streaming`` (data plane ``ref``) and ``repro_torch.streaming``
(``device="cpu"``) batch by batch.  After every batch the window's bytes,
the item counts, the tracked set and its supports, the supports, the
rules, the rule index (arrays and version) and every ledger field but the
host time must be equal — phase names, kinds, policies, simulated time,
energy, switches, syncs and bytes — and so must the ``BatchReport``s,
bar their host walls.  ``python -m repro_torch.launch.stream --smoke
--device cpu`` runs in a subprocess and must print what the reference's
smoke prints.
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.itemsets import itemsets_to_bitmap  # noqa: E402
from repro.data.baskets import BasketConfig as RefBasketConfig  # noqa: E402
from repro.data.baskets import generate_baskets as ref_generate  # noqa: E402
from repro.data.baskets import stationary_baskets as ref_stationary  # noqa: E402
from repro.kernels.support_count.ref import support_count_ref  # noqa: E402
from repro.pipeline import MarketBasketPipeline as RefPipeline  # noqa: E402
from repro.serving import Query as RefQuery  # noqa: E402
from repro.serving import RecommendationEngine as RefEngine  # noqa: E402
from repro.serving import RuleIndex as RefRuleIndex  # noqa: E402
from repro.serving import ServingConfig as RefServingConfig  # noqa: E402
from repro.streaming import SlidingWindow as RefWindow  # noqa: E402
from repro.streaming import StreamingConfig as RefConfig  # noqa: E402
from repro.streaming import StreamingMiner as RefMiner  # noqa: E402
from repro.streaming import TransactionStream as RefStream  # noqa: E402
from repro_torch.data.baskets import (BasketConfig,  # noqa: E402
                                      generate_baskets, stationary_baskets)
from repro_torch.kernels.support_count.ops import support_count  # noqa: E402
from repro_torch.launch.common import PROFILES, standard_parser  # noqa: E402
from repro_torch.pipeline import (MarketBasketPipeline,  # noqa: E402
                                  PipelineConfig)
from repro_torch.runtime import POLICY_NAMES, PlaneReport  # noqa: E402
from repro_torch.serving import (Query, RecommendationEngine,  # noqa: E402
                                 RuleIndex, ServingConfig,
                                 recommend_bruteforce)
from repro_torch.streaming import (SlidingWindow,  # noqa: E402
                                   StreamingConfig, StreamingMiner,
                                   StreamingReport, TransactionStream)
from test_torch_autotune import costmodel_pair  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the fields that time this process, left out of every comparison
WALLS = ("host_time_s", "wall_time_s", "wall_s", "refresh_latency_s",
         "warm_wall_s")
INDEX_FIELDS = ("ante", "sizes", "conf", "lift", "support", "cons")


def _plain(x):
    """Dataclasses/lists/dicts -> plain values, without host walls."""
    if dataclasses.is_dataclass(x):
        x = {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items() if k not in WALLS}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.generic):
        return x.item()
    return x


def _stationary(n_tx, n_items, **kw):
    T = stationary_baskets(n_tx, n_items, **kw)
    assert T.tobytes() == ref_stationary(n_tx, n_items, **kw).tobytes()
    return T


def _generated(**kw):
    T = generate_baskets(BasketConfig(**kw))
    assert T.tobytes() == ref_generate(RefBasketConfig(**kw)).tobytes()
    return T


def small_kw(**kw):
    base = dict(window=256, batch_size=64, min_support=0.05,
                min_confidence=0.5, n_tiles=4, data_plane="ref",
                power="none")
    base.update(kw)
    return base


def _miners(n_items, ref_engine=None, engine=None, **kw):
    """(reference miner, port miner) over the same config; under
    ``costmodel`` each gets an equal instance fed support_count's measured
    walls (see ``test_torch_autotune.costmodel_pair``)."""
    ref_policy, port_policy = (costmodel_pair("support_count")
                               if kw.get("policy") == "costmodel"
                               else (None, None))
    ref = RefMiner(n_items, config=RefConfig(**kw), engine=ref_engine,
                   policy=ref_policy)
    port = StreamingMiner(n_items, config=StreamingConfig(device="cpu", **kw),
                          engine=engine, policy=port_policy)
    return ref, port


def _same_index(ref, port):
    if ref is None:
        assert port is None
        return
    for f in INDEX_FIELDS:
        a, b = getattr(ref, f), getattr(port, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    for f in ("n_rows", "n_rules", "n_items", "version"):
        assert getattr(ref, f) == getattr(port, f), f


def _same_state(ref, port):
    """Everything the two miners hold must be equal, walls aside."""
    assert ref.window.rows().tobytes() == port.window.rows().tobytes()
    np.testing.assert_array_equal(port._item_counts, ref._item_counts)
    assert port._tracked == ref._tracked
    assert port._tracked_supp.dtype == ref._tracked_supp.dtype
    np.testing.assert_array_equal(port._tracked_supp, ref._tracked_supp)
    assert port._levels == ref._levels
    assert port.supports == ref.supports
    assert [dataclasses.astuple(r) for r in port.rules] == \
        [dataclasses.astuple(r) for r in ref.rules]
    _same_index(ref.index, port.index)
    assert _plain(port._batches) == _plain(ref._batches)
    assert _plain(port.runtime.ledger.phases) == \
        _plain(ref.runtime.ledger.phases)


def _same_report(ref, port):
    assert _plain(port) == _plain(ref)
    for attr in ("n_batches", "n_revalidations", "n_refreshes",
                 "total_time_s", "total_energy_j", "total_switches",
                 "total_reissued", "constraint_violations"):
        assert getattr(port, attr) == getattr(ref, attr), attr


def _feed(ref, port, T, batch_size):
    """Both miners through T batch by batch, equal after every batch."""
    for a, b in zip(RefStream(T, batch_size), TransactionStream(T, batch_size)):
        assert a.tobytes() == b.tobytes()
        rep_ref, rep_port = ref.process_batch(a), port.process_batch(b)
        assert _plain(rep_port) == _plain(rep_ref)
        _same_state(ref, port)


# ---------------------------------------------------------------------------
# sources: TransactionStream + SlidingWindow
# ---------------------------------------------------------------------------

def test_stream_batches_cover_corpus_in_order():
    T = _generated(n_tx=100, n_items=16, seed=0)
    s, r = TransactionStream(T, 32), RefStream(T, 32)
    batches = list(s)
    assert [len(b) for b in batches] == [32, 32, 32, 4]
    assert s.n_batches == r.n_batches == 4
    assert (s.n_tx, s.n_items) == (r.n_tx, r.n_items)
    assert [b.tobytes() for b in batches] == [b.tobytes() for b in r]
    np.testing.assert_array_equal(np.concatenate(batches), T)
    assert len(s.take(2)) == 2
    lists = [[0, 3], [], [15, 1]]
    assert TransactionStream(lists, 2, n_items=16).T.tobytes() == \
        RefStream(lists, 2, n_items=16).T.tobytes()
    for cls in (TransactionStream, RefStream):
        with pytest.raises(ValueError):
            cls(T, 0)
        with pytest.raises(ValueError):
            cls(np.array([[0, 2]]), 1)    # not 0/1


def test_window_push_returns_exact_slabs():
    w, r = SlidingWindow(4, 8), RefWindow(4, 8)
    for batch in (np.eye(3, 8, dtype=np.uint8), np.ones((3, 8), np.uint8)):
        got, want = w.push(batch), r.push(batch)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()
    a1, e1 = SlidingWindow(4, 8).push(np.eye(3, 8, dtype=np.uint8))
    assert a1.shape == (3, 128) and e1.shape == (0, 128)
    assert w.n == 4 and w.full and len(w) == 4
    # arrival order preserved: eye row 2, then the three all-ones rows
    np.testing.assert_array_equal(
        w.rows_raw(),
        np.vstack([np.eye(3, 8, dtype=np.uint8)[2:],
                   np.ones((3, 8), dtype=np.uint8)]))
    assert w.rows().tobytes() == r.rows().tobytes()
    with pytest.raises(ValueError):
        w.push(np.ones((1, 7), np.uint8))
    for bad in ((0, 8), (4, 0)):
        with pytest.raises(ValueError):
            SlidingWindow(*bad)


def test_window_batch_larger_than_capacity_stays_exact():
    """Rows that arrive and evict in one push must cancel in the delta."""
    rng = np.random.default_rng(0)
    w, r = SlidingWindow(4, 8), RefWindow(4, 8)
    first = rng.integers(0, 2, size=(2, 8)).astype(np.uint8)
    w.push(first)
    r.push(first)
    old_sum = w.rows().sum(axis=0, dtype=np.int64)
    big = rng.integers(0, 2, size=(7, 8)).astype(np.uint8)
    arrived, evicted = w.push(big)
    ref_arrived, ref_evicted = r.push(big)
    assert arrived.tobytes() == ref_arrived.tobytes()
    assert evicted.tobytes() == ref_evicted.tobytes()
    assert arrived.shape[0] == 7 and evicted.shape[0] == 5
    np.testing.assert_array_equal(w.rows_raw(), big[-4:])
    np.testing.assert_array_equal(
        w.rows().sum(axis=0, dtype=np.int64),
        old_sum + arrived.sum(axis=0, dtype=np.int64)
        - evicted.sum(axis=0, dtype=np.int64))


def test_window_rows_do_not_alias_caller_buffer():
    """With n_items already lane-aligned, pad_items is a no-op — the window
    must still own its rows, or a caller reusing one buffer across pushes
    silently rewrites history."""
    buf = np.zeros((2, 128), dtype=np.uint8)     # 128 = no padding path
    buf[:, 0] = 1
    w, r = SlidingWindow(8, 128), RefWindow(8, 128)
    w.push(buf)
    r.push(buf)
    buf[:, :] = 0
    buf[:, 5] = 1                                # caller reuses the buffer
    w.push(buf)
    r.push(buf)
    rows = w.rows_raw()
    assert rows[:2, 0].all() and not rows[:2, 5].any()   # history intact
    assert rows[2:, 5].all() and not rows[2:, 0].any()
    assert rows.tobytes() == r.rows_raw().tobytes()


# ---------------------------------------------------------------------------
# delta counters stay exact without re-validation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rexec", ["pipelined", "per_tile"])
@pytest.mark.parametrize("policy", ["static", "costmodel"])
def test_delta_counters_match_full_recount_between_validations(rexec,
                                                               policy):
    T = _stationary(1024, 32, n_patterns=4, seed=5)
    ref, port = _miners(32, **small_kw(min_support=0.15, policy=policy,
                                       round_execution=rexec))
    for a in TransactionStream(T, 64):
        assert _plain(port.process_batch(a)) == _plain(ref.process_batch(a))
        _same_state(ref, port)
        W = port.window.rows()
        if port._tracked:
            C = itemsets_to_bitmap(port._tracked,
                                   port.window.n_items_padded)
            want = np.asarray(support_count_ref(W, C), dtype=np.int64)
            np.testing.assert_array_equal(port._tracked_supp, want)
        np.testing.assert_array_equal(port._item_counts,
                                      W.sum(axis=0, dtype=np.int64))
    # the stationary stream settles: the tail of the run is delta-only
    assert not port._batches[-1].revalidated
    # the pipelined delta phase reads back once; per_tile once a counted slab
    deltas = [p for p in port.runtime.ledger.phases
              if p.name.startswith("stream-delta-")]
    assert len(deltas) == 1024 // 64
    if rexec == "pipelined":
        assert all(p.syncs == 1 for p in deltas)
        validations = [p for p in port.runtime.ledger.phases
                       if p.name.startswith("stream-validate-k")]
        assert validations and all(p.syncs == 1 for p in validations)


def test_stationary_stream_stops_revalidating():
    T = _stationary(1536, 32, n_patterns=4, seed=9)
    kw = small_kw(min_support=0.15)
    ref, port = _miners(32, **kw)
    report = port.run(TransactionStream(T, 64))
    _same_report(ref.run(RefStream(T, 64)), report)
    _same_state(ref, port)
    warm = kw["window"] // kw["batch_size"]
    tail = report.batches[warm + 1:]
    assert tail and not any(b.revalidated for b in tail)
    # parity still holds at the end of the delta-only tail
    pipe = MarketBasketPipeline(config=port.config.pipeline_config()).run(
        port.window.rows_raw())
    assert port.supports == pipe.supports
    assert port.rules == pipe.rules


def test_boundary_crossing_triggers_revalidation():
    """Flip the stream distribution mid-run: the lattice must go stale and
    re-validate, and the state must still match a one-shot mine."""
    A = _stationary(512, 32, n_patterns=4, seed=1)
    B = _stationary(512, 32, n_patterns=4, seed=2)   # different patterns
    ref, port = _miners(32, **small_kw(min_support=0.15))
    _feed(ref, port, A, 64)
    before = len(port._batches)
    _feed(ref, port, B, 64)
    assert any(b.revalidated for b in port._batches[before:])
    pipe = MarketBasketPipeline(config=port.config.pipeline_config()).run(
        port.window.rows_raw())
    assert port.supports == pipe.supports and port.rules == pipe.rules


def test_revalidate_every_forces_periodic_full_pass():
    T = _stationary(1024, 32, n_patterns=4, seed=5)
    ref, port = _miners(32, **small_kw(min_support=0.15, revalidate_every=2))
    report = port.run(TransactionStream(T, 64))
    _same_report(ref.run(RefStream(T, 64)), report)
    forced = [b.revalidated for b in report.batches if (b.idx + 1) % 2 == 0]
    assert forced and all(forced)


# ---------------------------------------------------------------------------
# refresh semantics
# ---------------------------------------------------------------------------

def test_refresh_every_batches_rule_regeneration_and_flush_closes_gap():
    T = _stationary(1024, 32, n_patterns=4, seed=5)
    ref, port = _miners(32, **small_kw(min_support=0.15, refresh_every=4))
    _feed(ref, port, T, 64)
    refreshes = [b for b in port._batches
                 if b.rules_refreshed and not b.revalidated]
    # only every 4th batch refreshed on the delta path
    assert all(b.idx % 4 == 0 for b in refreshes)
    # rules may be stale now; flush must restore exact parity
    ref.flush()
    port.flush()
    _same_state(ref, port)
    pipe = MarketBasketPipeline(config=port.config.pipeline_config()).run(
        port.window.rows_raw())
    assert port.rules == pipe.rules


def test_unchanged_supports_skip_rule_regeneration():
    """Pushing and evicting identical rows leaves supports untouched: the
    rules phase must not run again (no-op refresh)."""
    row = np.zeros((1, 8), dtype=np.uint8)
    row[0, :3] = 1
    ref, port = _miners(8, window=4, batch_size=1, min_support=0.5,
                        min_confidence=0.5, n_tiles=1, data_plane="ref",
                        power="none")
    for _ in range(8):                      # window cycles identical rows
        rep = port.process_batch(row)
        ref.process_batch(row)
        _same_state(ref, port)
    assert not rep.rules_refreshed          # supports never moved
    assert port.index is not None
    v = port.index.version
    port.flush()
    ref.flush()
    assert port.index.version == v         # flush is a no-op too
    _same_state(ref, port)


def test_index_version_monotone_and_engine_hot_swap():
    T = _generated(n_tx=768, n_items=24, seed=4)
    ref_engine = RefEngine(RefRuleIndex.build([], 24),
                           config=RefServingConfig(k=3, data_plane="ref"))
    engine = RecommendationEngine(
        RuleIndex.build([], 24),
        config=ServingConfig(k=3, data_plane="ref", device="cpu"))
    ref, port = _miners(24, ref_engine, engine,
                        **small_kw(window=128, batch_size=64,
                                   min_support=0.08))
    versions = []
    for batch in TransactionStream(T, 64):
        ref.process_batch(batch)
        port.process_batch(batch)
        _same_state(ref, port)
        versions.append(engine.index.version)
        assert engine.index is port.index   # the swap is the same object
        assert engine.index.version == ref_engine.index.version
    assert versions == sorted(versions)      # monotone non-decreasing
    assert versions[-1] > 0                  # the stream did refresh
    # the engine serves from the swapped index on the CPU
    baskets = [np.flatnonzero(row).tolist() for row in T[:8]]
    assert [engine.recommend(Query.of(b)) for b in baskets] == \
        [ref_engine.recommend(RefQuery.of(b)) for b in baskets]


def test_attach_engine_swaps_the_live_index_in():
    T = _generated(n_tx=256, n_items=24, seed=4)
    ref, port = _miners(24, **small_kw(window=128, min_support=0.08))
    _feed(ref, port, T, 64)
    engine = RecommendationEngine(
        RuleIndex.build([], 24), config=ServingConfig(k=3, device="cpu"))
    ref.attach_engine(RefEngine(RefRuleIndex.build([], 24),
                                config=RefServingConfig(k=3,
                                                        data_plane="ref")))
    port.attach_engine(engine)
    assert engine.index is port.index and port.index.version > 0
    _same_index(ref.index, port.index)


# ---------------------------------------------------------------------------
# accounting: the streaming plane speaks the shared ledger dialect
# ---------------------------------------------------------------------------

def test_ledger_slice_backs_report_totals():
    T = _stationary(768, 32, n_patterns=4, seed=5)
    ref, port = _miners(32, **small_kw(min_support=0.15, power="cpu"))
    report = port.run(TransactionStream(T, 64))
    _same_report(ref.run(RefStream(T, 64)), report)
    assert report.ledger is not None and report.ledger.n_phases > 0
    # every batch's phase count sums to the ledger slice: one PhaseRecord
    # per phase, none lost, none double-counted
    assert sum(b.n_phases for b in report.batches) == report.ledger.n_phases
    assert report.total_energy_j == pytest.approx(
        report.ledger.total_energy_j)
    assert report.total_time_s == pytest.approx(report.ledger.total_time_s)
    assert {p.kind for p in report.ledger.phases} <= {"serial", "map"}
    # take_report drained the live ledger (long-lived miner, no leak)
    assert port.runtime.ledger.n_phases == 0
    assert "StreamingMiner" in report.summary()


@pytest.mark.parametrize("policy", ["dynamic", "costmodel"])
def test_policy_knob_reaches_every_phase(policy):
    T = _stationary(512, 32, n_patterns=4, seed=5)
    ref, port = _miners(32, **small_kw(min_support=0.15, policy=policy,
                                       power="cpu"))
    report = port.run(TransactionStream(T, 64))
    _same_report(ref.run(RefStream(T, 64)), report)
    assert report.policy == policy
    assert all(p.policy == policy for p in report.ledger.phases)


# ---------------------------------------------------------------------------
# the closed loop and constraint surfacing (tests/test_system.py)
# ---------------------------------------------------------------------------

def test_stream_refresh_serve_closed_loop_dynamic():
    """All planes as one system under policy=dynamic: micro-batches mined
    incrementally, rules hot-swapped into the live engine, queries served
    from the freshest index — with version monotonicity, no stale reads
    across refresh(), and the shared-ledger accounting invariants, each
    equal to the reference's."""
    n_items = 32
    T = np.vstack([_stationary(512, n_items, n_patterns=4, seed=1),
                   _stationary(512, n_items, n_patterns=4, seed=2)])
    kw = dict(window=256, batch_size=64, min_support=0.15,
              min_confidence=0.5, n_tiles=4, data_plane="ref",
              policy="dynamic")
    serve_kw = dict(k=3, data_plane="ref", policy="dynamic", cache_size=256)
    ref_engine = RefEngine(RefRuleIndex.build([], n_items),
                           config=RefServingConfig(**serve_kw))
    engine = RecommendationEngine(RuleIndex.build([], n_items),
                                  config=ServingConfig(device="cpu",
                                                       **serve_kw))
    ref, port = _miners(n_items, ref_engine, engine, **kw)

    items = list(range(6))                  # covers items of several rules
    versions, serve_reports = [], []
    for batch in TransactionStream(T, 64):
        ref.process_batch(batch)
        port.process_batch(batch)
        _same_state(ref, port)
        versions.append(engine.index.version)
        got, srep = engine.serve([Query.of(items)])
        want, ref_srep = ref_engine.serve([RefQuery.of(items)])
        assert got == want and _plain(srep) == _plain(ref_srep)
        serve_reports.append(srep)
        # no stale read: what we got is exactly what the *current* rules
        # imply — a cache entry surviving a refresh would violate this
        assert got[0] == recommend_bruteforce(port.rules, items, 3)
        # serving the same query twice without a refresh must hit the LRU:
        # no miss, hence no scoring map phase (admission still runs)
        _, srep2 = engine.serve([Query.of(items)])
        _, ref_srep2 = ref_engine.serve([RefQuery.of(items)])
        assert _plain(srep2) == _plain(ref_srep2)
        assert srep2.cache_hits == 1 and srep2.cache_misses == 0
        assert not srep2.ledger.by_kind("map")

    # RuleIndex.version is monotone and actually advanced mid-run
    assert versions == sorted(versions)
    assert versions[-1] > versions[0] >= 0
    assert engine.index.version == port.index.version

    sreport = port.take_report()
    _same_report(ref.take_report(), sreport)
    assert sreport.n_revalidations >= 1     # the distribution flip forced it
    assert sum(b.n_phases for b in sreport.batches) == \
        sreport.ledger.n_phases
    assert sreport.total_time_s == pytest.approx(
        sum(p.sim_time_s for p in sreport.ledger.phases))
    assert sreport.total_energy_j == pytest.approx(
        sum(p.energy_j for p in sreport.ledger.phases))
    assert sreport.total_switches == \
        sum(p.switches for p in sreport.ledger.phases)
    assert {p.kind for p in sreport.ledger.phases} <= {"serial", "map"}
    assert all(p.policy == "dynamic" for p in sreport.ledger.phases)
    for srep in serve_reports:
        assert srep.ledger is not None
        assert srep.energy_j == pytest.approx(srep.ledger.total_energy_j)
        assert srep.switches == srep.ledger.total_switches
        assert len(srep.ledger.by_kind("serial")) == srep.n_batches
    # nothing leaked into the live runtimes
    assert port.runtime.ledger.n_phases == 0
    assert engine.runtime.ledger.n_phases == 0


def test_min_speed_violation_reaches_streaming_report():
    T = _stationary(512, 32, n_patterns=4, seed=3)
    kw = dict(window=128, batch_size=64, min_support=0.15, n_tiles=2,
              data_plane="ref", power="none", serial_min_speed=1e6)
    ref, port = _miners(32, **kw)
    report = port.run(TransactionStream(T, 64))
    _same_report(ref.run(RefStream(T, 64)), report)
    assert report.constraint_violations > 0
    assert "WARNING" in report.summary()


# ---------------------------------------------------------------------------
# the port's own surface: config refusals, the report protocol, the CLI
# ---------------------------------------------------------------------------

def test_streaming_report_is_a_plane_report():
    rep = StreamingReport(backend="ref", policy="static", split="lpt",
                          window=8, batch_size=4)
    assert isinstance(rep, PlaneReport)
    assert (rep.total_time_s, rep.total_energy_j, rep.total_switches,
            rep.constraint_violations, rep.mean_refresh_latency_s) == \
        (0.0, 0.0, 0, 0, 0.0)
    assert isinstance(rep.summary(), str)


def test_unknown_policy_and_round_execution_are_refused():
    with pytest.raises(ValueError, match="unknown"):
        StreamingConfig(policy="nope", device="cpu")
    with pytest.raises(ValueError, match="round_execution"):
        StreamingMiner(8, config=StreamingConfig(device="cpu",
                                                 round_execution="eager"))


def test_cuda_default_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingConfig()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingConfig(device="cuda:0")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        StreamingMiner(8, config=StreamingConfig(device="cpu",
                                                 data_plane="cuda"))


@pytest.mark.parametrize("min_support", [0.0, 1e-9, 0.02, 0.08, 0.5, 1.0,
                                         1.5, 7, 80, 10_000])
def test_abs_support_is_the_pipelines(min_support):
    cfg = StreamingConfig(min_support=min_support, device="cpu")
    pipe = cfg.pipeline_config()
    ref = RefConfig(min_support=min_support)
    for n in (1, 7, 64, 511, 512, 20_000):
        assert cfg.abs_support(n) == pipe.abs_support(n) == \
            ref.abs_support(n)
    assert (pipe.device, pipe.tuning) == ("cpu", None)
    mxu = StreamingConfig(device="cpu", tuning={"variant": "mxu"})
    assert mxu.pipeline_config().tuning == {"variant": "mxu"}


@pytest.mark.parametrize("N,M", [(1, 384), (5, 2944), (8, 128),
                                 (1000, 2944), (1024, 384)])
def test_support_count_at_the_delta_shapes(N, M):
    """A slab of batch rows (1 to 1,024) against the whole tracked set:
    the shapes the delta phase gives the support-count wrapper.  The
    last 7 candidates are the bucket's empty padding rows, which the
    wrapper counts against its own zero-padded transaction rows too, so
    the delta phase slices them away (as this test does)."""
    rng = np.random.default_rng(N + M)
    T = (rng.random((N, 1024)) < 0.05).astype(np.uint8)
    C = np.zeros((M, 1024), np.uint8)
    cols = rng.integers(0, 1000, (M, 3))
    for m in range(M - 7):                    # 7 padding rows stay empty
        C[m, cols[m, :1 + m % 3]] = 1
    want = np.asarray(support_count_ref(T, C))
    got = support_count(torch.from_numpy(T), torch.from_numpy(C))
    assert got.dtype == torch.int32 and got.shape == (M,)
    np.testing.assert_array_equal(got.numpy()[:M - 7], want[:M - 7])


def test_cli_flags_follow_the_port():
    ap = standard_parser()
    args = ap.parse_args([])
    assert (args.device, args.data_plane, args.policy) == \
        ("cuda", "auto", "static")
    for flag, value in (("--policy", "nope"), ("--data-plane", "pallas")):
        with pytest.raises(SystemExit):
            ap.parse_args([flag, value])
    assert POLICY_NAMES == ("costmodel", "dynamic", "static")
    for policy in POLICY_NAMES:
        assert ap.parse_args(["--policy", policy]).policy == policy
    assert args.autotune is True
    assert ap.parse_args(["--no-autotune"]).autotune is False
    assert sorted(PROFILES) == ["homogeneous", "paper", "straggler"]


def test_stream_cli_smoke_prints_the_reference_smoke(capsys):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.stream", "--smoke",
         "--device", "cpu"], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    ok = [ln for ln in out.stdout.splitlines() if "smoke OK" in ln]
    assert len(ok) == 2
    assert "(policy=static)" in ok[0] and "(policy=dynamic)" in ok[1]

    from repro.launch.stream import stream as ref_stream
    ref_stream(smoke=True, data_plane="ref")
    ref_out = capsys.readouterr().out

    def comparable(text):
        # the summaries' refresh latency and wall time the host's clocks
        text = re.sub(r"refresh-to-visible [0-9.]+ms", "", text)
        return re.sub(r"wall [0-9.]+s", "", text).splitlines()
    assert comparable(out.stdout) == comparable(ref_out)


def test_stream_cli_smoke_takes_costmodel_without_autotune(capsys):
    """``--policy costmodel --no-autotune`` is accepted; the smoke still
    gates the static and the dynamic policy, as the reference's does, and
    prints what the reference's smoke prints with the same flags."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.stream", "--smoke",
         "--device", "cpu", "--policy", "costmodel", "--no-autotune"],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    ok = [ln for ln in out.stdout.splitlines() if "smoke OK" in ln]
    assert len(ok) == 2
    assert "(policy=static)" in ok[0] and "(policy=dynamic)" in ok[1]

    from repro.launch.stream import stream as ref_stream
    ref_stream(smoke=True, data_plane="ref", policy="costmodel",
               autotune=False)
    ref_out = capsys.readouterr().out

    def comparable(text):
        text = re.sub(r"refresh-to-visible [0-9.]+ms", "", text)
        return re.sub(r"wall [0-9.]+s", "", text).splitlines()
    assert comparable(out.stdout) == comparable(ref_out)
