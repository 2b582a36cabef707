"""The port's serving plane, held against the reference's.

Same corpora (made with the same numpy code from the same seed) are mined
by both packages; the rule index, every recommendation, every
``ServingReport`` field and every ledger ``PhaseRecord`` field of the
port's ``RecommendationEngine`` on the CPU must equal the reference
engine's (``data_plane="ref"``) and the brute-force oracle's — except the
fields that time this process (``wall_time_s``, ``host_time_s``,
``warm_wall_s``).  The admission pieces are driven by the same scripted
clocks as the reference's own tests.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data.baskets import BasketConfig as RefBasketConfig  # noqa: E402
from repro.data.baskets import generate_baskets as ref_generate  # noqa: E402
from repro.pipeline import MarketBasketPipeline as RefPipeline  # noqa: E402
from repro.pipeline import PipelineConfig as RefPipelineConfig  # noqa: E402
from repro.serving import AsyncServer as RefAsyncServer  # noqa: E402
from repro.serving import Query as RefQuery  # noqa: E402
from repro.serving import RecommendationEngine as RefEngine  # noqa: E402
from repro.serving import RuleIndex as RefRuleIndex  # noqa: E402
from repro.serving import ServingConfig as RefServingConfig  # noqa: E402
from repro_torch.pipeline import (MarketBasketPipeline,  # noqa: E402
                                  PipelineConfig)
from repro_torch.runtime import PlaneReport  # noqa: E402
from repro_torch.serving import (AsyncServer, BucketLadder,  # noqa: E402
                                 Handle, Query, RecommendationEngine,
                                 RequestQueue, RuleIndex, ServingConfig,
                                 ShedError, SloGovernor, VirtualClock,
                                 WallClock, recommend_bruteforce)
from repro_torch.serving.cache import ResultCache, basket_key  # noqa: E402
from test_torch_autotune import costmodel_pair  # noqa: E402

# (BasketConfig kwargs, mining kwargs): the corpus of tests/test_serving.py
# and the quickstart's
CORPORA = {
    "mined": (dict(n_tx=500, n_items=32, n_patterns=5, pattern_len=3,
                   pattern_prob=0.5, seed=3),
              dict(min_support=0.05, min_confidence=0.5, n_tiles=4)),
    "quickstart": (dict(n_tx=4096, n_items=96, seed=42),
                   dict(min_support=80, min_confidence=0.65, n_tiles=32)),
}
_MINED = {}


def _mined(name):
    """(T, reference rules, port rules) for a corpus, mined once."""
    if name not in _MINED:
        kw, mine_kw = CORPORA[name]
        T = ref_generate(RefBasketConfig(**kw))
        ref = RefPipeline(config=RefPipelineConfig(data_plane="ref",
                                                   **mine_kw)).run(T).rules
        port = MarketBasketPipeline(config=PipelineConfig(
            device="cpu", **mine_kw)).run(T).rules
        assert ref, "the corpus must mine a non-trivial rule set"
        assert [dataclasses.astuple(r) for r in port] == \
            [dataclasses.astuple(r) for r in ref]
        _MINED[name] = (T, ref, port)
    return _MINED[name]


def _plain(x):
    """Dataclasses/lists/dicts -> plain values, without the fields that
    time this process."""
    if dataclasses.is_dataclass(x):
        x = {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()
                if k not in ("host_time_s", "wall_time_s", "warm_wall_s")}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.generic):
        return x.item()
    return x


def _ids(T, n):
    return [list(np.nonzero(row)[0]) for row in T[:n]]


def _engines(name, **kw):
    """(reference engine, port engine) over the same corpus and config;
    under ``costmodel`` each gets an equal instance fed the rule-match
    kernel's measured walls (see ``test_torch_autotune.costmodel_pair``)."""
    T, ref_rules, port_rules = _mined(name)
    n_items = T.shape[1]
    ref_policy, port_policy = (costmodel_pair("rule_match")
                               if kw.get("policy") == "costmodel"
                               else (None, None))
    ref = RefEngine(RefRuleIndex.build(ref_rules, n_items),
                    config=RefServingConfig(data_plane="ref", **kw),
                    policy=ref_policy)
    port = RecommendationEngine(RuleIndex.build(port_rules, n_items),
                                config=ServingConfig(device="cpu", **kw),
                                policy=port_policy)
    return ref, port


def _assert_same_report(port_rep, ref_rep):
    assert _plain(port_rep) == _plain(ref_rep)
    assert port_rep.ledger.n_phases == ref_rep.ledger.n_phases > 0
    for p, r in zip(port_rep.ledger.phases, ref_rep.ledger.phases):
        assert _plain(p) == _plain(r), p.name
    for attr in ("qps", "hit_rate", "total_time_s", "total_energy_j",
                 "total_switches"):
        assert getattr(port_rep, attr) == getattr(ref_rep, attr), attr


# ---------------------------------------------------------------------------
# the compiled index
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CORPORA))
def test_index_arrays_byte_equal_reference(name):
    T, ref_rules, port_rules = _mined(name)
    ref = RefRuleIndex.build(ref_rules, T.shape[1], version=2)
    port = RuleIndex.build(port_rules, T.shape[1], version=2)
    for f in ("ante", "sizes", "conf", "lift", "support", "cons"):
        a, b = getattr(port, f), getattr(ref, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    for attr in ("n_rows", "n_rules", "n_items", "version", "n_rows_padded",
                 "n_items_padded", "nbytes"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    shuffled = list(port_rules)
    np.random.default_rng(0).shuffle(shuffled)
    assert RuleIndex.build(shuffled, T.shape[1]).same_arrays(port)


def test_index_rejects_bad_inputs_and_has_no_store_yet(tmp_path):
    _, ref_rules, port_rules = _mined("mined")
    for build, rules in ((RefRuleIndex.build, ref_rules),
                         (RuleIndex.build, port_rules)):
        with pytest.raises(ValueError):
            build(rules, 2)                          # items >= 2 referenced
        with pytest.raises(ValueError):
            build(rules, 32, r_bucket=100)           # not a lane multiple
        with pytest.raises(ValueError):
            build(rules, 0)
    empty = RuleIndex.build([], 32)                  # all-padding index
    assert empty.same_arrays(RefRuleIndex.build([], 32))
    assert empty.n_rows == 0 and empty.n_rows_padded == 128
    engine = RecommendationEngine(empty, config=ServingConfig(
        k=3, device="cpu"))
    assert engine.recommend(Query.of([0, 1])) == []
    # the store is ported: the all-padding index round-trips
    empty.save(str(tmp_path))
    assert RuleIndex.load(str(tmp_path)).same_arrays(empty)


# ---------------------------------------------------------------------------
# serve(): results, reports and ledgers against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CORPORA))
@pytest.mark.parametrize("policy", ["static", "dynamic", "costmodel"])
@pytest.mark.parametrize("arrivals", ["at_once", "exponential"])
def test_serve_matches_reference_and_oracle(name, policy, arrivals):
    T, ref_rules, port_rules = _mined(name)
    ids = _ids(T, 120)
    arrival = (None if arrivals == "at_once" else
               np.cumsum(np.random.default_rng(11).exponential(0.05, 120)))
    ref, port = _engines(name, k=4, batch_buckets=(1, 8, 64),
                         policy=policy, cache_size=64)
    want, ref_rep = ref.serve([RefQuery.of(q) for q in ids], arrival)
    got, port_rep = port.serve([Query.of(q) for q in ids], arrival)
    assert got == want
    assert got == [recommend_bruteforce(port_rules, q, 4) for q in ids]
    assert any(got)
    assert port_rep.backend == ref_rep.backend == "ref"
    _assert_same_report(port_rep, ref_rep)
    # a second serve hits the cache on both sides alike
    again, port_rep2 = port.serve([Query.of(q) for q in ids], arrival)
    _, ref_rep2 = ref.serve([RefQuery.of(q) for q in ids], arrival)
    assert again == got and port_rep2.cache_hits > 0
    _assert_same_report(port_rep2, ref_rep2)


def test_queries_as_bitmaps_tensors_and_ids_agree():
    T, _, _ = _mined("mined")
    _, port = _engines("mined", k=3)
    from_ids, _ = port.serve([Query.of(q) for q in _ids(T, 10)])
    from_rows, _ = port.serve([Query.of(row) for row in T[:10]])
    from_tensors, _ = port.serve(
        [Query.of(torch.from_numpy(row)) for row in T[:10]])
    assert from_rows == from_ids == from_tensors


def test_bad_inputs_raise_like_reference():
    T, _, _ = _mined("mined")
    ref, port = _engines("mined", k=3)
    n_pad = port.index.n_items_padded
    padded = np.zeros(n_pad, np.uint8)
    padded[port.index.n_items + 1] = 1               # bit in the lane padding
    cases = [
        (ValueError, lambda e, Q: e.recommend(Q.of([T.shape[1] + 5]))),
        (ValueError, lambda e, Q: e.serve([Q.of(np.full(T.shape[1], 2,
                                                        np.uint8))])),
        (ValueError, lambda e, Q: e.serve([Q.of(padded)])),
        (TypeError, lambda e, Q: e.serve([list(np.nonzero(T[0])[0])])),
        (TypeError, lambda e, Q: e.submit(T[0])),
        (ValueError, lambda e, Q: e.serve([Q.of([1]), Q.of([2])],
                                          arrival_s=[1.0])),
        (ValueError, lambda e, Q: e.serve([Q.of([1]), Q.of([2])],
                                          arrival_s=[2.0, 1.0])),
        (ValueError, lambda e, Q: Q.of({"basket": [1]})),
    ]
    for exc, call in cases:
        with pytest.raises(exc):
            call(ref, RefQuery)
        with pytest.raises(exc):
            call(port, Query)
    _, _, port_rules = _mined("mined")
    index = RuleIndex.build(port_rules, 32)
    for kw in (dict(k=0), dict(k=33), dict(batch_buckets=()),
               dict(batch_buckets=(0, 8))):
        with pytest.raises(ValueError):
            RecommendationEngine(index, config=ServingConfig(device="cpu",
                                                             **kw))
    with pytest.raises(ValueError):
        AsyncServer(port, slots=65)


def test_config_refuses_what_the_port_cannot_run():
    _, _, port_rules = _mined("mined")
    index = RuleIndex.build(port_rules, 32)
    with pytest.raises(ValueError):
        ServingConfig(device="cpu", tuning={"variant": "bogus"})
    for plane in ("pallas", "cuda"):                 # cuda needs a card
        with pytest.raises(ValueError):
            RecommendationEngine(index, config=ServingConfig(
                device="cpu", data_plane=plane))


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default config is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingConfig()


# ---------------------------------------------------------------------------
# cache and refresh
# ---------------------------------------------------------------------------

def test_refresh_bumps_version_and_clears_cache():
    T, _, port_rules = _mined("mined")
    _, port = _engines("mined", k=4, cache_size=256)
    queries = [Query.of(q) for q in _ids(T, 20)]
    first, rep1 = port.serve(queries)
    assert rep1.cache_misses > 0
    again, rep2 = port.serve(queries)
    assert again == first
    assert rep2.cache_hits == len(queries) and rep2.cache_misses == 0
    v0 = port.index.version
    port.refresh(RuleIndex.build(port_rules, T.shape[1]))
    assert port.index.version == v0 + 1 and len(port.cache) == 0
    _, rep3 = port.serve(queries)
    assert rep3.cache_hits == 0 and rep3.cache_misses == len(queries)
    assert rep3.index_version == v0 + 1


def test_cache_lru_eviction_and_disabled_cache():
    cache = ResultCache(maxsize=2)
    keys = [basket_key(np.eye(8, dtype=np.uint8)[i]) for i in range(3)]
    for i, key in enumerate(keys):
        cache.put(key, [(i, 1.0)])
    assert cache.get(keys[0]) is None                # evicted, a miss
    assert cache.get(keys[2]) == [(2, 1.0)]
    assert cache.hits == 1 and cache.misses == 1
    got = cache.get(keys[2])
    got.append((9, 0.1))                             # callers get copies
    assert cache.get(keys[2]) == [(2, 1.0)]
    with pytest.raises(ValueError):
        ResultCache(maxsize=-1)
    off = ResultCache(maxsize=0)
    off.put(keys[0], [(0, 1.0)])
    assert off.get(keys[0]) is None and len(off) == 0


# ---------------------------------------------------------------------------
# the open loop: AsyncServer against serve() and the reference server
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["static", "dynamic", "costmodel"])
def test_async_server_matches_serve_and_reference(policy):
    T, _, port_rules = _mined("mined")
    ids = _ids(T, 48)
    arrivals = np.cumsum(np.random.default_rng(11).exponential(0.05, 48))
    oracle = [recommend_bruteforce(port_rules, q, 5) for q in ids]
    closed, _ = _engines("mined", k=5, policy=policy)[1].serve(
        [Query.of(q) for q in ids], arrivals)
    reps = []
    for engine, Q, Server in zip(_engines("mined", k=5, policy=policy),
                                 (RefQuery, Query),
                                 (RefAsyncServer, AsyncServer)):
        server = Server(engine)
        handles = [server.submit(Q.of(q), arrival_s=float(t))
                   for q, t in zip(ids, arrivals)]
        assert server.drain() == handles
        reps.append(server.take_report())
        assert [h.result() for h in handles] == closed == oracle
    ref_rep, port_rep = reps
    assert _plain(port_rep) == _plain(ref_rep)
    assert isinstance(port_rep, PlaneReport)
    assert port_rep.warm_wall_s > 0 and port_rep.n_completed == 48


def test_engine_submit_poll_drain_surface():
    T, _, port_rules = _mined("mined")
    _, engine = _engines("mined", k=5, cache_size=64)
    q = _ids(T, 1)[0]
    h = engine.submit({"items": q, "id": 99})
    assert h.rid == 99
    want = recommend_bruteforce(port_rules, q, 5)
    assert engine.poll(h) == want
    h2 = engine.submit(Query.of(q))                  # rid moves on
    assert h2.rid > 99
    assert [x.rid for x in engine.drain()] == [99, h2.rid]
    assert h2.result() == want


def test_slo_shedding_and_rewarm_after_refresh():
    T, _, port_rules = _mined("mined")
    _, engine = _engines("mined", k=5, slo_ms=1000.0)
    server = AsyncServer(engine)
    assert server.ladder.warmed
    v0 = server._warm_version
    qs = [Query.of(q) for q in _ids(T, 3)]
    for b in server.ladder.buckets:
        server.ladder.observe(b, 0.5)
    late = server.submit(qs[0], arrival_s=0.0)
    fresh = server.submit(qs[1], arrival_s=0.8)
    server.clock.advance(0.8)
    server.drain()
    assert late.status == "shed" and fresh.status == "done"
    with pytest.raises(ShedError, match="shed"):
        late.result()
    rep = server.take_report()
    assert rep.n_shed == 1 and rep.n_completed == 1
    assert len(rep.ledger.by_kind("shed")) == 1
    engine.refresh(RuleIndex.build(port_rules[: len(port_rules) // 2], 32))
    ok = server.submit(qs[2])
    assert server.poll(ok) is not None
    assert server._warm_version == engine.index.version > v0


def test_threaded_wall_clock_mode():
    T, _, _ = _mined("mined")
    qs = [Query.of(q) for q in _ids(T, 12)]
    inline, _ = _engines("mined", k=5)[1].serve(qs)
    _, engine = _engines("mined", k=5)
    with AsyncServer(engine) as server:
        handles = [server.submit(q) for q in qs]
        results = [h.result(timeout=30.0) for h in handles]
    assert results == inline
    rep = server.take_report()
    assert rep.clock == "wall" and rep.n_completed == 12 and rep.n_shed == 0


# ---------------------------------------------------------------------------
# admission pieces under a scripted clock (mirrors of the reference's units)
# ---------------------------------------------------------------------------

def _handle(rid, arrival_s, n_items=8):
    bits = np.zeros(n_items, dtype=np.uint8)
    return Handle(rid=rid, query=Query([0]), arrival_s=arrival_s,
                  bits=bits, key=basket_key(bits))


def test_request_queue_fifo_and_arrival_gating():
    q = RequestQueue()
    for rid, t in enumerate([0.0, 1.0, 2.0]):
        q.append(_handle(rid, t))
    assert q.next_arrival() == 0.0
    assert [h.rid for h in q.take_ready(now=1.5, limit=10)] == [0, 1]
    assert len(q) == 1 and q.next_arrival() == 2.0
    for rid in range(3, 9):
        q.append(_handle(rid, 2.0))
    assert [h.rid for h in q.take_ready(now=5.0, limit=4)] == [2, 3, 4, 5]
    assert q.wait_depth(3, timeout=0.0) and not q.wait_depth(4, 0.0)


def test_bucket_ladder_pick_warm_and_ewma():
    ladder = BucketLadder([64, 1, 8, 8])
    assert ladder.buckets == (1, 8, 64) and ladder.max_bucket == 64
    assert [ladder.pick(n) for n in (1, 2, 8, 9, 64)] == [1, 8, 8, 64, 64]
    for bad in (0, 65):
        with pytest.raises(ValueError):
            ladder.pick(bad)
    with pytest.raises(ValueError):
        BucketLadder([1], ewma_alpha=0.0)
    ladder = BucketLadder([1, 4])
    clock = iter(np.arange(0.0, 10.0, 0.5))
    warmed = []
    total = ladder.warm(warmed.append, lambda: float(next(clock)))
    assert warmed == [1, 4] and total == pytest.approx(1.0)
    assert ladder.warmed and ladder.state[1].warm_wall_s == 0.5
    ladder.observe(1, 2.0)
    assert ladder.projected_step_s(1) == pytest.approx(2.0)
    assert ladder.projected_step_s(4) == pytest.approx(8.0)
    ladder.observe(1, 1.0)
    assert ladder.projected_step_s(1) == pytest.approx(0.3 * 1.0 + 0.7 * 2.0)


def test_slo_governor_sheds_at_scripted_threshold():
    ladder = BucketLadder([1, 8])
    gov = SloGovernor(slo_s=1.0, ladder=ladder)
    late, fresh = _handle(0, 0.0), _handle(1, 0.7)
    admit, shed = gov.split(now=0.8, ready=[late, fresh])
    assert [h.rid for h in admit] == [0, 1] and not shed
    ladder.observe(8, 0.5)
    admit, shed = gov.split(now=0.8, ready=[late, fresh])
    assert [h.rid for h in shed] == [0] and [h.rid for h in admit] == [1]
    assert gov.n_shed == 1
    assert SloGovernor(0.0, ladder).split(5.0, [late])[1] == []


def test_handle_query_and_clocks():
    h = _handle(0, 0.0)
    with pytest.raises(RuntimeError, match="pending"):
        h.result()
    h._finish("done", [(1, 0.5)], t_done=2.0)
    assert h.done() and h.latency_s == pytest.approx(2.0)
    assert h.result() == [(1, 0.5)]
    with pytest.raises(AssertionError):
        h._finish("done", [], 3.0)
    s = _handle(1, 0.0)
    s._finish("shed", None, 1.0)
    with pytest.raises(ShedError):
        s.result()
    q = Query.of({"items": [3, 7], "id": 42, "arrival_s": 1.5})
    assert (q.payload, q.rid, q.arrival_s) == ([3, 7], 42, 1.5)
    assert Query.of(q) is q
    assert Query.of(Query([1]), arrival_s=2.0).arrival_s == 2.0
    with pytest.raises(ValueError, match="allow only"):
        Query.of({"items": [1], "priority": 9})
    v = VirtualClock()
    assert v.domain == "sim" and v.now() == 0.0
    assert v.advance(2.0) == 2.0 and v.advance(1.0) == 2.0
    w = WallClock()
    assert w.domain == "wall" and w.advance(1e9) < 1.0
