"""The port's mining main path, held against the reference pipeline.

Same corpora (made with the same numpy code from the same seed) go through
``repro.pipeline.MarketBasketPipeline`` (data plane ``ref``) and
``repro_torch.pipeline.MarketBasketPipeline`` on the CPU.  Supports, rules
in order, round reports and every ledger field but the host wall time
must be equal — including the h2d/d2h bytes and syncs, which pin the
one-readback-per-round contract.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.mapreduce import FailureEvent as RefFailureEvent  # noqa: E402
from repro.data.baskets import BasketConfig as RefBasketConfig  # noqa: E402
from repro.data.baskets import generate_baskets as ref_generate  # noqa: E402
from repro.pipeline import MarketBasketPipeline as RefPipeline  # noqa: E402
from repro.pipeline import PipelineConfig as RefConfig  # noqa: E402
from repro_torch.core.itemsets import (apriori_bruteforce,  # noqa: E402
                                       generate_candidates,
                                       itemsets_to_bitmap)
from repro_torch.core.mapreduce import FailureEvent  # noqa: E402
from repro_torch.data.baskets import BasketConfig, generate_baskets  # noqa: E402
from repro_torch.data.sparse import SparseSlab  # noqa: E402
from repro_torch.pipeline import (MarketBasketPipeline,  # noqa: E402
                                  PipelineConfig)
from repro_torch.pipeline.dataplane import pad_candidates  # noqa: E402
from repro_torch.pipeline.devgen import DeviceLattice  # noqa: E402
from repro_torch.runtime import TransferMeter  # noqa: E402

# (BasketConfig kwargs, min_support, n_tiles): small_db of
# tests/test_pipeline.py and the quickstart corpus
CORPORA = {
    "small_db": (dict(n_tx=300, n_items=24, n_patterns=4, pattern_len=3,
                      pattern_prob=0.5, seed=5), 0.05, 4),
    "quickstart": (dict(n_tx=4096, n_items=96, seed=42), 80, 32),
}


def _corpus(name):
    kw, _, _ = CORPORA[name]
    T = generate_baskets(BasketConfig(**kw))
    ref = ref_generate(RefBasketConfig(**kw))
    assert T.dtype == ref.dtype and T.shape == ref.shape
    assert T.tobytes() == ref.tobytes()
    return T


def _plain(x):
    """Dataclasses/lists/dicts -> plain values, without host wall times
    (the one ledger field that measures this process, not the mine)."""
    if dataclasses.is_dataclass(x):
        x = {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()
                if k not in ("host_time_s", "wall_time_s")}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.generic):
        return x.item()
    return x


def _assert_same_mine(ref, port):
    assert port.supports == ref.supports
    assert [dataclasses.astuple(r) for r in port.rules] == \
        [dataclasses.astuple(r) for r in ref.rules]
    assert port.n_tx == ref.n_tx
    assert _plain(port.report.rounds) == _plain(ref.report.rounds)
    assert _plain(port.report.rules_phase) == _plain(ref.report.rules_phase)
    assert len(port.report.ledger.phases) == len(ref.report.ledger.phases)
    for p, r in zip(port.report.ledger.phases, ref.report.ledger.phases):
        assert _plain(p) == _plain(r), p.name
    for attr in ("backend", "policy", "split", "n_tx", "n_items", "n_tiles",
                 "min_support", "n_itemsets", "n_rules", "total_time_s",
                 "total_energy_j", "total_switches"):
        assert getattr(port.report, attr) == getattr(ref.report, attr), attr


@pytest.mark.parametrize("corpus", sorted(CORPORA))
@pytest.mark.parametrize("policy", ["static", "dynamic"])
@pytest.mark.parametrize("rexec", ["pipelined", "per_tile"])
def test_port_mines_like_reference(corpus, policy, rexec):
    T = _corpus(corpus)
    _, min_support, n_tiles = CORPORA[corpus]
    common = dict(min_support=min_support, min_confidence=0.6,
                  n_tiles=n_tiles, policy=policy, round_execution=rexec)
    ref = RefPipeline(config=RefConfig(data_plane="ref", **common)).run(T)
    port = MarketBasketPipeline(
        config=PipelineConfig(device="cpu", **common)).run(T)
    assert port.report.backend == "ref"
    assert len(port.report.rounds) >= 3 and port.rules
    _assert_same_mine(ref, port)


@pytest.mark.parametrize("policy", ["static", "dynamic"])
def test_failure_replan_matches_reference(policy):
    """A core that dies mid-round: the re-plan, switches and energy must
    match the reference's, and the answer must not change."""
    T = _corpus("small_db")
    common = dict(min_support=0.05, n_tiles=8, policy=policy)
    ref = RefPipeline(config=RefConfig(data_plane="ref", **common)).run(
        T, failures=[RefFailureEvent(device=3, at_time=20.0)])
    port = MarketBasketPipeline(
        config=PipelineConfig(device="cpu", **common)).run(
            T, failures=[FailureEvent(device=3, at_time=20.0)])
    _assert_same_mine(ref, port)
    assert port.report.total_switches > 0
    assert any(3 in r.failed_devices for r in port.report.rounds)


def _mk_cfg(**kw):
    base = dict(min_support=0.05, min_confidence=0.5, n_tiles=4,
                device="cpu")
    base.update(kw)
    return PipelineConfig(**base)


def test_two_round_mine_transfer_ledger_is_exact():
    """Mirror of tests/test_round_exec.py's byte-exact ledger test."""
    T = generate_baskets(BasketConfig(n_tx=256, n_items=24, seed=3))
    cfg = _mk_cfg(max_k=2)
    res = MarketBasketPipeline(config=cfg).run(T)
    rounds = res.report.rounds
    assert len(rounds) == 2 and rounds[1].n_frequent > 0
    led = res.report.ledger
    by_name = {p.name: p for p in led.phases}
    n_items_pad = 128
    f1 = rounds[0].n_frequent
    f1_cap = max(cfg.m_bucket, -(-f1 // cfg.m_bucket) * cfg.m_bucket)
    m_cap = rounds[1].m_padded
    f2 = rounds[1].n_frequent

    r1 = by_name["mba-round1-item-counts"]
    assert r1.h2d_bytes == 256 * n_items_pad
    assert r1.d2h_bytes == n_items_pad * 8
    assert r1.syncs == 1
    cg = by_name["mba-candgen-k2"]
    assert cg.h2d_bytes == f1_cap * 4
    assert cg.d2h_bytes == 0 and cg.syncs == 0
    r2 = by_name["mba-round2-support"]
    assert r2.h2d_bytes == 0
    assert r2.d2h_bytes == (m_cap + 1) * 4
    assert r2.syncs == 1
    ru = by_name["mba-rules"]
    assert ru.h2d_bytes == 0
    assert ru.d2h_bytes == f2 * 2 * 4
    assert ru.syncs == 1
    assert led.total_h2d_bytes == r1.h2d_bytes + cg.h2d_bytes
    assert led.total_d2h_bytes == (r1.d2h_bytes + r2.d2h_bytes
                                   + ru.d2h_bytes)
    assert led.total_syncs == 3


def test_pipelined_syncs_once_per_round_per_tile_syncs_per_tile():
    T = generate_baskets(BasketConfig(n_tx=512, n_items=32, seed=5))
    runs = {}
    for rexec in ("pipelined", "per_tile"):
        res = MarketBasketPipeline(config=_mk_cfg(round_execution=rexec)
                                   ).run(T)
        maps = res.report.ledger.by_kind("map")
        assert maps
        want = 1 if rexec == "pipelined" else 4
        assert all(p.syncs == want for p in maps), \
            [(p.name, p.syncs) for p in maps]
        runs[rexec] = res
    want = apriori_bruteforce(T, max(1, int(0.05 * 512)), max_k=8)
    assert runs["pipelined"].supports == runs["per_tile"].supports == want
    assert runs["pipelined"].rules == runs["per_tile"].rules


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("lat_kw", [{}, {"max_join_rows": 0}],
                         ids=["device-join", "host-fallback"])
def test_device_join_prune_matches_generate_candidates(seed, lat_kw):
    """Mirror of the reference's lattice test: the torch join/prune emits
    generate_candidates' list in order, through finalize/advance/decode."""
    rng = np.random.default_rng(seed)
    n_items, min_sup = 16, 5
    lat = DeviceLattice(n_items, m_bucket=8, meter=TransferMeter("cpu"),
                        **lat_kw)
    items = np.sort(rng.choice(n_items, size=9, replace=False))
    lat.seed_items(items)
    frequent = [(int(i),) for i in items]
    expect = {}
    for _ in (2, 3, 4, 5):
        want = generate_candidates(frequent)
        gen = lat.join()
        if not want:
            assert gen is None
            break
        C, valid_c, bitmap, m_cap = gen
        Ch, v = C.numpy(), valid_c.numpy()
        assert [tuple(int(x) for x in row) for row in Ch[v]] == want
        ref_bitmap = pad_candidates(itemsets_to_bitmap(want, n_items), m_cap)
        assert (bitmap.numpy() == ref_bitmap).all()
        counts = rng.integers(0, 10, size=len(want))
        acc = torch.zeros(m_cap, dtype=torch.int32)
        acc[:len(want)] = torch.from_numpy(counts.astype(np.int32))
        packed, Fn, vn = lat.finalize(acc, C, valid_c, min_sup)
        assert packed.dtype == torch.int32
        m_true, f_true = lat.advance(packed.numpy(), Fn, vn, min_sup)
        frequent = [c for c, s in zip(want, counts) if s >= min_sup]
        assert m_true == len(want) and f_true == len(frequent)
        expect.update({c: int(s) for c, s in zip(want, counts)
                       if s >= min_sup})
        if not frequent:
            break
    assert lat.decode_supports() == expect


def test_ingest_paths_agree():
    T = _corpus("small_db")
    cfg = _mk_cfg()
    base = MarketBasketPipeline(config=cfg).run(T)
    lists = [list(np.nonzero(row)[0]) for row in T]
    for baskets in (lists, SparseSlab.from_dense(T)):
        res = MarketBasketPipeline(config=cfg).run(baskets)
        assert res.supports == base.supports and res.rules == base.rules


def test_config_refuses_what_the_port_cannot_run():
    with pytest.raises(ValueError, match="not ported"):
        PipelineConfig(policy="costmodel", device="cpu")
    with pytest.raises(ValueError):
        MarketBasketPipeline(config=_mk_cfg(data_plane="cuda"))
    with pytest.raises(ValueError):
        MarketBasketPipeline(config=_mk_cfg(data_plane="pallas"))
    with pytest.raises(ValueError):
        MarketBasketPipeline(config=_mk_cfg(round_execution="bogus"))
    with pytest.raises(ValueError):
        MarketBasketPipeline(config=_mk_cfg(tuning={"variant": "bogus"}))


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default config is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        PipelineConfig()
