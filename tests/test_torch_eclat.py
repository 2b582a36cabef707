"""The port's vertical (Eclat) mining plane, algorithm auto-selection and
``make_miner``, held against the reference.

Same corpora (made with the same numpy code from the same seed) go through
``repro.mining.EclatMiner`` (data plane ``ref``) and
``repro_torch.mining.EclatMiner`` on the CPU.  Supports, rules in order,
round reports and every ledger field but the host wall time must be equal
— including the h2d/d2h bytes and syncs, which pin the
one-readback-per-round contract.  The auto-selector must price and pick
exactly as the reference does under equal kernel rates.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.mapreduce import FailureEvent as RefFailureEvent  # noqa: E402
from repro.data.baskets import BasketConfig as RefBasketConfig  # noqa: E402
from repro.data.baskets import generate_baskets as ref_generate  # noqa: E402
from repro.data.sparse import SparseSlab as RefSlab  # noqa: E402
from repro.data.sparse import density_stats as ref_density_stats  # noqa: E402
from repro.data.sparse import (  # noqa: E402
    pack_tid_columns as ref_pack_tid_columns)
from repro.launch.tuning import (  # noqa: E402
    shape_flops_bytes as ref_shape_flops_bytes)
from repro.mining import AlgorithmCostModel as RefCostModel  # noqa: E402
from repro.mining import EclatMiner as RefEclat  # noqa: E402
from repro.mining import local_min_support as ref_local_min_support  # noqa: E402
from repro.mining import make_miner as ref_make_miner  # noqa: E402
from repro.mining import partition_stats as ref_partition_stats  # noqa: E402
from repro.mining import (  # noqa: E402
    select_partition_algorithm as ref_select_partition_algorithm)
from repro.pipeline import PipelineConfig as RefConfig  # noqa: E402
from repro_torch.core.itemsets import apriori_bruteforce  # noqa: E402
from repro_torch.core.mapreduce import FailureEvent  # noqa: E402
from repro_torch.data.baskets import (BasketConfig,  # noqa: E402
                                      generate_baskets, sparse_baskets)
from repro_torch.data.sparse import (SparseSlab, density_stats,  # noqa: E402
                                     pack_tid_columns)
from repro_torch.kernels.support_count.intersect import (  # noqa: E402
    intersect_count_words)
from repro_torch.launch.tuning import shape_flops_bytes  # noqa: E402
from repro_torch.mining import (AlgorithmCostModel, EclatMiner,  # noqa: E402
                                SONConfig, SONMiner, local_min_support,
                                make_miner,
                                partition_stats, select_algorithm,
                                select_partition_algorithm)
from repro_torch.pipeline import (MarketBasketPipeline,  # noqa: E402
                                  PipelineConfig)
from test_torch_autotune import costmodel_pair  # noqa: E402

# (BasketConfig kwargs, min_support, n_tiles): test_eclat.py's dense corpus
# and the quickstart corpus
DENSE = {
    "dense": (dict(n_tx=600, n_items=48, seed=0), 0.05, 8),
    "quickstart": (dict(n_tx=4096, n_items=96, seed=42), 80, 32),
}
# a small retail-regime corpus: a 1,024-item universe, ~0.6% noise item
# frequency, 20 patterns near 4% (60 frequent items at 2% support)
SPARSE = (dict(n_tx=1000, n_items=1024, basket_len=6, max_item_freq=0.04,
               seed=4), 0.02, 8)


def _dense(name):
    kw = DENSE[name][0]
    T = generate_baskets(BasketConfig(**kw))
    assert T.tobytes() == ref_generate(RefBasketConfig(**kw)).tobytes()
    return T


def _sparse_lists():
    kw = dict(SPARSE[0])
    return sparse_baskets(**kw), kw["n_items"]


def _corpus(name):
    """(port input, reference input, min_support, n_tiles)."""
    if name == "sparse":
        lists, n_items = _sparse_lists()
        port = SparseSlab.from_baskets(lists, n_items=n_items)
        ref = RefSlab.from_baskets(lists, n_items=n_items)
        np.testing.assert_array_equal(port.indices, ref.indices)
        return port, ref, SPARSE[1], SPARSE[2]
    T = _dense(name)
    return T, T, DENSE[name][1], DENSE[name][2]


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


def _rules(res):
    return [dataclasses.astuple(r) for r in res.rules]


def _assert_same_mine(ref, port):
    assert port.supports == ref.supports
    assert _rules(port) == _rules(ref)
    assert port.n_tx == ref.n_tx
    assert _plain(port.report.rounds) == _plain(ref.report.rounds)
    assert _plain(port.report.rules_phase) == _plain(ref.report.rules_phase)
    assert len(port.report.ledger.phases) == len(ref.report.ledger.phases)
    for p, r in zip(port.report.ledger.phases, ref.report.ledger.phases):
        assert _plain(p) == _plain(r), p.name
    for attr in ("backend", "policy", "algorithm", "split", "n_tx",
                 "n_items", "n_tiles", "min_support", "n_itemsets",
                 "n_rules", "total_time_s", "total_energy_j",
                 "total_switches"):
        assert getattr(port.report, attr) == getattr(ref.report, attr), attr


def _mine_both(port_in, ref_in, failures=(), **common):
    # costmodel: equal instances for both packages, fed the intersect
    # kernel's measured walls (see test_torch_autotune.costmodel_pair)
    ref_policy, port_policy = (costmodel_pair("intersect_count")
                               if common.get("policy") == "costmodel"
                               else (None, None))
    ref = RefEclat(config=RefConfig(data_plane="ref", **common),
                   policy=ref_policy).run(
        ref_in, failures=[RefFailureEvent(*f) for f in failures])
    port = EclatMiner(config=PipelineConfig(device="cpu", **common),
                      policy=port_policy).run(
        port_in, failures=[FailureEvent(*f) for f in failures])
    return ref, port


# ---------------------------------------------------------------------------
# EclatMiner against the reference's, ledger and all
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("corpus", ["dense", "sparse"])
@pytest.mark.parametrize("policy", ["static", "dynamic", "costmodel"])
@pytest.mark.parametrize("rexec", ["pipelined", "per_tile"])
def test_eclat_mines_like_reference(corpus, policy, rexec):
    port_in, ref_in, min_support, n_tiles = _corpus(corpus)
    ref, port = _mine_both(port_in, ref_in, min_support=min_support,
                           n_tiles=n_tiles, policy=policy,
                           round_execution=rexec)
    assert port.report.backend == "ref" and port.report.algorithm == "eclat"
    assert len(port.report.rounds) >= 3 and port.rules
    _assert_same_mine(ref, port)
    maps = port.report.ledger.by_kind("map")
    if rexec == "pipelined":
        assert [p.syncs for p in maps] == [1] * len(maps)


@pytest.mark.parametrize("policy", ["static", "dynamic", "costmodel"])
def test_eclat_failure_replan_matches_reference(policy):
    """A core that dies mid-round: the re-plan, switches and energy must
    match the reference's, and the answer must not change."""
    T = _dense("quickstart")
    ref, port = _mine_both(T, T, failures=[(3, 1e3)], min_support=80,
                           n_tiles=32, policy=policy)
    _assert_same_mine(ref, port)
    assert port.report.total_switches > 0
    assert any(3 in r.failed_devices for r in port.report.rounds)


@pytest.mark.parametrize("form", ["bitmap", "id_lists", "slab"])
def test_input_forms_agree(form):
    """A dense bitmap, id lists and a sparse slab of the same corpus mine
    the same answer as the reference does from that form."""
    T = _dense("dense")
    lists = [np.flatnonzero(row).tolist() for row in T]
    port_in, ref_in = {
        "bitmap": (T, T),
        "id_lists": (lists, lists),
        "slab": (SparseSlab.from_dense(T), RefSlab.from_dense(T)),
    }[form]
    ref, port = _mine_both(port_in, ref_in, min_support=0.05, n_tiles=8)
    _assert_same_mine(ref, port)
    bitmap = EclatMiner(config=PipelineConfig(
        device="cpu", min_support=0.05, n_tiles=8)).run(T)
    assert port.supports == bitmap.supports
    assert _rules(port) == _rules(bitmap)


# (n_tx, n_items): one word, n_tx not a multiple of 8 or 32, a multiple of
# 32, several words, more items than one row pad
PACK_SHAPES = [(1, 1), (7, 3), (31, 5), (32, 4), (33, 2), (100, 7),
               (257, 130), (1000, 200)]


@pytest.mark.parametrize("shape", PACK_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_pack_tid_columns_is_byte_equal_to_the_csr_route(shape):
    """The direct packing gives the bytes of the CSR scatter (the route it
    replaced) and of the reference, with all-zero columns and bit 31 of
    every word set in the first column."""
    n_tx, n_items = shape
    T = (np.random.default_rng(n_tx + n_items).random(shape) < 0.4
         ).astype(np.uint8)
    T[:, -1] = 0                                  # an all-zero column
    T[31::32, 0] = 1                              # bit 31 of each word
    want = SparseSlab.from_dense(T).tid_columns()
    for bitmap in (T, T.astype(bool), T.astype(np.float32)):
        got = pack_tid_columns(bitmap)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
    assert pack_tid_columns(T).tobytes() == ref_pack_tid_columns(T).tobytes()
    if n_tx >= 32:
        assert want[0, 0] >> 31 == 1
    for pads in ((8, 4), (1, 1)):
        assert (pack_tid_columns(T, *pads).tobytes()
                == SparseSlab.from_dense(T).tid_columns(*pads).tobytes())


@pytest.mark.parametrize("bad", [np.full((4, 3), 2, np.uint8),
                                 np.full((4, 3), 0.5), np.full((4, 3), -1)],
                         ids=["two", "half", "minus_one"])
def test_pack_tid_columns_refuses_non_binary(bad):
    with pytest.raises(ValueError):
        pack_tid_columns(bad)
    with pytest.raises(ValueError):
        SparseSlab.from_dense(bad)


def test_sparse_input_never_densifies(monkeypatch):
    slab = SparseSlab.from_baskets(sparse_baskets(300, 256, seed=4),
                                   n_items=256)
    monkeypatch.setattr(
        SparseSlab, "to_dense",
        lambda self: (_ for _ in ()).throw(
            AssertionError("eclat densified the sparse slab")))
    res = EclatMiner(config=PipelineConfig(device="cpu", min_support=0.02,
                                           n_tiles=8)).run(slab)
    assert res.report.algorithm == "eclat"
    assert res.report.n_itemsets > 0


def _edge(name):
    if name == "no_frequent":
        # support in *every* transaction
        return _dense_small(100, 16, 1), dict(min_support=1.0)
    if name == "single_survivor":
        # exactly one frequent item: no pairs to intersect, no rules
        T = np.zeros((40, 8), np.uint8)
        T[:, 3] = 1
        T[:5, 0] = 1
        return T, dict(min_support=0.5)
    # every item in every basket: the lattice saturates at max_k
    return np.ones((30, 5), np.uint8), dict(min_support=0.9, max_k=3)


def _dense_small(n_tx, n_items, seed):
    return generate_baskets(BasketConfig(n_tx=n_tx, n_items=n_items,
                                         seed=seed))


@pytest.mark.parametrize("edge", ["no_frequent", "single_survivor",
                                  "all_frequent"])
def test_edge_corpora_match_reference(edge):
    T, kw = _edge(edge)
    ref, port = _mine_both(T, T, n_tiles=8, **kw)
    _assert_same_mine(ref, port)
    apriori = MarketBasketPipeline(config=PipelineConfig(
        device="cpu", n_tiles=8, **kw)).run(T)
    assert port.supports == apriori.supports
    if edge == "no_frequent":
        assert port.supports == {} and port.rules == []
    elif edge == "single_survivor":
        assert port.supports == {(3,): 40} and port.rules == []
    else:
        assert all(v == 30 for v in port.supports.values())
        assert max(len(c) for c in port.supports) == 3


@pytest.mark.parametrize("rexec", ["pipelined", "per_tile"])
def test_supports_equal_bruteforce_and_apriori(rexec):
    T = _dense("dense")
    cfg = PipelineConfig(device="cpu", min_support=0.05, n_tiles=8,
                         round_execution=rexec)
    eclat = EclatMiner(config=cfg).run(T)
    apriori = MarketBasketPipeline(config=cfg).run(T)
    assert eclat.supports == apriori.supports
    assert _rules(eclat) == _rules(apriori)
    assert eclat.supports == apriori_bruteforce(
        T, cfg.abs_support(T.shape[0]), max_k=8)


# ---------------------------------------------------------------------------
# auto-selection and make_miner
# ---------------------------------------------------------------------------

SLOW, FAST = (1e3, 1e3), (1e15, 1e15)


@pytest.mark.parametrize("fast", ["apriori", "eclat"])
def test_scripted_rates_force_each_algorithm(fast):
    T = _dense_small(256, 32, 8)
    rates = {"support_count": FAST if fast == "apriori" else SLOW,
             "intersect_count": FAST if fast == "eclat" else SLOW}
    pick = select_algorithm(T, 13, model=AlgorithmCostModel(rates))
    assert pick.algorithm == fast
    assert pick.est_cost_s[fast] == min(pick.est_cost_s.values())
    assert pick.features["n_tx"] == 256.0
    miner, choice = make_miner(T, config=PipelineConfig(
        device="cpu", algorithm="auto", min_support=0.05),
        model=AlgorithmCostModel(rates))
    assert choice.algorithm == fast
    assert isinstance(miner, EclatMiner if fast == "eclat"
                      else MarketBasketPipeline)
    assert f"auto-selected {fast}" in choice.summary()
    ref_miner, ref_choice = ref_make_miner(
        T, config=RefConfig(algorithm="auto", min_support=0.05),
        model=RefCostModel(rates))
    assert type(ref_miner).__name__ == type(miner).__name__
    assert choice.summary() == ref_choice.summary()


# rates equal in both packages, so nothing depends on either's datasheet
RATES = [{"support_count": (197e12, 819e9), "intersect_count": (197e12,
                                                                 819e9)},
         {"support_count": (1e12, 1e12), "intersect_count": (5e10, 2e9)}]


def _stats_pair(name):
    port_in, ref_in, min_support, _ = _corpus(name)
    port, ref = density_stats(port_in), ref_density_stats(ref_in)
    return port, ref, PipelineConfig(min_support=min_support,
                                     device="cpu").abs_support(port.n_tx)


def _same_choice(got, want):
    assert got.algorithm == want.algorithm
    assert got.est_cost_s == want.est_cost_s         # bit for bit
    assert got.features == want.features
    assert got.cost_source == want.cost_source


@pytest.mark.parametrize("rates", [0, 1])
@pytest.mark.parametrize("corpus", ["dense", "quickstart", "sparse"])
def test_estimate_equals_reference(corpus, rates):
    port, ref, min_sup = _stats_pair(corpus)
    assert (port.n_tx, port.n_items, port.nnz, port.density) == \
        (ref.n_tx, ref.n_items, ref.nnz, ref.density)
    np.testing.assert_array_equal(port.item_counts, ref.item_counts)
    for sup in (min_sup, 1, 10**9):
        _same_choice(AlgorithmCostModel(RATES[rates]).estimate(port, sup),
                     RefCostModel(RATES[rates]).estimate(ref, sup))


def test_default_model_prices_at_the_h100_roofline():
    from repro_torch.launch.roofline import HBM_BW, PEAK_FLOPS
    assert (PEAK_FLOPS, HBM_BW) == (989e12, 3.35e12)
    port, _, min_sup = _stats_pair("dense")
    got = AlgorithmCostModel().estimate(port, min_sup)
    _same_choice(got, AlgorithmCostModel(
        {"support_count": (PEAK_FLOPS, HBM_BW),
         "intersect_count": (PEAK_FLOPS, HBM_BW)}).estimate(port, min_sup))
    assert got.cost_source == {"support_count": "roofline",
                               "intersect_count": "roofline"}


@pytest.mark.parametrize("kernel,shape", [
    ("intersect_count", (2176, 3200)), ("intersect_count", (1, 1)),
    ("support_count", (100_000, 2176, 1024)), ("rule_match", (64, 896, 1024))])
def test_shape_flops_bytes_equals_reference(kernel, shape):
    assert shape_flops_bytes(kernel, shape) == \
        ref_shape_flops_bytes(kernel, shape)


@pytest.mark.parametrize("corpus", ["quickstart", "sparse"])
def test_son_helpers_equal_reference(corpus):
    port, ref, min_sup = _stats_pair(corpus)
    for rows in (1, 100, 333, port.n_tx, 10 * port.n_tx):
        assert local_min_support(min_sup, rows, port.n_tx) == \
            ref_local_min_support(min_sup, rows, ref.n_tx)
        got, want = partition_stats(port, rows), ref_partition_stats(ref,
                                                                     rows)
        assert (got.n_tx, got.n_items, got.nnz, got.density,
                got.max_item_frequency) == (want.n_tx, want.n_items,
                                            want.nnz, want.density,
                                            want.max_item_frequency)
        np.testing.assert_array_equal(got.item_counts, want.item_counts)
        _same_choice(
            select_partition_algorithm(port, rows, min_sup,
                                       AlgorithmCostModel(RATES[1])),
            ref_select_partition_algorithm(ref, rows, min_sup,
                                           RefCostModel(RATES[1])))
    assert local_min_support(5, 10, 0) == ref_local_min_support(5, 10, 0)


@pytest.mark.parametrize("algorithm", ["apriori", "eclat", "auto"])
def test_make_miner_mines_like_the_reference(algorithm):
    """Each algorithm through make_miner gives the reference's supports and
    rules; explicit algorithms return no choice, ``auto`` its evidence."""
    T = _dense_small(500, 40, 10)
    common = dict(min_support=0.05, n_tiles=8, algorithm=algorithm)
    model = AlgorithmCostModel(RATES[0])
    miner, choice = make_miner(T, config=PipelineConfig(device="cpu",
                                                        **common),
                               model=model)
    ref_miner, ref_choice = ref_make_miner(
        T, config=RefConfig(data_plane="ref", **common),
        model=RefCostModel(RATES[0]))
    assert type(miner).__name__ == type(ref_miner).__name__
    assert (choice is None) == (algorithm != "auto")
    if choice is not None:
        _same_choice(choice, ref_choice)
    got, want = miner.run(T), ref_miner.run(T)
    _assert_same_mine(want, got)
    # every formulation mines the oracle's answer
    oracle = MarketBasketPipeline(config=PipelineConfig(
        device="cpu", min_support=0.05, n_tiles=8)).run(T)
    assert got.supports == oracle.supports
    assert _rules(got) == _rules(oracle)


def test_auto_with_the_default_model_mines_the_oracle_answer():
    port_in, _, min_support, n_tiles = _corpus("sparse")
    miner, choice = make_miner(port_in, config=PipelineConfig(
        device="cpu", algorithm="auto", min_support=min_support,
        n_tiles=n_tiles))
    assert choice.cost_source == {"support_count": "roofline",
                                  "intersect_count": "roofline"}
    res = miner.run(port_in)
    oracle = EclatMiner(config=PipelineConfig(
        device="cpu", min_support=min_support, n_tiles=n_tiles)).run(
            port_in)
    assert res.supports == oracle.supports
    assert _rules(res) == _rules(oracle)


def test_cpu_mines_launch_no_kernel():
    before = intersect_count_words.launches
    T = _dense("dense")
    EclatMiner(config=PipelineConfig(device="cpu", min_support=0.05)).run(T)
    assert intersect_count_words.launches == before


# ---------------------------------------------------------------------------
# what is refused
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["son", "unknown_algorithm",
                                  "unknown_data_plane", "cuda_on_cpu"])
def test_refused(case, tmp_path):
    T = _dense_small(64, 16, 0)
    cpu = PipelineConfig(device="cpu")
    if case == "son":
        # out-of-core SON is ported: make_miner routes son= to SONMiner
        miner, choice = make_miner(T, config=cpu, son=SONConfig(
            workdir=str(tmp_path), partition_rows=32))
        assert isinstance(miner, SONMiner) and choice is None
        assert miner.run(T).supports == MarketBasketPipeline(
            config=cpu).run(T).supports
    elif case == "unknown_algorithm":
        with pytest.raises(ValueError, match="unknown mining algorithm"):
            PipelineConfig(device="cpu", algorithm="fpgrowth")
    elif case == "unknown_data_plane":
        with pytest.raises(ValueError, match="unknown data plane"):
            EclatMiner(config=PipelineConfig(device="cpu",
                                             data_plane="pallas"))
    else:
        with pytest.raises(ValueError, match="needs a CUDA device"):
            EclatMiner(config=PipelineConfig(device="cpu",
                                             data_plane="cuda"))


def test_default_device_is_the_card():
    """make_miner and EclatMiner default to ``device="cuda"``; where no
    card is present that default raises rather than mining on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default does not raise")
    T = _dense_small(64, 16, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_miner(T)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EclatMiner()
