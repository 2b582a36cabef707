"""The port's SON out-of-core plane, held against the reference's.

Mirrors ``tests/test_son.py`` (bar its 8-rank sharded case, which
``tests/test_torch_sharded.py`` runs on 8 gloo ranks): the same corpora
(made with the same numpy code from the same seeds) go through
``repro.mining.SONMiner`` (data plane ``ref``) and
``repro_torch.mining.SONMiner`` on the CPU.  Supports, rules, report counts
and every ledger field but the host wall time must be equal — phase names,
syncs and bytes included — and both must equal the single-shot pipeline.
A workdir killed at any partition boundary resumes bit-identically under
either package, and a rule index goes through ``save`` → ``load`` in either
package's store and serves the same recommendations.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data.baskets import BasketConfig as RefBasketConfig  # noqa: E402
from repro.data.baskets import generate_baskets as ref_generate  # noqa: E402
from repro.data.baskets import sparse_baskets as ref_sparse  # noqa: E402
from repro.data.sparse import SparseSlab as RefSlab  # noqa: E402
from repro.data.sparse import density_stats as ref_density_stats  # noqa: E402
from repro.core.mapreduce import FailureEvent as RefFailureEvent  # noqa: E402
from repro.mining import SONConfig as RefSONConfig  # noqa: E402
from repro.mining import SONKilled as RefSONKilled  # noqa: E402
from repro.mining import local_min_support as ref_local_min_support  # noqa: E402
from repro.mining import make_miner as ref_make_miner  # noqa: E402
from repro.mining import partition_stats as ref_partition_stats  # noqa: E402
from repro.mining.son import corpus_fingerprint as ref_fingerprint  # noqa: E402
from repro.mining.son import partition_slices as ref_partition_slices  # noqa: E402
from repro.pipeline import PipelineConfig as RefConfig  # noqa: E402
from repro.serving import RuleIndex as RefRuleIndex  # noqa: E402
from repro_torch.core.mapreduce import FailureEvent  # noqa: E402
from repro_torch.data.baskets import (BasketConfig,  # noqa: E402
                                      generate_baskets, sparse_baskets)
from repro_torch.data.sparse import SparseSlab, density_stats  # noqa: E402
from repro_torch.mining import (SONConfig, SONKilled, SONMiner,  # noqa: E402
                                local_min_support, make_miner,
                                partition_stats)
from repro_torch.mining.son import (corpus_fingerprint,  # noqa: E402
                                    partition_slices)
from repro_torch.pipeline import (MarketBasketPipeline,  # noqa: E402
                                  PipelineConfig)
from repro_torch.serving import (Query, RecommendationEngine,  # noqa: E402
                                 RuleIndex, ServingConfig)
from test_torch_autotune import costmodel_pair  # noqa: E402

ROWS = 64          # partition size → 3 partitions on the 192-row corpora
DENSE = dict(n_tx=192, n_items=24, seed=1)
# item frequencies well above the global threshold used below: SON's
# per-partition threshold floor(G * rows / n_tx) must stay >= 2, or pass 1
# degenerates into mining every subset of every transaction
SPARSE = dict(n_tx=192, n_items=256, seed=2, max_item_freq=0.15)


def _corpus(name):
    """(port input, reference input) made by each package's own code."""
    if name == "dense":
        T = generate_baskets(BasketConfig(**DENSE))
        assert T.tobytes() == ref_generate(RefBasketConfig(**DENSE)).tobytes()
        return T, T
    lists = sparse_baskets(**SPARSE)
    assert lists == ref_sparse(**SPARSE)
    return (SparseSlab.from_baskets(lists, n_items=SPARSE["n_items"]),
            RefSlab.from_baskets(lists, n_items=SPARSE["n_items"]))


def _cfg(algorithm="apriori", policy="static", min_support=0.05, **kw):
    return dict(min_support=min_support, algorithm=algorithm, policy=policy,
                n_tiles=4, **kw)


def _policy(common, side):
    """The policy argument for one package (0 reference, 1 port): equal
    ``costmodel`` instances fed support_count's measured walls (see
    ``test_torch_autotune.costmodel_pair``), else the config's name."""
    if common.get("policy") == "costmodel":
        return costmodel_pair("support_count")[side]
    return None


def port_son(T, common, workdir, **kw):
    son = SONConfig(workdir=str(workdir), partition_rows=ROWS, **kw)
    miner, choice = make_miner(T, config=PipelineConfig(device="cpu",
                                                        **common), son=son,
                               policy=_policy(common, 1))
    assert choice is None and isinstance(miner, SONMiner)
    return miner.run(T), miner


def ref_son(T, common, workdir, **kw):
    son = RefSONConfig(workdir=str(workdir), partition_rows=ROWS, **kw)
    miner, _ = ref_make_miner(T, config=RefConfig(data_plane="ref",
                                                  **common), son=son,
                              policy=_policy(common, 0))
    return miner.run(T), miner


def single_shot(T, common):
    """The oracle: one in-core Apriori pipeline over the whole corpus."""
    cfg = PipelineConfig(device="cpu", **dict(common, algorithm="apriori",
                                              policy="static"))
    return MarketBasketPipeline(config=cfg).run(T)


# each reference mine once per module (the first jit-compiles for seconds)
_REF = {}


@pytest.fixture(scope="module")
def ref_mine(tmp_path_factory):
    def mine(dataset, **common):
        key = (dataset, tuple(sorted(common.items())))
        if key not in _REF:
            _, ref_in = _corpus(dataset)
            wd = tmp_path_factory.mktemp("ref_son")
            _REF[key] = ref_son(ref_in, _cfg(**common), wd)[0]
        return _REF[key]
    return mine


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


def _assert_same_son(ref, port):
    """Supports, rules, report counts and the whole ledger, walls aside."""
    assert port.supports == ref.supports
    assert _rules(port) == _rules(ref)
    assert port.n_tx == ref.n_tx
    assert _plain(port.report.rules_phase) == _plain(ref.report.rules_phase)
    assert len(port.report.ledger.phases) == len(ref.report.ledger.phases)
    for p, r in zip(port.report.ledger.phases, ref.report.ledger.phases):
        assert _plain(p) == _plain(r), p.name
    for attr in ("backend", "policy", "algorithm", "split", "n_tx",
                 "n_items", "n_tiles", "min_support", "n_itemsets",
                 "n_rules", "execution", "n_partitions", "partition_rows",
                 "partitions_resumed", "checkpoint_saves",
                 "checkpoint_bytes", "replans", "total_time_s",
                 "total_energy_j", "total_switches"):
        assert getattr(port.report, attr) == getattr(ref.report, attr), attr


# ---------------------------------------------------------------------------
# SON partition math
# ---------------------------------------------------------------------------

def test_local_threshold_floor_guarantees_no_false_negatives():
    # sum of the per-partition floors never exceeds the global threshold:
    # an itemset below the local bound everywhere is below G globally
    for n_tx, rows, G in [(192, 64, 10), (1000, 128, 37), (97, 10, 5)]:
        parts = partition_slices(n_tx, rows)
        assert parts == ref_partition_slices(n_tx, rows)
        total = sum(local_min_support(G, hi - lo, n_tx) - 1
                    for lo, hi in parts)
        assert total < G
        assert all(local_min_support(G, hi - lo, n_tx) >= 1
                   for lo, hi in parts)
        assert [local_min_support(G, hi - lo, n_tx) for lo, hi in parts] \
            == [ref_local_min_support(G, hi - lo, n_tx) for lo, hi in parts]


def test_partition_stats_scales_features():
    T, _ = _corpus("dense")
    stats = density_stats(T)
    ps = partition_stats(stats, 64)
    assert ps.n_tx == 64 and ps.n_items == stats.n_items
    assert ps.nnz < stats.nnz
    np.testing.assert_array_equal(
        ps.item_counts, (stats.item_counts * (64 / stats.n_tx)).astype(int))
    ref = ref_partition_stats(ref_density_stats(T), 64)
    assert (ps.n_tx, ps.n_items, ps.nnz, ps.density,
            ps.max_item_frequency) == (ref.n_tx, ref.n_items, ref.nnz,
                                       ref.density, ref.max_item_frequency)
    np.testing.assert_array_equal(ps.item_counts, ref.item_counts)


@pytest.mark.parametrize("dataset", ["dense", "sparse"])
@pytest.mark.parametrize("algorithm", ["apriori", "eclat", "auto"])
def test_corpus_fingerprint_is_the_references(dataset, algorithm):
    port_in, ref_in = _corpus(dataset)
    common = _cfg(algorithm)
    got = corpus_fingerprint(density_stats(port_in),
                             PipelineConfig(device="cpu", **common), ROWS)
    want = ref_fingerprint(ref_density_stats(ref_in),
                           RefConfig(data_plane="ref", **common), ROWS)
    assert got == want and len(got) == 16


# ---------------------------------------------------------------------------
# bit-identity vs the single-shot pipeline and the reference's SON
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["static", "dynamic", "costmodel"])
@pytest.mark.parametrize("dataset,algorithm,min_support", [
    ("dense", "apriori", 0.05),
    ("dense", "eclat", 0.05),
    ("sparse", "apriori", 0.08),
    ("sparse", "eclat", 0.08),
])
def test_son_matches_single_shot_and_reference(tmp_path, ref_mine, dataset,
                                               algorithm, min_support,
                                               policy):
    port_in, _ = _corpus(dataset)
    common = _cfg(algorithm, policy, min_support)
    oracle = single_shot(port_in, common)
    assert oracle.supports, "oracle mined nothing — corpus too sparse"
    result, _ = port_son(port_in, common, tmp_path)
    assert result.supports == oracle.supports
    assert _rules(result) == _rules(oracle)
    assert result.report.execution == "out_of_core"
    assert result.report.n_partitions == len(partition_slices(
        density_stats(port_in).n_tx, ROWS))
    assert result.report.partitions_resumed == 0
    _assert_same_son(ref_mine(dataset, algorithm=algorithm, policy=policy,
                              min_support=min_support), result)


def test_auto_selects_one_global_algorithm(tmp_path, ref_mine):
    T, _ = _corpus("dense")
    common = _cfg("auto")
    result, miner = port_son(T, common, tmp_path)
    assert miner.algorithm_choice is not None
    assert result.report.algorithm == miner.algorithm_choice.algorithm
    oracle = single_shot(T, common)
    assert result.supports == oracle.supports
    assert _rules(result) == _rules(oracle)
    ref = ref_mine("dense", algorithm="auto")
    assert result.supports == ref.supports and _rules(result) == _rules(ref)


@pytest.mark.parametrize("policy", ["static", "dynamic", "costmodel"])
def test_partition_failures_replan_like_the_reference(tmp_path, policy):
    """A core that dies inside partition 1's local pass re-plans there, as
    the reference's does, and the answer does not change."""
    port_in, ref_in = _corpus("dense")
    common = _cfg(policy=policy)
    port, _ = port_son(port_in, common, tmp_path / "port")
    miner, _ = make_miner(port_in, config=PipelineConfig(
        device="cpu", **common), son=SONConfig(
            workdir=str(tmp_path / "port_f"), partition_rows=ROWS),
        policy=_policy(common, 1))
    failed = miner.run(port_in, {1: [FailureEvent(3, 1.0)]})
    rminer, _ = ref_make_miner(ref_in, config=RefConfig(
        data_plane="ref", **common), son=RefSONConfig(
            workdir=str(tmp_path / "ref_f"), partition_rows=ROWS),
        policy=_policy(common, 0))
    ref_failed = rminer.run(ref_in, {1: [RefFailureEvent(3, 1.0)]})
    assert failed.supports == port.supports
    assert _rules(failed) == _rules(port)
    assert any(3 in r.failed_devices for r in failed.report.ledger.phases)
    _assert_same_son(ref_failed, failed)


# ---------------------------------------------------------------------------
# kill-and-resume, within the port and across the packages
# ---------------------------------------------------------------------------

N_BOUNDARIES = 6   # 3 partitions x 2 passes


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """The uninterrupted port mine every resume is held to."""
    T, _ = _corpus("dense")
    result, _ = port_son(T, _cfg(), tmp_path_factory.mktemp("base"))
    assert 2 * result.report.n_partitions == N_BOUNDARIES
    return result


@pytest.mark.parametrize("n", range(1, N_BOUNDARIES + 1))
def test_kill_at_every_partition_boundary_resumes_bit_identical(
        tmp_path, base, n):
    T, _ = _corpus("dense")
    with pytest.raises(SONKilled) as ei:
        port_son(T, _cfg(), tmp_path, abort_after=n)
    assert ei.value.boundary == n
    resumed, _ = port_son(T, _cfg(), tmp_path, resume=True)
    assert resumed.supports == base.supports, f"kill at boundary {n}"
    assert _rules(resumed) == _rules(base), f"kill at boundary {n}"
    assert resumed.report.partitions_resumed == n


@pytest.mark.parametrize("n", range(1, N_BOUNDARIES + 1))
@pytest.mark.parametrize("killed_by", ["reference", "port"])
def test_kill_under_one_package_resumes_under_the_other(tmp_path, base,
                                                        killed_by, n):
    """The workdir format, checkpoints and fingerprint are shared: a mine
    killed at boundary n under one package finishes under the other with
    the uninterrupted answer and the reference's resumed ledger."""
    port_in, ref_in = _corpus("dense")
    common = _cfg()
    kill, kill_exc = ((ref_son, RefSONKilled) if killed_by == "reference"
                      else (port_son, SONKilled))
    with pytest.raises(kill_exc):
        kill(ref_in if killed_by == "reference" else port_in, common,
             tmp_path / "a", abort_after=n)
    # the same kill twice, so each package resumes its own copy
    with pytest.raises(kill_exc):
        kill(ref_in if killed_by == "reference" else port_in, common,
             tmp_path / "b", abort_after=n)
    resumed, _ = port_son(port_in, common, tmp_path / "a", resume=True)
    ref_resumed, _ = ref_son(ref_in, common, tmp_path / "b", resume=True)
    assert resumed.supports == base.supports
    assert _rules(resumed) == _rules(base)
    assert resumed.report.partitions_resumed == n
    _assert_same_son(ref_resumed, resumed)


def test_ledger_prices_every_partition_and_checkpoint(tmp_path, ref_mine):
    T, _ = _corpus("dense")
    result, _ = port_son(T, _cfg(), tmp_path)
    P = result.report.n_partitions
    phases = result.report.ledger.phases
    names = [r.name for r in phases]
    for p in range(P):
        assert f"son-spill-p{p}" in names             # pass-0 spill write
        assert names.count(f"son-load-p{p}") == 2     # pass-1 + pass-2 loads
        assert any(n.startswith(f"son-p{p}/") for n in names)  # local pass
        assert f"son-recount-p{p}" in names           # global re-count
    ckpts = [n for n in names if n.startswith("son-ckpt-b")]
    assert len(ckpts) == 2 * P == result.report.checkpoint_saves
    assert result.report.checkpoint_bytes > 0
    assert all(r.sim_time_s > 0 and r.energy_j > 0 for r in phases)
    assert "mba-rules" in names
    # each chunk's re-count reads back once: one int32 vector, widened
    recounts = [r for r in phases if r.name.startswith("son-recount-p")]
    assert [r.syncs for r in recounts] == [1] * P
    assert len({r.d2h_bytes for r in recounts}) == 1
    assert all(r.h2d_bytes > 0 for r in recounts)
    _assert_same_son(ref_mine("dense"), result)


def test_resume_rejects_mismatched_job(tmp_path):
    T, _ = _corpus("dense")
    with pytest.raises(SONKilled):
        port_son(T, _cfg(min_support=0.05), tmp_path, abort_after=2)
    with pytest.raises(ValueError, match="fingerprint"):
        port_son(T, _cfg(min_support=0.10), tmp_path, resume=True)


def test_resume_without_spill_errors(tmp_path):
    T, _ = _corpus("dense")
    with pytest.raises(FileNotFoundError, match="resume"):
        port_son(T, _cfg(), tmp_path / "nothing", resume=True)


# ---------------------------------------------------------------------------
# what is refused
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["no_son_config", "no_workdir",
                                  "zero_rows"])
def test_refused(tmp_path, case):
    cpu = PipelineConfig(device="cpu")
    if case == "no_son_config":
        with pytest.raises(ValueError, match="requires a SONConfig"):
            SONMiner(config=cpu)
    elif case == "no_workdir":
        with pytest.raises(ValueError, match="workdir is required"):
            SONConfig(workdir="")
    else:
        with pytest.raises(ValueError, match="partition_rows"):
            SONConfig(workdir=str(tmp_path), partition_rows=0)


# ---------------------------------------------------------------------------
# the mined rules through RuleIndex.save -> load
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("saved_by", ["port", "reference"])
def test_rule_index_save_load_serves_the_same(tmp_path, ref_mine, saved_by):
    T, _ = _corpus("dense")
    result, _ = port_son(T, _cfg(), tmp_path / "son")
    index = RuleIndex.build(result.rules, T.shape[1], version=3)
    ref_index = RefRuleIndex.build(ref_mine("dense").rules, T.shape[1],
                                   version=3)
    d = str(tmp_path / "index")
    (index if saved_by == "port" else ref_index).save(d)
    loaded = RuleIndex.load(d)
    assert loaded.same_arrays(index)
    assert (loaded.n_rows, loaded.n_rules, loaded.n_items, loaded.version) \
        == (index.n_rows, index.n_rules, index.n_items, 3)
    assert RuleIndex.load(d, version=3).same_arrays(index)
    ref_loaded = RefRuleIndex.load(d)
    for f in ("ante", "sizes", "conf", "lift", "support", "cons"):
        np.testing.assert_array_equal(getattr(ref_loaded, f),
                                      getattr(index, f))
    queries = [Query.of(np.flatnonzero(row).tolist()) for row in T[:48]]
    cfg = ServingConfig(k=3, device="cpu")
    want, _ = RecommendationEngine(index, config=cfg).serve(queries)
    got, _ = RecommendationEngine(loaded, config=cfg).serve(queries)
    assert got == want and any(want)


def test_rule_index_load_refuses_other_checkpoints(tmp_path):
    T, _ = _corpus("dense")
    result, _ = port_son(T, _cfg(), tmp_path / "son")
    with pytest.raises(ValueError, match="not a rule index"):
        RuleIndex.load(str(tmp_path / "son" / "state"))
    with pytest.raises(FileNotFoundError, match="no rule index"):
        RuleIndex.load(str(tmp_path / "nothing"))
