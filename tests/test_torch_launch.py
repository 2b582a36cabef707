"""The port's minimal Apriori driver and its mining and serving CLIs, held
against the reference's.

In process, on the CPU: ``repro_torch.core.itemsets.apriori`` (plain and
through the kernel wrapper's plain versions) against
``repro.core.itemsets.apriori`` with ``use_pallas=False``, and both against
``apriori_bruteforce``; ``repro_torch.launch.mine.mine`` against
``repro.launch.mine.mine`` in every single-device mode (dense and sparse,
Apriori, Eclat and auto, each switching policy, out of core with a kill and
its resume); ``repro_torch.launch.recommend.recommend`` closed-loop and
async against the reference's.  Supports, rules, recommendations, reports
and ledgers (walls aside) must be equal.

``--sharded`` runs in two subprocesses side by side, as
``tests/test_torch_sharded.py`` does: the reference on 8 forced host
devices (``XLA_FLAGS``), the port on the 8 gloo ranks its ``mine`` spawns.
Run as a script (``python tests/test_torch_launch.py reference|port
OUTDIR``), this file is one of them.  The command lines (``python -m
repro_torch.launch.mine ...``, ``... recommend ...``) run as subprocesses
too.  Only the reference side and the in-process tests import jax.
"""
import contextlib
import dataclasses
import json
import os
import signal
import subprocess
import sys
import tempfile
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
# seconds: each side's subprocess, and each command line
TIMEOUT_S = 300
# tests/test_itemsets.py's structured corpus and its threshold
STRUCTURED = (dict(n_tx=2000, n_items=40, n_patterns=3, pattern_len=3,
                   pattern_prob=0.5, seed=7), 60)
# the corpus of the in-process mine() cases (a smoke-sized IBM Quest draw)
MINE = dict(n_tx=1024, n_items=48, min_support=0.05, min_confidence=0.6,
            n_tiles=8, top=0)
RECOMMEND = dict(n_tx=2048, n_items=64, min_support=0.03, n_queries=1000)
SHARDED_CASES = ("sharded", "son_sharded")


def _plain(x):
    """Dataclasses/arrays/tuples -> JSON values, without the fields that
    time this process (host and run walls)."""
    if dataclasses.is_dataclass(x):
        x = {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {str(k): _plain(v) for k, v in x.items()
                if k not in ("host_time_s", "wall_time_s", "warm_wall_s")}
    if isinstance(x, (list, tuple, np.ndarray)):
        return [_plain(v) for v in x]
    if isinstance(x, np.generic):
        return x.item()
    return x


def _summary(result):
    """A mine as JSON: supports, rules, the report (walls aside) and the
    ledger's counts."""
    led = result.report.ledger
    return {
        "supports": sorted([list(k), v] for k, v in result.supports.items()),
        "rules": _plain([dataclasses.astuple(r) for r in result.rules]),
        "report": _plain(result.report),
        "ledger": {"n_phases": len(led.phases),
                   "names": [p.name for p in led.phases],
                   "syncs": sum(p.syncs for p in led.phases),
                   "h2d_bytes": sum(p.h2d_bytes for p in led.phases),
                   "d2h_bytes": sum(p.d2h_bytes for p in led.phases)},
    }


# ---------------------------------------------------------------------------
# the sharded subprocesses
# ---------------------------------------------------------------------------

def _sharded_mines(mine, workdir, **kw):
    """The reference CI's two sharded smokes through one package's mine:
    ``--sharded --smoke`` and ``--out-of-core --sharded --smoke --policy
    dynamic``."""
    return {
        "sharded": _summary(mine(sharded=True, smoke=True, top=0, **kw)),
        "son_sharded": _summary(mine(
            out_of_core=True, sharded=True, smoke=True, policy="dynamic",
            son_dir=os.path.join(workdir, "son"), top=0, **kw)),
    }


def _reference_side(out: Path) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    from repro.launch.mine import mine
    with tempfile.TemporaryDirectory() as wd:
        got = _sharded_mines(mine, wd)
    (out / "reference.json").write_text(json.dumps(got))


def _port_side(out: Path) -> None:
    from repro_torch.launch.mine import mine
    with tempfile.TemporaryDirectory() as wd:
        got = _sharded_mines(mine, wd, device="cpu", n_shards=8)
    (out / "port.json").write_text(json.dumps(got))


@pytest.fixture(scope="module")
def sharded_sides(subprocesses):
    """The two sharded sides' mines: ``(reference, port)``."""
    out = subprocesses["sides"]
    return tuple(json.loads((out / f"{side}.json").read_text())
                 for side in ("reference", "port"))


@pytest.mark.parametrize("case", SHARDED_CASES)
def test_sharded_mine_equals_reference(sharded_sides, case):
    ref, port = sharded_sides
    got, want = port[case], ref[case]
    assert got["supports"] == want["supports"]
    assert got["rules"] == want["rules"]
    assert got["ledger"] == want["ledger"]
    assert got["report"] == want["report"]
    if case == "sharded":
        assert got["report"]["execution"] == "sharded"
        assert got["report"]["n_shards"] == 8
    else:
        assert got["report"]["execution"] == "out_of_core"
        assert got["report"]["n_partitions"] == 4


# ---------------------------------------------------------------------------
# the reference, imported only where a test needs it
# ---------------------------------------------------------------------------

def _ref():
    class Ref:
        from repro.core import itemsets
        from repro.core.mapreduce import FailureEvent
        from repro.launch import mine, recommend
        from repro.mining import AlgorithmCostModel
        from repro.pipeline import pipeline
        from repro.data.baskets import BasketConfig
        from repro.serving import RuleIndex
    return Ref


# ---------------------------------------------------------------------------
# support_counts and the minimal Apriori driver
# ---------------------------------------------------------------------------

def _random_db(seed, n_tx=120, n_items=16, density=0.3):
    """A corpus as tests/test_itemsets.py's strategy draws them."""
    rng = np.random.default_rng(seed)
    return (rng.random((n_tx, n_items)) < density).astype(np.uint8)


def _itemsets_corpus(name):
    from repro_torch.data.baskets import BasketConfig, generate_baskets
    if name == "structured":
        kw, min_sup = STRUCTURED
        return generate_baskets(BasketConfig(**kw)), min_sup
    return _random_db(int(name[-1])), 12


@pytest.mark.parametrize("use_kernel", [False, True])
def test_support_counts_equal_reference(use_kernel):
    from repro_torch.core.itemsets import itemsets_to_bitmap, support_counts
    ref = _ref().itemsets
    T = np.array([[1, 1, 0, 1], [1, 0, 0, 1], [0, 1, 1, 0]], np.uint8)
    C = itemsets_to_bitmap([(0,), (0, 3), (1, 2), (0, 1, 3)], 4)
    got = support_counts(torch.from_numpy(T), torch.from_numpy(C),
                         use_kernel=use_kernel)
    assert got.dtype == torch.int32 and got.tolist() == [2, 2, 1, 1]
    T = _random_db(3, n_tx=300, n_items=40)
    C = (np.random.default_rng(4).random((70, 40)) < 0.06).astype(np.uint8)
    C[np.arange(70), np.arange(70) % 40] = 1     # no empty candidate
    got = support_counts(torch.from_numpy(T), torch.from_numpy(C),
                         use_kernel=use_kernel)
    want = np.asarray(ref.support_counts(T, C, use_pallas=False))
    np.testing.assert_array_equal(got.numpy(), want)


def _exec(rep):
    return {f: _plain(getattr(rep, f)) for f in (
        "makespan", "busy_s", "waves", "switches", "reissued",
        "failed_devices", "tiles_done", "energy_j")}


@pytest.mark.parametrize("failed", [False, True])
@pytest.mark.parametrize("n_tiles", [2, 4, 8])
@pytest.mark.parametrize("corpus", ["structured", "random1"])
def test_apriori_equals_reference(corpus, n_tiles, failed):
    from repro_torch.core.itemsets import (apriori, apriori_bruteforce,
                                           generate_candidates)
    from repro_torch.core.mapreduce import FailureEvent
    from repro_torch.runtime import TransferMeter
    ref = _ref()
    T, min_sup = _itemsets_corpus(corpus)
    # the fastest core dies early in every round
    events = ((lambda E: [E(device=3, at_time=0.5)]) if failed
              else (lambda E: None))
    meter = TransferMeter("cpu")
    got = apriori(T, min_sup, n_tiles=n_tiles, failures=events(FailureEvent),
                  device="cpu", meter=meter)
    want = ref.itemsets.apriori(T, min_sup, n_tiles=n_tiles,
                                failures=events(ref.FailureEvent))
    assert got.supports == want.supports
    assert got.supports == apriori_bruteforce(T, min_sup,
                                              max_k=T.shape[1])
    assert (got.n_tx, got.levels) == (want.n_tx, want.levels)
    assert [name for name, _ in got.reports] == \
        [name for name, _ in want.reports]
    for (_, g), (_, w) in zip(got.reports, want.reports):
        assert _exec(g) == _exec(w)
    if failed:
        # its tiles move to the survivors, every level
        assert all(rep.failed_devices == [3] and rep.switches
                   and rep.tiles_done[3] == 0 for _, rep in got.reports)
    # one upload a tile and a candidate batch; one read back a level
    n_cands = sum(len(generate_candidates(got.frequent(k - 1)))
                  for k in range(2, len(got.reports) + 1))
    assert meter.syncs == len(got.reports)
    assert meter.h2d_bytes == T.nbytes + n_cands * T.shape[1]
    assert meter.d2h_bytes == 4 * (T.shape[1] + n_cands)


def test_apriori_kernel_path_equals_plain_and_refuses_no_card():
    from repro_torch.core.itemsets import apriori
    T, min_sup = _itemsets_corpus("structured")
    plain = apriori(T, min_sup, n_tiles=4, device="cpu")
    kern = apriori(T, min_sup, n_tiles=4, device="cpu", use_kernel=True)
    assert kern.supports == plain.supports and kern.levels == plain.levels
    assert [_exec(r) for _, r in kern.reports] == \
        [_exec(r) for _, r in plain.reports]
    assert max(len(s) for s in plain.supports) >= 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            apriori(T, min_sup)


# ---------------------------------------------------------------------------
# mine(): every single-device mode against the reference's
# ---------------------------------------------------------------------------

# case -> mine() keywords beyond MINE
MINE_CASES = {
    # tests/test_system.py's two cases, at their own sizes
    "system_oracle": dict(n_tx=600, n_items=48, min_support=0.05,
                          min_confidence=0.5, n_tiles=8, top=0),
    "system_lpt": dict(n_tx=512, n_items=32, min_support=0.05, n_tiles=16,
                       split="lpt", top=0),
    "system_equal": dict(n_tx=512, n_items=32, min_support=0.05, n_tiles=16,
                         split="equal", top=0),
    "eclat_smoke": dict(MINE, algorithm="eclat", smoke=True),
    "auto": dict(MINE, algorithm="auto"),
    "sparse_eclat": dict(MINE, dataset="sparse", algorithm="eclat",
                         n_items=256),
    "sparse_apriori": dict(MINE, dataset="sparse", n_items=256),
    "dynamic": dict(MINE, policy="dynamic"),
    "costmodel": dict(MINE, policy="costmodel"),
    "per_tile": dict(MINE, round_execution="per_tile"),
}
# the auto case's kernel rates (peak, bandwidth), the same in both
# packages: each package's default model reads its own autotune cache
AUTO_RATES = {"support_count": (1e3, 1e3), "intersect_count": (1e15, 1e15)}


@contextlib.contextmanager
def _same_models(ref):
    """Both packages price ``auto`` and ``costmodel`` from equal inputs
    (on the CPU each package's default reads its own cache and data
    sheet)."""
    from test_torch_autotune import costmodel_pair

    from repro_torch.mining import AlgorithmCostModel
    from repro_torch.pipeline import pipeline

    with contextlib.ExitStack() as stack:
        for side, (model, module) in enumerate((
                (ref.AlgorithmCostModel, ref.pipeline),
                (AlgorithmCostModel, pipeline))):
            stack.enter_context(mock.patch.object(
                model, "from_autotune",
                lambda *a, model=model, **k: model(AUTO_RATES)))
            stack.enter_context(mock.patch.object(
                module, "autotuned_costmodel",
                lambda kernel, *a, side=side, **k:
                costmodel_pair(kernel)[side]))
        yield


@pytest.mark.parametrize("case", sorted(MINE_CASES))
def test_mine_equals_reference(case):
    from repro_torch.core.itemsets import apriori_bruteforce
    from repro_torch.data.baskets import (BasketConfig, generate_baskets,
                                          pad_items)
    from repro_torch.launch.mine import mine
    ref = _ref()
    kw = MINE_CASES[case]
    with _same_models(ref):
        got = mine(device="cpu", **kw)
        want = ref.mine.mine(**kw)
    assert _summary(got) == _summary(want)
    if case == "auto":
        assert got.report.algorithm == "eclat"
    if case == "system_oracle":
        T = pad_items(generate_baskets(BasketConfig(n_tx=600, n_items=48,
                                                    seed=0)))
        assert got.supports == apriori_bruteforce(T, 30, max_k=8)
        assert all(r.confidence >= 0.5 for r in got.rules)
    if case == "system_lpt":
        eq = mine(device="cpu", **MINE_CASES["system_equal"])
        assert got.report.total_time_s < eq.report.total_time_s
        assert got.supports == eq.supports


def test_mine_out_of_core_kill_and_resume_equal_reference(tmp_path):
    from repro_torch.launch.mine import mine
    ref = _ref()
    kw = dict(MINE, out_of_core=True, partition_rows=256, smoke=True)
    runs = {}
    for side, fn, extra in (("port", mine, {"device": "cpu"}),
                            ("reference", ref.mine.mine, {})):
        d = str(tmp_path / side)
        once = fn(son_dir=d + "/once", **kw, **extra)
        with pytest.raises(SystemExit) as e:
            fn(son_dir=d + "/killed", kill_after=2, **kw, **extra)
        assert e.value.code == 3
        resumed = fn(son_dir=d + "/killed", resume=True, **kw, **extra)
        runs[side] = (_summary(once), _summary(resumed), resumed)
    assert runs["port"][:2] == runs["reference"][:2]
    once, resumed, res = runs["port"]
    assert once["supports"] == resumed["supports"]
    assert once["rules"] == resumed["rules"]
    assert res.report.partitions_resumed == 2
    assert res.report.n_partitions == 4


def test_mine_refuses_without_a_card():
    from repro_torch.launch.mine import mine
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mine(**MINE)


# ---------------------------------------------------------------------------
# recommend(): closed loop and async against the reference's
# ---------------------------------------------------------------------------

def test_synthetic_trace_equals_reference():
    from repro_torch.data.baskets import BasketConfig
    from repro_torch.launch.recommend import synthetic_trace
    ref = _ref()
    fields = [f.name for f in dataclasses.fields(BasketConfig)]
    assert fields == [f.name for f in dataclasses.fields(ref.BasketConfig)]
    for gap in (0.0, 0.25):
        q, a = synthetic_trace(BasketConfig(n_tx=64, n_items=40, seed=3),
                               300, 104, gap)
        rq, ra = ref.recommend.synthetic_trace(
            ref.BasketConfig(n_tx=64, n_items=40, seed=3), 300, 104, gap)
        assert [x.payload.tolist() for x in q] == \
            [np.asarray(x.payload).tolist() for x in rq]
        if gap:
            np.testing.assert_array_equal(a, ra)
        else:
            assert a is None and ra is None


def _assert_same_serve(got, want):
    (g_res, g_rep), (w_res, w_rep) = got, want
    assert g_res == w_res and any(g_res)
    assert _plain(g_rep) == _plain(w_rep)
    assert g_rep.ledger.n_phases == w_rep.ledger.n_phases > 0


@pytest.mark.parametrize("use_async", [False, True])
def test_recommend_equals_reference(tmp_path, use_async, capsys):
    from repro_torch.launch.recommend import recommend
    ref = _ref()
    kw = dict(RECOMMEND, smoke=True, use_async=use_async)
    got = recommend(device="cpu", index_dir=str(tmp_path / "port"), **kw)
    out = capsys.readouterr().out
    want = ref.recommend.recommend(index_dir=str(tmp_path / "ref"), **kw)
    _assert_same_serve(got, want)
    if use_async:
        assert out.count("async smoke OK") == 2          # static, dynamic
        return
    assert "smoke OK: 1000 queries" in out
    # the baskets' own items are displayed (the reference prints the
    # dataclass's nonzero fields there: "basket {0}")
    shown = [ln for ln in out.splitlines() if ln.startswith("   basket {")]
    assert shown and not any(ln.startswith("   basket {0} ") for ln in shown)
    # the saved index loads as the reference's
    from repro_torch.serving import RuleIndex
    port_index = RuleIndex.load(str(tmp_path / "port"))
    ref_index = ref.RuleIndex.load(str(tmp_path / "ref"))
    loaded = ref.RuleIndex.load(str(tmp_path / "port"))
    for f in ("ante", "sizes", "conf", "lift", "support", "cons"):
        np.testing.assert_array_equal(getattr(loaded, f),
                                      getattr(ref_index, f))
        np.testing.assert_array_equal(getattr(port_index, f),
                                      getattr(ref_index, f))


# ---------------------------------------------------------------------------
# the command lines
# ---------------------------------------------------------------------------

# name -> argument lists run in turn (one chain a name; the chains run side
# by side), and the exit code each must give
CLI = {
    "mine_smoke": [(["mine", "--smoke"], 0)],
    "mine_kill_resume": [(["mine", "--out-of-core", "--smoke", "--son-dir",
                           "{tmp}/son-kr", "--kill-after", "3"], 3),
                         (["mine", "--out-of-core", "--smoke", "--son-dir",
                           "{tmp}/son-kr", "--resume"], 0)],
    "mine_profile": [(["mine", "--smoke", "--profile-dir",
                       "{tmp}/mine-trace"], 0)],
    "recommend_smoke": [(["recommend", "--smoke"], 0)],
}


@pytest.fixture(scope="module")
def subprocesses(tmp_path_factory):
    """The two sharded sides and every chain of ``CLI``, all started
    together (a chain's next command when its last one exits): the sides'
    output directory, and name -> [(rc, stdout, stderr), ...] with the
    command lines' scratch directory."""
    out = tmp_path_factory.mktemp("launch_sharded")
    tmp = tmp_path_factory.mktemp("cli")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}

    def start(cmd):
        return subprocess.Popen(cmd, env=env, cwd=ROOT,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True,
                                start_new_session=True)

    def start_cli(args):
        return start([sys.executable, "-m",
                      f"repro_torch.launch.{args[0]}",
                      *[a.format(tmp=tmp) for a in args[1:]],
                      "--device", "cpu"])

    procs = {side: start([sys.executable, __file__, side, str(out)])
             for side in ("reference", "port")}
    pending = {name: list(chain) for name, chain in CLI.items()}
    procs.update({name: start_cli(chain[0][0])
                  for name, chain in pending.items()})
    runs = {name: [] for name in CLI}
    errors = {}
    try:
        while procs:
            for name, proc in list(procs.items()):
                # communicate() drains the pipes: a chatty process never
                # blocks on a full one
                res = proc.communicate(timeout=TIMEOUT_S)
                del procs[name]
                if name not in CLI:
                    if proc.returncode:
                        errors[name] = res[1][-4000:]
                    continue
                runs[name].append((proc.returncode, *res))
                pending[name].pop(0)
                if pending[name]:
                    procs[name] = start_cli(pending[name][0][0])
    finally:
        for proc in procs.values():        # a side and its spawned ranks
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
    assert not errors, errors
    return {"sides": out, "cli": (runs, tmp)}


@pytest.fixture(scope="module")
def cli_runs(subprocesses):
    return subprocesses["cli"]


@pytest.mark.parametrize("name", sorted(CLI))
def test_command_line(cli_runs, name):
    runs, tmp = cli_runs
    for (args, want_rc), (rc, out, err) in zip(CLI[name], runs[name]):
        assert rc == want_rc, (args, err[-3000:])
    if name == "mine_kill_resume":
        assert "killed at partition boundary 3" in runs[name][0][1]
        assert "smoke OK: apriori out-of-core resumed" in runs[name][1][1]
    if name == "mine_profile":
        traces = list((tmp / "mine-trace").glob("*.pt.trace.json"))
        assert len(traces) == 1
        events = json.loads(traces[0].read_text())["traceEvents"]
        assert any(e.get("name") == "repro_torch.mine" for e in events)
    if name == "recommend_smoke":
        assert "smoke OK: 1000 queries" in runs[name][0][1]


if __name__ == "__main__":
    side, outdir = sys.argv[1], Path(sys.argv[2])
    (_reference_side if side == "reference" else _port_side)(outdir)
