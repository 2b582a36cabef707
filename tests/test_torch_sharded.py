"""The port's sharded mining plane, held against the reference's.

Host side, in process: the shard planner (``plan_shard_rows``,
``plan_batches``, ``replan``, ``plan_shards``, ``shard_bitmap``,
``count_moves``), ``mesh_profile`` and the fault policies give the
reference's answers case by case, and ``make_shard_mesh`` refuses to run
without a process group.

Devices, in two subprocesses run side by side: the reference mines on 8
forced host devices (``XLA_FLAGS``), the port on 8 gloo ranks spawned by
``repro_torch.distributed.ranks.spawn_ranks`` (the forced devices have no
counterpart in PyTorch; spawned ranks play their part).  Each runs the
same cases on the reference test's corpus (1,024 x 48, seed 7,
min_support 0.05) — ``run_sharded`` on the word-count job, Apriori with
``verify_rounds``, a ``device_loss`` at k=2, ``mesh_profile(8)``, the
``dynamic`` policy, a straggler, Eclat with a ``device_loss``, ``auto`` —
and SON over a mesh with a mid-partition ``device_loss`` (and a kill and
resume).  Supports, rules, the whole report and ledger (walls aside) must
be equal, and every rank's answer must equal rank 0's.

Run as a script (``python tests/test_torch_sharded.py reference|port
OUTDIR``), this file is one of those subprocesses; the test module starts
them.  Only the reference side and the in-process tests import jax.
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

from repro_torch.core.hetero import HeterogeneityProfile  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N_RANKS = 8
CORPUS = dict(n_tx=1024, n_items=48, seed=7)
MIN_SUPPORT = 0.05
# tests/test_son.py's dense corpus and partitioning
SON_CORPUS = dict(n_tx=192, n_items=24, seed=1)
SON_ROWS = 64
# seconds: each side's subprocess, and each collective inside the port's
TIMEOUT_S = 300
COLLECTIVE_TIMEOUT_S = 120

# case -> (ShardedMiner keywords, PipelineConfig keywords, fault events as
# (round, kind, rank, severity))
CASES = {
    "apriori": (dict(verify_rounds=True), {}, []),
    "device_loss": (dict(verify_rounds=True), {},
                    [(2, "device_loss", 3, 1.0)]),
    "mesh_profile": (dict(profile="mesh"), {}, []),
    "dynamic": (dict(policy="dynamic", verify_rounds=True), {}, []),
    "straggler": (dict(verify_rounds=True), {}, [(2, "straggler", 1, 4.0)]),
    "eclat_device_loss": (dict(verify_rounds=True), dict(algorithm="eclat"),
                          [(2, "device_loss", 5, 1.0)]),
    "auto_apriori": ({}, dict(algorithm="auto"), []),
    "auto_eclat": ({}, dict(algorithm="auto"), []),
}
# the auto cases' kernel rates (peak, bandwidth), the same in both
# packages: each package's default model reads its own autotune cache
SLOW, FAST = (1e3, 1e3), (1e15, 1e15)
AUTO_RATES = {
    "auto_apriori": {"support_count": FAST, "intersect_count": SLOW},
    "auto_eclat": {"support_count": SLOW, "intersect_count": FAST},
}
DEVICE_CASES = ["wordcount", *CASES, "son", "son_resume"]


# ---------------------------------------------------------------------------
# what both sides record
# ---------------------------------------------------------------------------

def _plain(x):
    """Dataclasses/arrays/tuples -> JSON values, without the fields that
    time this process (host and run walls)."""
    if dataclasses.is_dataclass(x):
        x = {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {str(k): _plain(v) for k, v in x.items()
                if k not in ("host_time_s", "wall_time_s")}
    if isinstance(x, (list, tuple, np.ndarray)):
        return [_plain(v) for v in x]
    if isinstance(x, np.generic):
        return x.item()
    return x


def _summary(result, choice=None):
    """A mine as JSON: supports, rules, the report (walls aside) and the
    ledger's counts."""
    led = result.report.ledger
    return {
        "supports": sorted([list(k), v] for k, v in result.supports.items()),
        "rules": _plain([dataclasses.astuple(r) for r in result.rules]),
        "report": _plain(result.report),
        "ledger": {"n_phases": len(led.phases),
                   "syncs": sum(p.syncs for p in led.phases),
                   "h2d_bytes": sum(p.h2d_bytes for p in led.phases),
                   "d2h_bytes": sum(p.d2h_bytes for p in led.phases)},
        "choice": None if choice is None else choice.summary(),
    }


def _mine_cases(pkg, mesh, config):
    """Every ``CASES`` mine through one package's names (``pkg``: a dict of
    its classes; ``config(**kw)``: its PipelineConfig for this side)."""
    T = pkg["generate_baskets"](pkg["BasketConfig"](**CORPUS))
    out = {}
    for name, (miner_kw, cfg_kw, events) in CASES.items():
        miner_kw = dict(miner_kw)
        if miner_kw.get("profile") == "mesh":
            miner_kw["profile"] = pkg["mesh_profile"](N_RANKS)
        faults = pkg["FaultPlan"]([pkg["FaultEvent"](*e) for e in events])
        miner = pkg["ShardedMiner"](mesh=mesh, config=config(
            min_support=MIN_SUPPORT, min_confidence=0.6, **cfg_kw),
            **miner_kw)
        model = pkg["AlgorithmCostModel"]
        scripted = (mock.patch.object(model, "from_autotune",
                                      lambda *a, **k: model(AUTO_RATES[name]))
                    if name in AUTO_RATES else contextlib.nullcontext())
        with scripted:
            res = miner.run(T, faults=faults if events else None)
        out[name] = _summary(res, miner.algorithm_choice)
    return out


def _son_cases(pkg, mesh, config, workdir):
    """SON over the mesh with a device loss in partition 1 (as
    tests/test_son.py's multi-device case), then killed after boundary 2
    and resumed."""
    T = pkg["generate_baskets"](pkg["BasketConfig"](**SON_CORPUS))
    cfg = config(min_support=0.05, algorithm="apriori", policy="static",
                 n_tiles=4)
    faults = {1: pkg["FaultPlan"]([pkg["FaultEvent"](2, "device_loss", 1)])}

    def son(sub, **kw):
        return pkg["SONMiner"](config=cfg, mesh=mesh, son=pkg["SONConfig"](
            workdir=os.path.join(workdir, sub), partition_rows=SON_ROWS,
            **kw))

    out = {"son": _summary(son("once").run(T, faults))}
    try:
        son("killed", abort_after=2).run(T, faults)
        killed_at = None
    except pkg["SONKilled"] as e:
        killed_at = e.boundary
    resumed = son("killed", resume=True).run(T, faults)
    out["son_resume"] = dict(_summary(resumed), killed_at=killed_at)
    return out


def _wordcount(Profile, run_sharded, SimulatedCluster, MapReduceJob,
               Runtime, MeasuredPhase, TaskSpec, PowerModel, mesh, tiles,
               data, bincount, zeros, to_list):
    """The reference test's word-count job: ``run_sharded`` against
    ``SimulatedCluster``, bare and through ``Runtime.run_phase``."""
    profile = Profile.homogeneous(N_RANKS, 100.0)
    job = MapReduceJob("wc", map_fn=bincount,
                       combine_fn=lambda a, b: a + b, zero_fn=zeros)
    axis = _axis(mesh)
    sim, sim_rep = SimulatedCluster(profile).run(job, tiles)
    shard, shard_rep = run_sharded(job, data, mesh, axis, profile=profile)
    rt = Runtime(profile, policy="static", power=PowerModel.cpu(profile))
    costs = np.full(N_RANKS, 32.0 * 4)                 # bytes per rank

    def execute(asg, c):
        res, rep = run_sharded(job, data, mesh, axis)
        return MeasuredPhase(result=res, wall_s=rep.makespan)

    shard2, rec = rt.run_phase(
        TaskSpec("wc-runtime", float(costs.sum()), parallel=True,
                 n_tiles=N_RANKS),
        execute, tile_costs=costs, assignment=rt.pinned_assignment(costs))
    return {"simulated": to_list(sim), "sharded": to_list(shard),
            "sharded_runtime": to_list(shard2),
            "report": _plain({k: getattr(shard_rep, k) for k in
                              ("makespan", "busy_s", "tiles_done",
                               "switches", "reissued")}),
            "record": _plain(rec)}


def _axis(mesh):
    names = getattr(mesh, "axis_names", None) or mesh.mesh_dim_names
    return names[0]


def _wordcount_tiles():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 16, 32).astype(np.int32) for _ in range(N_RANKS)]


# ---------------------------------------------------------------------------
# the two subprocesses
# ---------------------------------------------------------------------------

def _reference_side(out: Path) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax.numpy as jnp
    from repro.core.hetero import HeterogeneityProfile as RefProfile
    from repro.core.mapreduce import (MapReduceJob, SimulatedCluster,
                                      run_sharded)
    from repro.core.power import PowerModel
    from repro.core.scheduler import TaskSpec
    from repro.data.baskets import BasketConfig, generate_baskets
    from repro.distributed.fault import FaultEvent, FaultPlan
    from repro.distributed.mining import (ShardedMiner, make_shard_mesh,
                                          mesh_profile)
    from repro.mining import (AlgorithmCostModel, SONConfig, SONKilled,
                              SONMiner)
    from repro.pipeline import PipelineConfig
    from repro.runtime import MeasuredPhase, Runtime

    mesh = make_shard_mesh(N_RANKS)
    tiles = _wordcount_tiles()
    got = {"wordcount": _wordcount(
        RefProfile, run_sharded, SimulatedCluster, MapReduceJob, Runtime,
        MeasuredPhase,
        TaskSpec, PowerModel, mesh, tiles,
        jnp.concatenate([jnp.asarray(t) for t in tiles]),
        lambda t: jnp.bincount(jnp.asarray(t), length=16),
        lambda: jnp.zeros(16, jnp.int32),
        lambda v: np.asarray(v).tolist())}
    pkg = dict(AlgorithmCostModel=AlgorithmCostModel,
               BasketConfig=BasketConfig, generate_baskets=generate_baskets,
               FaultEvent=FaultEvent, FaultPlan=FaultPlan,
               ShardedMiner=ShardedMiner, mesh_profile=mesh_profile,
               SONConfig=SONConfig, SONKilled=SONKilled, SONMiner=SONMiner)

    def config(**kw):
        return PipelineConfig(data_plane="ref", **kw)

    got.update(_mine_cases(pkg, mesh, config))
    with tempfile.TemporaryDirectory() as wd:
        got.update(_son_cases(pkg, mesh, config, wd))
    (out / "reference.json").write_text(json.dumps(got))


def _port_rank(rank: int, out: str, workdir: str) -> None:
    """One rank of the port's side: every case, written to
    ``rank<r>.json``."""
    from repro_torch.core.mapreduce import (MapReduceJob, SimulatedCluster,
                                            run_sharded)
    from repro_torch.core.power import PowerModel
    from repro_torch.core.scheduler import TaskSpec
    from repro_torch.data.baskets import BasketConfig, generate_baskets
    from repro_torch.distributed.fault import FaultEvent, FaultPlan
    from repro_torch.distributed.mining import (ShardedMiner,
                                                make_shard_mesh,
                                                mesh_profile)
    from repro_torch.mining import (AlgorithmCostModel, SONConfig, SONKilled,
                                    SONMiner)
    from repro_torch.pipeline import PipelineConfig
    from repro_torch.runtime import MeasuredPhase, Runtime

    mesh = make_shard_mesh()
    tiles = _wordcount_tiles()
    got = {"wordcount": _wordcount(
        HeterogeneityProfile, run_sharded, SimulatedCluster, MapReduceJob,
        Runtime, MeasuredPhase,
        TaskSpec, PowerModel, mesh, [torch.from_numpy(t) for t in tiles],
        torch.from_numpy(tiles[rank]),
        lambda t: torch.bincount(t, minlength=16).to(torch.int32),
        lambda: torch.zeros(16, dtype=torch.int32),
        lambda v: v.tolist())}
    pkg = dict(AlgorithmCostModel=AlgorithmCostModel,
               BasketConfig=BasketConfig, generate_baskets=generate_baskets,
               FaultEvent=FaultEvent, FaultPlan=FaultPlan,
               ShardedMiner=ShardedMiner, mesh_profile=mesh_profile,
               SONConfig=SONConfig, SONKilled=SONKilled, SONMiner=SONMiner)

    def config(**kw):
        return PipelineConfig(device="cpu", **kw)

    got.update(_mine_cases(pkg, mesh, config))
    got.update(_son_cases(pkg, mesh, config, workdir))
    Path(out, f"rank{rank}.json").write_text(json.dumps(got))


def _port_side(out: Path) -> None:
    from repro_torch.distributed.ranks import spawn_ranks

    with tempfile.TemporaryDirectory() as wd:
        spawn_ranks(_port_rank, N_RANKS, args=(str(out), wd),
                    store=str(out / "store"),
                    timeout_s=COLLECTIVE_TIMEOUT_S)


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """Both subprocesses, started together: ``(reference, [rank 0..7])``."""
    out = tmp_path_factory.mktemp("sharded")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    procs = {side: subprocess.Popen(
        [sys.executable, __file__, side, str(out)], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True) for side in ("reference", "port")}
    errors = {}
    try:
        for side, proc in procs.items():
            _, err = proc.communicate(timeout=TIMEOUT_S)
            if proc.returncode:
                errors[side] = err[-4000:]
    finally:
        for proc in procs.values():       # the side and its spawned ranks
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
    assert not errors, errors
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(N_RANKS)]
    return json.loads((out / "reference.json").read_text()), ranks


# ---------------------------------------------------------------------------
# devices: the port on 8 gloo ranks against the reference on 8 devices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", DEVICE_CASES)
def test_port_equals_reference(sides, case):
    ref, ranks = sides
    got, want = ranks[0][case], ref[case]
    if case == "wordcount":
        assert got == want
        assert got["sharded"] == got["simulated"] == got["sharded_runtime"]
        assert got["record"]["energy_j"] > 0
        assert got["record"]["sim_time_s"] > 0
        return
    assert got["supports"] == want["supports"]
    assert got["rules"] == want["rules"]
    assert got["ledger"] == want["ledger"]
    assert got["report"] == want["report"]
    assert got["choice"] == want["choice"]
    if case == "son_resume":
        assert got["killed_at"] == want["killed_at"] == 2


@pytest.mark.parametrize("case", DEVICE_CASES)
def test_every_rank_agrees(sides, case):
    _, ranks = sides
    for r in range(1, N_RANKS):
        assert ranks[r][case] == ranks[0][case], f"rank {r}"


@pytest.mark.parametrize("case", [c for c in CASES] + ["son", "son_resume"])
def test_sharded_mines_equal_the_single_device_pipeline(sides, case):
    """The reference test's claims, on the port's rank 0: the single-device
    answer, and what the report says about shards, re-plans and energy."""
    from repro_torch.data.baskets import BasketConfig, generate_baskets
    from repro_torch.pipeline import MarketBasketPipeline, PipelineConfig

    _, ranks = sides
    got = ranks[0][case]
    son = case.startswith("son")
    T = generate_baskets(BasketConfig(**(SON_CORPUS if son else CORPUS)))
    single = MarketBasketPipeline(
        HeterogeneityProfile.paper() if son else None,
        config=PipelineConfig(min_support=MIN_SUPPORT, min_confidence=0.6,
                              n_tiles=4 if son else 32, device="cpu")).run(T)
    assert got["supports"] == sorted([list(k), v]
                                     for k, v in single.supports.items())
    assert got["rules"] == _plain([dataclasses.astuple(r)
                                   for r in single.rules])
    rep = got["report"]
    if case == "son":
        assert rep["replans"] >= 1 and rep["execution"] == "out_of_core"
    if case == "son_resume":
        # the device loss fell in a partition the killed run finished
        assert got["killed_at"] == 2 and rep["partitions_resumed"] == 2
    if son:
        return
    assert rep["execution"] == "sharded" and rep["n_shards"] == N_RANKS
    # Eclat shards 32-transaction words
    assert sum(rep["shard_rows"]) >= CORPUS["n_tx"] // (
        32 if rep["algorithm"] == "eclat" else 1)
    assert all(sum(r["tiles_per_device"]) == r["n_tiles"]
               for r in rep["rounds"])
    energy = sum(r["energy_j"] for r in rep["rounds"])
    assert energy > 0
    if case in ("device_loss", "eclat_device_loss"):
        dead = 3 if case == "device_loss" else 5
        r2 = [r for r in rep["rounds"] if r["k"] == 2][0]
        assert rep["replans"] == 1 and rep["shard_rows"][dead] == 0
        assert r2["reissued"] > 0 and r2["failed_devices"] == [dead]
        assert all(r["map_busy_s"][dead] == 0.0 for r in rep["rounds"]
                   if r["k"] >= 2 and r["n_tiles"])
    if case == "mesh_profile":
        rows = np.asarray(rep["shard_rows"], dtype=float)
        speeds = np.asarray(rep["profile_speeds"])
        assert rows[np.argmax(speeds)] == rows.max() > rows[np.argmin(speeds)]
    if case == "straggler":
        assert rep["replans"] == 1 and rep["shard_rows"][1] < rep[
            "shard_rows"][5]
    if case == "dynamic":
        assert rep["policy"] == "dynamic"
    # each counting round reads its reduced vector back once
    maps = [p for p in rep["ledger"]["phases"] if p["kind"] == "map"]
    assert [p["syncs"] for p in maps] == [1] * len(maps)


# ---------------------------------------------------------------------------
# host side: the planner and the fault policies, port against reference
# ---------------------------------------------------------------------------

def _profiles(pkg):
    return {"paper": pkg.HeterogeneityProfile.paper(),
            "homogeneous4": pkg.HeterogeneityProfile.homogeneous(4, 100.0),
            "mesh8": pkg.mesh_profile(8)}


class _Port:
    from repro_torch.core.hetero import HeterogeneityProfile
    from repro_torch.data import sharding
    from repro_torch.distributed import fault
    from repro_torch.distributed.mining import (count_moves, mesh_profile,
                                                plan_shards, rank_slab,
                                                shard_bitmap)


def _ref():
    class Ref:
        from repro.core.hetero import HeterogeneityProfile
        from repro.data import sharding
        from repro.distributed import fault
        from repro.distributed.mining import (count_moves, mesh_profile,
                                              plan_shards, shard_bitmap)
    return Ref


def _both(fn):
    """fn(package) on each package: its value, or the type of what it
    raised."""
    out = []
    for pkg in (_ref(), _Port):
        try:
            out.append(fn(pkg))
        except (ValueError, RuntimeError) as e:
            out.append(type(e))
    return out


ALIVE = {None: None, "one_dead": [True, False, True, True],
         "fastest_dead": [True, True, True, False],
         "all_dead": [False] * 4}


@pytest.mark.parametrize("profile,n_rows,row_block,alive", [
    ("paper", 2048, 8, None), ("paper", 100_000, 8, None),
    ("paper", 100_000, 8, "fastest_dead"), ("paper", 3200, 1, None),
    ("homogeneous4", 999, 8, "one_dead"), ("homogeneous4", 100, 8,
                                           "all_dead"),
    ("homogeneous4", 0, 8, None), ("paper", 7, 8, None),
])
def test_plan_shard_rows(profile, n_rows, row_block, alive):
    def plan(pkg):
        mask = None if ALIVE[alive] is None else np.array(ALIVE[alive])
        return pkg.sharding.plan_shard_rows(
            _profiles(pkg)[profile], n_rows, row_block=row_block,
            alive=mask).tolist()
    ref, port = _both(plan)
    assert port == ref
    if profile == "paper" and n_rows == 2048:
        rows = np.asarray(port)
        shares = HeterogeneityProfile.paper().shares() * 2048
        assert rows.sum() == 2048 and (rows % 8 == 0).all()
        assert rows[3] == rows.max() and (np.abs(rows - shares) <= 8).all()


@pytest.mark.parametrize("case", ["proportional", "replan", "indivisible"])
def test_plan_batches_and_replan(case):
    def plan(pkg):
        if case == "proportional":
            p = pkg.sharding.plan_batches(
                pkg.HeterogeneityProfile.paper(), global_batch=80,
                microbatch=1)
            return p.counts.tolist(), p.step_batches
        if case == "indivisible":
            return pkg.sharding.plan_batches(
                pkg.HeterogeneityProfile.homogeneous(2), 10, 3)
        prof = pkg.HeterogeneityProfile.homogeneous(4, 10.0)
        p = pkg.sharding.plan_batches(prof, 64, 1)
        prof.observe(0, work_done=1.0, seconds=1.0)
        return p.counts.tolist(), pkg.sharding.replan(prof, p).counts.tolist()
    ref, port = _both(plan)
    assert port == ref
    if case == "proportional":
        counts, total = port
        assert total == 80 and counts[3] >= 4 * counts[0]
    elif case == "replan":
        assert port[0] == [16] * 4 and port[1][0] < 16 and sum(port[1]) == 64
    else:
        assert port is ValueError


@pytest.mark.parametrize("profile,n_rows,row_block,dead", [
    ("paper", 64, 8, 3), ("paper", 1024, 8, 0), ("mesh8", 1024, 8, 3),
    ("mesh8", 32, 1, 5), ("homogeneous4", 999, 8, 1),
])
def test_shard_layout_and_moves(profile, n_rows, row_block, dead):
    T = (np.arange(n_rows * 4, dtype=np.uint8).reshape(n_rows, 4) % 3 == 0
         ).astype(np.uint8)

    def layout(pkg):
        prof = _profiles(pkg)[profile]
        plan = pkg.plan_shards(prof, n_rows, row_block=row_block)
        alive = np.ones(prof.n, dtype=bool)
        alive[dead] = False
        plan2 = pkg.plan_shards(prof, n_rows, row_block=row_block,
                                alive=alive)
        return dict(rows=[plan.rows.tolist(), plan2.rows.tolist()],
                    width=[plan.width, plan2.width],
                    blocks=[plan.n_blocks, plan2.n_blocks],
                    owners=plan2.block_owners().tolist(),
                    costs=plan.shard_costs(4).tolist(),
                    layout=[pkg.shard_bitmap(T, p).tolist()
                            for p in (plan, plan2)],
                    moves=list(pkg.count_moves(plan, plan2)))
    ref, port = _both(layout)
    assert port == ref
    # zero padding is inert: the layout keeps every column sum, and the
    # dead rank's blocks re-issue
    for S in port["layout"]:
        assert (np.asarray(S).sum(axis=0) == T.sum(axis=0)).all()
    assert port["moves"][1] == port["rows"][0][dead] // row_block
    assert port["rows"][1][dead] == 0
    # each rank's slab, built alone, is its slice of the layout
    plan = _Port.plan_shards(_profiles(_Port)[profile], n_rows,
                             row_block=row_block)
    S = _Port.shard_bitmap(T, plan)
    for d in range(plan.n_shards):
        assert np.array_equal(_Port.rank_slab(T, plan, d),
                              S[d * plan.width:(d + 1) * plan.width])


def test_count_moves_rejects_plans_of_other_bitmaps():
    prof = HeterogeneityProfile.paper()
    with pytest.raises(ValueError, match="different bitmaps"):
        _Port.count_moves(_Port.plan_shards(prof, 64),
                          _Port.plan_shards(prof, 128))


@pytest.mark.parametrize("n", [1, 4, 8, 12])
def test_mesh_profile(n):
    ref, port = _both(lambda pkg: (pkg.mesh_profile(n).speeds.tolist(),
                                   pkg.mesh_profile(n).names,
                                   pkg.mesh_profile(n).ewma_alpha))
    assert port == ref
    assert port[0][:4] == [80.0, 120.0, 200.0, 400.0][:n]


@pytest.mark.parametrize("case", ["fault_plan_at", "elastic_shrink",
                                  "budget", "not_elastic", "straggler",
                                  "detect_stragglers"])
def test_fault_policies(case):
    def run(pkg):
        f = pkg.fault
        if case == "fault_plan_at":
            fp = f.FaultPlan([f.FaultEvent(3, "device_loss", 1),
                              f.FaultEvent(3, "straggler", 0, 2.0)])
            return ([dataclasses.astuple(e) for e in fp.at(3)], fp.at(4))
        if case == "detect_stragglers":
            return (f.detect_stragglers(np.array([1.0, 1.1, 0.9, 5.0]),
                                        threshold=2.0),
                    f.detect_stragglers(np.array([1.0, 3.0, 1.0, 1.0]),
                                        threshold=1.5))
        prof = pkg.HeterogeneityProfile.homogeneous(4, 10.0)
        if case == "straggler":
            return f.RestartPolicy().on_straggler(
                prof, 2, slowdown=8.0).speeds.tolist()
        pol = f.RestartPolicy(max_restarts=2,
                              elastic=case != "not_elastic")
        p2 = pol.on_device_loss(prof, 1)
        if case == "not_elastic":
            return p2
        if case == "elastic_shrink":
            return p2.n, p2.names, p2.speeds.tolist(), pol.restarts_used
        pol.on_device_loss(p2, 0)
        return pol.on_device_loss(p2, 0)        # the third: over budget
    ref, port = _both(run)
    assert port == ref
    if case == "detect_stragglers":
        assert port[0] == [3]
    elif case == "elastic_shrink":
        assert port[0] == 3
    elif case == "budget":
        assert port is RuntimeError
    elif case == "not_elastic":
        assert port is None
    elif case == "straggler":
        assert port[2] < 10.0


def test_make_shard_mesh_needs_a_process_group():
    import torch.distributed as dist

    from repro_torch.distributed.mining import ShardedMiner, make_shard_mesh

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_shard_mesh()
    with pytest.raises(RuntimeError, match="init_process_group"):
        ShardedMiner()


if __name__ == "__main__":
    side, outdir = sys.argv[1], Path(sys.argv[2])
    if side == "reference":
        _reference_side(outdir)
    else:
        _port_side(outdir)
