"""The port's compile surfaces (``repro_torch.launch.dryrun``,
``hlo_cost``, ``report``, the spec helpers, ``cell_config`` and the
roofline terms) against the reference's, on the CPU.

The pure functions and the spec helpers are compared in this process,
on every registered architecture.  The dry runs run in subprocesses,
started together by one module fixture: the reference's mini cells on 8
forced host devices (the reference's ``tests/test_dryrun_mini.py``
setup), and the port's on fake process groups with ``jax``, ``jaxlib``
and ``repro`` blocked, one subprocess for the (2, 4) mesh's cells and one
for each (2, 2, 2) cell, whose strided shards make DTensor's
redistribution planner the slow part, and one for a full-width cell on
the 256-rank production mesh.

Two more groups hold the train cells of the MoE archs.  The uneven ones
take the production ratio of microbatch rows to batch shards (16 rows
over 2 × 16 at ``grad_accum`` 16) on the (2, 2, 2) mesh: ``grad_accum``
128 leaves 2 rows over its 4 batch shards; the reference runs them in a
subprocess of its own.  The trip-count ones run each cell at
``grad_accum`` 4 twice, once as the dry run counts it (one trip,
multiplied by its trips) and once with every trip dispatched, the test
script's own switch (``steps.counting_trips`` made a no-op).
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs.base import get_config as ref_get_config  # noqa: E402
from repro.launch import roofline as RR  # noqa: E402
from repro.launch import steps as RS  # noqa: E402
from repro.launch import tuning as RT  # noqa: E402
from repro_torch.configs.base import SHAPES, get_config, list_archs  # noqa
from repro_torch.launch import hlo_cost, report  # noqa: E402
from repro_torch.launch import roofline as R  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.launch import tuning  # noqa: E402
from repro_torch.launch.dryrun import _active_params, _params_total  # noqa

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
             d_ff=128, vocab_size=512)
CELLS = [("granite-3-8b", "train_4k"), ("rwkv6-7b", "decode_32k"),
         ("gemma3-1b", "prefill_32k")]
# 2 microbatch rows over the (2, 2, 2) mesh's 4 batch shards, as 16 rows
# over the 2 x 16 x 16 mesh's 32
UNEVEN = ["deepseek-v2-236b", "dbrx-132b"]
UNEVEN_ACCUM = 128
TRIP_ARCHS = ["granite-3-8b", "dbrx-132b", "deepseek-v2-236b"]
TRIP_ACCUM = 4
FIXED = ("arch", "shape", "mesh", "profile", "chips", "kind", "config",
         "params_total", "params_active")

_REF = r'''
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
import numpy as np
import jax
from repro.configs.base import get_config, list_archs
from repro.launch import steps as S
from repro.launch.dryrun import _active_params, lower_cell
from repro.launch.mesh import make_test_mesh
cells, small = json.loads(sys.argv[1]), json.loads(sys.argv[2])
meshes, accum, params = json.loads(sys.argv[3])
out = {"records": {}, "params": {}}
for mp in meshes:
    mesh = make_test_mesh(multi_pod=mp)
    for arch, shape in cells:
        over = dict(small)
        if arch == "gemma3-1b":
            over.update(n_kv_heads=1, local_window=16, global_every=2)
        rec = lower_cell(arch, shape, mesh, profile="tuned", overrides=over,
                         opt_overrides={"grad_accum": accum})
        out["records"][f"{arch}|{shape}|{'mp' if mp else 'pod'}"] = rec
for arch in list_archs() if params else ():
    cfg = get_config(arch)
    spec = S.param_specs(cfg)
    total = int(sum(np.prod(l.shape) for l in jax.tree_util.tree_leaves(spec)))
    out["params"][arch] = [total, _active_params(cfg, spec)]
print("RESULT" + json.dumps(out))
'''

_PORT = r'''
import sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None
import contextlib, json
from repro_torch.launch import steps
from repro_torch.launch.dryrun import fake_process_group, lower_cell
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.core.compat import make_mesh
jobs, small = json.loads(sys.argv[1]), json.loads(sys.argv[2])
counting_trips = steps.counting_trips
out = {}
for key, arch, shape, mesh_name, full, accum, every_trip in jobs:
    over = None if full else dict(small)
    if over is not None and arch == "gemma3-1b":
        over.update(n_kv_heads=1, local_window=16, global_every=2)
    size = {"pod": 8, "mp": 8, "one": 1, "full_pod": 256}[mesh_name]
    # every trip of the grad-accum loop dispatched: the counting context
    # no longer takes them as one
    steps.counting_trips = ((lambda repeat: contextlib.nullcontext())
                            if every_trip else counting_trips)
    with fake_process_group(size):
        mesh = {"pod": lambda: make_test_mesh(multi_pod=False),
                "mp": lambda: make_test_mesh(multi_pod=True),
                "one": lambda: make_mesh((1, 1), ("data", "model")),
                "full_pod": lambda: make_production_mesh()}[mesh_name]()
        out[key] = lower_cell(arch, shape, mesh, profile="tuned",
                              overrides=over,
                              opt_overrides=None if full
                              else {"grad_accum": accum})
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "repro") and sys.modules[m] is not None)
assert not bad, bad
print("RESULT" + json.dumps(out))
'''


def _start(script, *args):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return subprocess.Popen([sys.executable, "-c", script, *args], cwd=ROOT,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _result(proc, timeout):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-3000:]
    line = [ln for ln in out.splitlines() if ln.startswith("RESULT")][0]
    return json.loads(line[len("RESULT"):])


def _trip_jobs(mesh, archs):
    """Each trip-count cell of ``archs`` on ``mesh``, counted, then every
    trip run."""
    return [[f"{a}|train_4k|{mesh}|{how}", a, "train_4k", mesh, False,
             TRIP_ACCUM, how == "every"]
            for a in archs for how in ("counted", "every")]


@pytest.fixture(scope="module")
def runs():
    small = json.dumps(SMALL)
    ref = _start(_REF, json.dumps(CELLS), small,
                 json.dumps([[False, True], 2, True]))
    ref_uneven = _start(_REF, json.dumps([[a, "train_4k"] for a in UNEVEN]),
                        small, json.dumps([[True], UNEVEN_ACCUM, False]))
    pod = [[f"{a}|{s}|pod", a, s, "pod", False, 2, False] for a, s in CELLS]
    pod.append(["granite-3-8b|train_4k|one", "granite-3-8b", "train_4k",
                "one", False, 2, False])
    port = [_start(_PORT, json.dumps(pod), small)]
    port += [_start(_PORT, json.dumps([[f"{a}|{s}|mp", a, s, "mp", False,
                                        2, False]]), small)
             for a, s in CELLS]
    full = _start(_PORT, json.dumps([["full", "granite-3-8b", "decode_32k",
                                      "full_pod", True, 1, False]]), small)
    uneven = _start(_PORT, json.dumps(
        [[f"{a}|train_4k|mp", a, "train_4k", "mp", False, UNEVEN_ACCUM,
          False] for a in UNEVEN]), small)
    # the (2, 2, 2) mesh's deepseek-v2-236b cell takes as long as the
    # other two there: a subprocess of its own
    trips = [_start(_PORT, json.dumps(_trip_jobs(m, archs)), small)
             for m, archs in (("pod", TRIP_ARCHS),
                              ("mp", TRIP_ARCHS[:2]),
                              ("mp", TRIP_ARCHS[2:]))]
    recs, trip_recs = {}, {}
    for proc in port:
        recs.update(_result(proc, 600))
    for proc in trips:
        trip_recs.update(_result(proc, 600))
    return {"ref": _result(ref, 600), "port": recs,
            "full": _result(full, 600)["full"],
            "uneven": _result(uneven, 600),
            "ref_uneven": _result(ref_uneven, 600)["records"],
            "trips": trip_recs}


# ---------------------------------------------------------------------------
# pure functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list_archs())
def test_pick_vocab_chunk_and_cell_config_equal_reference(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    assert tuning.pick_vocab_chunk(cfg.vocab_size) == \
        RT.pick_vocab_chunk(rcfg.vocab_size)
    for shape in SHAPES:
        for profile in ("baseline", "tuned"):
            got, opts = tuning.cell_config(cfg, shape, profile)
            want, ropts = RT.cell_config(rcfg, shape, profile)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert opts == ropts


@pytest.mark.parametrize("arch", list_archs())
def test_model_flops_and_roofline_terms_equal_reference(arch):
    cfg = get_config(arch)
    coll = {"all-gather": 3_000_000, "all-reduce": 5_000_000}
    cost = {"flops": 7.5e12, "bytes accessed": 2.5e11}
    for name, shape in SHAPES.items():
        n_active = 1_000_000 + len(name)
        mf = R.model_flops_for(cfg, shape, n_active, shape.kind)
        assert mf == RR.model_flops_for(ref_get_config(arch),
                                        REF_SHAPES[name], n_active,
                                        shape.kind)
        for chips in (8, 256, 512):
            got = R.derive_terms(cost, R.CollectiveStats(dict(coll)), chips,
                                 mf)
            want = RR.derive_terms(cost, RR.CollectiveStats(dict(coll)),
                                   chips, mf)
            for field in ("useful_ratio", "flops_per_device",
                          "bytes_per_device", "collective_bytes",
                          "model_flops"):
                assert getattr(got, field) == getattr(want, field), field
            assert got.compute_s == cost["flops"] / R.PEAK_FLOPS
            assert got.memory_s == cost["bytes accessed"] / R.HBM_BW
            assert got.collective_s == sum(coll.values()) / R.LINK_BW
            assert got.dominant == max(
                ("compute", "memory", "collective"),
                key=lambda t: getattr(got, f"{t}_s"))
            assert got.roofline_fraction == pytest.approx(
                (mf / chips / R.PEAK_FLOPS) / got.bound_s, rel=1e-12)


def test_hlo_cost_keeps_fields_and_analyze_names_the_counting():
    cost = hlo_cost.HloCost(flops=2.0, traffic_bytes=3.0,
                            collective_bytes=4.0,
                            collective_by_op={"all-gather": 4.0})
    cost.add(cost.scaled(2.0))
    assert (cost.flops, cost.traffic_bytes, cost.collective_bytes) == \
        (6.0, 9.0, 12.0)
    assert cost.collective_by_op == {"all-gather": 12.0}
    with pytest.raises(NotImplementedError, match="HLO"):
        hlo_cost.analyze("HloModule m")


# ---------------------------------------------------------------------------
# spec helpers
# ---------------------------------------------------------------------------

def _key(k):
    return str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))


def _ref_leaves(tree):
    return {"/".join(_key(k) for k in path): (tuple(leaf.shape),
                                              str(jnp.dtype(leaf.dtype)))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        assert tree.device.type == "meta", (prefix, tree.device)
        return {prefix[:-1]: (tuple(tree.shape),
                              str(tree.dtype).replace("torch.", ""))}
    return {k: v for key, sub in items
            for k, v in _port_leaves(sub, f"{prefix}{key}/").items()}


_PARAMS = {}


def _param_specs(arch):
    if arch not in _PARAMS:
        cfg, rcfg = get_config(arch), ref_get_config(arch)
        _PARAMS[arch] = (S.param_specs(cfg), RS.param_specs(rcfg))
    return _PARAMS[arch]


@pytest.mark.parametrize("arch", list_archs())
def test_spec_helpers_equal_reference_trees(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    port, ref = _param_specs(arch)
    assert _port_leaves(port) == _ref_leaves(ref)
    assert _port_leaves(S.abstract_opt_state(port)) == \
        _ref_leaves(RS.abstract_opt_state(ref))
    assert cfg.shapes() == rcfg.shapes()
    for name in cfg.shapes():
        got, want = S.input_specs(arch, name), RS.input_specs(arch, name)
        assert _port_leaves(got) == _ref_leaves(want), name
        if SHAPES[name].kind != "decode":
            assert _port_leaves(S.batch_specs(cfg, SHAPES[name])) == \
                _ref_leaves(RS.batch_specs(rcfg, REF_SHAPES[name]))


def test_spec_helpers_under_a_callers_fake_mode():
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

    mode = FakeTensorMode()
    cfg = get_config("gemma3-1b")
    params = S.param_specs(cfg, fake_mode=mode)
    d = S.decode_specs(cfg, SHAPES["decode_32k"], mode)
    opt = S.abstract_opt_state(params, mode)
    for leaf in jax.tree_util.tree_leaves((params, d, tuple(opt))):
        assert isinstance(leaf, FakeTensor) and leaf.fake_mode is mode
    assert _port_leaves(_to_meta(params)) == _port_leaves(S.param_specs(cfg))


def _to_meta(tree):
    return jax.tree_util.tree_map(
        lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"), tree)


def test_param_counts_equal_reference(runs):
    for arch, (total, active) in runs["ref"]["params"].items():
        port, _ = _param_specs(arch)
        assert _params_total(port) == total, arch
        assert _active_params(get_config(arch), port) == active, arch


# ---------------------------------------------------------------------------
# the mini dry run (a mirror of tests/test_dryrun_mini.py) and full width
# ---------------------------------------------------------------------------

def _mini(runs):
    return {k: v for k, v in runs["port"].items() if not k.endswith("one")}


def test_all_mini_cells_run(runs):
    mini = _mini(runs)
    assert len(mini) == 6
    for key, rec in mini.items():
        assert rec["ok"], key
        assert rec["cost"]["flops"] > 0, key
        assert rec["compile_s"] is None
        assert rec["memory"]["peak_estimate_bytes"] >= \
            rec["memory"]["argument_bytes"] > 0


def test_train_cell_has_collectives_on_both_meshes(runs):
    for mesh in ("pod", "mp"):
        rec = runs["port"][f"granite-3-8b|train_4k|{mesh}"]
        assert rec["collectives"]["total_bytes"] > 0, mesh
        assert rec["memory"]["alias_bytes"] > 0, mesh   # the moments


def test_flops_are_per_device(runs):
    one = runs["port"]["granite-3-8b|train_4k|one"]["cost"]["flops"]
    per = runs["port"]["granite-3-8b|train_4k|pod"]["cost"]["flops"]
    assert 8 * per >= one
    assert 8 * per < 8 * one


def test_mini_records_fixed_fields_equal_reference(runs):
    for key, rec in _mini(runs).items():
        want = runs["ref"]["records"][key]
        for field in FIXED:
            assert rec[field] == want[field], (key, field)
        assert rec["roofline"]["model_flops_global"] == \
            want["roofline"]["model_flops_global"], key


@pytest.mark.parametrize("arch", UNEVEN)
def test_uneven_microbatch_cells_run(runs, arch):
    """2 microbatch rows over 4 batch shards: MLA's and the experts' head
    splits and the microbatch's rows placed where DTensor's views hold."""
    rec = runs["uneven"][f"{arch}|train_4k|mp"]
    assert rec["ok"] and rec["chips"] == 8
    assert rec["config"]["grad_accum"] == UNEVEN_ACCUM
    assert rec["cost"]["flops"] > 0
    assert rec["collectives"]["total_bytes"] > 0
    assert rec["memory"]["alias_bytes"] > 0              # the moments


@pytest.mark.parametrize("arch", UNEVEN)
def test_uneven_records_fixed_fields_equal_reference(runs, arch):
    rec = runs["uneven"][f"{arch}|train_4k|mp"]
    want = runs["ref_uneven"][f"{arch}|train_4k|mp"]
    for field in FIXED:
        assert rec[field] == want[field], field
    assert rec["roofline"]["model_flops_global"] == \
        want["roofline"]["model_flops_global"]


@pytest.mark.parametrize("mesh", ["pod", "mp"])
@pytest.mark.parametrize("arch", TRIP_ARCHS)
def test_trip_counted_record_equals_every_trip(runs, arch, mesh):
    """One grad-accum trip counted and multiplied by its trips gives the
    record of dispatching every trip, field for field."""
    got = runs["trips"][f"{arch}|train_4k|{mesh}|counted"]
    want = runs["trips"][f"{arch}|train_4k|{mesh}|every"]
    assert got["ok"] and want["ok"]
    assert got["config"]["grad_accum"] == TRIP_ACCUM
    for field in ("memory", "cost", "collectives", "roofline"):
        assert got[field] == want[field], field
    assert got["cost"]["flops"] > 0
    assert got["collectives"]["total_bytes"] > 0


def test_full_width_decode_on_the_pod_mesh(runs):
    rec = runs["full"]
    assert rec["ok"] and rec["chips"] == 256
    assert rec["mesh"] == {"data": 16, "model": 16}
    assert rec["cost"]["flops"] > 0
    assert rec["collectives"]["total_bytes"] > 0
    # the new key and value land in rank 0's shard of the cache
    assert rec["memory"]["alias_bytes"] > 0


def test_report_renders_the_mini_records(runs, tmp_path):
    for key, rec in _mini(runs).items():
        arch, shape, mesh = key.split("|")
        rec = dict(rec, mesh_mode="pod" if mesh == "pod" else "multipod")
        (tmp_path / f"{arch}__{shape}__{mesh}.json").write_text(
            json.dumps(rec))
    (tmp_path / "x__long_500k__pod.json").write_text(json.dumps(
        {"arch": "x", "shape": "long_500k", "ok": False, "skipped": True,
         "reason": "pure full-attention arch; long-context decode"}))
    recs = report.load(str(tmp_path))
    pod = report.dryrun_table(recs, "tuned", mesh="pod")
    assert pod.count("\n") == 1 + 3 and "fits 80GB" in pod
    assert "| granite-3-8b | train_4k | pod | - |" in pod
    assert report.dryrun_table(recs, "tuned", mesh="multipod").count(
        "\n") == 1 + 3
    assert report.roofline_table(recs, "tuned", mesh="pod").count(
        "\n") == 1 + 3
    assert "| x | long_500k | both |" in report.skipped_table(recs)


def test_run_cells_writes_where_it_is_told(tmp_path):
    from repro_torch.launch import dryrun

    out = tmp_path / "records"
    assert dryrun.run_cells(["granite-3-8b"], ["long_500k"], ["pod"],
                            "tuned", str(out)) == []
    rec = json.loads((out / "granite-3-8b__long_500k__pod__tuned.json")
                     .read_text())
    assert rec["skipped"] and not rec["ok"]
    assert dryrun.DEFAULT_OUT == "results/dryrun_torch"
    assert report.load() == report.load(dryrun.DEFAULT_OUT)
