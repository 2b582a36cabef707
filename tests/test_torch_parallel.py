"""The port's parallel plane held against the reference's: collectives,
the quantized all-reduce, elastic restore across meshes and packages, and
the sequence-parallel and expert sharding hints.

Two subprocesses run side by side, as in ``tests/test_torch_sharded.py``:
the reference on 8 forced host devices (``XLA_FLAGS``), the port on 8 gloo
ranks spawned by ``repro_torch.distributed.ranks.spawn_ranks`` (each
collective bounded by a timeout, so a rank that skips one fails the run).
Both build the test meshes of ``launch/mesh.make_test_mesh``: (2, 4)
("data", "model") and (2, 2, 2) ("pod", "data", "model").  Rank r of the
port sits at the row-major mesh coordinate of r; the reference's values
are gathered by coordinate (``shard_map`` with every axis on the output's
leading dim), so each port rank is compared with the device at its
coordinate.

- Collectives, on the reference test's inputs (``tests/test_distributed.py``
  cases 2-4: ``arange`` data, seed 1's normal draw for ``psum_int8``) and a
  ``reduce_scatter_sum`` case of its own: every rank's array equals the
  reference device's exactly.  Sums over two participants cannot depend
  on order, and ``psum_int8`` sums int32.  One case reduce-scatters seeded
  normal floats over the 4-rank "model" axis, where XLA and gloo may add in
  different orders: it is bounded by 4 float32 ulps of the sum of
  magnitudes.
- Elastic: granite-3-8b's smoke parameters are sharded onto (2, 4) with
  ``param_pspecs``, saved, and restored with ``restore_elastic`` onto
  (2, 2, 2).  Each rank's local blocks equal the matching slices of the
  saved arrays bit for bit, the blocks are the reference's
  (``devices_indices_map``), and ``extra["step"] == 1``.  Each package
  then restores the other's checkpoint, and its whole arrays hash equal to
  what the other saved.
- Elastic under ``parallel_strategy="fsdp"`` as well: the same checkpoint
  restored onto (2, 2, 2) with its weights split over ("data", "model"),
  where DTensor nests two mesh dims' shards in one tensor dim.
- Hints, under each test mesh's context: ``sequence_shard`` and
  ``_expert_shard`` give a replicated DTensor the reference's blocks where
  the shapes divide (on (2, 2, 2) the batch over ("pod", "data")), and
  return their input where they do not.

Run as a script (``python tests/test_torch_parallel.py reference|port
OUTDIR``), this file is one of those subprocesses.  Only the reference
side imports jax.
"""
import hashlib
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
N_RANKS = 8
TIMEOUT_S = 300
COLLECTIVE_TIMEOUT_S = 120
WAIT_S = 240               # for the other side's checkpoint
ELASTIC_ARCH = "granite-3-8b"
ULPS = 4                   # the reordered float sum's bound

# name -> (mesh, input, input spec, what each rank computes)
COLLECTIVES = {
    "ring_all_gather": ("test", "arange8x2", ("model", None), "ring model"),
    "ring_all_gather_rows": ("test", "arange24x3",
                             (("data", "model"), None), "ring model"),
    "hierarchical_psum": ("multipod", "arange8", (("pod", "data"),),
                          "hier data pod"),
    "hierarchical_psum_inner": ("multipod", "arange8", (("pod", "data"),),
                                "hier data"),
    "psum_int8": ("test", "normal16", ("data",), "int8 data"),
    "reduce_scatter_sum": ("test", "arange64x3", (("data", "model"),),
                           "rs model"),
    "reduce_scatter_sum_floats": ("test", "normal64x3",
                                  (("data", "model"),), "rs model"),
}
# "mesh hint case" -> (shape, whether the hint shards it there); on
# (2, 2, 2) the batch splits over the ("pod", "data") pair
HINTS = {
    "test sequence_shard divides": ((8, 16, 6), True),
    "test sequence_shard batch": ((3, 16, 6), False),
    "test sequence_shard sequence": ((8, 6, 6), False),
    "test sequence_shard rank2": ((8, 16), False),
    "test sequence_shard rank4": ((4, 8, 3, 2), True),
    "test expert_shard divides": ((4, 2, 3, 6), True),
    "test expert_shard experts": ((3, 2, 3, 6), False),
    "multipod sequence_shard divides": ((8, 6, 6), True),
    "multipod sequence_shard batch": ((6, 16, 6), False),
    "multipod sequence_shard sequence": ((8, 5, 6), False),
    "multipod expert_shard divides": ((2, 4, 3, 6), True),
}


def _inputs(name):
    if name == "normal16":
        return np.random.default_rng(1).standard_normal(16).astype(np.float32)
    if name == "normal64x3":
        return np.random.default_rng(2).standard_normal((64, 3)).astype(
            np.float32)
    shape = {"arange8x2": (4, 2), "arange24x3": (8, 3), "arange8": (8,),
             "arange64x3": (64, 3)}[name]
    return np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)


def _digest(arr: np.ndarray) -> str:
    """A whole array's bytes and shape, hashed (bfloat16 by its uint16
    view)."""
    if str(arr.dtype) == "bfloat16":
        arr = arr.view(np.uint16)
    h = hashlib.sha256(np.ascontiguousarray(arr).tobytes())
    return f"{arr.dtype}{list(arr.shape)}:{h.hexdigest()}"


def _slices_json(index, shape):
    return [[s.start or 0, n if s.stop is None else s.stop]
            for s, n in zip(index, shape)]


def _wait_for(path: Path) -> None:
    t0 = time.time()
    while not path.exists():
        if time.time() - t0 > WAIT_S:
            raise TimeoutError(f"{path} never appeared")
        time.sleep(0.2)


# ---------------------------------------------------------------------------
# the reference: 8 forced host devices
# ---------------------------------------------------------------------------

def _reference_side(out: Path) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.checkpoint import store
    from repro.checkpoint.elastic import restore_elastic
    from repro.configs.base import get_config
    from repro.core.compat import mesh_context
    from repro.distributed import meshes as M
    from repro.distributed.collectives import (hierarchical_psum,
                                               reduce_scatter_sum,
                                               ring_all_gather)
    from repro.launch.mesh import make_test_mesh
    from repro.models import transformer as T
    from repro.models.layers import sequence_shard
    from repro.models.moe import _expert_shard
    from repro.optim.compression import psum_int8

    meshes = {"test": make_test_mesh(),
              "multipod": make_test_mesh(multi_pod=True)}

    def coord_of(mesh):
        return {d: [int(i) for i in idx]
                for idx, d in np.ndenumerate(mesh.devices)}

    def layout(x, mesh):
        """{coordinate: the block's slices} of a placed array, each block
        checked against the whole array."""
        full = np.asarray(x)
        coords = coord_of(mesh)
        for shard in x.addressable_shards:
            assert np.array_equal(np.asarray(shard.data), full[shard.index])
        return {json.dumps(coords[d]): _slices_json(idx, x.shape)
                for d, idx in x.sharding.devices_indices_map(
                    x.shape).items()}

    def body(op):
        kind, *axes = op.split()
        if kind == "ring":
            return lambda x: ring_all_gather(x, axes[0])
        if kind == "hier":
            return lambda x: hierarchical_psum(
                x, axes[0], axes[1] if len(axes) > 1 else None)
        if kind == "int8":
            return lambda x: psum_int8(x, axes[0])
        return lambda x: reduce_scatter_sum(x, axes[0])

    got = {"collectives": {}}
    for name, (mesh_name, inp, spec, op) in COLLECTIVES.items():
        mesh = meshes[mesh_name]
        fn = body(op)
        every = tuple(mesh.axis_names)
        f = shard_map(lambda x, fn=fn: fn(x)[None], mesh=mesh,
                      in_specs=(P(*spec),), out_specs=P(every),
                      check_rep=False)
        res = np.asarray(f(jnp.asarray(_inputs(inp))))
        got["collectives"][name] = res.tolist()   # [coordinate, ...]

    # elastic: save from (2, 4), restore onto (2, 2, 2)
    cfg = get_config(ELASTIC_ARCH, smoke=True)
    params = T.init_params(cfg, jax.random.PRNGKey(0))
    mesh1, mesh2 = meshes["test"], meshes["multipod"]
    sh1 = M.named(M.param_pspecs(cfg, params, mesh1), mesh1)
    placed = jax.tree.map(lambda x, s: jax.device_put(x, s), params, sh1)
    store.save(str(out / "ref_ckpt"), 1, placed, extra={"step": 1})
    (out / "ref_ckpt.done").write_text("")

    def keyed(tree):
        return {M._path_str(p): x for p, x in
                jax.tree_util.tree_flatten_with_path(tree)[0]}

    saved = {k: _digest(np.asarray(v)) for k, v in keyed(params).items()}
    restored, extra = restore_elastic(str(out / "ref_ckpt"), params, cfg,
                                      mesh2)
    own = {k: layout(v, mesh2) for k, v in keyed(restored).items()}
    assert all(_digest(np.asarray(v)) == saved[k]
               for k, v in keyed(restored).items())
    _wait_for(out / "port_ckpt.done")
    theirs, their_extra = restore_elastic(str(out / "port_ckpt"), params,
                                          cfg, mesh2)
    got["elastic"] = {
        "saved": saved, "layout": own, "step": extra["step"],
        "port_ckpt": {k: _digest(np.asarray(v))
                      for k, v in keyed(theirs).items()},
        "port_layout": {k: layout(v, mesh2)
                        for k, v in keyed(theirs).items()},
        "port_step": their_extra["step"]}

    fsdp = cfg.replace(parallel_strategy="fsdp")
    got["elastic"]["fsdp_layout"] = {
        k: layout(v, mesh2) for k, v in keyed(restore_elastic(
            str(out / "ref_ckpt"), params, fsdp, mesh2)[0]).items()}

    # the hints on a replicated input, under each mesh
    hints = {"sequence_shard": sequence_shard, "expert_shard": _expert_shard}
    got["hints"] = {}
    for case, (shape, _) in HINTS.items():
        mesh_name, hint, _ = case.split()
        mesh = meshes[mesh_name]
        with mesh_context(mesh):
            x = jax.device_put(
                jnp.arange(int(np.prod(shape)), dtype=jnp.float32
                           ).reshape(shape), NamedSharding(mesh, P()))
            got["hints"][case] = layout(jax.jit(hints[hint])(x), mesh)
    (out / "reference.json").write_text(json.dumps(got))


# ---------------------------------------------------------------------------
# the port: 8 gloo ranks
# ---------------------------------------------------------------------------

def _port_rank(rank: int, out: str) -> None:
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import store
    from repro_torch.checkpoint.elastic import restore_elastic
    from repro_torch.configs.base import get_config
    from repro_torch.core.compat import mesh_context
    from repro_torch.distributed import meshes as M
    from repro_torch.distributed.collectives import (hierarchical_psum,
                                                     reduce_scatter_sum,
                                                     ring_all_gather)
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import sequence_shard
    from repro_torch.models.moe import _expert_shard
    from repro_torch.optim.adamw import tree_map
    from repro_torch.optim.compression import psum_int8

    out = Path(out)
    meshes = {"test": make_test_mesh(),
              "multipod": make_test_mesh(multi_pod=True)}
    got = {"coordinate": {k: list(m.get_coordinate())
                          for k, m in meshes.items()}}

    def body(op):
        kind, *axes = op.split()
        if kind == "ring":
            arrived = []

            def ring(x):
                y = ring_all_gather(
                    x, axes[0], compute=lambda s, i: arrived.append(i))
                assert sorted(arrived) == [
                    i for i in range(meshes["test"].size(1))
                    if i != meshes["test"].get_local_rank(axes[0])]
                return y
            return ring
        if kind == "hier":
            return lambda x: hierarchical_psum(
                x, axes[0], axes[1] if len(axes) > 1 else None)
        if kind == "int8":
            return lambda x: psum_int8(x, axes[0])
        return lambda x: reduce_scatter_sum(x, axes[0])

    got["collectives"] = {}
    for name, (mesh_name, inp, spec, op) in COLLECTIVES.items():
        mesh = meshes[mesh_name]
        full = torch.from_numpy(_inputs(inp))
        mine = full[M.NamedSharding(mesh, M.P(*spec)).slices(
            full.shape, mesh.get_coordinate())].clone()
        before = mine.clone()
        with mesh_context(mesh):
            res = body(op)(mine)
        assert torch.equal(mine, before), name          # input untouched
        got["collectives"][name] = res.tolist()

    # elastic: save from (2, 4), restore onto (2, 2, 2)
    cfg = get_config(ELASTIC_ARCH, smoke=True)
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    mesh1, mesh2 = meshes["test"], meshes["multipod"]
    flat = store._flatten(params)

    placed = tree_map(lambda x, s: s.distribute(x), params,
                      M.named(M.param_pspecs(cfg, params, mesh1), mesh1))
    assert all(isinstance(x, DTensor)
               for x in store._flatten(placed).values())
    store.save(str(out / "port_ckpt"), 1, placed, extra={"step": 1})
    if rank == 0:
        (out / "port_ckpt.done").write_text("")
    coord2 = mesh2.get_coordinate()

    def blocks(restored, want, cfg=cfg):
        """This rank's block slices of each leaf, each block equal bit for
        bit to the matching slice of ``want``'s leaf and the whole leaf
        gathered back to ``want``'s."""
        specs = store._flatten(M.param_pspecs(cfg, params, mesh2))
        res = {}
        for k, v in store._flatten(restored).items():
            assert isinstance(v, DTensor) and v.device_mesh == mesh2, k
            sl = M.NamedSharding(mesh2, specs[k]).slices(v.shape, coord2)
            assert torch.equal(v.to_local(), want[k][sl]), k
            assert tuple(v.placements) == \
                M.NamedSharding(mesh2, specs[k]).placements(), k
            assert torch.equal(v.full_tensor(), want[k]), k
            res[k] = _slices_json(sl, v.shape)
        return res

    def digests(tree):
        return {k: _digest(_np(v.full_tensor()))
                for k, v in store._flatten(tree).items()}

    restored, extra = restore_elastic(str(out / "port_ckpt"), params, cfg,
                                      mesh2)
    got["elastic"] = {"layout": blocks(restored, flat), "step": extra["step"],
                      "saved": {k: _digest(_np(v)) for k, v in flat.items()},
                      "restored": digests(restored)}
    _wait_for(out / "ref_ckpt.done")
    theirs, their_extra = restore_elastic(str(out / "ref_ckpt"), params, cfg,
                                          mesh2)
    whole, _ = store.restore(str(out / "ref_ckpt"), params)
    got["elastic"].update(ref_layout=blocks(theirs, store._flatten(whole)),
                          ref_ckpt=digests(theirs),
                          ref_step=their_extra["step"])
    fsdp = cfg.replace(parallel_strategy="fsdp")
    got["elastic"]["fsdp_layout"] = blocks(restore_elastic(
        str(out / "port_ckpt"), params, fsdp, mesh2)[0], flat, fsdp)

    # the hints on a replicated DTensor, under each mesh
    hints = {"sequence_shard": sequence_shard, "expert_shard": _expert_shard}
    got["hints"] = {}
    for case, (shape, _) in HINTS.items():
        mesh_name, hint, _ = case.split()
        mesh = meshes[mesh_name]
        with mesh_context(mesh):
            full = torch.arange(int(np.prod(shape)),
                                dtype=torch.float32).reshape(shape)
            assert hints[hint](full) is full              # a plain tensor
            x = M.NamedSharding(mesh, M.P()).distribute(full)
            y = hints[hint](x)
            spec = _spec_of(y.placements, y.dim(), mesh)
            sl = M.NamedSharding(mesh, spec).slices(shape,
                                                    mesh.get_coordinate())
            assert torch.equal(y.to_local(), full[sl])
            assert torch.equal(y.full_tensor(), full)
            got["hints"][case] = {"slices": _slices_json(sl, shape),
                                  "same": y is x}
    # outside a mesh context a DTensor comes back as it is
    x = M.NamedSharding(mesh1, M.P()).distribute(torch.zeros(8, 16, 6))
    got["hints_outside"] = sequence_shard(x) is x
    (out / f"rank{rank}.json").write_text(json.dumps(got))


def _spec_of(placements, ndim, mesh):
    """The spec that DTensor ``placements`` on ``mesh`` express (the
    inverse of ``NamedSharding.placements``)."""
    from repro_torch.distributed.meshes import P

    entries = [[] for _ in range(ndim)]
    for a, pl in zip(mesh.mesh_dim_names, placements):
        if pl.is_shard():
            entries[pl.dim % ndim].append(a)
    return P(*(tuple(e) if e else None for e in entries))


def _np(t):
    """A tensor's bytes as numpy (bfloat16 as its uint16 view, tagged by
    the dtype name ``_digest`` prints)."""
    import torch
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _port_side(out: Path) -> None:
    from repro_torch.distributed.ranks import spawn_ranks

    spawn_ranks(_port_rank, N_RANKS, args=(str(out),),
                store=str(out / "store"), timeout_s=COLLECTIVE_TIMEOUT_S)


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """Both subprocesses, started together: ``(reference, [rank 0..7])``."""
    pytest.importorskip("torch")
    out = tmp_path_factory.mktemp("parallel")
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


def _row_major(coord, mesh_name):
    shape = (2, 4) if mesh_name == "test" else (2, 2, 2)
    return int(np.ravel_multi_index(coord, shape))


@pytest.mark.parametrize("name", list(COLLECTIVES))
def test_collectives_equal_reference(sides, name):
    ref, ranks = sides
    mesh_name = COLLECTIVES[name][0]
    for r, got in enumerate(ranks):
        at = _row_major(got["coordinate"][mesh_name], mesh_name)
        assert at == r
        mine = np.asarray(got["collectives"][name], np.float32)
        want = np.asarray(ref["collectives"][name][at], np.float32)
        assert mine.shape == want.shape, (name, r)
        if name != "reduce_scatter_sum_floats":
            np.testing.assert_array_equal(mine, want, err_msg=f"rank {r}")
            continue
        # four addends, summed in an order XLA and gloo may not share:
        # rank (d, m) keeps rows 2m, 2m+1 of the sum of data row d's blocks
        d, m = got["coordinate"]["test"]
        blocks = _inputs("normal64x3").reshape(2, 4, 8, 3)[d]
        mag = np.abs(blocks).sum(0)[2 * m:2 * m + 2]
        bound = ULPS * np.finfo(np.float32).eps * mag
        assert (np.abs(mine - want) <= bound).all(), (r, mine - want)


def test_collectives_match_their_flat_versions(sides):
    """The reference test's own claims on the port's ranks: the ring equals
    the flat all-gather, the two-level sum the flat one, and the int8 sum
    lies within 5% of the float32 sum's largest entry."""
    _, ranks = sides
    x = _inputs("arange8x2")
    y = _inputs("arange8")
    g = _inputs("normal16")
    for got in ranks:
        c = got["collectives"]
        np.testing.assert_array_equal(c["ring_all_gather"], x)
        np.testing.assert_array_equal(c["hierarchical_psum"],
                                      y.reshape(4, 2).sum(0))
        exact = g.reshape(2, 8).sum(0)
        approx = np.asarray(c["psum_int8"], np.float32)
        assert (np.abs(approx - exact) / (np.abs(exact).max() + 1e-9)
                < 0.05).all()


def test_elastic_restore_across_meshes(sides):
    """Each rank's blocks on (2, 2, 2) equal the saved arrays' slices bit
    for bit (checked on the ranks), the whole arrays hash equal to what was
    saved, and the step comes back."""
    _, ranks = sides
    for got in ranks:
        e = got["elastic"]
        assert e["step"] == 1
        assert e["restored"] == e["saved"]
        assert e["layout"]
    sharded = {k for k, v in ranks[0]["elastic"]["layout"].items()
               if any(list(s) != list(ranks[1]["elastic"]["layout"][k][i])
                      for i, s in enumerate(v))}
    assert sharded, "no leaf is sharded on (2, 2, 2)"


def test_elastic_blocks_equal_reference(sides):
    """The port's block of every leaf at every coordinate of (2, 2, 2) is
    the reference's, for the port's checkpoint and for the reference's."""
    ref, ranks = sides
    for got in ranks:
        coord = json.dumps(got["coordinate"]["multipod"])
        for key in ("layout", "ref_layout"):
            mine = got["elastic"][key]
            assert set(mine) == set(ref["elastic"]["layout"])
            for k, sl in mine.items():
                assert sl == ref["elastic"]["layout"][k][coord], (key, k)
                assert sl == ref["elastic"]["port_layout"][k][coord], k
        mine = got["elastic"]["fsdp_layout"]
        assert set(mine) == set(ref["elastic"]["fsdp_layout"])
        for k, sl in mine.items():
            assert sl == ref["elastic"]["fsdp_layout"][k][coord], k
    # the fsdp restore splits some leaf over ("data", "model") together
    assert ref["elastic"]["fsdp_layout"] != ref["elastic"]["layout"]


def test_elastic_restore_across_packages(sides):
    """The reference restores the port's checkpoint, and the port the
    reference's, each to the other's saved bits."""
    ref, ranks = sides
    e = ref["elastic"]
    assert e["step"] == e["port_step"] == 1
    assert e["port_ckpt"] == ranks[0]["elastic"]["saved"]
    for got in ranks:
        assert got["elastic"]["ref_ckpt"] == e["saved"]
        assert got["elastic"]["ref_step"] == 1


@pytest.mark.parametrize("case", list(HINTS))
def test_hints_equal_reference(sides, case):
    ref, ranks = sides
    shards = HINTS[case][1]
    for got in ranks:
        coord = json.dumps(got["coordinate"][case.split()[0]])
        mine = got["hints"][case]
        assert mine["slices"] == ref["hints"][case][coord], case
        assert mine["same"] == (not shards), case
        assert got["hints_outside"]


if __name__ == "__main__":
    _side, _out = sys.argv[1], Path(sys.argv[2])
    (_reference_side if _side == "reference" else _port_side)(_out)
