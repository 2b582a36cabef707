"""The port's sharding rules against the reference's
``distributed/meshes.py``, at full width, with no devices and no weights.

For each of the ten registered architectures the reference's parameter
shapes come from ``jax.eval_shape(T.init_params, ...)`` and the port's
from its own ``init_params`` under ``FakeTensorMode`` (shapes and dtypes,
no values drawn).  Both packages' ``param_pspecs``, ``opt_pspecs``,
``cache_pspecs`` and ``batch_pspecs`` are compared entry for entry, as
plain tuples keyed by path, on four device-free meshes: (2, 4) and
(2, 2, 2) (the test meshes), (16, 16) and (2, 16, 16) (the production
meshes), the reference's ``AbstractMesh`` on its side and the port's
``compat.AbstractMesh`` on the other.  ``parallel_strategy="fsdp"``
covers the fused ("data", "model") branch.  ``plan_resize`` is held on the
reference's own case (``tests/test_checkpoint.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.checkpoint.elastic import plan_resize as ref_plan_resize  # noqa
from repro.configs.base import get_config as ref_get_config  # noqa: E402
from repro.core.hetero import HeterogeneityProfile as RefProfile  # noqa
from repro.distributed import meshes as RM  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro_torch.checkpoint.elastic import plan_resize  # noqa: E402
from repro_torch.configs.base import get_config, list_archs  # noqa: E402
from repro_torch.core.compat import AbstractMesh  # noqa: E402
from repro_torch.core.hetero import HeterogeneityProfile  # noqa: E402
from repro_torch.distributed import meshes as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

MESHES = {"test": ((2, 4), ("data", "model")),
          "test_multipod": ((2, 2, 2), ("pod", "data", "model")),
          "production": ((16, 16), ("data", "model")),
          "production_multipod": ((2, 16, 16), ("pod", "data", "model"))}
# the cache and batch: B divides 2 and 4 but not 16, S every model axis
CACHE_B, CACHE_S = 8, 2048


def _ref_mesh(shape, names):
    return jax.sharding.AbstractMesh(shape, names)


def _plain(spec):
    """A spec as a tuple of entries (None, a name, or a tuple of names)."""
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e
                 for e in spec)


def _ref_flat(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
    )[0]:
        out[RM._path_str(path)] = _plain(leaf)
    return out


def _port_flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _port_flat(sub, f"{prefix}{key}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _port_flat(sub, f"{prefix}{i}/").items()}
    assert isinstance(tree, M.PartitionSpec), type(tree)
    return {prefix[:-1]: _plain(tree)}


_SHAPES = {}


def _shapes(arch, **change):
    """(reference's abstract params and cache, the port's fake ones)."""
    key = (arch, tuple(sorted(change.items())))
    if key not in _SHAPES:
        rcfg = ref_get_config(arch).replace(**change)
        ref_p = jax.eval_shape(lambda k: RT.init_params(rcfg, k),
                               jax.random.PRNGKey(0))
        ref_c = jax.eval_shape(lambda: RT.init_cache(rcfg, CACHE_B, CACHE_S))
        cfg = get_config(arch).replace(**change)
        with FakeTensorMode():
            port_p = T.init_params(cfg, torch.Generator().manual_seed(0))
            port_c = T.init_cache(cfg, CACHE_B, CACHE_S)
        _SHAPES[key] = (rcfg, ref_p, ref_c, cfg, port_p, port_c)
    return _SHAPES[key]


def _batch(cfg, fake):
    """The batch keys a train step takes, as shapes."""
    keys = {"tokens": (CACHE_B, CACHE_S), "labels": (CACHE_B, CACHE_S)}
    if cfg.frontend == "audio":
        keys = {"frames": (CACHE_B, CACHE_S, cfg.d_model),
                "labels": (CACHE_B, CACHE_S, cfg.n_codebooks)}
    if cfg.frontend == "vision":
        keys["vision_embeds"] = (CACHE_B, cfg.n_vision_tokens, cfg.d_model)
    if fake:
        return {k: torch.empty(s, device="meta") for k, s in keys.items()}
    return {k: jax.ShapeDtypeStruct(s, jnp.float32) for k, s in keys.items()}


def _compare(arch, mesh_name, **change):
    rcfg, ref_p, ref_c, cfg, port_p, port_c = _shapes(arch, **change)
    shape, names = MESHES[mesh_name]
    rmesh, mesh = _ref_mesh(shape, names), AbstractMesh(shape, names)
    pairs = {
        "param": (RM.param_pspecs(rcfg, ref_p, rmesh),
                  M.param_pspecs(cfg, port_p, mesh)),
        "opt": (RM.opt_pspecs(rcfg, ref_p, rmesh),
                M.opt_pspecs(cfg, port_p, mesh)),
        "cache": (RM.cache_pspecs(rcfg, ref_c, rmesh, CACHE_S),
                  M.cache_pspecs(cfg, port_c, mesh, CACHE_S)),
        "batch": (RM.batch_pspecs(_batch(rcfg, False), rmesh),
                  M.batch_pspecs(_batch(cfg, True), mesh)),
    }
    sharded = 0
    for what, (want, got) in pairs.items():
        want, got = _ref_flat(want), _port_flat(got)
        assert got == want, (arch, mesh_name, what)
        sharded += sum(any(e is not None for e in s) for s in got.values())
    assert sharded > 0
    return pairs


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_rules_equal_reference(arch, mesh_name):
    pairs = _compare(arch, mesh_name)
    # ZeRO-1 puts "data" on every moment leaf with a free dividing dim
    opt = _port_flat(pairs["opt"][1])
    assert any("data" in M._axes_of(e) for s in opt.values() for e in s)


@pytest.mark.parametrize("mesh_name", ["test", "production_multipod"])
@pytest.mark.parametrize("arch", ["gemma3-1b", "granite-3-8b", "dbrx-132b",
                                  "hymba-1.5b", "rwkv6-7b"])
def test_fsdp_rules_equal_reference(arch, mesh_name):
    """``parallel_strategy="fsdp"``: the model dim of every column and row
    weight is split over ("data", "model") where that divides."""
    pairs = _compare(arch, mesh_name, parallel_strategy="fsdp")
    param = _port_flat(pairs["param"][1])
    assert any(e == ("data", "model") for s in param.values() for e in s)


def test_placements_nest_axes_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    mesh = AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    sh = M.NamedSharding(mesh, M.P(("pod", "data"), None, "model"))
    assert sh.placements() == (Shard(0), Shard(0), Shard(2))
    assert M.NamedSharding(mesh, M.P(None)).placements() == (Replicate(),) * 3
    # the first axis of a tuple is major: (pod 1, data 0) holds rows 4-5
    assert sh.slices((8, 3, 4), (1, 0, 1)) == (slice(4, 6), slice(0, 3),
                                               slice(2, 4))
    with pytest.raises(NotImplementedError, match="mesh's order"):
        M.NamedSharding(mesh, M.P(("data", "pod"))).placements()


def test_resize_plan_gates_chips_and_replans():
    """The reference's case, in both packages, on device-free meshes."""
    for old, new in (("test", "test_multipod"), ("test_multipod", "test"),
                     ("production", "test")):
        got = [plan_resize(AbstractMesh(*MESHES[old]),
                           AbstractMesh(*MESHES[new]), global_batch=16,
                           microbatch=2, profile=prof)
               for prof in (HeterogeneityProfile.paper(), None)]
        want = [ref_plan_resize(_ref_mesh(*MESHES[old]),
                                _ref_mesh(*MESHES[new]), global_batch=16,
                                microbatch=2, profile=prof)
                for prof in (RefProfile.paper(), None)]
        for g, w in zip(got, want):
            assert (g.old_shape, g.new_shape, g.gated_chips, g.is_shrink) \
                == (w.old_shape, w.new_shape, w.gated_chips, w.is_shrink)
            assert g.batch_plan.counts.tolist() == \
                w.batch_plan.counts.tolist()
            assert g.batch_plan.step_batches == w.batch_plan.step_batches
    plan = plan_resize(AbstractMesh(*MESHES["test"]),
                       AbstractMesh(*MESHES["test_multipod"]),
                       global_batch=16, microbatch=2,
                       profile=HeterogeneityProfile.paper())
    assert plan.batch_plan.step_batches == 8 and plan.gated_chips == 0
    shrink = plan_resize(AbstractMesh(*MESHES["production"]),
                         AbstractMesh(*MESHES["test"]), 16, 2)
    assert shrink.is_shrink and shrink.gated_chips == 248
    assert np.sum(shrink.batch_plan.counts) == 8
