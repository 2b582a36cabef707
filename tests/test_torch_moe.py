"""The port's Mixture-of-Experts layer and dbrx-132b, held against the
reference.

``moe_forward`` is compared on the reference's own expert weights (a
layer of the smoke config, carried by ``params_from_numpy``) in float32
at ``atol`` 1e-5, with and without shared experts, and where capacity
binds: dbrx's smoke config at ``capacity_factor`` 0.25 and S = 64 drops
slots, and the same slots must go.  The dbrx-132b slice (prefill, decode,
greedy tokens, serve_demo) follows ``tests/torch_lm_parity.py``.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_lm_parity as P  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.kernels.flash_attention import kernel  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ARCH = "dbrx-132b"


@functools.cache
def carried(arch, dtype):
    return P.carry(arch, dtype)


def _moe_layer(c: P.Carried, i=0):
    return (jax.tree.map(lambda a: a[i], c.ref_params["layers"]["moe"]),
            T._layer(c.params["layers"]["moe"], i))


def _normal(shape, seed):
    a = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,E,K,cf", [
    (1, 16, 4, 1.25), (64, 4, 2, 0.25), (2048, 16, 4, 1.25),
    (2048, 160, 6, 1.25), (256, 160, 6, 160 / 6), (7, 8, 2, 1.0)])
def test_capacity_matches_reference(S, E, K, cf):
    assert moe.moe_capacity(S, E, K, cf) == ref_moe.moe_capacity(S, E, K, cf)


@pytest.mark.parametrize("arch", [ARCH, "deepseek-v2-236b"])
def test_moe_init_tree_matches_reference(arch):
    ref_cfg, cfg = P.configs(arch, "bfloat16")
    want = ref_moe.moe_init(jax.random.PRNGKey(0), ref_cfg, jnp.bfloat16)
    got = moe.moe_init(torch.Generator().manual_seed(0), cfg,
                       torch.bfloat16)
    assert P.tree_spec(got) == P.tree_spec(want)
    assert ("shared" in got) == bool(cfg.moe.n_shared)


@pytest.mark.parametrize("arch,cf,S,drops", [
    (ARCH, None, 40, False),
    (ARCH, 0.25, 64, True),
    ("deepseek-v2-236b", None, 40, False),     # shared experts
    ("deepseek-v2-236b", 0.25, 64, True)],
    ids=["dbrx", "dbrx-capacity-binds", "deepseek",
         "deepseek-capacity-binds"])
def test_moe_forward_matches_reference(arch, cf, S, drops):
    c = carried(arch, "float32")
    ref_cfg, cfg = c.ref_cfg, c.cfg
    if cf is not None:
        ref_cfg, cfg = (x.replace(moe=dataclasses.replace(
            x.moe, capacity_factor=cf)) for x in (ref_cfg, cfg))
    jp, p = _moe_layer(c)
    jx, x = _normal((2, S, cfg.d_model), 3)
    y, aux = moe.moe_forward(p, cfg, x)
    want_y, want_aux = ref_moe.moe_forward(jp, ref_cfg, jx)
    np.testing.assert_allclose(P.as_np(y), P.as_np(want_y), atol=P.ATOL)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=P.ATOL)
    assert y.dtype == x.dtype
    dropped = int(moe.route(p, cfg, x).dropped)
    assert (dropped > 0) == drops
    if drops:
        # every token keeps at most its top-k slots, and some keep fewer
        assert dropped < 2 * S * cfg.moe.top_k


def test_moe_forward_bf16_matches_reference():
    c = carried(ARCH, "bfloat16")
    jp, p = _moe_layer(c)
    jx, x = _normal((2, 40, c.cfg.d_model), 4)
    y, _ = moe.moe_forward(p, c.cfg, x.bfloat16())
    want, _ = ref_moe.moe_forward(jp, c.ref_cfg, jx.astype(jnp.bfloat16))
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(P.as_np(y), P.as_np(want),
                               atol=P.LOGITS_ATOL["bfloat16"])


def test_route_ranks_slots_slot_major():
    """Slots rank within their expert token by token, choice by choice;
    position < capacity is kept."""
    c = carried(ARCH, "float32")
    _, p = _moe_layer(c)
    cfg = c.cfg.replace(moe=MoEConfig(n_experts=4, top_k=2, expert_d_ff=96,
                                      capacity_factor=0.25))
    _, x = _normal((2, 64, cfg.d_model), 5)
    r = moe.route(p, cfg, x)
    assert r.capacity == 8
    for b in range(2):
        seen = {}
        for j, e in enumerate(r.expert[b].tolist()):
            assert int(r.position[b, j]) == seen.get(e, 0)
            seen[e] = seen.get(e, 0) + 1
    assert torch.equal(r.keep, r.position < 8)
    assert int(r.dropped) == int((r.position >= 8).sum())


# ---------------------------------------------------------------------------
# dbrx-132b
# ---------------------------------------------------------------------------


def test_full_config_matches_reference_without_building_it():
    P.check_full_config(ARCH)
    cfg = P.get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.moe.n_experts, cfg.moe.top_k) == (
                40, 6144, 48, 8, 128, 16, 4)


def test_init_params_tree_matches_reference():
    P.check_params_tree(ARCH)


@pytest.mark.parametrize("dtype", P.DTYPES)
def test_init_cache_tree_matches_reference(dtype):
    P.check_cache_tree(ARCH, dtype)


@pytest.mark.parametrize("dtype", P.DTYPES)
def test_prefill_step_matches_reference(dtype):
    launches = kernel.flash_attention_fwd.launches
    P.check_prefill(carried(ARCH, dtype), dtype)
    assert kernel.flash_attention_fwd.launches == launches     # CPU: plain


def test_decode_steps_match_reference():
    P.check_decode_step(carried(ARCH, "float32"))


def test_prefill_into_cache_and_greedy_decode_match_reference():
    P.check_greedy_tokens(carried(ARCH, "float32"))


def test_serve_demo_greedy_tokens_equal_the_reference():
    P.check_serve_demo(ARCH, carried(ARCH, "bfloat16").params)
