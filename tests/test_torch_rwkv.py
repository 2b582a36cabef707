"""The port's rwkv6-7b serving path (the RWKV-6 time-mix + channel-mix
block), held against the reference.

The reference's parameters, drawn by ``init_params(cfg, PRNGKey(0))`` on
rwkv6-7b's smoke config (2 layers, d 64, 4 heads of 16, ff 128, vocab
512), are carried into the port leaf for leaf (``params_from_numpy``), and
the same numpy-seeded inputs go through both packages.  Both of the
port's ``time_mix_impl`` forms are held to the reference's ``scan`` form
(its ``chunked`` form clamps exponents and is not the sequential
recurrence).  Tolerances are those of ``tests/test_torch_hymba.py``: in
float32 1e-4 for anything that runs the recurrence (the sums run in
another order than the reference's einsum), in bf16 3e-2 (a few bf16
steps at |x| <= 1, where the two frameworks round at different points);
greedy tokens must be equal.  Only smoke-sized configs are built here:
the full config is checked through its fields and counts alone.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as ref_get_config  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import rwkv6 as ref_rwkv6  # noqa: E402
from repro.models import transformer as ref_T  # noqa: E402
from repro_torch.configs.base import (MLAConfig, MoEConfig,  # noqa: E402
                                     get_config)
from repro_torch.kernels.rwkv6_wkv import kernel as wkv  # noqa: E402
from repro_torch.launch import serve, steps  # noqa: E402
from repro_torch.models import rwkv6  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

ARCH = "rwkv6-7b"
ATOL = {"float32": 1e-4, "bfloat16": 3e-2}
DTYPES = tuple(ATOL)
# the reference's parameter tree at full width, counted by
# jax.eval_shape(init_params); cfg.param_count()'s formula leaves out the
# channel-mix wr and counts the LoRAs roughly
FULL_TREE_PARAMS = 7_584_878_592
FULL_FORMULA_PARAMS = 7_055_081_472


def _cfgs(dtype, impl="scan"):
    kw = dict(param_dtype=dtype, activ_dtype=dtype)
    return (ref_get_config(ARCH, smoke=True).replace(**kw),
            get_config(ARCH, smoke=True).replace(time_mix_impl=impl, **kw))


def _carry(dtype):
    ref_cfg, cfg = _cfgs(dtype)
    ref_params = ref_T.init_params(ref_cfg, jax.random.PRNGKey(0))
    return (ref_cfg, cfg, ref_params,
            params_from_numpy(jax.tree.map(np.asarray, ref_params)))


@pytest.fixture(scope="module")
def carried32():
    return _carry("float32")


@pytest.fixture(scope="module")
def carried16():
    return _carry("bfloat16")


@pytest.fixture(params=DTYPES)
def carried(request):
    name = "carried32" if request.param == "float32" else "carried16"
    return (request.param, *request.getfixturevalue(name))


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _normal(shape, seed, dtype="float32", scale=1.0):
    a = (np.random.default_rng(seed).standard_normal(shape) * scale
         ).astype(np.float32)
    return (jnp.asarray(a).astype(dtype),
            torch.from_numpy(a).to(T.dtype_of(dtype)))


def _layer0(ref_params, params, key=None):
    jp = jax.tree.map(lambda a: a[0], ref_params["layers"])
    p = T._layer(params["layers"], 0)
    return (jp, p) if key is None else (jp[key], p[key])


def _tree_spec(tree):
    """{path: (shape, dtype name)} of a tree of jnp arrays or tensors."""
    if isinstance(tree, dict):
        return {f"{k}/{p}" if p else k: s for k, v in tree.items()
                for p, s in _tree_spec(v).items()}
    return {"": (tuple(tree.shape), str(tree.dtype).split(".")[-1])}


def _state(cfg, dtype, B, seed):
    """A non-zero time-mix + channel-mix state, in both packages."""
    H, n, d = cfg.n_heads, cfg.head_dim, cfg.d_model
    (jt, t), (jc, c) = (_normal((B, d), seed, dtype),
                        _normal((B, d), seed + 1, dtype))
    jw, w = _normal((B, H, n, n), seed + 2, "float32", 0.3)
    return ({"tm_x": jt, "cm_x": jc, "wkv": jw},
            {"tm_x": t, "cm_x": c, "wkv": w})


# ---------------------------------------------------------------------------
# the time-mix, the channel-mix and the block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["no-state", "state"])
@pytest.mark.parametrize("impl", rwkv6.TIME_MIX_IMPLS)
def test_time_forward_matches_reference(carried, impl, with_state):
    dtype, ref_cfg, cfg, ref_params, params = carried
    jp, p = _layer0(ref_params, params, "time")
    cfg = cfg.replace(time_mix_impl=impl)
    jx, x = _normal((2, 40, cfg.d_model), 1, dtype)
    jst, st = _state(cfg, dtype, 2, 2) if with_state else (None, None)
    launches = wkv.wkv6_fwd.launches
    y, new = rwkv6.rwkv_time_forward(p, cfg, x, st)
    assert wkv.wkv6_fwd.launches == launches                # CPU: plain
    want, ref_new = ref_rwkv6.rwkv_time_forward(jp, ref_cfg, jx, jst)
    assert y.dtype == x.dtype and new["wkv"].dtype == torch.float32
    np.testing.assert_allclose(_np(y), _np(want), atol=ATOL[dtype])
    for key in ("tm_x", "wkv"):
        assert tuple(new[key].shape) == ref_new[key].shape
        np.testing.assert_allclose(_np(new[key]), _np(ref_new[key]),
                                   atol=ATOL[dtype])


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["no-state", "state"])
def test_channel_forward_matches_reference(carried, with_state):
    dtype, ref_cfg, cfg, ref_params, params = carried
    jp, p = _layer0(ref_params, params, "channel")
    jx, x = _normal((2, 40, cfg.d_model), 3, dtype)
    jst, st = _state(cfg, dtype, 2, 4) if with_state else (None, None)
    y, new = rwkv6.rwkv_channel_forward(p, cfg, x, st)
    want, ref_new = ref_rwkv6.rwkv_channel_forward(jp, ref_cfg, jx, jst)
    np.testing.assert_allclose(_np(y), _np(want), atol=ATOL[dtype])
    np.testing.assert_array_equal(_np(new["cm_x"]), _np(ref_new["cm_x"]))


def test_time_forward_one_token_step_matches_reference(carried32):
    """Decode: S == 1 steps the state in plain code on every device."""
    ref_cfg, cfg, ref_params, params = carried32
    jp, p = _layer0(ref_params, params, "time")
    jx, x = _normal((2, 1, cfg.d_model), 5)
    jst, st = _state(cfg, "float32", 2, 6)
    y, new = rwkv6.rwkv_time_forward(p, cfg, x, st)
    want, ref_new = ref_rwkv6.rwkv_time_forward(jp, ref_cfg, jx, jst)
    np.testing.assert_allclose(_np(y), _np(want), atol=ATOL["float32"])
    for key in ("tm_x", "wkv"):
        np.testing.assert_allclose(_np(new[key]), _np(ref_new[key]),
                                   atol=ATOL["float32"])


def test_init_state_and_init_matches_reference_trees():
    ref_cfg, cfg = _cfgs("bfloat16")
    gen = torch.Generator().manual_seed(0)
    for got, want in (
            (rwkv6.rwkv_time_init(gen, cfg, torch.bfloat16),
             ref_rwkv6.rwkv_time_init(jax.random.PRNGKey(0), ref_cfg,
                                      jnp.bfloat16)),
            (rwkv6.rwkv_channel_init(gen, cfg, torch.bfloat16),
             ref_rwkv6.rwkv_channel_init(jax.random.PRNGKey(0), ref_cfg,
                                         jnp.bfloat16)),
            (rwkv6.rwkv_init_state(cfg, 3, torch.bfloat16),
             ref_rwkv6.rwkv_init_state(ref_cfg, 3, jnp.bfloat16))):
        assert _tree_spec(got) == _tree_spec(want)
    time = rwkv6.rwkv_time_init(gen, cfg, torch.bfloat16)
    ref_time = ref_rwkv6.rwkv_time_init(jax.random.PRNGKey(0), ref_cfg,
                                        jnp.bfloat16)
    for key in ("w_base", "ln_scale"):              # deterministic leaves
        np.testing.assert_array_equal(_np(time[key]), _np(ref_time[key]))


def test_unknown_time_mix_impl_raises(carried32):
    _, cfg, _, params = carried32
    p = T._layer(params["layers"], 0)["time"]
    with pytest.raises(ValueError, match="time_mix_impl"):
        rwkv6.rwkv_time_forward(p, cfg.replace(time_mix_impl="parallel"),
                                torch.zeros((1, 4, cfg.d_model)))


def test_block_full_matches_reference(carried32):
    ref_cfg, cfg, ref_params, params = carried32
    jp, p = _layer0(ref_params, params)
    jx, x = _normal((2, 40, cfg.d_model), 7)
    got, aux = T._block_full(cfg, p, x, 0)
    want, _ = ref_T._block_full(ref_cfg, jp, jx, 0)
    assert aux == 0.0
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL["float32"])


# ---------------------------------------------------------------------------
# the slice
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", rwkv6.TIME_MIX_IMPLS)
def test_prefill_step_matches_reference(carried, impl):
    dtype, ref_cfg, cfg, ref_params, params = carried
    toks = _tokens(cfg, 2, 40)
    want = ref_steps.make_prefill_step(ref_cfg)(
        ref_params, {"tokens": jnp.asarray(toks)})
    launches = wkv.wkv6_fwd.launches
    got = steps.make_prefill_step(cfg.replace(time_mix_impl=impl))(
        params, {"tokens": torch.from_numpy(toks)})
    assert wkv.wkv6_fwd.launches == launches                # CPU: plain
    assert got.shape == (2, cfg.vocab_size) and got.dtype == T.dtype_of(dtype)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL[dtype])


def test_params_from_numpy_carries_every_rwkv_leaf(carried):
    """The carried tree has the reference's paths, shapes and dtypes
    (mu_base, w_base, u and ln_scale in float32, the LoRAs and projections
    in the param dtype), and every value arrives bit for bit (bf16 through
    the int16 view)."""
    dtype, _, _, ref_params, params = carried
    assert _tree_spec(params) == _tree_spec(ref_params)
    time = params["layers"]["time"]
    assert {k for k, v in time.items() if v.dtype == torch.float32} >= {
        "mu_base", "w_base", "u", "ln_scale"}
    assert time["w_lora1"].dtype == T.dtype_of(dtype)
    flat = jax.tree_util.tree_flatten_with_path(ref_params)[0]
    assert len(flat) == len(_tree_spec(params))
    for path, want in flat:
        got = params
        for key in path:
            got = got[key.key]
        want = np.asarray(want)
        if want.dtype.name == "bfloat16":
            got, want = got.view(torch.int16), want.view(np.int16)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_init_cache_tree_matches_reference(dtype):
    ref_cfg, cfg = _cfgs(dtype)
    want = ref_T.init_cache(ref_cfg, 3, 24)
    got = T.init_cache(cfg, 3, 24)
    assert sorted(got) == ["cm_x", "tm_x", "wkv"]          # no K/V
    assert _tree_spec(got) == _tree_spec(want)
    assert not any(v.any() for v in got.values())
    # each layer's state is its own memory, written in place by decode
    assert all(v.is_contiguous() for v in got.values())


def test_init_params_tree_matches_reference():
    ref_cfg, cfg = _cfgs("bfloat16")
    want = ref_T.init_params(ref_cfg, jax.random.PRNGKey(0))
    got = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert _tree_spec(got) == _tree_spec(want)
    assert sorted(got["layers"]) == ["channel", "ln1", "ln2", "time"]
    assert T.param_count(got) == ref_T.param_count(want)
    assert cfg.param_count() == ref_cfg.param_count()
    again = T.init_params(cfg, torch.Generator().manual_seed(0))
    assert torch.equal(again["layers"]["time"]["wr"],
                       got["layers"]["time"]["wr"])             # seeded


def test_decode_steps_match_reference_with_caches(carried32):
    ref_cfg, cfg, ref_params, params = carried32
    toks = _tokens(cfg, 2, 6, seed=2)
    ref_cache = ref_T.init_cache(ref_cfg, 2, 8)
    cache = T.init_cache(cfg, 2, 8)
    ref_step = ref_steps.make_decode_step(ref_cfg)
    step = steps.make_decode_step(cfg)
    for t in range(toks.shape[1]):
        ref_logits, ref_cache = ref_T.decode_step(
            ref_params, ref_cfg, ref_cache, jnp.asarray(toks[:, t:t + 1]), t)
        logits, cache = T.decode_step(params, cfg, cache,
                                      torch.from_numpy(toks[:, t:t + 1]), t)
        np.testing.assert_allclose(_np(logits), _np(ref_logits),
                                   atol=ATOL["float32"])
        for key in ("tm_x", "cm_x", "wkv"):
            np.testing.assert_allclose(_np(cache[key]), _np(ref_cache[key]),
                                       atol=ATOL["float32"])
    ref_next, _ = ref_step(ref_params, ref_cache, jnp.asarray(toks[:, :1]),
                           6)
    nxt, same = step(params, cache, torch.from_numpy(toks[:, :1]), 6)
    assert same is cache and nxt.dtype == torch.int32    # in place
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(ref_next))


@pytest.mark.parametrize("dtype,atol,rtol", [("float32", ATOL["float32"],
                                              0.0),
                                             ("bfloat16", 0.15, 0.05)])
def test_decode_matches_forward(dtype, atol, rtol):
    """Decode logits at position t equal the full forward's at t: mirrors
    tests/test_models_smoke.py::test_decode_matches_forward (its bf16
    tolerance), and in float32 at the slice's tolerance."""
    cfg = get_config(ARCH, smoke=True).replace(param_dtype=dtype,
                                               activ_dtype=dtype)
    params = T.init_params(cfg, torch.Generator().manual_seed(1))
    toks = torch.from_numpy(_tokens(cfg, 1, 8, seed=2))
    with torch.no_grad():
        h, _ = T.forward_hidden(params, cfg, params["embed"][toks])
        full = (h @ params["lm_head"].T).float().numpy()
        cache = T.init_cache(cfg, 1, 8)
        for t in range(8):
            logits, cache = T.decode_step(params, cfg, cache,
                                          toks[:, t:t + 1], t)
            np.testing.assert_allclose(logits.float().numpy(), full[:, t],
                                       atol=atol, rtol=rtol)


def test_prefill_into_cache_and_greedy_decode_match_reference(carried32):
    ref_cfg, cfg, ref_params, params = carried32
    toks = _tokens(cfg, 2, 20, seed=1)
    ref_logits, ref_cache = ref_serve.prefill_into_cache(
        ref_params, ref_cfg, jnp.asarray(toks), 28)
    logits, cache = serve.prefill_into_cache(params, cfg,
                                             torch.from_numpy(toks), 28)
    np.testing.assert_allclose(_np(logits), _np(ref_logits),
                               atol=ATOL["float32"])
    ref_toks, _ = ref_serve.decode(ref_params, ref_cfg, ref_cache,
                                   ref_logits, 20, 8)
    got, _ = serve.decode(params, cfg, cache, logits, 20, 8)
    np.testing.assert_array_equal(got, ref_toks)


def test_serve_demo_greedy_tokens_equal_the_reference(carried16):
    """serve_demo runs the smoke config's own dtype, bfloat16, on the
    reference's weights for seed 0 in both packages."""
    _, cfg, _, params = carried16
    want = ref_serve.serve_demo(ARCH, batch=2, prompt_len=8, new_tokens=6)
    runs = [serve.serve_demo(ARCH, batch=2, prompt_len=8, new_tokens=6,
                             device="cpu", params=params) for _ in range(2)]
    toks = runs[0]["tokens"]
    assert toks.shape == (2, 6) and toks.dtype == np.int32
    np.testing.assert_array_equal(toks, np.asarray(want["tokens"]))
    np.testing.assert_array_equal(runs[1]["tokens"], toks)


# ---------------------------------------------------------------------------
# the full config, without building it
# ---------------------------------------------------------------------------


def test_full_config_matches_reference_without_building_it():
    cfg, ref_cfg = get_config(ARCH), ref_get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert (cfg.block_type, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size) == (
                "rwkv", 32, 4096, 64, 64, 14336, 65536)
    assert cfg.param_count() == ref_cfg.param_count() == FULL_FORMULA_PARAMS
    shapes = jax.eval_shape(lambda k: ref_T.init_params(ref_cfg, k),
                            jax.random.PRNGKey(0))
    assert sum(int(np.prod(x.shape)) for x in
               jax.tree_util.tree_leaves(shapes)) == FULL_TREE_PARAMS
    for batch, seq in ((1, 2048), (4, 32_768)):
        assert cfg.kv_cache_bytes(batch, seq) == \
            ref_cfg.kv_cache_bytes(batch, seq)
    assert cfg.shapes() == ref_cfg.shapes()


@pytest.mark.parametrize("change", [
    dict(moe=MoEConfig(n_experts=4, top_k=2)), dict(mla=MLAConfig()),
    dict(frontend="vision", n_vision_tokens=4)],
    ids=["moe", "mla", "vision"])
def test_rwkv_with_unported_branches_raises(change):
    cfg = get_config(ARCH, smoke=True).replace(**change)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.init_cache(cfg, 1, 4)
