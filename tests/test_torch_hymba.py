"""The port's hymba-1.5b serving path (the hybrid attention + Mamba block),
held against the reference.

The reference's parameters, drawn by ``init_params(cfg, PRNGKey(0))`` on
hymba-1.5b's smoke config, are carried into the port leaf for leaf
(``params_from_numpy``), and the same numpy-seeded inputs go through both
packages.  In float32, modules are compared at ``atol`` 1e-5 and anything
that runs the SSM scan at 1e-4 (the scan kernel's tolerance in
``tests/test_kernels.py``: the reference's associative and chunked forms
sum in another order than the sequential one); the slice's logits at 1e-4,
in bf16 at the tolerance stated below; greedy tokens must be equal.  Only
smoke-sized configs are built here: the full config is checked through
its fields and counts alone.
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
from repro.models import ssm as ref_ssm  # noqa: E402
from repro.models import transformer as ref_T  # noqa: E402
from repro_torch.configs.base import (MLAConfig, MoEConfig,  # noqa: E402
                                     get_config)
from repro_torch.kernels.flash_attention import kernel as flash  # noqa: E402
from repro_torch.kernels.selective_scan import kernel as scan  # noqa: E402
from repro_torch.launch import serve, steps  # noqa: E402
from repro_torch.models import attention, ssm  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

ARCH = "hymba-1.5b"
ATOL = 1e-5          # modules without the scan, float32
SCAN_ATOL = 1e-4     # modules with the scan, and the slice's logits
# bf16 keeps 8 significant bits: at |logit| <= 1 one step is 2**-8 =
# 0.0039.  The two frameworks round to bf16 at different points through
# 2 layers of two branches each, so the logits may differ by a few steps;
# 3e-2 allows about eight (as for gemma3-1b in test_torch_lm.py).
BF16_LOGITS_ATOL = 3e-2
DTYPES = ("float32", "bfloat16")
# the reference's parameter tree at full width, counted by
# jax.eval_shape(init_params): cfg.param_count()'s formula leaves out
# x_proj, dt_proj, dt_bias and the two fuse norms
FULL_TREE_PARAMS = 1_662_161_600
FULL_FORMULA_PARAMS = 1_639_836_800


def _cfgs(dtype):
    kw = dict(param_dtype=dtype, activ_dtype=dtype)
    return (ref_get_config(ARCH, smoke=True).replace(**kw),
            get_config(ARCH, smoke=True).replace(**kw))


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


def _normal(shape, seed, scale=1.0):
    a = (np.random.default_rng(seed).standard_normal(shape) * scale
         ).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


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


# ---------------------------------------------------------------------------
# the SSM branch and the hybrid block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["no-state", "state"])
@pytest.mark.parametrize("impl", ssm.SSM_IMPLS)
def test_ssm_forward_matches_reference(carried32, impl, with_state):
    """S = 256 so that the reference's chunked form runs its chunks."""
    ref_cfg, cfg, ref_params, params = carried32
    jp, p = _layer0(ref_params, params, "ssm")
    ref_cfg, cfg = (c.replace(ssm_impl=impl) for c in (ref_cfg, cfg))
    di = cfg.ssm.expand * cfg.d_model
    jx, x = _normal((2, 256, cfg.d_model), 1)
    jst = st = None
    if with_state:
        (jh, h), (jc, c) = (_normal((2, di, cfg.ssm.d_state), 2, 0.5),
                            _normal((2, cfg.ssm.d_conv - 1, di), 3))
        jst, st = {"h": jh, "conv": jc}, {"h": h, "conv": c}
    launches = scan.selective_scan_fwd.launches
    y, new = ssm.ssm_forward(p, cfg, x, st)
    assert scan.selective_scan_fwd.launches == launches      # CPU: plain
    want, ref_new = ref_ssm.ssm_forward(jp, ref_cfg, jx, jst)
    np.testing.assert_allclose(_np(y), _np(want), atol=SCAN_ATOL)
    for key in ("h", "conv"):
        assert tuple(new[key].shape) == ref_new[key].shape
        np.testing.assert_allclose(_np(new[key]), _np(ref_new[key]),
                                   atol=SCAN_ATOL)


def test_ssm_one_token_step_matches_reference(carried32):
    ref_cfg, cfg, ref_params, params = carried32
    jp, p = _layer0(ref_params, params, "ssm")
    di = cfg.ssm.expand * cfg.d_model
    jx, x = _normal((2, 1, cfg.d_model), 4)
    (jh, h), (jc, c) = (_normal((2, di, cfg.ssm.d_state), 5, 0.5),
                        _normal((2, cfg.ssm.d_conv - 1, di), 6))
    y, new = ssm.ssm_forward(p, cfg, x, {"h": h, "conv": c})
    want, ref_new = ref_ssm.ssm_forward(jp, ref_cfg, jx,
                                        {"h": jh, "conv": jc})
    np.testing.assert_allclose(_np(y), _np(want), atol=ATOL)
    for key in ("h", "conv"):
        np.testing.assert_allclose(_np(new[key]), _np(ref_new[key]),
                                   atol=ATOL)


def test_ssm_init_matches_reference_tree():
    ref_cfg, cfg = _cfgs("bfloat16")
    want = ref_ssm.ssm_init(jax.random.PRNGKey(0), ref_cfg, jnp.bfloat16)
    got = ssm.ssm_init(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    assert _tree_spec(got) == _tree_spec(want)
    for key in ("A_log", "D", "dt_bias"):     # deterministic leaves
        np.testing.assert_array_equal(_np(got[key]), _np(want[key]))


@pytest.mark.parametrize("window", [0, 16])
def test_block_full_matches_reference(carried32, window):
    ref_cfg, cfg, ref_params, params = carried32
    jp, p = _layer0(ref_params, params)
    jx, x = _normal((2, 40, cfg.d_model), 7)
    got, aux = T._block_full(cfg, p, x, window)
    want, _ = ref_T._block_full(ref_cfg, jp, jx, window)
    assert aux == 0.0
    np.testing.assert_allclose(_np(got), _np(want), atol=SCAN_ATOL)


# ---------------------------------------------------------------------------
# the slice
# ---------------------------------------------------------------------------


def test_prefill_step_matches_reference(carried):
    dtype, ref_cfg, cfg, ref_params, params = carried
    toks = _tokens(cfg, 2, 40)      # past the smoke window of 16
    want = ref_steps.make_prefill_step(ref_cfg)(
        ref_params, {"tokens": jnp.asarray(toks)})
    before = (flash.flash_attention_fwd.launches,
              scan.selective_scan_fwd.launches)
    got = steps.make_prefill_step(cfg)(params,
                                       {"tokens": torch.from_numpy(toks)})
    assert (flash.flash_attention_fwd.launches,
            scan.selective_scan_fwd.launches) == before      # CPU: plain
    assert got.shape == (2, cfg.vocab_size) and got.dtype == T.dtype_of(dtype)
    atol = SCAN_ATOL if dtype == "float32" else BF16_LOGITS_ATOL
    np.testing.assert_allclose(_np(got), _np(want), atol=atol)


def test_params_from_numpy_carries_every_hybrid_leaf(carried):
    """The carried tree has the reference's paths, shapes and dtypes, and
    every value arrives bit for bit (bf16 through the int16 view)."""
    _, _, _, ref_params, params = carried
    assert _tree_spec(params) == _tree_spec(ref_params)
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
    assert sorted(got) == ["conv", "h", "k", "v"]
    assert _tree_spec(got) == _tree_spec(want)
    assert not any(v.any() for v in got.values())
    # each layer's state is its own memory, written in place by decode
    assert all(v.is_contiguous() for v in got.values())


def test_init_params_tree_matches_reference():
    ref_cfg, cfg = _cfgs("bfloat16")
    want = ref_T.init_params(ref_cfg, jax.random.PRNGKey(0))
    got = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert _tree_spec(got) == _tree_spec(want)
    assert T.param_count(got) == ref_T.param_count(want)
    assert cfg.param_count() == ref_cfg.param_count()
    again = T.init_params(cfg, torch.Generator().manual_seed(0))
    assert torch.equal(again["layers"]["ssm"]["in_proj"],
                       got["layers"]["ssm"]["in_proj"])          # seeded


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
                                   atol=SCAN_ATOL)
    for key in ("k", "v", "h", "conv"):
        np.testing.assert_allclose(_np(cache[key]), _np(ref_cache[key]),
                                   atol=SCAN_ATOL)
    ref_next, _ = ref_step(ref_params, ref_cache, jnp.asarray(toks[:, :1]),
                           6)
    nxt, same = step(params, cache, torch.from_numpy(toks[:, :1]), 6)
    assert same is cache and nxt.dtype == torch.int32    # in place
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(ref_next))


@pytest.mark.parametrize("dtype,atol,rtol", [("float32", SCAN_ATOL, 0.0),
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
    np.testing.assert_allclose(_np(logits), _np(ref_logits), atol=SCAN_ATOL)
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
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size) == (
                32, 1600, 25, 5, 64, 5504, 32001)
    assert [i for i, w in enumerate(attention.layer_windows(cfg))
            if w == 0] == [15, 31]
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
def test_hybrid_with_unported_branches_raises(change):
    cfg = get_config(ARCH, smoke=True).replace(**change)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.init_cache(cfg, 1, 4)
