"""The port's LM serving path (gemma3-1b), held against the reference.

The reference's parameters, drawn by ``init_params(cfg, PRNGKey(0))`` on
gemma3-1b's smoke config, are carried into the port leaf for leaf
(``params_from_numpy``), and the same numpy-seeded tokens go through both
packages.  Modules are compared in float32 at ``atol`` 1e-5, the slice's
logits at 1e-4 in float32 and at the bf16 tolerance stated below; greedy
tokens must be equal.  Only smoke-sized configs are built here: the full
config is checked through its counts, computed from the config alone.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as ref_get_config  # noqa: E402
from repro.configs.base import list_archs as ref_list_archs  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import transformer as ref_T  # noqa: E402
import torch_lm_parity  # noqa: E402
from repro_torch.configs.base import (MLAConfig, MoEConfig,  # noqa: E402
                                     get_config, list_archs)
from repro_torch.kernels.flash_attention import kernel  # noqa: E402
from repro_torch.launch import serve, steps  # noqa: E402
from repro_torch.models import attention, layers  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

ARCH = "gemma3-1b"
ATOL = 1e-5          # modules, float32
LOGITS_ATOL = 1e-4   # the whole slice, float32
# bf16 keeps 8 significant bits: at |logit| <= 1 one step is 2**-8 = 0.0039.
# The two frameworks round to bf16 at different points through 4 layers, so
# the slice's logits may differ by a few steps; 3e-2 allows about eight.
BF16_LOGITS_ATOL = 3e-2
DTYPES = ("float32", "bfloat16")


def _cfgs(dtype):
    kw = dict(param_dtype=dtype, activ_dtype=dtype)
    return (ref_get_config(ARCH, smoke=True).replace(**kw),
            get_config(ARCH, smoke=True).replace(**kw))


def _carry(dtype):
    """(reference config, port config, reference params, port params):
    the reference's smoke weights in ``dtype`` and their copy in the
    port."""
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
    """(dtype, *carried) for each dtype."""
    name = "carried32" if request.param == "float32" else "carried16"
    return (request.param, *request.getfixturevalue(name))


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _normal(shape, seed):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _layer0(ref_params, params, key):
    return (jax.tree.map(lambda a: a[0], ref_params["layers"][key]),
            {k: v[0] for k, v in params["layers"][key].items()})


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


def test_rmsnorm_matches_reference():
    jx, x = _normal((2, 5, 64), 0)
    js, s = _normal((64,), 1)
    np.testing.assert_allclose(
        _np(layers.rmsnorm({"scale": s}, x, 1e-6)),
        _np(ref_layers.rmsnorm({"scale": js}, jx, 1e-6)), atol=ATOL)
    # bf16 in, bf16 out, float32 inside
    got = layers.rmsnorm({"scale": s}, x.bfloat16())
    assert got.dtype == torch.bfloat16


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope_matches_reference(theta):
    jx, x = _normal((2, 40, 4, 16), 2)
    pos = np.arange(40)[None, :]
    np.testing.assert_allclose(
        _np(layers.apply_rope(x, torch.from_numpy(pos), theta)),
        _np(ref_layers.apply_rope(jx, jnp.asarray(pos), theta)), atol=ATOL)


def test_mlp_matches_reference(carried32):
    _, _, ref_params, params = carried32
    jp, p = _layer0(ref_params, params, "ffn")
    jx, x = _normal((2, 7, 64), 3)
    np.testing.assert_allclose(_np(layers.mlp(p, x)),
                               _np(ref_layers.mlp(jp, jx)), atol=ATOL)


@pytest.mark.parametrize("smoke", [True, False])
def test_layer_windows_match_reference(smoke):
    got = attention.layer_windows(get_config(ARCH, smoke=smoke))
    want = ref_attn.layer_windows(ref_get_config(ARCH, smoke=smoke))
    assert got == np.asarray(want).tolist()
    assert all(type(w) is int for w in got)


@pytest.mark.parametrize("window", [0, 16])
def test_gqa_forward_and_prefill_match_reference(carried32, window):
    ref_cfg, cfg, ref_params, params = carried32
    jp, p = _layer0(ref_params, params, "attn")
    jx, x = _normal((2, 40, 64), 4)
    want = ref_attn.gqa_forward(jp, ref_cfg, jx, window)
    np.testing.assert_allclose(_np(attention.gqa_forward(p, cfg, x, window)),
                               _np(want), atol=ATOL)
    out, kv = attention.gqa_prefill(p, cfg, x, window)
    ref_out, ref_kv = ref_attn.gqa_prefill(jp, ref_cfg, jx, window)
    np.testing.assert_allclose(_np(out), _np(ref_out), atol=ATOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(kv[key]), _np(ref_kv[key]),
                                   atol=ATOL)


@pytest.mark.parametrize("impl", ["naive", "chunked"])
def test_attention_impls_agree(carried32, impl):
    ref_cfg, cfg, ref_params, params = carried32
    jp, p = _layer0(ref_params, params, "attn")
    jx, x = _normal((1, 32, 64), 5)
    kw = dict(attention_impl=impl, attention_chunk=8)
    np.testing.assert_allclose(
        _np(attention.gqa_forward(p, cfg.replace(**kw), x, 16)),
        _np(ref_attn.gqa_forward(jp, ref_cfg.replace(**kw), jx, 16)),
        atol=ATOL)


@pytest.mark.parametrize("window", [0, 4])
def test_gqa_decode_matches_reference(carried32, window):
    ref_cfg, cfg, ref_params, params = carried32
    jp, p = _layer0(ref_params, params, "attn")
    rng = np.random.default_rng(6)
    shape = (2, 12, cfg.n_kv_heads, cfg.head_dim)
    k0, v0 = (rng.standard_normal(shape).astype(np.float32)
              for _ in range(2))
    jx, x = _normal((2, 1, 64), 7)
    cache = {"k": torch.from_numpy(k0.copy()),
             "v": torch.from_numpy(v0.copy())}
    out, new = attention.gqa_decode(p, cfg, x, cache, 9, window)
    ref_out, ref_new = ref_attn.gqa_decode(
        jp, ref_cfg, jx, {"k": jnp.asarray(k0), "v": jnp.asarray(v0)}, 9,
        window)
    np.testing.assert_allclose(_np(out), _np(ref_out), atol=ATOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(new[key]), _np(ref_new[key]),
                                   atol=ATOL)
    assert new is cache            # written in place


# ---------------------------------------------------------------------------
# the slice
# ---------------------------------------------------------------------------


def test_prefill_step_matches_reference(carried):
    dtype, ref_cfg, cfg, ref_params, params = carried
    toks = _tokens(cfg, 2, 40)      # past the smoke window of 16
    want = ref_steps.make_prefill_step(ref_cfg)(
        ref_params, {"tokens": jnp.asarray(toks)})
    launches = kernel.flash_attention_fwd.launches
    got = steps.make_prefill_step(cfg)(params,
                                       {"tokens": torch.from_numpy(toks)})
    assert kernel.flash_attention_fwd.launches == launches     # CPU: plain
    assert got.shape == (2, cfg.vocab_size) and got.dtype == T.dtype_of(dtype)
    atol = LOGITS_ATOL if dtype == "float32" else BF16_LOGITS_ATOL
    np.testing.assert_allclose(_np(got), _np(want), atol=atol)


def test_prefill_into_cache_and_greedy_decode_match_reference(carried32):
    ref_cfg, cfg, ref_params, params = carried32
    toks = _tokens(cfg, 2, 20, seed=1)
    ref_logits, ref_cache = ref_serve.prefill_into_cache(
        ref_params, ref_cfg, jnp.asarray(toks), 28)
    logits, cache = serve.prefill_into_cache(params, cfg,
                                             torch.from_numpy(toks), 28)
    np.testing.assert_allclose(_np(logits), _np(ref_logits),
                               atol=LOGITS_ATOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(cache[key]), _np(ref_cache[key]),
                                   atol=ATOL)
    ref_toks, _ = ref_serve.decode(ref_params, ref_cfg, ref_cache,
                                   ref_logits, 20, 8)
    got, _ = serve.decode(params, cfg, cache, logits, 20, 8)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref_toks)


def test_decode_step_matches_reference(carried32):
    ref_cfg, cfg, ref_params, params = carried32
    toks = _tokens(cfg, 2, 1, seed=2)
    ref_cache = ref_T.init_cache(ref_cfg, 2, 8)
    ref_next, ref_cache = ref_steps.make_decode_step(ref_cfg)(
        ref_params, ref_cache, jnp.asarray(toks), 0)
    nxt, cache = steps.make_decode_step(cfg)(
        params, T.init_cache(cfg, 2, 8), torch.from_numpy(toks), 0)
    assert nxt.dtype == torch.int32
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(ref_next))
    np.testing.assert_allclose(_np(cache["k"]), _np(ref_cache["k"]),
                               atol=ATOL)


@pytest.mark.parametrize("dtype", DTYPES)
def test_init_cache_tree_matches_reference(dtype):
    ref_cfg, cfg = _cfgs(dtype)
    want = ref_T.init_cache(ref_cfg, 3, 24)
    got = T.init_cache(cfg, 3, 24)
    assert sorted(got) == sorted(want)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape
        assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype)
        assert not got[key].any()


def _tree_spec(tree):
    """{path: (shape, dtype name)} of a tree of jnp arrays or tensors."""
    if isinstance(tree, dict):
        return {f"{k}/{p}" if p else k: s for k, v in tree.items()
                for p, s in _tree_spec(v).items()}
    return {"": (tuple(tree.shape), str(tree.dtype).split(".")[-1])}


def test_init_params_tree_matches_reference():
    ref_cfg, cfg = ref_get_config(ARCH, smoke=True), \
        get_config(ARCH, smoke=True)
    want = ref_T.init_params(ref_cfg, jax.random.PRNGKey(0))
    got = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert _tree_spec(got) == _tree_spec(want)
    assert T.param_count(got) == ref_T.param_count(want)
    assert cfg.param_count() == ref_cfg.param_count()
    again = T.init_params(cfg, torch.Generator().manual_seed(0))
    assert torch.equal(again["embed"], got["embed"])     # seeded


def test_full_config_matches_reference_without_building_it():
    cfg, ref_cfg = get_config(ARCH), ref_get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert cfg.param_count() == ref_cfg.param_count() == 999_811_584
    for batch, seq in ((1, 2048), (4, 32_768)):
        assert cfg.kv_cache_bytes(batch, seq) == \
            ref_cfg.kv_cache_bytes(batch, seq)
    assert cfg.shapes() == ref_cfg.shapes()
    assert list(list_archs()) == list(ref_list_archs())
    assert len(list_archs()) == 10
    with pytest.raises(KeyError):
        get_config("llama-70b")


def test_params_from_numpy_carries_lists():
    """A MoE config's leading dense layers are a list of layer trees."""
    tree = {"dense_layers": [{"w": np.ones((2, 3), np.float32)},
                             {"w": np.zeros((2, 3), np.float32)}],
            "embed": np.arange(4, dtype=np.int32)}
    got = params_from_numpy(tree)
    assert isinstance(got["dense_layers"], list)
    assert [float(t["w"].sum()) for t in got["dense_layers"]] == [6.0, 0.0]
    assert T.param_count(got) == 16
    assert T._layer({"a": [torch.arange(6).view(3, 2)]}, 1)["a"][0].tolist() \
        == [2, 3]


def test_params_from_numpy_keeps_bf16_bits():
    a = jnp.asarray(np.random.default_rng(8).standard_normal((3, 5)),
                    jnp.bfloat16)
    got = params_from_numpy({"w": {"x": np.asarray(a)}})["w"]["x"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy(), np.asarray(a).view(np.int16))


# ---------------------------------------------------------------------------
# serve_demo and the other branches
# ---------------------------------------------------------------------------


def test_serve_demo_on_the_cpu_with_carried_weights(carried16):
    """serve_demo runs the config's own dtype, bfloat16."""
    _, cfg, _, params = carried16
    runs = [serve.serve_demo(ARCH, batch=2, prompt_len=8, new_tokens=6,
                             device="cpu", params=params) for _ in range(2)]
    toks = runs[0]["tokens"]
    assert toks.shape == (2, 6) and toks.dtype == np.int32
    assert ((toks >= 0) & (toks < cfg.vocab_size)).all()
    np.testing.assert_array_equal(runs[1]["tokens"], toks)
    # the prompts are the reference's: np.random.default_rng(seed)
    prompts = torch.from_numpy(_tokens(cfg, 2, 8).astype(np.int64))
    logits, cache = serve.prefill_into_cache(params, cfg, prompts, 14)
    want, _ = serve.decode(params, cfg, cache, logits, 8, 6)
    np.testing.assert_array_equal(toks, want)


def test_serve_demo_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default does not raise")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.serve_demo(ARCH, batch=1, prompt_len=2, new_tokens=1)


@pytest.mark.parametrize("change, match", [
    (dict(frontend="vision", n_vision_tokens=4), None),
    (dict(block_type="rwkv7"), "unknown block type 'rwkv7'"),
    (dict(moe=MoEConfig(n_experts=4, top_k=2)), None),
    (dict(mla=MLAConfig()), None),
    (dict(frontend="audio", n_codebooks=4), None)],
    ids=["vision", "rwkv", "moe", "mla", "audio"])
def test_unported_branches_raise(change, match):
    """The branches the port once refused on gemma3-1b's smoke config:
    vision, MoE, MLA and audio now run and match the reference (tree,
    prefill logits, greedy tokens); an unknown block type still raises."""
    if match is None:
        torch_lm_parity.check_branch(ARCH, **change)
        return
    cfg = get_config(ARCH, smoke=True).replace(**change)
    with pytest.raises(NotImplementedError, match=match):
        T.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match=match):
        T.init_cache(cfg, 1, 4)


def test_sequence_parallel_raises(carried32):
    _, cfg, _, params = carried32
    x = torch.zeros((1, 4, cfg.d_model))
    p = {k: v[0] for k, v in params["layers"]["attn"].items()}
    with pytest.raises(NotImplementedError, match="ROADMAP item 6.5"):
        attention.gqa_forward(p, cfg.replace(sequence_parallel=True), x, 0)
