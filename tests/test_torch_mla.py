"""The port's MLA (DeepSeek-V2 multi-head latent attention) and
deepseek-v2-236b, held against the reference.

``mla_forward`` (non-absorbed prefill, both ``attention_impl``s) and
``mla_decode`` (absorbed form over the ``c_kv``/``k_rope`` cache) run on
the reference's own weights (layer 0 of deepseek's smoke config, carried
by ``params_from_numpy``) in float32 at ``atol`` 1e-5.  MLA never reaches
the flash kernel: its q/k head size differs from its v head size, and the
reference computes it outside its Pallas kernel.  The slice, with its
leading dense layer kept as a list (``params["dense_layers"]``), follows
``tests/torch_lm_parity.py``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_lm_parity as P  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import transformer as ref_T  # noqa: E402
from repro_torch.kernels.flash_attention import kernel  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ARCH = "deepseek-v2-236b"


@functools.cache
def carried(dtype):
    return P.carry(ARCH, dtype)


def _mla_layer(c: P.Carried):
    return (jax.tree.map(lambda a: a[0], c.ref_params["layers"]["attn"]),
            T._layer(c.params["layers"]["attn"], 0))


def _normal(shape, seed):
    a = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


def test_mla_init_tree_matches_reference():
    ref_cfg, cfg = P.configs(ARCH, "bfloat16")
    want = ref_attn.mla_init(jax.random.PRNGKey(0), ref_cfg, jnp.bfloat16)
    got = attention.mla_init(torch.Generator().manual_seed(0), cfg,
                             torch.bfloat16)
    assert P.tree_spec(got) == P.tree_spec(want)


@pytest.mark.parametrize("impl,S", [("naive", 40), ("chunked", 32),
                                    ("chunked", 36)],
                         ids=["naive", "chunked", "chunked-ragged"])
def test_mla_forward_matches_reference(impl, S):
    c = carried("float32")
    kw = dict(attention_impl=impl, attention_chunk=8)
    ref_cfg, cfg = c.ref_cfg.replace(**kw), c.cfg.replace(**kw)
    jp, p = _mla_layer(c)
    jx, x = _normal((2, S, cfg.d_model), 1)
    launches = kernel.flash_attention_fwd.launches
    y, cache = attention.mla_forward(p, cfg, x, 16, return_cache=True)
    assert kernel.flash_attention_fwd.launches == launches
    want, ref_cache = ref_attn.mla_forward(jp, ref_cfg, jx, 16,
                                           return_cache=True)
    np.testing.assert_allclose(P.as_np(y), P.as_np(want), atol=P.ATOL)
    for key in ("c_kv", "k_rope"):
        np.testing.assert_allclose(P.as_np(cache[key]),
                                   P.as_np(ref_cache[key]), atol=P.ATOL)
    np.testing.assert_allclose(
        P.as_np(attention.mla_forward(p, cfg, x)), P.as_np(want),
        atol=P.ATOL)


@pytest.mark.parametrize("pos", [0, 9, 11])
def test_mla_decode_matches_reference(pos):
    c = carried("float32")
    jp, p = _mla_layer(c)
    m = c.cfg.mla
    rng = np.random.default_rng(6)
    c0 = rng.standard_normal((2, 12, m.kv_lora_rank)).astype(np.float32)
    r0 = rng.standard_normal((2, 12, m.qk_rope_head_dim)).astype(np.float32)
    jx, x = _normal((2, 1, c.cfg.d_model), 7)
    cache = {"c_kv": torch.from_numpy(c0.copy()),
             "k_rope": torch.from_numpy(r0.copy())}
    y, new = attention.mla_decode(p, c.cfg, x, cache, pos)
    want, ref_new = ref_attn.mla_decode(
        jp, c.ref_cfg, jx, {"c_kv": jnp.asarray(c0),
                            "k_rope": jnp.asarray(r0)}, pos)
    np.testing.assert_allclose(P.as_np(y), P.as_np(want), atol=P.ATOL)
    for key in ("c_kv", "k_rope"):
        np.testing.assert_allclose(P.as_np(new[key]), P.as_np(ref_new[key]),
                                   atol=P.ATOL)
    assert new is cache            # written in place


def test_mla_decode_continues_the_prefill():
    """The absorbed decode at position S-1 over the prefill's own latent
    cache gives the non-absorbed prefill's last output."""
    c = carried("float32")
    _, p = _mla_layer(c)
    _, x = _normal((2, 12, c.cfg.d_model), 8)
    y, cache = attention.mla_forward(p, c.cfg, x, return_cache=True)
    y1, _ = attention.mla_decode(p, c.cfg, x[:, -1:], dict(cache), 11)
    np.testing.assert_allclose(P.as_np(y1[:, 0]), P.as_np(y[:, -1]),
                               atol=P.ATOL)


# ---------------------------------------------------------------------------
# deepseek-v2-236b
# ---------------------------------------------------------------------------


def test_full_config_matches_reference_without_building_it():
    P.check_full_config(ARCH)
    cfg = P.get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.moe.n_experts,
            cfg.moe.top_k, cfg.moe.n_shared, cfg.moe.first_dense_layers,
            cfg.mla.kv_lora_rank) == (60, 5120, 128, 160, 6, 2, 1, 512)


def test_init_params_tree_matches_reference():
    P.check_params_tree(ARCH)
    c = carried("bfloat16")
    assert isinstance(c.params["dense_layers"], list)
    assert "ffn" in c.params["dense_layers"][0]
    assert "moe" in c.params["layers"]
    assert T.param_count(c.params) == ref_T.param_count(c.ref_params)


@pytest.mark.parametrize("dtype", P.DTYPES)
def test_init_cache_tree_matches_reference(dtype):
    P.check_cache_tree(ARCH, dtype)


@pytest.mark.parametrize("dtype", P.DTYPES)
def test_prefill_step_matches_reference(dtype):
    launches = kernel.flash_attention_fwd.launches
    P.check_prefill(carried(dtype), dtype)
    assert kernel.flash_attention_fwd.launches == launches


def test_decode_steps_match_reference():
    P.check_decode_step(carried("float32"))


def test_prefill_into_cache_and_greedy_decode_match_reference():
    P.check_greedy_tokens(carried("float32"))


def test_serve_demo_greedy_tokens_equal_the_reference():
    P.check_serve_demo(ARCH, carried("bfloat16").params)
