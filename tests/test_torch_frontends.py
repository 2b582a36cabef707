"""The port's modality-frontend stubs and the two configs that use them,
internvl2-26b (vision) and musicgen-large (audio), held against the
reference.

The stubs run on the reference's own frontend weights (carried by
``params_from_numpy``) in float32 at ``atol`` 1e-5.  A vision prefill
reads ``vision_embeds`` [B, n_vision_tokens, d] beside the tokens; an
audio prefill reads ``frames`` [B, S, d] and gives [B, K, V] codebook
logits, and an audio decode step takes [B, 1, K] tokens.  The slices
follow ``tests/torch_lm_parity.py``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_lm_parity as P  # noqa: E402
from repro.models import stubs as ref_stubs  # noqa: E402
from repro_torch.kernels.flash_attention import kernel  # noqa: E402
from repro_torch.models import stubs  # noqa: E402

VISION, AUDIO = "internvl2-26b", "musicgen-large"
ARCHS = (VISION, AUDIO)


@functools.cache
def carried(arch, dtype):
    return P.carry(arch, dtype)


def _normal(shape, seed):
    a = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


# ---------------------------------------------------------------------------
# the stubs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_stub_init_trees_match_reference(arch):
    ref_cfg, cfg = P.configs(arch, "bfloat16")
    gen = torch.Generator().manual_seed(0)
    if arch == AUDIO:
        want = ref_stubs.audio_head_init(jax.random.PRNGKey(0), ref_cfg,
                                         jnp.bfloat16)
        got = stubs.audio_head_init(gen, cfg, torch.bfloat16)
    else:
        want = ref_stubs.vision_proj_init(jax.random.PRNGKey(0), ref_cfg,
                                          jnp.bfloat16)
        got = stubs.vision_proj_init(gen, cfg, torch.bfloat16)
    assert P.tree_spec(got) == P.tree_spec(want)


def test_audio_embed_and_logits_match_reference():
    c = carried(AUDIO, "float32")
    jp, p = c.ref_params["audio"], c.params["audio"]
    K, V = c.cfg.n_codebooks, c.cfg.vocab_size
    toks = np.random.default_rng(1).integers(0, V, (2, 5, K)).astype(
        np.int32)
    np.testing.assert_allclose(
        P.as_np(stubs.audio_embed_tokens(p, torch.from_numpy(toks))),
        P.as_np(ref_stubs.audio_embed_tokens(jp, jnp.asarray(toks))),
        atol=P.ATOL)
    jh, h = _normal((2, 5, c.cfg.d_model), 2)
    got = stubs.audio_logits(p, h)
    assert tuple(got.shape) == (2, 5, K, V)
    np.testing.assert_allclose(P.as_np(got),
                               P.as_np(ref_stubs.audio_logits(jp, jh)),
                               atol=P.ATOL)


def test_vision_prepend_matches_reference():
    c = carried(VISION, "float32")
    jp, p = c.ref_params["vision"], c.params["vision"]
    d, nv = c.cfg.d_model, c.cfg.n_vision_tokens
    jv, v = _normal((2, nv, d), 3)
    jt, t = _normal((2, 6, d), 4)
    got = stubs.vision_prepend(p, v, t)
    assert tuple(got.shape) == (2, nv + 6, d)
    np.testing.assert_allclose(
        P.as_np(got), P.as_np(ref_stubs.vision_prepend(jp, jv, jt)),
        atol=P.ATOL)


# ---------------------------------------------------------------------------
# internvl2-26b and musicgen-large
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_matches_reference_without_building_it(arch):
    P.check_full_config(arch)
    cfg = P.get_config(arch)
    want = ((48, 6144, 48, 8, 128, "vision", 256, 0) if arch == VISION
            else (48, 2048, 32, 32, 64, "audio", 0, 4))
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.frontend, cfg.n_vision_tokens,
            cfg.n_codebooks) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_reference(arch):
    P.check_params_tree(arch)
    params = carried(arch, "bfloat16").params
    assert ("lm_head" in params) == (arch == VISION)
    assert (arch == AUDIO) == ("audio" in params)


@pytest.mark.parametrize("dtype", P.DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_tree_matches_reference(arch, dtype):
    P.check_cache_tree(arch, dtype)


@pytest.mark.parametrize("dtype", P.DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_matches_reference(arch, dtype):
    launches = kernel.flash_attention_fwd.launches
    P.check_prefill(carried(arch, dtype), dtype)
    assert kernel.flash_attention_fwd.launches == launches     # CPU: plain


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch):
    P.check_decode_step(carried(arch, "float32"))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_into_cache_and_greedy_decode_match_reference(arch):
    P.check_greedy_tokens(carried(arch, "float32"))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_demo_greedy_tokens_equal_the_reference(arch):
    P.check_serve_demo(arch, carried(arch, "bfloat16").params)


def test_audio_serve_demo_decodes_every_codebook():
    c = carried(AUDIO, "bfloat16")
    out = P.serve.serve_demo(AUDIO, batch=2, prompt_len=4, new_tokens=3,
                             device="cpu", params=c.params)
    toks = out["tokens"]
    assert toks.shape == (2, 3, c.cfg.n_codebooks) and toks.dtype == np.int32
    assert ((toks >= 0) & (toks < c.cfg.vocab_size)).all()
