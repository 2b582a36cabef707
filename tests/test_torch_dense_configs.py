"""The port's three dense GQA configs (granite-3-8b, minitron-8b,
mistral-nemo-12b), held against the reference.

Each is a plain ``attn`` block; the smoke configs (2 layers, d 64, 4/2
heads of 16) carry the reference's weights into the port
(``tests/torch_lm_parity.py`` states the tolerances).  The full configs,
head size 128 and GQA 32/8, are checked from their fields and counts
alone: they are 8-12e9 parameters.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import torch_lm_parity as P  # noqa: E402
from repro_torch.kernels.flash_attention import kernel  # noqa: E402

ARCHS = ("granite-3-8b", "minitron-8b", "mistral-nemo-12b")


@functools.cache
def carried(arch, dtype):
    return P.carry(arch, dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_matches_reference_without_building_it(arch):
    P.check_full_config(arch)
    cfg = P.get_config(arch)
    assert (cfg.block_type, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads,
            cfg.frontend, cfg.moe, cfg.mla) == ("attn", 128, 32, 8, None,
                                                None, None)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_reference(arch):
    P.check_params_tree(arch)


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
