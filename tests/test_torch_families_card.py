"""The LM families on the card: the three dense GQA configs, dbrx-132b
(MoE), deepseek-v2-236b (MLA + MoE), internvl2-26b (vision) and
musicgen-large (audio), at their smoke sizes.

These tests need an NVIDIA card (marked ``cuda``; each skips where none is
present) and import neither jax nor the reference:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_families_card.py

Weights are drawn from a seed on the CPU and copied to the card, so both
devices run the same model.  In float32 the card's prefill (the flash
kernel on every GQA layer, plain MLA and MoE) holds the CPU's plain
prefill at ``atol`` 1e-4; repeated runs on the card are bitwise equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import kernel  # noqa: E402
from repro_torch.launch import serve, steps  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ARCHS = ("granite-3-8b", "minitron-8b", "mistral-nemo-12b", "dbrx-132b",
         "deepseek-v2-236b", "internvl2-26b", "musicgen-large")
ATOL = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def _batch(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S)))}
    if cfg.frontend == "vision":
        batch["vision_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32))
    if cfg.frontend == "audio":
        batch = {"frames": torch.from_numpy(rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32))}
    return batch


def _gqa_layers(cfg):
    return 0 if cfg.mla is not None else cfg.n_layers


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_on_the_card_matches_the_cpu(card, arch):
    cfg = get_config(arch, smoke=True).replace(param_dtype="float32",
                                               activ_dtype="float32")
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = _batch(cfg, 2, 40)
    want = steps.make_prefill_step(cfg)(params, batch)
    kernel.zero_launches()
    got = steps.make_prefill_step(cfg)(_to(params, card), _to(batch, card))
    torch.cuda.synchronize()
    assert kernel.flash_attention_fwd.launches == _gqa_layers(cfg)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_demo_on_the_card_repeats(card, arch):
    cfg = get_config(arch, smoke=True)
    runs = []
    for _ in range(2):
        kernel.zero_launches()
        runs.append(serve.serve_demo(arch, batch=2, prompt_len=8,
                                     new_tokens=6, device="cuda")["tokens"])
        assert kernel.flash_attention_fwd.launches == 0    # plain decode
    want = (2, 6, cfg.n_codebooks) if cfg.frontend == "audio" else (2, 6)
    assert runs[0].shape == want
    assert ((runs[0] >= 0) & (runs[0] < cfg.vocab_size)).all()
    np.testing.assert_array_equal(runs[0], runs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("arch,S", [("dbrx-132b", 512),
                                    ("deepseek-v2-236b", 512)])
def test_moe_forward_on_the_card_is_deterministic(card, arch, S):
    """The combine sums each token's slots in a fixed order: two bf16 runs
    give the same bits, with slots dropped past capacity."""
    cfg = get_config(arch, smoke=True)
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))
    gen = torch.Generator(device=card).manual_seed(0)
    p = moe.moe_init(gen, cfg, torch.bfloat16)
    x = torch.randn((4, S, cfg.d_model), generator=gen, device=card).to(
        torch.bfloat16)
    y1, aux1 = moe.moe_forward(p, cfg, x)
    y2, aux2 = moe.moe_forward(p, cfg, x)
    assert int(moe.route(p, cfg, x).dropped) > 0
    assert torch.equal(y1, y2) and torch.equal(aux1, aux2)
    want, _ = moe.moe_forward(_to(p, "cpu"), cfg, x.cpu())
    np.testing.assert_allclose(y1.float().cpu().numpy(),
                               want.float().numpy(), atol=3e-2)
