"""The port's flash-attention kernel on the card, against its plain version.

These tests need an NVIDIA card (marked ``cuda``; each skips where none is
present) and import neither jax nor the reference, so they run on a
machine with PyTorch for CUDA alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_flash_attention_card.py

Inputs are drawn with numpy from a seed and cast to bfloat16, the models'
type; the tolerance is ``tests/test_kernels.py``'s 2e-2 + 2e-2·|plain|.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import kernel  # noqa: E402

TOL = 2e-2             # tests/test_kernels.py:61, bfloat16


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


# the models' prefill layouts at one batch row, and ragged lengths across
# a 128-row query tile, all in bf16
CARD_CASES = ([(2048, 4, 1, 256, w) for w in (0, 512)]
              + [(2048, 25, 5, 64, w) for w in (0, 1024)]
              + [(S, 4, 1, hd, 0) for S in (1, 129, 1000) for hd in (64, 256)])


@pytest.mark.cuda
@pytest.mark.parametrize("S,H,KV,hd,win", CARD_CASES)
def test_hopper_kernel_matches_plain_version_on_the_card(card, S, H, KV, hd,
                                                         win):
    rng = np.random.default_rng(S + hd + win)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32))
               .to(card, torch.bfloat16)
               for shape in ((1, S, H, hd), (1, S, KV, hd), (1, S, KV, hd)))
    launches = dict(kernel.flash_attention_fwd.launches_by_route)
    got = kernel.flash_attention_fwd(q, k, v, window=win)
    want = kernel.flash_attention_plain(q, k, v, window=win)
    torch.cuda.synchronize()
    launches["hopper"] += 1
    assert kernel.flash_attention_fwd.launches_by_route == launches
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(),
                               atol=TOL, rtol=TOL)
