"""The autotune sweep on the card: the smoke lattice of all three tunable
kernels, measured with CUDA events and held exactly against the plain
oracle, into a scratch cache that the ops resolver then serves.

These tests need an NVIDIA card (marked ``cuda``; each skips where none is
present) and import neither jax nor the reference, so they run on a
machine with PyTorch for CUDA alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_autotune_card.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.autotune.cache import (  # noqa: E402
    AutotuneCache, default_cache, device_kind, resolve_config)
from repro_torch.kernels.autotune.tuner import standard_shapes  # noqa: E402
from repro_torch.launch.autotune import autotune  # noqa: E402
from repro_torch.launch.tuning import TUNABLE_KERNELS, VARIANTS  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def test_smoke_sweep_on_the_card(card, tmp_path):
    path = str(tmp_path / "tune.json")
    cache = autotune(out=path, smoke=True, reps=5, device="cuda",
                     log=lambda line: None)
    kind = device_kind(card)
    assert kind == torch.cuda.get_device_name(0).replace(" ", "_")
    assert AutotuneCache.load(path).entries == cache.entries
    for kernel in TUNABLE_KERNELS:
        (shape,) = standard_shapes(kernel, smoke=True)
        key = cache.key(kernel, shape, card)
        assert key.endswith(f"|{kind}")
        ent = cache.entries[key]
        assert ent["cost_us"] > 0 and ent["source"] == "measured"
        assert all(s["matched"] for s in ent["swept"])
        assert {s["config"]["variant"] for s in ent["swept"]} == \
            set(VARIANTS[kernel])
        assert resolve_config(kernel, shape, cache, card) == ent["config"]
        assert resolve_config(kernel, shape, cache, "cpu") == \
            {"variant": "packed"}            # no cpu entries: the default


def test_checked_in_cache_dispatches_on_this_card(card):
    """Where the checked-in cache was swept on this kind of card, the
    default resolver serves its winner at every lattice shape."""
    cache = default_cache(reload=True)
    if not cache.has_kernel("support_count", card):
        pytest.skip(f"the checked-in cache holds no entries for "
                    f"{device_kind(card)}")
    for kernel in TUNABLE_KERNELS:
        for shape in standard_shapes(kernel):
            want = cache.lookup(kernel, shape, card)["config"]
            assert resolve_config(kernel, shape, None, card) == want
