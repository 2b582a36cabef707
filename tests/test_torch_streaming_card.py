"""The port's streaming plane on the card, against itself on the CPU.

These tests need an NVIDIA card (marked ``cuda``; each skips where none is
present) and import neither jax nor the reference:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_streaming_card.py

A Zipf-noise stream (re-validating batch after batch) followed by a
stationary one (the delta path alone) goes through ``StreamingMiner`` on
the card's packed and int8 support-count kernels and through the plain
counts on the CPU: supports, rules, tracked supports, the rule index and
every report and ledger field but the host walls must be equal, and the
path's kernel must have launched.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.data.baskets import (BasketConfig,  # noqa: E402
                                      generate_baskets, stationary_baskets)
from repro_torch.kernels.support_count import fused, kernel  # noqa: E402
from repro_torch.streaming import (StreamingConfig,  # noqa: E402
                                   StreamingMiner, TransactionStream)

WALLS = ("host_time_s", "wall_time_s", "wall_s", "refresh_latency_s")


def _plain(x):
    if dataclasses.is_dataclass(x):
        x = {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items() if k not in WALLS}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.generic):
        return x.item()
    return x


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["packed", "mxu"])
def test_stream_on_the_card_equals_the_cpu(card, variant):
    n_items = 200
    T = np.vstack([generate_baskets(BasketConfig(n_tx=1024, n_items=n_items,
                                                 seed=0)),
                   stationary_baskets(1024, n_items, seed=1)])
    kw = dict(window=512, batch_size=64, min_support=0.05, n_tiles=4)
    tuning = {"variant": variant}
    wrapper = {"packed": fused.support_count_packed,
               "mxu": kernel.support_count_int8}[variant]
    cpu = StreamingMiner(n_items, config=StreamingConfig(device="cpu", **kw))
    gpu = StreamingMiner(n_items, config=StreamingConfig(
        device="cuda", tuning=tuning, **kw))
    launches = wrapper.launches
    for batch in TransactionStream(T, kw["batch_size"]):
        cpu.process_batch(batch)
        gpu.process_batch(batch)
        assert gpu.supports == cpu.supports
        np.testing.assert_array_equal(gpu._tracked_supp, cpu._tracked_supp)
    want, got = cpu.run([]), gpu.run([])
    assert wrapper.launches > launches
    assert gpu.rules == cpu.rules and gpu.index.same_arrays(cpu.index)
    assert (got.backend, want.backend) == ("cuda", "ref")
    assert dict(_plain(got), backend="ref") == _plain(want)
    assert got.n_revalidations and not got.batches[-1].revalidated
