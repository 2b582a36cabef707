"""Hypothesis property: the port's incremental mining equals the
reference's, and both equal batch mining.

Mirrors ``tests/test_streaming_props.py`` with its strategy, example
counts and deadline: for random basket streams, window sizes and
micro-batch sizes, the port's ``StreamingMiner`` (``device="cpu"``) after
K micro-batches must hold the reference miner's supports, rules, tracked
supports, batch reports (walls aside) and ledger, and its supports and
rules must equal the port's one-shot ``MarketBasketPipeline`` over the
same window — under ``static`` and ``dynamic``."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("hypothesis")  # optional dev dep; module skips cleanly without it
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.streaming import StreamingConfig as RefConfig  # noqa: E402
from repro.streaming import StreamingMiner as RefMiner  # noqa: E402
from repro.streaming import TransactionStream as RefStream  # noqa: E402
from repro_torch.pipeline import MarketBasketPipeline  # noqa: E402
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


@st.composite
def stream_cases(draw):
    n_items = draw(st.integers(4, 12))
    n_tx = draw(st.integers(1, 48))
    window = draw(st.integers(1, 24))
    batch = draw(st.integers(1, 16))
    density = draw(st.floats(0.1, 0.6))
    seed = draw(st.integers(0, 2 ** 16))
    rng = np.random.default_rng(seed)
    T = (rng.random((n_tx, n_items)) < density).astype(np.uint8)
    min_support = draw(st.sampled_from([0.1, 0.25, 0.5]))
    min_conf = draw(st.sampled_from([0.3, 0.6]))
    return T, window, batch, min_support, min_conf


def _check(case, policy="static"):
    T, window, batch, min_support, min_conf = case
    kw = dict(window=window, batch_size=batch, min_support=min_support,
              min_confidence=min_conf, n_tiles=2, data_plane="ref",
              power="none", policy=policy)
    ref = RefMiner(T.shape[1], config=RefConfig(**kw))
    miner = StreamingMiner(T.shape[1],
                           config=StreamingConfig(device="cpu", **kw))
    ref_report = ref.run(RefStream(T, batch))
    report = miner.run(TransactionStream(T, batch))
    assert _plain(report) == _plain(ref_report)
    assert miner.supports == ref.supports
    assert [dataclasses.astuple(r) for r in miner.rules] == \
        [dataclasses.astuple(r) for r in ref.rules]
    assert miner._tracked == ref._tracked
    np.testing.assert_array_equal(miner._tracked_supp, ref._tracked_supp)
    rows = miner.window.rows_raw()
    assert rows.tobytes() == ref.window.rows_raw().tobytes()
    assert miner.window.n == min(T.shape[0], window)
    pipe = MarketBasketPipeline(config=miner.config.pipeline_config()).run(
        rows)
    assert miner.supports == pipe.supports
    assert miner.rules == pipe.rules


@settings(max_examples=25, deadline=None)
@given(stream_cases())
def test_incremental_equals_reference_and_batch_mining(case):
    _check(case)


@settings(max_examples=10, deadline=None)
@given(stream_cases(), st.sampled_from(["static", "dynamic"]))
def test_parity_is_policy_independent(case, policy):
    """Scheduling must never change what gets mined, only when/where."""
    _check(case, policy)
