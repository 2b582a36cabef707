"""The port's Apriori driver and its mining and serving CLIs on the card,
against themselves on the CPU.

These tests need an NVIDIA card (marked ``cuda``; each skips where none is
present) and import neither jax nor the reference:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_launch_card.py

``apriori`` on the support-count kernel the cache picks and on the plain
count, ``mine`` in its single-device modes (and under ``--profile-dir``,
whose trace must hold the kernels) and ``recommend`` closed-loop and async
give the CPU's supports, rules and recommendations, launching the path's
kernels.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.itemsets import apriori  # noqa: E402
from repro_torch.data.baskets import BasketConfig, generate_baskets  # noqa: E402
from repro_torch.kernels.rule_match import fused as rm_fused  # noqa: E402
from repro_torch.kernels.rule_match import kernel as rm_kernel  # noqa: E402
from repro_torch.kernels.support_count import (fused, intersect,  # noqa: E402
                                               kernel)
from repro_torch.launch.mine import mine  # noqa: E402
from repro_torch.launch.recommend import recommend  # noqa: E402
from repro_torch.runtime import TransferMeter  # noqa: E402

WRAPPERS = {"packed": fused.support_count_packed,
            "int8": kernel.support_count_int8,
            "intersect": intersect.intersect_count_words,
            "rm_packed": rm_fused.rule_scores_packed,
            "rm_int8": rm_kernel.rule_scores_int8}
MINE = dict(n_tx=2048, n_items=200, min_support=0.02, n_tiles=8, top=0)


def _launches():
    return {k: w.launches for k, w in WRAPPERS.items()}


def _since(before):
    return {k: v - before[k] for k, v in _launches().items()}


def _answer(res):
    return res.supports, [dataclasses.astuple(r) for r in res.rules]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_apriori_on_the_card_equals_the_cpu(card):
    T = generate_baskets(BasketConfig(n_tx=4096, n_items=300, seed=1))
    want = apriori(T, 60, n_tiles=8, device="cpu")
    for use_kernel in (True, False):
        meter = TransferMeter(card)
        before = _launches()
        got = apriori(T, 60, n_tiles=8, use_kernel=use_kernel, meter=meter)
        on = _since(before)
        assert got.supports == want.supports and got.levels == want.levels
        assert meter.syncs == len(got.reports)
        counting = 8 * (len(got.reports) - 1)
        assert (on["packed"] + on["int8"]) == (counting if use_kernel else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [
    {}, {"algorithm": "eclat"}, {"algorithm": "auto"},
    {"out_of_core": True, "partition_rows": 512}, {"policy": "dynamic"}])
def test_mine_on_the_card_equals_the_cpu(card, tmp_path, mode):
    kw = dict(MINE, **mode)
    if mode.get("out_of_core"):
        kw["son_dir"] = str(tmp_path / "son")
    want = mine(device="cpu", **dict(kw, son_dir=str(tmp_path / "cpu")))
    before = _launches()
    got = mine(**kw)
    on = _since(before)
    assert _answer(got) == _answer(want)
    assert on["packed"] + on["int8"] + on["intersect"] > 0


@pytest.mark.cuda
def test_mine_profile_trace_holds_the_kernels(card, tmp_path):
    mine(profile_dir=str(tmp_path / "trace"), **MINE)
    traces = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    assert kernels and any("support_count" in e["name"] for e in kernels)
    assert any(e.get("name") == "repro_torch.mine" for e in events)


@pytest.mark.cuda
@pytest.mark.parametrize("use_async", [False, True])
def test_recommend_on_the_card_equals_the_cpu(card, use_async):
    kw = dict(n_tx=2048, n_items=64, min_support=0.03, n_queries=1000,
              smoke=True, use_async=use_async)
    want, _ = recommend(device="cpu", **kw)
    before = _launches()
    got, report = recommend(**kw)
    on = _since(before)
    assert got == want and any(got)
    assert on["rm_packed"] + on["rm_int8"] > 0
    assert np.isfinite(report.p99_latency_s)
