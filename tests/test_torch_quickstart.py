"""The port's quickstart prints what the reference's objects hold.

``examples/quickstart_torch.py --device cpu`` runs in a subprocess; its
printed rules and recommendations must equal those of the reference
pipeline and engine built as ``examples/quickstart.py`` builds them.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core.hetero import HeterogeneityProfile  # noqa: E402
from repro.data.baskets import BasketConfig, generate_baskets  # noqa: E402
from repro.pipeline import MarketBasketPipeline, PipelineConfig  # noqa: E402
from repro.serving import (Query, RecommendationEngine,  # noqa: E402
                           RuleIndex, ServingConfig)

ROOT = Path(__file__).resolve().parents[1]


def test_quickstart_prints_the_reference_rules_and_recommendations():
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "quickstart_torch.py"),
         "--device", "cpu"], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()

    T = generate_baskets(BasketConfig(n_tx=4096, n_items=96, seed=42))
    profile = HeterogeneityProfile.paper()
    best = MarketBasketPipeline(profile, PipelineConfig(
        min_support=80, min_confidence=0.65, n_tiles=32, split="lpt",
        data_plane="ref")).run(T)
    engine = RecommendationEngine(RuleIndex.build(best.rules, T.shape[1]),
                                  profile, ServingConfig(data_plane="ref"))
    recs, _ = engine.serve([Query.of(row) for row in T[:64]])

    def block(header):
        i = next(j for j, line in enumerate(lines) if line.startswith(header))
        return lines[i + 1:i + 9]

    assert block("top rules") == ["   " + str(r) for r in best.rules[:8]]
    assert block("recommendations for the first 8") == [
        f"   {np.flatnonzero(row).tolist()} -> {rec}"
        for row, rec in zip(T[:8], recs)]
    assert any(recs[:8])
    assert f"top rules (of {len(best.rules)}):" in lines
