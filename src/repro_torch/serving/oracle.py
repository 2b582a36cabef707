"""Brute-force recommendation oracle — plain Python over the raw rule list.

Implements the serving semantics (see
``repro_torch.kernels.rule_match.ref``) with no index, no kernel and no
batching, so the engine's batched data-plane output can be pinned to it
*exactly* (confidences are compared in float32, matching what the compiled
index stores).  Used by ``tests/test_torch_serving.py`` and
``chip_smoke.py``.
"""
from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np

from repro_torch.core.rules import Rule


def recommend_bruteforce(rules: Sequence[Rule], basket: Iterable[int],
                         k: int) -> List[Tuple[int, float]]:
    """Top-k (item, score) for one basket given as an item-id collection.

    score(j) = max confidence (as f32) over rules with antecedent ⊆ basket
    and j in the consequent; items already in the basket are excluded;
    ranking is (score desc, item id asc); only score > 0 entries returned.
    """
    basket_set = set(int(i) for i in basket)
    scores = {}
    for rule in rules:
        if not set(rule.antecedent) <= basket_set:
            continue
        c = float(np.float32(rule.confidence))
        for item in rule.consequent:
            if item in basket_set:
                continue
            if scores.get(item, 0.0) < c:
                scores[item] = c
    ranked = sorted(scores.items(), key=lambda kv: (-kv[1], kv[0]))
    return [(int(i), float(s)) for i, s in ranked[:k] if s > 0.0]
