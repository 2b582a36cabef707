"""Association-rule generation (paper §V step 3).

Map phase: prune candidate itemsets by minimum confidence and emit rules;
reduce phase: collect.  Host-side enumeration is the (small) control plane;
all supports were computed on-device in step 2.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Tuple

from repro_torch.core.itemsets import AprioriResult


@dataclass(frozen=True)
class Rule:
    antecedent: Tuple[int, ...]
    consequent: Tuple[int, ...]
    support: float          # supp(A ∪ B) / n_tx
    confidence: float       # supp(A ∪ B) / supp(A)
    lift: float             # confidence / (supp(B) / n_tx)

    def __str__(self):
        a = ",".join(map(str, self.antecedent))
        b = ",".join(map(str, self.consequent))
        return (f"{{{a}}} => {{{b}}}  supp={self.support:.4f} "
                f"conf={self.confidence:.3f} lift={self.lift:.2f}")


def generate_rules(result: AprioriResult, min_confidence: float,
                   min_lift: float = 0.0) -> List[Rule]:
    rules: List[Rule] = []
    supports = result.supports
    n = float(result.n_tx)
    for itemset, supp in supports.items():
        if len(itemset) < 2:
            continue
        for r in range(1, len(itemset)):
            for ante in itertools.combinations(itemset, r):
                sa = supports.get(tuple(sorted(ante)))
                if not sa:
                    continue
                conf = supp / sa
                if conf < min_confidence:
                    continue
                cons = tuple(sorted(set(itemset) - set(ante)))
                sb = supports.get(cons)
                if sb is None:
                    continue
                lift = conf / (sb / n)
                if lift >= min_lift:
                    rules.append(Rule(tuple(sorted(ante)), cons,
                                      supp / n, conf, lift))
    # total order: (confidence, support) ties are common (many perfect-
    # confidence rules), and supports-dict insertion order would otherwise
    # leak into the result — the serving index build relies on this being
    # reproducible across processes
    rules.sort(key=lambda r: (-r.confidence, -r.support, -r.lift,
                              r.antecedent, r.consequent))
    return rules
