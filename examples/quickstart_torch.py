"""Quickstart on the PyTorch/CUDA port: the paper end-to-end, then serving.

The same composition as ``examples/quickstart.py``, through
``repro_torch``: basket ingestion → bitmap packing → MapReduce Apriori
rounds under the MB Scheduler on the paper's heterogeneous 80/120/200/400
four-core system (support counting in the ``support_count`` CUDA kernel) →
association rules → a compiled rule index served in scheduled batches
(rule matching in the ``rule_match`` CUDA kernel).  The LPT policy is
compared against a naive Hadoop-style equal split.

  PYTHONPATH=src python examples/quickstart_torch.py              # the card
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.core.hetero import HeterogeneityProfile
from repro_torch.data.baskets import BasketConfig, generate_baskets
from repro_torch.pipeline import MarketBasketPipeline, PipelineConfig
from repro_torch.serving import (Query, RecommendationEngine, RuleIndex,
                                 ServingConfig)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where counting and scoring run (default: cuda)")
    args = ap.parse_args()

    # 1. transactional data (IBM-Quest-style synthetic store data)
    T = generate_baskets(BasketConfig(n_tx=4096, n_items=96, seed=42))

    # 2. the full pipeline on the paper's system, per split strategy
    profile = HeterogeneityProfile.paper()        # 80 / 120 / 200 / 400
    results = {}
    for split in ("equal", "proportional", "lpt"):
        pipe = MarketBasketPipeline(
            profile,
            PipelineConfig(min_support=80, min_confidence=0.65, n_tiles=32,
                           split=split, device=args.device))
        results[split] = pipe.run(T)

    # 3. the structured report for the MB Scheduler (LPT) run
    best = results["lpt"]
    print(best.report.summary())

    # map phases only: the serial phases are identical under every policy,
    # so this is the ratio the paper's analytic bound speaks about
    speedup = (results["equal"].report.map_time_s
               / results["lpt"].report.map_time_s)
    saved = (results["equal"].report.total_energy_j
             - results["lpt"].report.total_energy_j)
    print(f"\nMB Scheduler (lpt) vs naive equal split: {speedup:.2f}x "
          f"faster, saving {saved:.1f} J "
          f"(paper's analytic bound for this core mix: 2.50x)")

    # 4. the mined rules (paper step 3)
    print(f"\ntop rules (of {len(best.rules)}):")
    for r in best.rules[:8]:
        print("  ", r)

    # 5. online serving: compile the rules into a device-resident index and
    #    answer "given this basket, which items next?" in scheduled batches
    engine = RecommendationEngine(RuleIndex.build(best.rules, T.shape[1]),
                                  profile,
                                  ServingConfig(device=args.device))
    recs, serving = engine.serve([Query.of(row) for row in T[:64]])
    print("\n" + serving.summary())
    print("\nrecommendations for the first 8 baskets:")
    for row, rec in zip(T[:8], recs):
        print(f"   {np.flatnonzero(row).tolist()} -> {rec}")


if __name__ == "__main__":
    main()
