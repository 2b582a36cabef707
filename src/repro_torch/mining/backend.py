"""The MiningBackend protocol + algorithm resolution.

Every mining backend is an object with the same ``run`` signature as
:class:`repro_torch.pipeline.MarketBasketPipeline` and returns the same
:class:`repro_torch.pipeline.PipelineResult` — frequent itemsets, supports,
rules and a report — held bit-identical across backends by the parity
tests.  Callers pick one with ``PipelineConfig.algorithm``:

* ``apriori`` — horizontal bitmap rounds (:class:`MarketBasketPipeline`);
* ``eclat``   — vertical tid-list intersections (:class:`EclatMiner`);
* ``auto``    — :func:`repro_torch.mining.select.select_algorithm` prices
  both formulations on the dataset's measured density features and picks
  one (the decision travels back as an :class:`AlgorithmChoice`).
"""
from __future__ import annotations

from typing import List, Optional, Protocol, Tuple, Union

from repro_torch.core.hetero import HeterogeneityProfile
from repro_torch.core.mapreduce import FailureEvent
from repro_torch.data.sparse import density_stats
from repro_torch.mining.eclat.miner import EclatMiner
from repro_torch.mining.select import (AlgorithmChoice, AlgorithmCostModel,
                                       select_algorithm)
from repro_torch.pipeline.pipeline import (ALGORITHMS, Baskets,
                                           MarketBasketPipeline,
                                           PipelineConfig, PipelineResult)
from repro_torch.runtime import SwitchingPolicy


class MiningBackend(Protocol):
    """What every mining plane exposes (structural — no registration)."""

    config: PipelineConfig

    def run(self, baskets: Baskets,
            failures: Optional[List[FailureEvent]] = None) -> PipelineResult:
        ...


def resolve_algorithm(algorithm: str) -> str:
    if algorithm not in ALGORITHMS:
        raise ValueError(f"unknown mining algorithm {algorithm!r} "
                         f"(known: {', '.join(ALGORITHMS)})")
    return algorithm


def make_miner(baskets: Baskets,
               profile: Optional[HeterogeneityProfile] = None,
               config: Optional[PipelineConfig] = None,
               policy: Union[str, SwitchingPolicy, None] = None,
               model: Optional[AlgorithmCostModel] = None,
               son=None,
               ) -> Tuple[MiningBackend, Optional[AlgorithmChoice]]:
    """Resolve ``config.algorithm`` to a ready miner.

    ``auto`` measures the dataset (density stats come straight from the
    slab/bitmap/id-lists, no densification) and routes through the
    algorithm cost model — seeded from the autotune cache's walls measured
    on ``config.device``, the H100 roofline on a cold cache, unless
    ``model`` scripts the rates; the returned :class:`AlgorithmChoice`
    carries the full evidence trail (``None`` when the algorithm was
    explicit).  The miner counts on ``config.device``: the card by
    default.

    ``son`` (a :class:`repro_torch.mining.son.SONConfig`) routes to the
    out-of-core two-pass :class:`repro_torch.mining.son.SONMiner` instead —
    the algorithm (including ``auto``, re-priced on the partition-sized
    problem) resolves per run inside the miner, so the choice is returned
    as ``None`` here and surfaced as ``miner.algorithm_choice`` after
    ``run()``.
    """
    config = config or PipelineConfig()
    algorithm = resolve_algorithm(config.algorithm)
    if son is not None:
        from repro_torch.mining.son import SONMiner
        return SONMiner(profile=profile, config=config, son=son,
                        policy=policy), None
    choice: Optional[AlgorithmChoice] = None
    if algorithm == "auto":
        # min_support resolves against the true tx count in every input
        # form; density_stats measures it without densifying
        stats = density_stats(baskets)
        choice = select_algorithm(baskets, config.abs_support(stats.n_tx),
                                  model=model, stats=stats,
                                  device=config.device)
        algorithm = choice.algorithm
    cls = EclatMiner if algorithm == "eclat" else MarketBasketPipeline
    return cls(profile=profile, config=config, policy=policy), choice
