"""Online rule-serving plane: compiled rule index + batched recommendation
engine (the query-side twin of ``repro_torch.pipeline``).

Two ways to drive it, one loop underneath:

* closed-loop — ``RecommendationEngine.serve(queries)`` replays a trace
  (a compat shim over the continuous-batching loop);
* open-loop — ``submit(query) -> Handle`` / ``poll`` / ``drain`` on the
  :class:`AsyncServer`: slot-based admission, warmed bucket ladder,
  SLO-aware shedding, optional background drain thread.

Scoring runs on the card through the ``rule_match`` CUDA kernels, or on
the CPU through their plain PyTorch versions when the caller asks for it.
"""
from repro_torch.serving.admission import (BucketLadder, Handle, Query,
                                           RequestQueue, ShedError,
                                           SloGovernor, VirtualClock,
                                           WallClock)
from repro_torch.serving.cache import ResultCache, basket_key
from repro_torch.serving.engine import (QueryLike, RecommendationEngine,
                                        ServingConfig, ServingReport)
from repro_torch.serving.index import RuleIndex
from repro_torch.serving.oracle import recommend_bruteforce
from repro_torch.serving.server import AsyncServer, AsyncServingReport

__all__ = [
    "AsyncServer", "AsyncServingReport", "BucketLadder", "Handle", "Query",
    "QueryLike", "RecommendationEngine", "RequestQueue", "ResultCache",
    "RuleIndex", "ServingConfig", "ServingReport", "ShedError",
    "SloGovernor", "VirtualClock", "WallClock", "basket_key",
    "recommend_bruteforce",
]
