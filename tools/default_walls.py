"""Time the port's default paths on the card for one source tree, so that
two trees (a parent commit's and a change's) can be held against each
other in turns on one card.

Mines the T10I4D100K-scale corpus (100,000 x 1,000, seed 0, min_support
1%, 32 tiles) with the default ``PipelineConfig`` (no variant pinned:
the autotune cache, where the tree has one, picks it) 7 times after a
warm-up, then through ``make_miner`` with ``algorithm="auto"`` 5 times,
serves its first 4,096 baskets through a default ``RecommendationEngine``
over the mined rules 5 times, and streams its first 40,000 rows then
28,000 stationary ones through a default ``StreamingMiner`` (window
20,000, batches of 1,000, a live engine) twice.  Each wall ends in a
synchronise.  Prints one JSON line: the walls, their medians (a stream's
mean batch wall in its churning first 40 batches and in its steady
last 8) and the launches of each support-count and rule-match kernel
over the mines and the serves.  Needs an NVIDIA card and the CUDA toolkit:

    python tools/default_walls.py ROOT LABEL

where ``ROOT`` holds the tree's ``src/`` (e.g. ``build/parent`` after
``git archive <commit> src | tar -x -C build/parent``, or ``.``).  Run
the two trees in turns, parent first, then change, change, parent, and
so on, each in a fresh process.
"""
import json
import sys
import time

root, label = sys.argv[1], sys.argv[2]
sys.path.insert(0, root + "/src")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.data.baskets import (BasketConfig,  # noqa: E402
                                      generate_baskets, stationary_baskets)
from repro_torch.kernels import loader  # noqa: E402
from repro_torch.kernels.rule_match import fused as rm_fused  # noqa: E402
from repro_torch.kernels.rule_match import kernel as rm_kernel  # noqa: E402
from repro_torch.kernels.support_count import fused, kernel  # noqa: E402
from repro_torch.mining import make_miner  # noqa: E402
from repro_torch.pipeline import MarketBasketPipeline, PipelineConfig  # noqa: E402
from repro_torch.serving import (Query, RecommendationEngine,  # noqa: E402
                                 RuleIndex, ServingConfig)
from repro_torch.streaming import (StreamingConfig,  # noqa: E402
                                   StreamingMiner, TransactionStream)

MINES, AUTOS, SERVES, STREAMS = 7, 5, 5, 2


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main():
    loader.build(["support_count_packed", "support_count_int8",
                  "rule_match_packed", "rule_match_int8", "intersect_count"])
    T = generate_baskets(BasketConfig(n_tx=100_000, n_items=1000, seed=0))
    cfg = PipelineConfig(min_support=0.01, n_tiles=32)
    auto = PipelineConfig(min_support=0.01, n_tiles=32, algorithm="auto")
    counters = (fused.support_count_packed, kernel.support_count_int8,
                rm_fused.rule_scores_packed, rm_kernel.rule_scores_int8)

    res = MarketBasketPipeline(config=cfg).run(T)            # warm-up
    index = RuleIndex.build(res.rules, T.shape[1])
    queries = [Query.of(np.flatnonzero(r).tolist()) for r in T[:4096]]
    RecommendationEngine(index, config=ServingConfig()).serve(queries[:64])
    walls = {"apriori": [], "auto": [], "serve": []}
    before = [c.launches for c in counters]
    for _ in range(MINES):
        walls["apriori"].append(timed(
            lambda: MarketBasketPipeline(config=cfg).run(T)))
    mined = [c.launches - b for c, b in zip(counters, before)]
    for _ in range(AUTOS):
        walls["auto"].append(timed(
            lambda: make_miner(T, config=auto)[0].run(T)))
    before = [c.launches for c in counters]
    for _ in range(SERVES):
        engine = RecommendationEngine(index, config=ServingConfig())
        walls["serve"].append(timed(lambda: engine.serve(queries)))
    served = [c.launches - b for c, b in zip(counters, before)]
    S = np.vstack([T[:40_000], stationary_baskets(28_000, 1000, seed=1)])
    walls["stream_churn_batch"], walls["stream_steady_batch"] = [], []
    for _ in range(STREAMS):
        engine = RecommendationEngine(RuleIndex.build([], 1000),
                                      config=ServingConfig(k=5))
        miner = StreamingMiner(1000, engine=engine, config=StreamingConfig(
            window=20_000, batch_size=1_000, min_support=0.01, n_tiles=8))
        report = miner.run(TransactionStream(S, 1_000))
        torch.cuda.synchronize()
        batches = [b.wall_s for b in report.batches]
        walls["stream_churn_batch"].append(float(np.mean(batches[:40])))
        walls["stream_steady_batch"].append(float(np.mean(batches[-8:])))
    print(json.dumps({
        "label": label, "walls": walls,
        "median": {k: float(np.median(v)) for k, v in walls.items()},
        "mine_launches_packed_int8": mined[:2],
        "serve_launches_packed_int8": served[2:]}))


if __name__ == "__main__":
    main()
