"""The continuously-operating system: stream micro-batches through the
incremental :class:`StreamingMiner`, hot-swapping fresh rules into a live
:class:`RecommendationEngine` — mining, serving and the scheduler runtime
running as one closed loop.

  PYTHONPATH=src python -m repro_torch.launch.stream --n-tx 8192 \
      --window 2048 --batch 128 --min-support 0.02 --policy dynamic \
      [--device cpu] [--no-autotune]

Counting and scoring run on the card unless ``--device cpu`` asks for the
CPU (where the data planes resolve to the plain PyTorch counts).

``--smoke`` is the parity gate: it runs K micro-batches and asserts the
final streaming state (frequent itemsets, supports, rules) is
bit-identical to a one-shot :class:`MarketBasketPipeline` over the same
window — under BOTH the static and the dynamic switching policy, since
scheduling must never change what gets mined — and that the live serving
index was refreshed monotonically and answers from the freshest rules.
"""
from __future__ import annotations

import sys
import numpy as np

from repro_torch.data.baskets import (BasketConfig, generate_baskets,
                                      stationary_baskets)
from repro_torch.launch.common import PROFILES, standard_parser
from repro_torch.pipeline import MarketBasketPipeline
from repro_torch.serving import (Query, RecommendationEngine, RuleIndex,
                                 ServingConfig, recommend_bruteforce)
from repro_torch.streaming import (StreamingConfig, StreamingMiner,
                                   TransactionStream)


def _run_stream(T: np.ndarray, cfg: StreamingConfig, profile_name: str,
                policy: str, serve_k: int, batches: int):
    """One streaming run with a live engine attached; returns the miner,
    its report and the engine."""
    profile = PROFILES[profile_name]()
    n_items = T.shape[1]
    engine = RecommendationEngine(
        RuleIndex.build([], n_items), PROFILES[profile_name](),
        ServingConfig(k=min(serve_k, n_items), data_plane=cfg.data_plane,
                      policy=policy, split=cfg.split,
                      autotune=cfg.autotune, device=cfg.device))
    miner = StreamingMiner(n_items, profile=profile, config=cfg,
                           engine=engine, policy=policy)
    report = miner.run(TransactionStream(T, cfg.batch_size),
                       max_batches=batches or None)
    return miner, report, engine


def stream(n_tx: int = 8192, n_items: int = 128, window: int = 2048,
           batch: int = 128, batches: int = 0, min_support: float = 0.02,
           min_confidence: float = 0.6, profile_name: str = "paper",
           policy: str = "static", split: str = "lpt",
           data_plane: str = "auto", n_tiles: int = 8,
           refresh_every: int = 1, revalidate_every: int = 0,
           serve_k: int = 5, seed: int = 0, top: int = 10,
           smoke: bool = False, autotune: bool = True,
           device: str = "cuda"):
    if smoke:                       # CI-sized: parity is the point, not scale
        n_tx, n_items = min(n_tx, 1536), min(n_items, 48)
        window, batch = min(window, 512), min(batch, 64)
        # high enough that the stationary segment's noise items sit many
        # standard deviations below the threshold — the lattice must be
        # able to settle or the delta-path assertion below can never hold
        min_support = max(min_support, 0.08)
        # two regimes, both must stay exact: a Zipf-noise segment whose
        # threshold churn forces re-validations, then a stationary
        # wide-margin segment longer than the window so the final batches
        # run the delta-only path the plane exists for (asserted below —
        # a smoke that re-validates every batch would never catch a
        # broken delta update)
        half = max(window + 2 * batch, n_tx // 2)
        T = np.vstack([
            generate_baskets(BasketConfig(n_tx=max(n_tx - half, batch),
                                          n_items=n_items, seed=seed)),
            stationary_baskets(half, n_items, seed=seed + 1)])
    else:
        T = generate_baskets(BasketConfig(n_tx=n_tx, n_items=n_items,
                                          seed=seed))
    cfg = StreamingConfig(window=window, batch_size=batch,
                          min_support=min_support,
                          min_confidence=min_confidence, n_tiles=n_tiles,
                          policy=policy, split=split, data_plane=data_plane,
                          autotune=autotune, device=device,
                          refresh_every=refresh_every,
                          revalidate_every=revalidate_every)

    # smoke checks every policy the paper contrasts; a plain run honors
    # the requested one
    policies = ("static", "dynamic") if smoke else (policy,)
    miner = report = engine = None
    for pol in policies:
        miner, report, engine = _run_stream(T, cfg, profile_name, pol,
                                            serve_k, batches)
        print(f"[stream] policy={pol}")
        print(report.summary())
        if not smoke:
            break

        # ---- parity gate: incremental == one-shot over the same window
        single = MarketBasketPipeline(
            PROFILES[profile_name](),
            cfg.pipeline_config(policy=pol)).run(miner.window.rows_raw())
        assert miner.supports == single.supports, \
            f"streaming vs one-shot itemset mismatch (policy={pol})"
        assert miner.rules == single.rules, \
            f"streaming vs one-shot rule mismatch (policy={pol})"

        # ---- the delta path actually ran: the stationary tail must not
        # re-validate (otherwise this gate only ever tests full Apriori)
        tail = report.batches[-3:]
        assert tail and not any(b.revalidated for b in tail), \
            f"stationary tail re-validated (policy={pol}) — delta path untested"
        assert report.n_revalidations < report.n_batches

        # ---- serving gate: the hot-swapped index answers from the
        # freshest rules (monotone swaps, cache invalidated)
        assert engine.index.version == miner.index.version
        assert any(b.index_swapped for b in report.batches)
        rng = np.random.default_rng(seed + 17)
        for _ in range(32):
            basket = sorted(rng.choice(n_items, size=3, replace=False)
                            .tolist())
            got = engine.recommend(Query.of(basket))
            want = recommend_bruteforce(miner.rules, basket,
                                        engine.config.k)
            assert got == want, (basket, got, want)
        print(f"[stream] smoke OK (policy={pol}): "
              f"{len(miner.supports)} itemsets, {len(miner.rules)} rules "
              f"bit-identical to the one-shot pipeline over the final "
              f"{miner.window.n}-tx window; index v{engine.index.version} "
              f"serves the freshest rules")

    if not smoke and miner is not None:
        print(f"[stream] top rules (min_conf={min_confidence}):")
        for r in miner.rules[:top]:
            print("   ", r)
    return miner, report


def main():
    ap = standard_parser()          # corpus / runtime / data-plane / seed
    ap.add_argument("--window", type=int, default=2048,
                    help="sliding-window capacity (transactions)")
    ap.add_argument("--batch", type=int, default=128,
                    help="micro-batch size (transactions per arrival)")
    ap.add_argument("--batches", type=int, default=0,
                    help="stop after this many micro-batches (0 = all)")
    ap.add_argument("--n-tiles", type=int, default=8,
                    help="map tiles for full re-validation passes")
    ap.add_argument("--refresh-every", type=int, default=1,
                    help="micro-batches between rule/index refreshes")
    ap.add_argument("--revalidate-every", type=int, default=0,
                    help="force a periodic full Apriori pass (0 = only "
                         "when the candidate lattice can change)")
    ap.add_argument("--serve-k", type=int, default=5,
                    help="recommendations per query on the live engine")
    ap.add_argument("--smoke", action="store_true",
                    help="small stream; assert final state bit-identical "
                         "to a one-shot pipeline over the same window "
                         "under static AND dynamic policies, and that the "
                         "live index serves the fresh rules")
    args = ap.parse_args()
    try:
        stream(args.n_tx, args.n_items, args.window, args.batch,
               args.batches, args.min_support, args.min_confidence,
               args.profile, args.policy, args.split, args.data_plane,
               args.n_tiles, args.refresh_every, args.revalidate_every,
               args.serve_k, args.seed, smoke=args.smoke,
               autotune=args.autotune, device=args.device)
    except AssertionError as e:
        print(f"[stream] SMOKE FAILED: {e}", file=sys.stderr)
        raise SystemExit(1)


if __name__ == "__main__":
    main()
