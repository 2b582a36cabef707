"""Mine → compile → serve: the online recommendation path end to end.

Mines association rules with the MarketBasketPipeline, compiles them into a
device-resident :class:`RuleIndex`, then replays a synthetic query trace
through the micro-batching :class:`RecommendationEngine` (admission via
``MBScheduler.assign_serial``, batched scoring via ``assign_parallel``).

  PYTHONPATH=src python -m repro_torch.launch.recommend --n-tx 8192 \\
      --queries 2048 [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.recommend --smoke
  PYTHONPATH=src python -m repro_torch.launch.recommend --async \\
      --target-qps 50 --slo-ms 500

Mining and scoring run on the card unless ``--device cpu`` asks for the
CPU.

``--smoke`` shrinks the problem, serves a 1k-query trace and pins every
batched top-k result to the brute-force Python oracle — a non-zero exit
means the serving data plane and the rule list disagree.

``--async`` drives the continuous-batching :class:`AsyncServer` instead of
the closed-loop ``serve()``: requests are submitted open-loop at
``--target-qps`` (Poisson arrivals) and drained through slot-based
admission on the warmed bucket ladder, with ``--slo-ms`` arming the
shedding governor.  ``--async --smoke`` additionally pins the async
results bit-identical to the closed-loop oracle under BOTH the static and
the dynamic switching policy — batching decisions must never change what
gets recommended.
"""
from __future__ import annotations

import sys

import numpy as np

from repro_torch.data.baskets import BasketConfig, generate_baskets
from repro_torch.launch.common import PROFILES, standard_parser
from repro_torch.pipeline import MarketBasketPipeline, PipelineConfig
from repro_torch.serving import (AsyncServer, Query, RecommendationEngine,
                                 RuleIndex, ServingConfig,
                                 recommend_bruteforce)


def synthetic_trace(cfg: BasketConfig, n_queries: int, seed: int,
                    mean_gap_s: float = 0.0):
    """Query baskets drawn from the same store distribution as the corpus
    (fresh seed), with optional exponential inter-arrival gaps."""
    Q = generate_baskets(BasketConfig(**{**cfg.__dict__, "n_tx": n_queries,
                                         "seed": seed}))
    queries = [Query.of(row) for row in Q]
    rng = np.random.default_rng(seed + 1)
    arrival = (np.cumsum(rng.exponential(mean_gap_s, n_queries))
               if mean_gap_s > 0 else None)
    return queries, arrival


def _items(q: Query) -> list:
    """A query's item ids (its payload is the basket's bitmap row)."""
    return np.nonzero(q.payload)[0].tolist()


def _recommend_async(make_engine, basket_cfg: BasketConfig, n_queries: int,
                     seed: int, mean_gap_s: float, target_qps: float,
                     rules, k: int, smoke: bool, policy: str):
    """Open-loop leg of the CLI: submit/drain on the AsyncServer.

    With ``--smoke`` the async results are pinned bit-identical to a
    fresh closed-loop ``serve()`` run AND the brute-force oracle, under
    both the static and the dynamic switching policy.
    """
    gap = (1.0 / target_qps) if target_qps > 0 else mean_gap_s
    queries, arrival = synthetic_trace(basket_cfg, n_queries, seed + 101,
                                       gap)
    if arrival is None:
        arrival = np.zeros(len(queries))
    policies = ("static", "dynamic") if smoke else (policy,)
    results = report = None
    for pol in policies:
        engine = make_engine(pol)
        server = AsyncServer(engine)
        handles = [server.submit(q, arrival_s=float(a))
                   for q, a in zip(queries, arrival)]
        server.drain()
        report = server.take_report()
        print(f"[recommend] async policy={pol} "
              f"target={target_qps or 'unpaced'} QPS")
        print(report.summary())
        results = [h.result() if h.status == "done" else None
                   for h in handles]

        if smoke:
            # the same trace through the closed-loop shim on a fresh
            # engine must produce byte-for-byte the same recommendations
            want, _ = make_engine(pol).serve(queries, arrival)
            bad = 0
            for h, got, w, q in zip(handles, results, want, queries):
                if h.status != "done":
                    continue
                oracle = recommend_bruteforce(rules, _items(q), k)
                if got != w or got != oracle:
                    bad += 1
                    if bad <= 3:
                        print(f"[recommend] ASYNC MISMATCH basket="
                              f"{_items(q)}\n  async  {got}"
                              f"\n  closed {w}\n  oracle {oracle}",
                              file=sys.stderr)
            if bad:
                print(f"[recommend] ASYNC SMOKE FAILED: {bad}/{len(queries)}"
                      f" requests disagree with the closed-loop oracle "
                      f"(policy={pol})", file=sys.stderr)
                raise SystemExit(1)
            print(f"[recommend] async smoke OK (policy={pol}): "
                  f"{report.n_completed} async results bit-identical to "
                  f"the closed loop and the brute-force oracle "
                  f"({report.n_shed} shed)")
    return results, report


def recommend(n_tx: int = 8192, n_items: int = 128,
              min_support: float = 0.02, min_confidence: float = 0.6,
              profile_name: str = "paper", split: str = "lpt",
              data_plane: str = "auto", n_queries: int = 2048, k: int = 5,
              batch: int = 64, cache_size: int = 4096, seed: int = 0,
              mean_gap_s: float = 0.0, index_dir: str = "",
              smoke: bool = False, top: int = 8, policy: str = "static",
              autotune: bool = True, use_async: bool = False,
              target_qps: float = 0.0, slo_ms: float = 0.0,
              device: str = "cuda"):
    profile = PROFILES[profile_name]()
    basket_cfg = BasketConfig(n_tx=n_tx, n_items=n_items, seed=seed)

    # 1. mine (the offline path)
    pipe = MarketBasketPipeline(
        profile,
        PipelineConfig(min_support=min_support, min_confidence=min_confidence,
                       policy=policy, split=split, data_plane=data_plane,
                       autotune=autotune, device=device))
    result = pipe.run(generate_baskets(basket_cfg))
    print(f"[recommend] mined {len(result.rules)} rules from {n_tx} tx "
          f"({result.report.n_rounds} rounds, backend="
          f"{result.report.backend})")

    # 2. compile the rule index (optionally persist it)
    index = RuleIndex.build(result.rules, n_items)
    print(f"[recommend] index: {index.n_rows} rows "
          f"({index.n_rows_padded}x{index.n_items_padded} padded, "
          f"{index.nbytes / 1024:.0f} KiB)")
    if index_dir:
        print(f"[recommend] saved index to {index.save(index_dir)}")

    # 3. replay the synthetic query trace
    buckets = tuple(sorted({1, min(8, batch), batch}))

    def make_engine(pol: str) -> RecommendationEngine:
        return RecommendationEngine(
            index, PROFILES[profile_name](),
            ServingConfig(k=k, batch_buckets=buckets, data_plane=data_plane,
                          cache_size=cache_size, policy=pol, split=split,
                          autotune=autotune, slo_ms=slo_ms, device=device))

    if use_async:
        return _recommend_async(make_engine, basket_cfg, n_queries, seed,
                                mean_gap_s, target_qps, result.rules, k,
                                smoke, policy)

    engine = make_engine(policy)
    queries, arrival = synthetic_trace(basket_cfg, n_queries, seed + 101,
                                       mean_gap_s)
    results, report = engine.serve(queries, arrival)
    print(report.summary())
    shown = 0
    for q, recs in zip(queries, results):
        if recs and shown < top:
            items = ",".join(str(i) for i in _items(q))
            print(f"   basket {{{items}}} -> " +
                  ", ".join(f"{i} ({s:.3f})" for i, s in recs))
            shown += 1

    # 4. smoke gate: every batched result must equal the brute-force oracle
    if smoke:
        bad = 0
        for q, got in zip(queries, results):
            want = recommend_bruteforce(result.rules, _items(q), k)
            if got != want:
                bad += 1
                if bad <= 3:
                    print(f"[recommend] MISMATCH basket={_items(q)}\n"
                          f"  got  {got}\n  want {want}", file=sys.stderr)
        if bad:
            print(f"[recommend] SMOKE FAILED: {bad}/{len(queries)} queries "
                  f"disagree with the brute-force oracle", file=sys.stderr)
            raise SystemExit(1)
        print(f"[recommend] smoke OK: {len(queries)} queries match the "
              f"brute-force oracle exactly")
    return results, report


def main():
    ap = standard_parser()          # corpus / runtime / data-plane / seed
    ap.add_argument("--queries", type=int, default=2048)
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--batch", type=int, default=64,
                    help="largest admission bucket")
    ap.add_argument("--cache-size", type=int, default=4096,
                    help="LRU entries; 0 disables the result cache")
    ap.add_argument("--mean-gap-s", type=float, default=0.0,
                    help="mean simulated inter-arrival gap (0 = all at once)")
    ap.add_argument("--index-dir", default="",
                    help="persist the compiled index here (checkpoint store)")
    ap.add_argument("--async", dest="use_async", action="store_true",
                    help="serve open-loop through the continuous-batching "
                         "AsyncServer (submit/poll/drain) instead of the "
                         "closed-loop serve()")
    ap.add_argument("--target-qps", type=float, default=0.0,
                    help="open-loop Poisson arrival rate for --async "
                         "(0 = unpaced, all requests at t=0)")
    ap.add_argument("--slo-ms", type=float, default=0.0,
                    help="latency budget for --async: the governor sheds "
                         "requests projected to miss it (0 = never shed)")
    ap.add_argument("--smoke", action="store_true",
                    help="small corpus, 1k queries, verify vs oracle "
                         "(with --async: pin async == closed-loop == oracle "
                         "under static AND dynamic policies)")
    args = ap.parse_args()
    if args.smoke:
        args.n_tx, args.n_items, args.queries = 2048, 64, 1000
        args.min_support = max(args.min_support, 0.03)
    recommend(args.n_tx, args.n_items, args.min_support, args.min_confidence,
              args.profile, args.split, args.data_plane, args.queries,
              args.k, args.batch, args.cache_size, args.seed, args.mean_gap_s,
              args.index_dir, args.smoke, policy=args.policy,
              autotune=args.autotune, use_async=args.use_async,
              target_qps=args.target_qps, slo_ms=args.slo_ms,
              device=args.device)


if __name__ == "__main__":
    main()
