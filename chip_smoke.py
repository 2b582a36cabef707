#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:

1. build both support-count kernels from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, in parallel) and print the build time;
2. call each kernel's wrapper at the shapes the mining main path gives it
   (one transaction tile × the k=2 candidate batch) and at a few ragged
   shapes, and require exact equality with its plain PyTorch version;
   time the kernel, the plain version and, for the int8 kernel,
   ``torch._int_mm`` plus the compare-and-sum (a yardstick the port never
   calls);
3. mine a corpus at the scale of IBM Quest T10I4D100K (100,000
   transactions over 1,000 items, min_support 1%) three times — through
   the ``packed`` kernel, the ``mxu`` kernel and the plain ``ref`` data
   plane — and require equal supports and rules, launches of each kernel
   on its path, one device-to-host read per counting round, and supports
   that numpy recounts exactly;
4. print the card's name and power limit, the ``kernels`` JSON line and,
   last, ``{"ok": true, "device": {...}}``.

It exits non-zero and prints no result where no CUDA device is available,
or where the port's sources are not beside it.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, dense int8 tensor-core
# rate, and 32-bit popcount issue rate per SM per clock (CUDA C++
# programming guide, arithmetic instruction throughput, compute 9.0).
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
POPC_PER_SM_PER_CLOCK = 16

CORPUS = dict(n_tx=100_000, n_items=1000, seed=0)   # T10I4D100K scale
MIN_SUPPORT = 0.01
N_TILES = 32
REPS = 20


def _nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]


def _cuda_ms(torch, fn, reps: int = REPS) -> float:
    """Mean device time of ``fn`` over ``reps`` launches, after warm-up
    (inputs stay in the 50 MB L2 between launches)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))

    import numpy as np

    from repro_torch.core.itemsets import (AprioriResult,
                                           apriori_bruteforce,
                                           generate_candidates,
                                           itemsets_to_bitmap)
    from repro_torch.core.rules import generate_rules
    from repro_torch.data.baskets import BasketConfig, generate_baskets
    from repro_torch.kernels import loader
    from repro_torch.kernels.support_count import fused, kernel
    from repro_torch.pipeline import (MarketBasketPipeline, PipelineConfig,
                                      ingest_baskets, uniform_tiles)
    from repro_torch.pipeline.dataplane import pad_candidates

    # float32 matmuls in the plain versions run in full float32 (the
    # default); their 0/1 operands are exact under TF32 too
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    props = torch.cuda.get_device_properties(dev)

    # ---- 1. build ------------------------------------------------------
    t0 = time.perf_counter()
    logs = loader.build(["support_count_packed", "support_count_int8"])
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(logs) or 'already built'})")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # ---- 2. kernels against their plain versions ----------------------
    t0 = time.perf_counter()
    T_all = generate_baskets(BasketConfig(**CORPUS))
    print(f"corpus: {T_all.shape} generated in "
          f"{time.perf_counter() - t0:.2f} s")
    T, n_items_raw, n_tx = ingest_baskets(T_all)
    tile = torch.from_numpy(uniform_tiles(T, N_TILES)[0]).to(dev)
    min_sup = max(1, int(MIN_SUPPORT * n_tx))
    counts = T.sum(axis=0, dtype=np.int64)
    frequent = [(int(i),) for i in np.flatnonzero(counts >= min_sup)]
    cands = generate_candidates(frequent)
    C = torch.from_numpy(pad_candidates(
        itemsets_to_bitmap(cands, T.shape[1]), 128)).to(dev)
    N, I = tile.shape
    M = C.shape[0]
    W = I // 32
    print(f"main-path shape: tile [{N}, {I}] x k=2 candidates [{M}, {I}] "
          f"({len(cands)} real)")

    def check(got, want, what):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"{what}: {bad} of {want.numel()} counts "
                                 "differ from the plain version")
        return float((got.to(torch.int64) - want.to(torch.int64)).abs()
                     .max()) if want.numel() else 0.0

    Tw, Cw = fused.pack_words(tile), fused.pack_words(C)
    Ti, Ci = tile.view(torch.int8), C.view(torch.int8)
    sizes = C.sum(dim=1, dtype=torch.int32)
    err = {
        "packed": check(fused.support_count_packed(Tw, Cw, sizes),
                        fused.support_count_packed_plain(Tw, Cw, sizes),
                        "support_count_packed (main-path shape)"),
        "int8": check(kernel.support_count_int8(Ti, Ci, sizes),
                      kernel.support_count_int8_plain(Ti, Ci, sizes),
                      "support_count_int8 (main-path shape)"),
    }
    rng = np.random.default_rng(1)
    for n, m, i in [(77, 200, 128), (4133, 1, 256), (1000, 257, 1024)]:
        t = torch.from_numpy((rng.random((n, i)) < 0.5).astype(np.int8))
        c = torch.from_numpy((rng.random((m, i)) < 0.02).astype(np.int8))
        c[0] = 0                                  # |c| = 0 matches all rows
        t, c = t.to(dev), c.to(dev)
        s = c.sum(dim=1, dtype=torch.int32)
        tw, cw = fused.pack_words(t), fused.pack_words(c)
        check(fused.support_count_packed(tw, cw, s),
              fused.support_count_packed_plain(tw, cw, s),
              f"support_count_packed [{n}, {m}, {i}]")
        check(kernel.support_count_int8(t, c, s),
              kernel.support_count_int8_plain(t, c, s),
              f"support_count_int8 [{n}, {m}, {i}]")
    print("kernels match their plain versions exactly "
          "(main-path shape + 3 ragged shapes)")

    def int_mm_count():
        dots = torch._int_mm(Ti, Ci.t())
        return (dots == sizes[None, :]).sum(dim=0, dtype=torch.int32)
    check(int_mm_count(), kernel.support_count_int8_plain(Ti, Ci, sizes),
          "torch._int_mm yardstick")
    timing = {
        "packed": dict(
            ms=_cuda_ms(torch, lambda: fused.support_count_packed(
                Tw, Cw, sizes)),
            plain_ms=_cuda_ms(torch, lambda: fused.support_count_packed_plain(
                Tw, Cw, sizes), reps=3),
            library_ms=None),
        "int8": dict(
            ms=_cuda_ms(torch, lambda: kernel.support_count_int8(
                Ti, Ci, sizes)),
            plain_ms=_cuda_ms(torch, lambda: kernel.support_count_int8_plain(
                Ti, Ci, sizes), reps=3),
            library_ms=_cuda_ms(torch, int_mm_count)),
    }
    clock_hz = float(_nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    popc_per_s = props.multi_processor_count * POPC_PER_SM_PER_CLOCK * clock_hz
    bound = {
        "packed": {"operations": N * M * W / popc_per_s * 1e3,
                   "bytes": (N * W * 4 + M * W * 4 + 2 * M * 4)
                   / HBM_BYTES_PER_S * 1e3},
        "int8": {"operations": 2 * N * M * I / INT8_OPS_PER_S * 1e3,
                 "bytes": (N * I + M * I + 2 * M * 4)
                 / HBM_BYTES_PER_S * 1e3},
    }
    for k, v in timing.items():
        by = max(bound[k], key=bound[k].get)
        v.update(bound_ms=bound[k][by], bound_by=by)
        print(f"{k}: kernel {v['ms']:.4f} ms, plain {v['plain_ms']:.4f} ms, "
              f"library {v['library_ms']} ms, bound {v['bound_ms']:.4f} ms "
              f"({by}; {props.multi_processor_count} SMs at "
              f"{clock_hz / 1e6:.0f} MHz)")

    # ---- 3. the mining main path, three ways --------------------------
    def mine(**kw):
        cfg = PipelineConfig(min_support=MIN_SUPPORT, n_tiles=N_TILES, **kw)
        t0 = time.perf_counter()
        res = MarketBasketPipeline(config=cfg).run(T_all)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rounds = [(r.k, r.n_candidates, r.n_frequent, r.m_padded)
                  for r in res.report.rounds]
        serial_s = sum(p.host_time_s for p in res.report.ledger.phases
                       if p.kind == "serial")
        print(f"mine {kw or 'default (packed)'}: backend "
              f"{res.report.backend}, {len(rounds)} rounds "
              f"(k, candidates, frequent, m_padded) {rounds}, "
              f"{len(res.supports)} itemsets, {len(res.rules)} rules, "
              f"wall {wall:.3f} s, of which candidate generation and "
              f"rules (serial phases) {serial_s:.3f} s")
        maps = res.report.ledger.by_kind("map")
        if not maps or any(p.syncs != 1 for p in maps):
            raise AssertionError("pipelined rounds must read back once "
                                 f"each: {[(p.name, p.syncs) for p in maps]}")
        return res

    # first mine on the card: a small corpus against the brute-force
    # oracle, which also takes the one-time start-up costs out of the walls
    small = generate_baskets(BasketConfig(n_tx=300, n_items=24, n_patterns=4,
                                          pattern_len=3, pattern_prob=0.5,
                                          seed=5))
    got = MarketBasketPipeline(config=PipelineConfig(
        min_support=0.05, n_tiles=4)).run(small).supports
    if got != apriori_bruteforce(small, 15, max_k=24):
        raise AssertionError("small mine differs from apriori_bruteforce")
    print("small corpus mined on the card = apriori_bruteforce")

    def drive(**kw):
        """One path of the main path: counts zeroed just before, read
        just after."""
        fused.support_count_packed.launches = 0
        kernel.support_count_int8.launches = 0
        res = mine(**kw)
        return res, {"packed": fused.support_count_packed.launches,
                     "int8": kernel.support_count_int8.launches}

    packed, on_packed = drive()
    mxu, on_mxu = drive(tuning={"variant": "mxu"})
    ref, on_ref = drive(data_plane="ref")
    print(f"launches: packed path {on_packed}, mxu path {on_mxu}, "
          f"ref path {on_ref}")
    launches = {"packed": on_packed["packed"], "int8": on_mxu["int8"]}
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was never launched: {launches}")
    if on_packed["int8"] or on_mxu["packed"] or any(on_ref.values()):
        raise AssertionError("a path launched another path's kernel")
    if launches["packed"] != launches["int8"]:
        raise AssertionError("both variants must count the same tiles")

    for name, res in (("mxu", mxu), ("ref", ref)):
        if res.supports != packed.supports or res.rules != packed.rules:
            raise AssertionError(f"{name} mine differs from packed")
    for itemset, sup in packed.supports.items():
        if int(T_all[:, list(itemset)].all(axis=1).sum()) != sup:
            raise AssertionError(f"support of {itemset} is not {sup}")
    want_rules = generate_rules(
        AprioriResult(supports=packed.supports, n_tx=n_tx, levels=0),
        0.6, min_lift=0.0)
    if packed.rules != want_rules:
        raise AssertionError("rules differ from generate_rules on the "
                             "recounted supports")
    if not packed.rules or max(len(s) for s in packed.supports) < 3:
        raise AssertionError("the corpus must mine rules and 3-itemsets")
    print(f"mines agree: {len(packed.supports)} itemsets recounted by "
          "numpy, rules regenerated")

    # ---- 4. result lines ----------------------------------------------
    print(_nvidia_smi("name,power.limit"))
    rows = []
    for key, name, src, replaces in (
            ("packed", "support_count_packed",
             "src/repro_torch/csrc/support_count_packed.cu",
             "src/repro/kernels/support_count/fused.py:94"),
            ("int8", "support_count_int8",
             "src/repro_torch/csrc/support_count_int8.cu",
             "src/repro/kernels/support_count/kernel.py:74")):
        rows.append(dict(name=name, route="cuda", source=src,
                         replaces=replaces, launches=launches[key],
                         max_abs_err=err[key], ok=True, **timing[key]))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
