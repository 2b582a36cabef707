"""Time the int8 rule-match kernel's two layouts and its cluster sizes at
serving's two buckets.

``src/repro_torch/csrc/rule_match_int8.cu`` puts either operand on
``wgmma``'s M side: the rules (the batch, rounded up, as N) or a block of
64 queries (32-rule tiles as N), and splits a tile's item axis over a
cluster of 1, 2, 4 or 8 CTAs.  ``kernel.geometry`` picks one of these a
shape.  This script launches every layout and cluster at [8 x 896 x
1,024] and [64 x 896 x 1,024] (serving's buckets against an index of 896
rules), holds each launch bit-equal to the plain version, and times them
in turns over several rounds (each round's order the reverse of the
last).  Needs an NVIDIA H100 and the CUDA toolkit:

    PYTHONPATH=src python tools/rule_match_int8_designs.py [--rounds N] \\
        [--out FILE]

Prints the card's name and power limit, then each launch's median,
fastest and slowest time over the rounds, marking the one
``kernel.geometry`` picks.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels.rule_match import kernel

RULES, ITEMS = 896, 1024
BUCKETS = (64, 8)
LAUNCHES = 100                  # launches a timing, queued behind a spin


def launch(Q, A, sizes, conf, geom):
    """One launch of the kernel at ``geom``, whichever the wrapper would
    pick."""
    _, fn = kernel._launcher()
    B, I = Q.shape
    out = torch.empty((B, A.shape[0]), dtype=torch.float32, device=Q.device)
    err = fn(Q.data_ptr(), A.data_ptr(), sizes.data_ptr(), conf.data_ptr(),
             out.data_ptr(), B, A.shape[0], I, int(geom.rules_on_m),
             geom.warpgroups, geom.n, geom.cluster,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{geom}: CUDA error {err}")
    return out


def layouts(B):
    """Both layouts at batch B, each with every cluster size."""
    n = next(t for t in kernel.QUERY_TILES if t >= min(B, 64))
    return ([kernel.Geometry(1, n, c) for c in kernel.CLUSTERS]
            + [kernel.Geometry(1, kernel.RULE_TILE, c, False)
               for c in kernel.CLUSTERS])


def inputs(B, seed):
    """Baskets of density 0.3 and antecedents of 1-3 random items (one
    empty), as the card tests draw them."""
    rng = np.random.default_rng(seed)
    Q = (rng.random((B, ITEMS)) < 0.3).astype(np.int8)
    A = np.zeros((RULES, ITEMS), np.int8)
    cols = rng.integers(0, ITEMS, (RULES, 3))
    keep = np.arange(3)[None, :] < rng.integers(1, 4, (RULES, 1))
    A[np.repeat(np.arange(RULES)[:, None], 3, 1)[keep], cols[keep]] = 1
    A[0] = 0
    sizes = A.sum(1).astype(np.float32)
    conf = rng.random(RULES).astype(np.float32)
    return [torch.from_numpy(x).cuda() for x in (Q, A, sizes, conf)]


def device_ms(fn) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(LAUNCHES):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / LAUNCHES


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=9)
    ap.add_argument("--out", type=Path, help="write the results as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    results = {}
    for B in BUCKETS:
        Q, A, sizes, conf = inputs(B, B)
        picked = kernel.geometry(B, RULES, ITEMS, sms)
        want = kernel.rule_scores_int8_plain(Q, A, sizes, conf)
        designs = {g.describe(B, RULES, ITEMS)
                   + (" [picked]" if g == picked else ""):
                   (lambda g=g: launch(Q, A, sizes, conf, g))
                   for g in layouts(B)}
        for name, fn in designs.items():
            got = fn()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{name} at bucket {B} differs from "
                                     "the plain version")
        times = {name: [] for name in designs}
        order = list(designs)
        for _ in range(args.rounds):
            for name in order:
                times[name].append(device_ms(designs[name]))
            order.reverse()
        print(f"[{B} x {RULES} x {ITEMS}], exact; ms over {args.rounds} "
              f"rounds of {LAUNCHES} launches (median, fastest, slowest):")
        for name, ts in times.items():
            print(f"  {name}: {statistics.median(ts):.5f}, {min(ts):.5f}, "
                  f"{max(ts):.5f}")
        results[B] = times
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(card=card, ms=results),
                                       indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
