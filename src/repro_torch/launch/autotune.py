"""Sweep the mining and serving kernels' variants and (re)write the
autotune winner cache.

  PYTHONPATH=src python -m repro_torch.launch.autotune          # the lattice
  PYTHONPATH=src python -m repro_torch.launch.autotune --smoke  # tiny sweep
  PYTHONPATH=src python -m repro_torch.launch.autotune --smoke \
      --device cpu --out /tmp/tune.json

Every candidate config is measured (synced warm-up + median of ``--reps``
synced repetitions, CUDA events on the card) *and* verified bit-identical
against the plain oracle before it may win; configs that disagree are
excluded from the argmin, so a cache entry is both the fastest and a
correct configuration for its (kernel, shape-bucket, device kind).  The
default ``--out`` is the checked-in cache the ops wrappers read
(:data:`repro_torch.kernels.autotune.cache.DEFAULT_CACHE_PATH`) — refresh
it on the card the measurements are for.  ``--device cpu`` sweeps the
kernels' plain versions and keys the entries ``cpu``.

``--smoke`` sweeps one small shape per kernel and writes to a scratch
file in the temporary directory unless ``--out`` names one: it exercises
the whole tune → verify → cache → resolve loop, not the winners.
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional

from repro_torch.kernels.autotune.cache import (DEFAULT_CACHE_PATH,
                                                AutotuneCache, device_kind)
from repro_torch.kernels.autotune.tuner import standard_shapes, tune_into
from repro_torch.launch.common import add_seed_arg
from repro_torch.launch.tuning import TUNABLE_KERNELS


def autotune(out: Optional[str] = None, smoke: bool = False,
             reps: int = 3, max_configs: int = 0, seed: int = 0,
             kernels: tuple = TUNABLE_KERNELS, device: str = "cuda",
             log=print) -> AutotuneCache:
    """Run the sweep on ``device`` and write the cache; returns it."""
    if out is None:
        out = (os.path.join(tempfile.gettempdir(),
                            "repro_torch_autotune_smoke.json")
               if smoke else DEFAULT_CACHE_PATH)
    if smoke and not max_configs:
        max_configs = 2
    cache = AutotuneCache.load(out)
    if cache.load_error:
        log(f"[autotune] starting fresh: {cache.load_error}")
    log(f"[autotune] device={device_kind(device)} smoke={smoke} "
        f"reps={reps} max_configs={max_configs or 'all'}")
    for kernel in kernels:
        shapes = standard_shapes(kernel, smoke=smoke)
        tune_into(cache, kernel, shapes, log=log, reps=reps,
                  max_configs=max_configs, seed=seed, device=device)
    path = cache.save(out)
    log(f"[autotune] wrote {len(cache)} entries to {path}")
    return cache


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="cache file to update (default: the checked-in "
                         "cache the ops wrappers read; with --smoke, a "
                         "scratch file in the temporary directory)")
    ap.add_argument("--smoke", action="store_true",
                    help="one small shape per kernel, 2 configs — "
                         "exercises the tune/verify/cache loop only")
    ap.add_argument("--reps", type=int, default=3,
                    help="synced repetitions per config (median wins)")
    ap.add_argument("--max-configs", type=int, default=0,
                    help="truncate the roofline-ordered candidate list "
                         "(0 = sweep all)")
    add_seed_arg(ap)                # shared with the other launch CLIs
    ap.add_argument("--kernel", action="append", default=None,
                    choices=list(TUNABLE_KERNELS),
                    help="restrict to one kernel (repeatable)")
    ap.add_argument("--device", default="cuda",
                    help="where the kernels run (default: cuda; cpu sweeps "
                         "their plain versions)")
    args = ap.parse_args()
    autotune(args.out, smoke=args.smoke, reps=args.reps,
             max_configs=args.max_configs, seed=args.seed,
             kernels=tuple(args.kernel) if args.kernel else TUNABLE_KERNELS,
             device=args.device)


if __name__ == "__main__":
    main()
