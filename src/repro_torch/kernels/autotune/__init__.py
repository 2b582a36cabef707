"""Kernel autotuning: measured variant selection for the mining and
serving kernels.

Three pieces:

* :mod:`repro_torch.kernels.autotune.cache` — the persistent winner
  store, keyed ``(kernel, shape-bucket, device kind)``, checked in as
  ``cache.json`` (swept on the card by ``python -m
  repro_torch.launch.autotune``) so cold starts get the card's measured
  winners without re-sweeping.  Missing/corrupt caches and devices
  without entries degrade to the roofline-seeded defaults in
  :mod:`repro_torch.launch.tuning`.
* :mod:`repro_torch.kernels.autotune.tuner` — the sweep: roofline-ordered
  candidates, synced median-of-reps measurement (CUDA events on the
  card), every config verified bit-identical against the plain oracle
  before it may win.
* ``CostModelPolicy.from_autotune`` (in :mod:`repro_torch.runtime.policies`)
  consumes :meth:`AutotuneCache.entries_for`, turning measured walls into
  effective peak/bandwidth so the scheduler's roofline estimates come
  from the card's measurements instead of constants.
"""
from repro_torch.kernels.autotune.cache import (DEFAULT_CACHE_PATH,
                                                AutotuneCache, default_cache,
                                                device_kind, resolve_config,
                                                shape_bucket)
from repro_torch.kernels.autotune.tuner import (TuneResult, standard_shapes,
                                                tune, tune_into)

__all__ = [
    "DEFAULT_CACHE_PATH", "AutotuneCache", "default_cache", "device_kind",
    "resolve_config", "shape_bucket", "TuneResult", "tune", "tune_into",
    "standard_shapes",
]
