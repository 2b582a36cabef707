"""The autotune winner cache — ``(kernel, shape-bucket, device kind)`` →
measured best config.

Key scheme
----------
``kernel|bucket|device``, e.g.
``support_count|n4096_m4096_i1024|NVIDIA_H100_80GB_HBM3``:

* *kernel* — ``support_count`` | ``intersect_count`` | ``rule_match``.
* *bucket* — every (padded) call shape rounded up per-dimension to the
  next power of two, so the cache stays O(log) in each axis while the
  planes' pad-to-bucket shape discipline keeps real calls near their
  bucket corner.
* *device* — :func:`device_kind` of the device the kernel ran on (the
  card's name, spaces → ``_``): winners are a per-silicon property, so a
  cache tuned on one device kind never configures another — lookups for
  an unknown device fall through to the roofline-seeded defaults.

Entries store the exact shape they were tuned at, the winning config,
its measured cost, and the full sweep (for audit).  ``lookup`` falls back
to the *nearest* cached bucket (log-scale distance, deterministic
tie-break) for the same kernel+device before giving up — a lattice sweep
then covers every in-between shape.

Degradation contract: a missing or corrupt cache file loads as an empty
cache (the parse error is kept on ``load_error``, never raised), and an
empty lookup returns ``None`` — callers then use
:func:`repro_torch.launch.tuning.default_config`, the roofline-seeded
default.

Wherever a ``device`` is taken it may be a ``torch.device``, a device
string (``"cuda"``, ``"cuda:0"``, ``"cpu"``) or a device-kind token;
``None`` is the card, where the port's entry points run by default.
"""
from __future__ import annotations

import functools
import json
import os
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

DEFAULT_CACHE_PATH = os.path.join(os.path.dirname(__file__), "cache.json")

_DIM_NAMES = {
    "support_count": ("n", "m", "i"),
    "intersect_count": ("m", "w"),
    "rule_match": ("b", "r", "i"),
}

DeviceLike = Union[torch.device, str, None]

# what a device string looks like ("cpu", "cuda", "cuda:0"); any other
# string is taken for a device-kind token
_DEVICE_STRING = re.compile(r"[a-z]+(:\d+)?")


@functools.cache
def _cuda_name(index: int) -> str:
    return torch.cuda.get_device_name(index)


def device_kind(device: DeviceLike = None) -> str:
    """Canonical device-kind token for cache keys: a CUDA device's name
    with spaces made ``_`` (e.g. ``NVIDIA_H100_80GB_HBM3``), ``"cpu"``
    for the CPU, and a token that names no device passed through.  Raises
    ``RuntimeError`` for a CUDA device where none is available."""
    if device is None:
        device = "cuda"
    if isinstance(device, str):
        if not _DEVICE_STRING.fullmatch(device):
            return device                     # already a device-kind token
        device = torch.device(device)
    if device.type == "cpu":
        return "cpu"
    if device.type != "cuda":
        raise ValueError(f"no device kind for {device}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device is available for {device}")
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return _cuda_name(index).replace(" ", "_")


def _pow2_ceil(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length() if x > 1 else 1


def shape_bucket(kernel: str, shape: Tuple[int, ...]) -> str:
    names = _DIM_NAMES.get(kernel)
    if names is None or len(shape) != len(names):
        raise ValueError(f"unknown kernel/shape: {kernel} {shape}")
    return "_".join(f"{n}{_pow2_ceil(d)}" for n, d in zip(names, shape))


def _bucket_dims(bucket: str) -> List[int]:
    return [int(part[1:]) for part in bucket.split("_")]


@dataclass
class AutotuneCache:
    """In-memory view of one cache file (see module docstring)."""

    entries: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    path: Optional[str] = None
    load_error: Optional[str] = None
    # lookup's answer per (kernel, bucket, device kind): the ops wrappers
    # resolve at every launch; put() clears it
    _found: Dict[Tuple[str, str, str], Optional[Dict[str, Any]]] = field(
        default_factory=dict, init=False, repr=False, compare=False)

    # ------------------------------------------------------------------
    @classmethod
    def load(cls, path: str = DEFAULT_CACHE_PATH) -> "AutotuneCache":
        """Read a cache file; missing/corrupt files load empty, with the
        reason on ``load_error`` — autotuning must never take a plane
        down, it can only make it faster."""
        try:
            with open(path) as f:
                data = json.load(f)
            entries = data["entries"]
            if not isinstance(entries, dict):
                raise TypeError("entries must be an object")
            for key, ent in entries.items():
                if "config" not in ent or "cost_us" not in ent:
                    raise KeyError(f"entry {key!r} missing config/cost_us")
            return cls(entries=dict(entries), path=path)
        except FileNotFoundError as e:
            return cls(path=path, load_error=str(e))
        except (json.JSONDecodeError, KeyError, TypeError, ValueError) as e:
            return cls(path=path, load_error=f"corrupt cache {path}: {e}")

    def save(self, path: Optional[str] = None) -> str:
        path = path or self.path or DEFAULT_CACHE_PATH
        payload = {
            "meta": {
                "note": "autotuned kernel configs; key = "
                        "kernel|shape-bucket|device_kind",
                "refresh": "python -m repro_torch.launch.autotune",
            },
            "entries": {k: self.entries[k] for k in sorted(self.entries)},
        }
        with open(path, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
            f.write("\n")
        self.path = path
        return path

    # ------------------------------------------------------------------
    @staticmethod
    def key(kernel: str, shape: Tuple[int, ...],
            device: DeviceLike = None) -> str:
        return f"{kernel}|{shape_bucket(kernel, shape)}|" \
               f"{device_kind(device)}"

    def put(self, kernel: str, shape: Tuple[int, ...],
            config: Dict[str, Any], cost_us: float,
            swept: Optional[List[Dict[str, Any]]] = None,
            device: DeviceLike = None) -> str:
        key = self.key(kernel, shape, device)
        self._found.clear()
        self.entries[key] = {
            "shape": [int(d) for d in shape],
            "config": dict(config),
            "cost_us": round(float(cost_us), 3),
            "source": "measured",
            "swept": swept or [],
        }
        return key

    # ------------------------------------------------------------------
    def lookup(self, kernel: str, shape: Tuple[int, ...],
               device: DeviceLike = None) -> Optional[Dict[str, Any]]:
        """Best known entry for this call shape: exact bucket, else the
        nearest cached bucket (same kernel+device) by log2 distance."""
        kind, bucket = device_kind(device), shape_bucket(kernel, shape)
        memo = (kernel, bucket, kind)
        if memo in self._found:
            return self._found[memo]
        found = self.entries.get(f"{kernel}|{bucket}|{kind}")
        if found is None:
            want = _bucket_dims(bucket)
            prefix, suffix = f"{kernel}|", f"|{kind}"
            best_key, best_dist = None, None
            for key in sorted(self.entries):
                if not (key.startswith(prefix) and key.endswith(suffix)):
                    continue
                dims = _bucket_dims(key.split("|")[1])
                dist = sum(abs(a.bit_length() - b.bit_length())
                           for a, b in zip(dims, want))
                if best_dist is None or dist < best_dist:
                    best_key, best_dist = key, dist
            found = self.entries.get(best_key) if best_key else None
        self._found[memo] = found
        return found

    def entries_for(self, kernel: str, device: DeviceLike = None
                    ) -> List[Dict[str, Any]]:
        prefix, suffix = f"{kernel}|", f"|{device_kind(device)}"
        return [self.entries[k] for k in sorted(self.entries)
                if k.startswith(prefix) and k.endswith(suffix)]

    def has_kernel(self, kernel: str, device: DeviceLike = None) -> bool:
        return bool(self.entries_for(kernel, device))

    def __len__(self) -> int:
        return len(self.entries)


# ---------------------------------------------------------------------------
# module-level default (the checked-in cache) + the ops-facing resolver
# ---------------------------------------------------------------------------

_default: Optional[AutotuneCache] = None


def default_cache(reload: bool = False) -> AutotuneCache:
    global _default
    if _default is None or reload:
        _default = AutotuneCache.load(DEFAULT_CACHE_PATH)
    return _default


def resolve_config(kernel: str, shape: Tuple[int, ...],
                   tuning: Any = None,
                   device: DeviceLike = None) -> Dict[str, Any]:
    """The single dispatch point the ops wrappers call per kernel launch.

    ``tuning`` selects the source of the config:
      * ``None``  — the checked-in default cache (autotuning ON);
      * ``False`` — autotuning OFF: the roofline-seeded default config;
      * a ``dict`` — an explicit config (a pin: tests, the tuner, the
        planes' ``tuning`` field);
      * an :class:`AutotuneCache` — that cache (tuner round-trips, smoke
        sweeps writing to a scratch path).

    ``device`` is the one the call runs on.  Cache misses — including
    cold/corrupt caches and unknown device kinds — fall back to
    :func:`repro_torch.launch.tuning.default_config`.
    """
    from repro_torch.launch.tuning import default_config
    if isinstance(tuning, dict):
        return dict(tuning)
    if tuning is False:
        return default_config(kernel, shape)
    cache = tuning if isinstance(tuning, AutotuneCache) else default_cache()
    entry = cache.lookup(kernel, shape, device)
    if entry is not None:
        return dict(entry["config"])
    return default_config(kernel, shape)


def plane_tuning(pin: Optional[dict], autotune: bool) -> Any:
    """What a plane hands its kernel wrapper as ``tuning``: its pinned
    config where it has one, else the default cache (``None``) with
    autotuning on or the roofline-seeded default (``False``) with it off."""
    if pin is not None:
        return pin
    return None if autotune else False
