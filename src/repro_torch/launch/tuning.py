"""Kernel tuning seeds and task-intrinsic work counts of the counting
kernels.

``shape_flops_bytes`` is shared by the algorithm cost model, the
cost-model policy's autotune seeding and the roofline bounds.

The tuning seeds (``kernel_candidates`` / ``estimate_cost_us`` /
``default_config`` / ``seed_order``) are the config spaces the autotuner
sweeps for the mining and serving kernels and a roofline cost model over
:mod:`repro_torch.launch.roofline` that orders the sweep and supplies the
cold-cache default: when :mod:`repro_torch.kernels.autotune` has no
measurement for a (kernel, shape bucket, device kind), the argmin of the
*estimated* costs is used, so a missing or corrupt cache degrades to the
roofline-seeded default instead of erroring.

The config space is the variant alone.  The reference's candidates also
name Pallas block shapes (``bn``/``bm``/``bi``/``bb``/``br``/``bw``); a
CUDA launcher here derives its launch geometry from the call's shape
(``geometry()`` beside each kernel), so there is no tile to tune.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

from repro_torch.launch.roofline import (B1_OPS, HBM_BW, INT8_OPS,
                                         LAUNCH_FLOOR_S)

TUNABLE_KERNELS = ("support_count", "intersect_count", "rule_match")

# the implementations each kernel family can dispatch to (ops wrappers)
VARIANTS = {"support_count": ("packed", "mxu"),
            "intersect_count": ("packed",),
            "rule_match": ("packed", "mxu")}


def shape_flops_bytes(kernel: str, shape: Tuple[int, ...]
                      ) -> Tuple[float, float]:
    """Task-intrinsic (flops, bytes) for one kernel shape — the variant-
    independent work the containment test costs, used to price a
    formulation at a kernel's effective peak/bandwidth and to turn a
    measured wall into effective peak/bandwidth for CostModelPolicy
    seeding."""
    if kernel == "intersect_count":
        # one AND+popcount+add per word-pair ≙ the 2·32 bit-ops the dense
        # formulation would spend on those 32 items (64 flops per word)
        m, w = shape
        return 64.0 * m * w, float(8 * m * w + 4 * m)
    n, m, i = shape
    flops = 2.0 * n * m * i
    bytes_ = float(n * i + m * i + 4 * m + (4 * n * m
                                            if kernel == "rule_match" else 0))
    return flops, bytes_


def kernel_candidates(kernel: str, shape: Tuple[int, ...]
                      ) -> List[Dict[str, Any]]:
    """The swept config space for one kernel at one (padded) shape.

    support_count:   shape = (N, M, I) — transactions, candidates, items.
    intersect_count: shape = (M, W)    — candidate rows, packed tid words.
    rule_match:      shape = (B, R, I) — queries, rule rows, items.
    Every candidate is ``{"variant": ...}``; all compute bit-identical
    results (the tuner holds each to the oracle), so any of them is safe.
    """
    if kernel not in TUNABLE_KERNELS:
        raise ValueError(f"unknown tunable kernel {kernel!r} "
                         f"(known: {', '.join(TUNABLE_KERNELS)})")
    return [{"variant": v} for v in VARIANTS[kernel]]


def estimate_cost_us(kernel: str, shape: Tuple[int, ...],
                     config: Dict[str, Any]) -> float:
    """Roofline-seeded cost estimate (µs) of one launch of a variant.

    The larger of its operations at its unit's rate and its bytes (each
    input read once, each output written once) over HBM, plus the launch
    floor.  ``mxu`` reads int8 bitmaps and does 2·N·M·I ops on the int8
    tensor cores; ``packed`` reads 32 items a word and does N·M·I bit
    AND-popcount-adds on the binary ones.  The intersect kernel's one
    variant is priced by its bytes.
    """
    if kernel == "intersect_count":
        m, w = shape
        seconds = (8.0 * m * w + 4.0 * m) / HBM_BW
    else:
        n, m, i = shape
        out = 4.0 * n * m if kernel == "rule_match" else 4.0 * m
        if config["variant"] == "mxu":
            ops_s = 2.0 * n * m * i / INT8_OPS
            in_bytes = float(n * i + m * i)
        else:
            ops_s = float(n) * m * i / B1_OPS
            in_bytes = (n + m) * i / 8.0
        seconds = max(ops_s, (in_bytes + 4.0 * m + out) / HBM_BW)
    return (seconds + LAUNCH_FLOOR_S) * 1e6


def default_config(kernel: str, shape: Tuple[int, ...]) -> Dict[str, Any]:
    """Cold-cache fallback: argmin of the roofline estimates (no
    measurement, deterministic — ties broken by the config's repr)."""
    cands = kernel_candidates(kernel, shape)
    return min(cands, key=lambda c: (estimate_cost_us(kernel, shape, c),
                                     sorted(c.items()).__repr__()))


def seed_order(kernel: str, shape: Tuple[int, ...],
               cands: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Sweep order: cheapest estimate first, so a truncated (smoke) sweep
    still measures the configs the roofline model believes in."""
    return sorted(cands, key=lambda c: estimate_cost_us(kernel, shape, c))
