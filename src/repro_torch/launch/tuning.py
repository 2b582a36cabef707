"""Task-intrinsic work counts of the counting kernels, shared by the
algorithm cost model and the roofline bounds."""
from __future__ import annotations

from typing import Tuple


def shape_flops_bytes(kernel: str, shape: Tuple[int, ...]
                      ) -> Tuple[float, float]:
    """Task-intrinsic (flops, bytes) for one kernel shape — the variant-
    independent work the containment test costs, used to price a
    formulation at a kernel's effective peak/bandwidth."""
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
