"""Roofline constants of one NVIDIA H100 SXM (NVIDIA's H100 data sheet,
dense rates without sparsity, at the full 700 W power limit).

``PEAK_FLOPS`` is the bf16 tensor-core peak, the same kind of peak the
reference's TPU roofline uses, so the algorithm cost model prices its
flop-equivalents against a like figure.
"""
from __future__ import annotations

PEAK_FLOPS = 989e12        # bf16 dense, FLOP/s
HBM_BW = 3.35e12           # HBM3, bytes/s
