"""Roofline constants of one NVIDIA H100 SXM (NVIDIA's H100 data sheet,
dense rates without sparsity, at the full 700 W power limit), and the two
rates the data sheet does not give, measured on the card.

``PEAK_FLOPS`` is the bf16 tensor-core peak, the same kind of peak the
reference's TPU roofline uses, so the algorithm cost model prices its
flop-equivalents against a like figure.  The kernel tuner's seed model
prices each support-count and rule-match variant at the rate of the unit
it runs on: ``INT8_OPS`` for the ``mxu`` kernels (int8 ``wgmma``) and
``B1_OPS`` for the ``packed`` ones (binary ``wgmma``), each call at least
``LAUNCH_FLOOR_S``.
"""
from __future__ import annotations

PEAK_FLOPS = 989e12        # bf16 dense, FLOP/s
HBM_BW = 3.35e12           # HBM3, bytes/s
INT8_OPS = 1979e12         # int8 dense tensor-core ops/s (data sheet)
# Measured, not from the data sheet: bit AND-popcount-adds a second on the
# binary tensor cores (wgmma .b1 .and.popc back to back on all 132 SMs),
# the median of three runs of tools/rule_match_packed_designs.py on an
# NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py's B1_OPS_PER_S).
B1_OPS = 7862e12
# Measured on the same card: an empty kernel queued behind others
# (torch.cuda._sleep(0), timed by chip_smoke.py; 0.0018-0.0020 ms).
LAUNCH_FLOOR_S = 1.9e-6
