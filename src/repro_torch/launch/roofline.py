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

The dry run's roofline terms (``derive_terms``), per device:

  compute_s    = FLOPs_per_device / PEAK_FLOPS
  memory_s     = bytes_per_device / HBM_BW
  collective_s = collective_bytes_per_device / LINK_BW

The counted collective bytes are what one device sends or receives on
the wire, by the reference's rules (its ``parse_collectives``, which
reads them from HLO text; the port's dry run counts the functional
collectives that DTensor dispatches and applies the same rules):

  all-gather          → result bytes (what a device receives)
  all-reduce          → 2 × result bytes (ring: reduce-scatter + all-gather)
  reduce-scatter      → result bytes × group size (what a device sends)
  all-to-all          → result bytes
  collective-permute  → result bytes

``LINK_BW`` is one NVLink 4 direction of an H100 SXM (450 GB/s, half the
data sheet's 900 GB/s).  A mesh axis wider than the 8 GPUs of one node
crosses nodes over InfiniBand, at about 50 GB/s a GPU; this one rate
ignores that, as the reference's one ICI rate ignores its own topology.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

PEAK_FLOPS = 989e12        # bf16 dense, FLOP/s
HBM_BW = 3.35e12           # HBM3, bytes/s
LINK_BW = 450e9            # NVLink 4, one direction, bytes/s
INT8_OPS = 1979e12         # int8 dense tensor-core ops/s (data sheet)
# Measured, not from the data sheet: bit AND-popcount-adds a second on the
# binary tensor cores (wgmma .b1 .and.popc back to back on all 132 SMs),
# the median of three runs of tools/rule_match_packed_designs.py on an
# NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py's B1_OPS_PER_S).
B1_OPS = 7862e12
# Measured on the same card: an empty kernel queued behind others
# (torch.cuda._sleep(0), timed by chip_smoke.py; 0.0018-0.0020 ms).
LAUNCH_FLOOR_S = 1.9e-6


@dataclass
class CollectiveStats:
    bytes_by_op: Dict[str, int] = field(default_factory=dict)
    count_by_op: Dict[str, int] = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_op.values())


@dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_device: float
    bytes_per_device: float
    collective_bytes: int
    model_flops: float
    useful_ratio: float                  # MODEL_FLOPS / (FLOPs × chips)
    dominant: str = ""

    def __post_init__(self):
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        self.dominant = max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the step bound spent on *useful* model math at peak:
        (MODEL_FLOPS / chips / PEAK) / max(term)."""
        if self.bound_s <= 0:
            return 0.0
        return (self.model_flops / PEAK_FLOPS) / self.bound_s


def derive_terms(cost: Dict[str, float], coll: CollectiveStats, chips: int,
                 model_flops_global: float) -> RooflineTerms:
    """``cost`` holds per-device ``flops`` and ``bytes accessed``."""
    flops_pd = float(cost.get("flops", 0.0))
    bytes_pd = float(cost.get("bytes accessed", 0.0))
    cbytes = coll.total_bytes
    model_pd = model_flops_global / chips
    return RooflineTerms(
        compute_s=flops_pd / PEAK_FLOPS,
        memory_s=bytes_pd / HBM_BW,
        collective_s=cbytes / LINK_BW,
        flops_per_device=flops_pd,
        bytes_per_device=bytes_pd,
        collective_bytes=cbytes,
        model_flops=model_pd,
        useful_ratio=(model_pd / flops_pd) if flops_pd else 0.0,
    )


def model_flops_for(cfg, shape, n_params_active: int, kind: str) -> float:
    """6·N·D for training, 2·N·D for inference (fwd only)."""
    tokens = shape.global_batch * (shape.seq_len if kind != "decode" else 1)
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_params_active * tokens
