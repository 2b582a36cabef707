"""The reference's trip-count-aware HLO cost model, and why the port has
no counterpart of its parser.

The reference re-derives FLOPs, HBM traffic and collective wire bytes by
walking the scheduled, SPMD-partitioned HLO text of a compiled XLA
module, multiplying each ``while`` body by its trip count.  A CUDA
program built from PyTorch has no HLO: eager PyTorch dispatches one aten
op at a time, and every loop is a Python loop that dispatches each trip.
So the port's dry run (:mod:`repro_torch.launch.dryrun`) counts the
dispatched ops themselves, on rank 0's local shards, with the trip
counts already in them:

* FLOPs through ``torch.utils.flop_counter``'s formula for each op;
* bytes as each op's operand and result bytes, views excluded;
* collective wire bytes from the functional collectives that DTensor
  dispatches, under the reference's wire-byte rules
  (:mod:`repro_torch.launch.roofline`), and counts by op from
  ``torch.distributed.tensor.debug.CommDebugMode``.

:class:`HloCost` keeps the reference's fields, which the dry run's
record fills from those counts; :func:`analyze` raises.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict


@dataclass
class HloCost:
    flops: float = 0.0
    traffic_bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_by_op: Dict[str, float] = field(default_factory=dict)
    unknown_trip_loops: int = 0

    def scaled(self, k: float) -> "HloCost":
        return HloCost(self.flops * k, self.traffic_bytes * k,
                       self.collective_bytes * k,
                       {o: b * k for o, b in self.collective_by_op.items()},
                       self.unknown_trip_loops)

    def add(self, other: "HloCost"):
        self.flops += other.flops
        self.traffic_bytes += other.traffic_bytes
        self.collective_bytes += other.collective_bytes
        for o, b in other.collective_by_op.items():
            self.collective_by_op[o] = self.collective_by_op.get(o, 0) + b
        self.unknown_trip_loops += other.unknown_trip_loops


def analyze(hlo_text: str) -> HloCost:
    """The reference parses HLO text here; a CUDA program has none."""
    raise NotImplementedError(
        "hlo_cost.analyze reads XLA HLO, which a CUDA program does not "
        "have; the port's dry run counts the dispatched ops instead "
        "(torch.utils.flop_counter FLOPs, operand and result bytes, and "
        "the functional collectives under CommDebugMode): see "
        "repro_torch.launch.dryrun.lower_cell")
