"""Shared scheduling runtime: one MBScheduler + PowerModel + phase ledger
behind every execution plane, with pluggable static/dynamic switching
policies (paper §VI)."""
from repro_torch.runtime.donation import SlabPool, donated_add
from repro_torch.runtime.ledger import ExecLedger, PhaseRecord
from repro_torch.runtime.policies import (POLICY_NAMES, DynamicPolicy,
                                          StaticPolicy, SwitchingPolicy,
                                          resolve_policy)
from repro_torch.runtime.report import LedgerTotals, PlaneReport
from repro_torch.runtime.runtime import MeasuredPhase, Runtime, resolve_power
from repro_torch.runtime.transfers import TransferMeter, TransferStats

__all__ = [
    "POLICY_NAMES", "DynamicPolicy", "ExecLedger", "LedgerTotals",
    "MeasuredPhase", "PhaseRecord", "PlaneReport", "Runtime", "SlabPool",
    "StaticPolicy", "SwitchingPolicy", "TransferMeter", "TransferStats",
    "donated_add", "resolve_policy", "resolve_power",
]
