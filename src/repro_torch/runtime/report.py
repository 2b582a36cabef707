"""PlaneReport — the one reporting contract every execution plane honors.

Each plane ends a run with a structured report (``PipelineReport``,
``ServingReport``, ``StreamingReport``, ``AsyncServingReport``).  They
grew independently but share load-bearing surface: a ledger slice (the
run's :class:`~repro_torch.runtime.ledger.PhaseRecord` sequence), totals derived
from it, a human ``summary()``, and a ``constraint_violations`` count.
Tools that walk reports (the benchmark harness, the CLI printers, the
system tests) should depend on this protocol, not on any one plane's
dataclass — new planes then plug in by conforming instead of by being
special-cased.

:class:`PlaneReport` is a runtime-checkable :class:`typing.Protocol`, so
conformance is structural (``isinstance(report, PlaneReport)`` checks the
surface exists) and the existing report dataclasses did not have to be
re-parented.  :class:`LedgerTotals` is the convenience mixin new reports
can inherit to derive every total from the attached ledger slice — the
single-source-of-truth rule the ledger module documents.
"""
from __future__ import annotations

from typing import Optional, Protocol, runtime_checkable

from repro_torch.runtime.ledger import ExecLedger


@runtime_checkable
class PlaneReport(Protocol):
    """Common surface of every plane's run report (structural)."""

    ledger: Optional[ExecLedger]        # this run's phase records

    def summary(self) -> str:           # human-readable multi-line account
        ...

    @property
    def total_time_s(self) -> float:    # Σ sim_time_s over the ledger slice
        ...

    @property
    def total_energy_j(self) -> float:  # Σ energy_j over the ledger slice
        ...

    @property
    def total_switches(self) -> int:    # Σ core switches over the slice
        ...

    @property
    def constraint_violations(self) -> int:   # flagged min_speed fallbacks
        ...


class LedgerTotals:
    """Mixin deriving the PlaneReport totals from ``self.ledger``.

    A report holding a ledger slice gets the totals for free and cannot
    drift from it; a ledger-less report (never ran) totals to zero.
    """

    ledger: Optional[ExecLedger] = None

    @property
    def total_time_s(self) -> float:
        return self.ledger.total_time_s if self.ledger else 0.0

    @property
    def total_energy_j(self) -> float:
        return self.ledger.total_energy_j if self.ledger else 0.0

    @property
    def total_switches(self) -> int:
        return self.ledger.total_switches if self.ledger else 0

    @property
    def total_reissued(self) -> int:
        return self.ledger.total_reissued if self.ledger else 0

    @property
    def constraint_violations(self) -> int:
        if self.ledger is None:
            return 0
        return len(self.ledger.constraint_violations())
