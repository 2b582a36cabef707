"""Device-transfer accounting — the observability half of pipelined rounds.

CUDA launches are asynchronous: a round of tile kernels costs almost
nothing to *enqueue*; what serializes a mining round is every host/device
boundary crossing — a ``.cpu()`` of a device tensor blocks until the
stream drains (one sync), and every upload of host data is an H2D copy.
The planes therefore route **all** boundary crossings through a
:class:`TransferMeter`, which makes three quantities exact and
ledger-attributable per phase:

* ``h2d_bytes`` — bytes staged host → device (tile uploads, candidate
  slabs on the legacy path, fallback candidate matrices)
* ``d2h_bytes`` — bytes read back device → host (one packed count vector
  per round on the pipelined path; per-tile vectors on the legacy path)
* ``syncs``     — device→host synchronization points (each ``d2h`` is one;
  the pipelined round contract is **exactly one per counting round**)

The meter counts on a CPU device too: there "device" tensors are torch
tensors and "host" values are numpy arrays, so the same run on either
device produces the same ledger.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Union

import numpy as np
import torch


@dataclass(frozen=True)
class TransferStats:
    """A point-in-time (or delta) view of a meter's counters."""

    h2d_bytes: int = 0
    d2h_bytes: int = 0
    syncs: int = 0

    def __sub__(self, other: "TransferStats") -> "TransferStats":
        return TransferStats(self.h2d_bytes - other.h2d_bytes,
                             self.d2h_bytes - other.d2h_bytes,
                             self.syncs - other.syncs)


def _on_device(x: torch.Tensor, device: torch.device) -> bool:
    """True when ``x`` lives on ``device`` (an index-less ``cuda`` matches
    any card)."""
    return (x.device.type == device.type
            and (device.index is None or x.device.index == device.index))


class TransferMeter:
    """Counts every host/device boundary crossing routed through it.

    ``h2d`` uploads host data (numpy, or a tensor on another device) to
    the meter's device as a fresh tensor; ``d2h`` copies a tensor back to
    a fresh numpy array, counting the bytes and the sync point.
    """

    def __init__(self, device: Union[str, torch.device] = "cuda") -> None:
        self.device = torch.device(device)
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        self.syncs = 0

    # ------------------------------------------------------------------
    def h2d(self, x: Any) -> torch.Tensor:
        """Stage host data on the device as a fresh tensor, counting the
        bytes moved.  A tensor already on the device passes through
        uncounted — call sites can route every input here without
        double-billing."""
        if isinstance(x, torch.Tensor) and _on_device(x, self.device):
            return x
        src = x if isinstance(x, torch.Tensor) else torch.as_tensor(
            np.asarray(x))
        out = src.to(self.device, copy=True)
        self.h2d_bytes += int(out.nbytes)
        return out

    def d2h(self, x: Any, dtype=None) -> np.ndarray:
        """Read a device tensor back to a fresh host array: one sync + its
        bytes (after the ``dtype`` cast).  Host values pass through
        uncounted (no boundary crossed)."""
        if isinstance(x, np.ndarray):
            return x if dtype is None else np.asarray(x, dtype=dtype)
        out = np.array(x.detach().cpu().numpy(), dtype=dtype)
        self.d2h_bytes += int(out.nbytes)
        self.syncs += 1
        return out

    # ------------------------------------------------------------------
    def stats(self) -> TransferStats:
        return TransferStats(self.h2d_bytes, self.d2h_bytes, self.syncs)

    def since(self, mark: TransferStats) -> TransferStats:
        return self.stats() - mark
