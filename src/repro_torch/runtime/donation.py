"""Round-persistent count slabs, updated in place.

The reference donates its accumulator buffers to XLA so each tile's
partial counts fold into the same allocation.  PyTorch runs eagerly and
lets the port say so directly: :func:`donated_add` adds in place into the
accumulator, and :class:`SlabPool` hands the same zeroed slab back to the
next round whose bucket shape repeats — the common case under
``m_bucket`` rounding, where consecutive Apriori levels share a padded
candidate shape.
"""
from __future__ import annotations

from typing import Dict, Tuple, Union

import torch


def donated_add(acc: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The round accumulator combiner: ``acc`` is dead after the add, so
    the running sum is written into it (``acc.add_(x)``).  Nothing here
    synchronizes, so all tile kernels of a round enqueue eagerly."""
    return acc.add_(x)


class SlabPool:
    """Round-persistent device slabs keyed by bucket shape.

    ``take(shape, dtype)`` returns a zeroed slab, reusing (``zero_()``)
    the previous round's buffer when the bucket shape repeats.
    """

    def __init__(self, device: Union[str, torch.device]) -> None:
        self.device = torch.device(device)
        self._slabs: Dict[Tuple[Tuple[int, ...], torch.dtype],
                          torch.Tensor] = {}

    def take(self, shape: Tuple[int, ...], dtype: torch.dtype
             ) -> torch.Tensor:
        slab = self._slabs.pop((tuple(shape), dtype), None)
        if slab is None:
            return torch.zeros(shape, dtype=dtype, device=self.device)
        return slab.zero_()

    def give(self, slab: torch.Tensor) -> None:
        """Return a slab to the pool once the round no longer reads it."""
        self._slabs[(tuple(slab.shape), slab.dtype)] = slab
