"""Transaction sources for the streaming plane.

:class:`TransactionStream` turns any transaction corpus (a packed 0/1
bitmap or variable-length item-id lists) into a sequence of fixed-size
micro-batches — the arrival process the :class:`StreamingMiner` consumes.

:class:`SlidingWindow` is the miner's state: the last ``capacity``
transactions, in arrival order.  ``push()`` returns the *slabs* whose
supports changed — the rows that arrived and the rows that fell out of
the window — which is exactly what delta support counting needs: support
over the window is linear in rows, so

  supp_new(c) = supp_old(c) + supp_arrived(c) - supp_evicted(c)

holds for every candidate ``c``, no matter how the window moved (this is
why a batch larger than the window is still exact: rows that arrive and
evict in the same push appear in both slabs and cancel).
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.data.baskets import pack_transactions, pad_items

Corpus = np.ndarray


class TransactionStream:
    """Micro-batch view over a transaction corpus.

    ``T`` is either a packed 0/1 bitmap ``uint8[n_tx, n_items]`` or a
    sequence of item-id transactions (packed on entry).  Iteration yields
    ``uint8[b, n_items]`` slabs of ``batch_size`` rows (the final slab may
    be short).  The stream is replayable: each ``__iter__`` starts over.
    """

    def __init__(self, T, batch_size: int,
                 n_items: Optional[int] = None):
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        if not isinstance(T, np.ndarray):
            T = pack_transactions(T, n_items)
        if T.ndim != 2:
            raise ValueError(f"corpus must be 2-D, got shape {T.shape}")
        if T.size and not ((T == 0) | (T == 1)).all():
            raise ValueError("corpus bitmap must contain only 0/1")
        self.T = T.astype(np.uint8, copy=False)
        self.batch_size = int(batch_size)

    @property
    def n_tx(self) -> int:
        return int(self.T.shape[0])

    @property
    def n_items(self) -> int:
        return int(self.T.shape[1])

    @property
    def n_batches(self) -> int:
        return -(-self.n_tx // self.batch_size) if self.n_tx else 0

    def __iter__(self) -> Iterator[np.ndarray]:
        for i in range(0, self.n_tx, self.batch_size):
            yield self.T[i:i + self.batch_size]

    def take(self, k: int) -> List[np.ndarray]:
        """The first ``k`` micro-batches (fewer if the corpus runs out)."""
        out: List[np.ndarray] = []
        for batch in self:
            if len(out) >= k:
                break
            out.append(batch)
        return out


class SlidingWindow:
    """The last ``capacity`` transactions, with arrive/evict slab deltas.

    Rows are stored lane-padded (item axis padded to 128, the kernel
    layout) so slabs and the materialized window go straight to the
    support-count data plane.  ``n_items`` is the raw item-universe width;
    every pushed batch must match it.
    """

    def __init__(self, capacity: int, n_items: int):
        if capacity <= 0:
            raise ValueError(f"window capacity must be positive: {capacity}")
        if n_items <= 0:
            raise ValueError(f"n_items must be positive: {n_items}")
        self.capacity = int(capacity)
        self.n_items = int(n_items)
        self.n_items_padded = n_items + (-n_items) % 128
        self._rows: Deque[np.ndarray] = deque()

    def __len__(self) -> int:
        return len(self._rows)

    @property
    def n(self) -> int:
        return len(self._rows)

    @property
    def full(self) -> bool:
        return len(self._rows) >= self.capacity

    # ------------------------------------------------------------------
    def push(self, batch: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Admit a micro-batch; returns ``(arrived, evicted)`` slabs.

        Both slabs are lane-padded ``uint8[b, n_items_padded]``; the
        evicted slab has zero rows until the window fills.  Rows of a
        batch larger than the window appear in both slabs (arrived then
        immediately evicted) so the delta algebra stays exact.
        """
        batch = np.asarray(batch, dtype=np.uint8)
        if batch.ndim != 2 or batch.shape[1] != self.n_items:
            raise ValueError(f"batch must be [b, {self.n_items}], got "
                             f"{batch.shape}")
        # own the rows: pad_items is a no-op when n_items is already a
        # multiple of 128, and deque rows that alias a caller buffer would
        # silently mutate the window if the caller reuses it
        arrived = pad_items(batch).copy()
        evicted_rows: List[np.ndarray] = []
        for row in arrived:
            self._rows.append(row)
            if len(self._rows) > self.capacity:
                evicted_rows.append(self._rows.popleft())
        evicted = (np.stack(evicted_rows) if evicted_rows
                   else np.zeros((0, self.n_items_padded), dtype=np.uint8))
        return arrived, evicted

    # ------------------------------------------------------------------
    def rows(self) -> np.ndarray:
        """The window contents in arrival order, lane-padded.

        This is byte-for-byte what a one-shot pipeline over "the same
        window" ingests (``ingest_baskets`` pads the same way), which is
        what the parity smoke compares against.
        """
        if not self._rows:
            return np.zeros((0, self.n_items_padded), dtype=np.uint8)
        return np.stack(list(self._rows))

    def rows_raw(self) -> np.ndarray:
        """Window contents over the raw item universe (padding sliced)."""
        return self.rows()[:, :self.n_items]
