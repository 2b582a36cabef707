"""LRU result cache for the serving engine.

Keys are canonicalized basket bitmaps (packed bits over the *true* item
universe, so lane padding and input form — id list vs 0/1 row — cannot
split one logical basket across entries).  Values are the final filtered
recommendation lists, so a hit skips the kernel entirely.

Hit/miss counters are cumulative for the cache's lifetime; the engine
reports per-``serve`` deltas.  ``maxsize=0`` disables caching (every
lookup is a miss), which is the "cache off" arm of a serving comparison.
The engine clears the cache on index ``refresh()`` — entries computed
against a stale index must never be served.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import List, Optional, Tuple

import numpy as np

Recommendation = List[Tuple[int, float]]


def basket_key(bits: np.ndarray) -> bytes:
    """Canonical cache key for a 0/1 basket vector over the true items."""
    return np.packbits(np.asarray(bits, dtype=np.uint8)).tobytes()


class ResultCache:
    def __init__(self, maxsize: int = 4096):
        if maxsize < 0:
            raise ValueError(f"maxsize must be >= 0, got {maxsize}")
        self.maxsize = maxsize
        self.hits = 0
        self.misses = 0
        self._entries: "OrderedDict[bytes, Recommendation]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key: bytes) -> Optional[Recommendation]:
        if self.maxsize and key in self._entries:
            self._entries.move_to_end(key)
            self.hits += 1
            # copy out: a caller mutating its result must not corrupt the
            # entry every later hit would see
            return list(self._entries[key])
        self.misses += 1
        return None

    def put(self, key: bytes, value: Recommendation) -> None:
        if not self.maxsize:
            return
        self._entries[key] = value
        self._entries.move_to_end(key)
        while len(self._entries) > self.maxsize:
            self._entries.popitem(last=False)

    def clear(self) -> None:
        """Drop all entries (index refresh); counters keep accumulating."""
        self._entries.clear()
