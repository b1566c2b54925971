"""Small shared containers."""

from __future__ import annotations

from collections import OrderedDict


class BoundedSet:
    """Insertion-ordered set with FIFO eviction past a capacity bound.

    Used for per-process bookkeeping keyed by task/object ids (cancelled
    ids, pending cancel requests): correctness needs recent entries, and a
    hard cap keeps day-scale drivers from growing without bound."""

    def __init__(self, cap: int = 16384):
        self._d: OrderedDict = OrderedDict()
        self._cap = cap

    def add(self, key) -> None:
        self._d[key] = None
        self._d.move_to_end(key)
        while len(self._d) > self._cap:
            self._d.popitem(last=False)

    def discard(self, key) -> None:
        self._d.pop(key, None)

    def __contains__(self, key) -> bool:
        return key in self._d

    def __len__(self) -> int:
        return len(self._d)
