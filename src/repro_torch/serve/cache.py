"""Capacity-bounded LRU caches for the serving subsystem.

The counterpart of ``repro/serve/cache.py`` (pure Python, the same
code).  Two cache populations share this one implementation:

* **warm answers** — per-family ``source → x*`` solutions (tensors on
  the family's device), repaired in place by updates
  (:func:`repro_torch.serve.family.apply_updates`);
* **compiled runners** — ``(plan.signature, backend, B-bucket, D) →
  run fn``; a server that sees many (family, bucket) shapes over its
  lifetime sheds the cold ones.

Eviction is strict LRU on *access* (a hit refreshes recency); ``hits`` /
``misses`` / ``evictions`` counters feed ``server.stats()``.  Capacity 0
disables the cache entirely (every get misses, puts are dropped) —
benchmarks use that to force cold compute.
"""

from __future__ import annotations

import collections
from typing import Any, Hashable, Iterator


class LRUCache:
    """An ordered-dict LRU with hit/miss/eviction counters."""

    def __init__(self, capacity: int):
        if capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {capacity}")
        self.capacity = capacity
        self._data: collections.OrderedDict = collections.OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._data

    def __iter__(self) -> Iterator:
        return iter(self._data)

    def get(self, key: Hashable, default: Any = None) -> Any:
        """Counted, recency-refreshing lookup."""
        if key in self._data:
            self._data.move_to_end(key)
            self.hits += 1
            return self._data[key]
        self.misses += 1
        return default

    def peek(self, key: Hashable, default: Any = None) -> Any:
        """Uncounted lookup that leaves recency untouched (for
        invariants/tests, never the serving hot path)."""
        return self._data.get(key, default)

    def put(self, key: Hashable, value: Any) -> None:
        if self.capacity == 0:
            return
        if key in self._data:
            self._data.move_to_end(key)
        self._data[key] = value
        while len(self._data) > self.capacity:
            self._data.popitem(last=False)
            self.evictions += 1

    def pop(self, key: Hashable, default: Any = None) -> Any:
        return self._data.pop(key, default)

    def clear(self) -> int:
        """Drop everything (delete-update invalidation); returns how many
        entries were dropped."""
        n = len(self._data)
        self._data.clear()
        return n

    def items(self):
        return self._data.items()

    def keys(self):
        return self._data.keys()

    def replace(self, key: Hashable, value: Any) -> None:
        """In-place value repair that does NOT touch recency or counters
        (warm-answer repair must not look like serving traffic)."""
        if key in self._data:
            self._data[key] = value
