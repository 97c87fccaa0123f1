"""A small LRU cache (used for the renderer's missing-cell negative cache,
reference: src/plugins/cell.rs:182-188, and anywhere a bounded recency set
is needed).

Copy of the reference's ``utils/lru.py``: ``tests/test_torch_render.py``
holds its results equal to the reference's.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Generic, Hashable, TypeVar

K = TypeVar("K", bound=Hashable)
V = TypeVar("V")


class LruCache(Generic[K, V]):
    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._data: OrderedDict[K, V] = OrderedDict()

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key: K) -> bool:
        return key in self._data

    def get(self, key: K, default=None):
        """Lookup that refreshes recency."""
        if key not in self._data:
            return default
        self._data.move_to_end(key)
        return self._data[key]

    def put(self, key: K, value: V) -> tuple[K, V] | None:
        """Insert; returns the evicted (key, value) if capacity overflowed."""
        self._data[key] = value
        self._data.move_to_end(key)
        if len(self._data) > self.capacity:
            return self._data.popitem(last=False)
        return None

    def remove(self, key: K) -> V | None:
        return self._data.pop(key, None)

    def purge(self) -> None:
        self._data.clear()

    def keys(self):
        return self._data.keys()
