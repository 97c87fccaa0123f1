"""SortedHashMap: a hash map with O(log n) pop-by-sort-key.

Copy of the reference's ``utils/sorted_hash.py``: ``tests/test_torch_render.py``
holds its results equal to the reference's.

Capability parity with the reference's ``SortedHashMap`` (reference:
src/sorted_hash.rs:1-110) — the renderer's cell-load priority queue:

- O(1) membership / removal by hash key,
- O(log n) ``pop_first`` by (sort_key, tie-break),
- inserting an existing hash key replaces its entry (and sort position),
- duplicate sort keys are allowed (tie-broken deterministically; the
  reference uses FxHash of the key, we use a monotonic insertion counter,
  which additionally makes pop order stable and reproducible).

Implementation: dict + lazy-deletion heap (invalid entries are skipped at
pop time), the standard Python equivalent of the BTreeSet+HashMap pair.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Any, Generic, Hashable, TypeVar

K = TypeVar("K", bound=Hashable)
SK = TypeVar("SK")
V = TypeVar("V")


@dataclass
class SortedEntry(Generic[K, SK, V]):
    hash_key: K
    sort_key: SK
    value: V


class SortedHashMap(Generic[K, SK, V]):
    def __init__(self):
        self._entries: dict[K, tuple[Any, SortedEntry[K, SK, V]]] = {}
        self._heap: list[tuple[Any, int, K, SortedEntry[K, SK, V]]] = []
        self._counter = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, hash_key: K) -> bool:
        return hash_key in self._entries

    def is_empty(self) -> bool:
        return not self._entries

    def insert(self, hash_key: K, sort_key: SK, value: V) -> None:
        """Insert or replace (replacement updates the sort position,
        sorted_hash.rs:61-77)."""
        entry = SortedEntry(hash_key, sort_key, value)
        token = (sort_key, self._counter)
        self._counter += 1
        self._entries[hash_key] = (token, entry)
        heapq.heappush(self._heap, (token, hash_key, entry))

    def get(self, hash_key: K) -> SortedEntry[K, SK, V] | None:
        item = self._entries.get(hash_key)
        return item[1] if item is not None else None

    def remove(self, hash_key: K) -> SortedEntry[K, SK, V] | None:
        """O(1) removal by hash key (lazy heap deletion)."""
        item = self._entries.pop(hash_key, None)
        return item[1] if item is not None else None

    def pop_first(self) -> SortedEntry[K, SK, V] | None:
        """Remove and return the entry with the smallest sort key."""
        while self._heap:
            token, hash_key, entry = heapq.heappop(self._heap)
            live = self._entries.get(hash_key)
            if live is not None and live[0] == token:
                del self._entries[hash_key]
                return entry
        return None

    def clear(self) -> None:
        self._entries.clear()
        self._heap.clear()
        self._counter = 0
