"""Generic asset manager: async loads, refcounted handles, eviction.

Copy of the reference's ``utils/assets.py``: ``tests/test_torch_viewer.py``
holds its results equal to the reference's.

Capability parity with the reference's asset plugin (reference:
src/plugins/asset.rs:17-676), re-designed without an ECS:

- ``load(id, source)`` deduplicates in-flight loads (asset.rs:496-506) and
  parses on the thread pool; completions surface as ``AssetEvent``s from
  ``poll_events`` (the PreUpdate ``handle_loaded_events`` equivalent,
  asset.rs:519-576) and resolve futures returned to direct callers,
- ``AssetHandle`` refcounts by construction/release; when the last handle
  drops, the entry evicts — saving first if it is dirty and auto-save is
  on (asset.rs:594-637),
- ``get_mut`` marks assets changed; ``save_all`` writes every dirty asset
  (asset.rs:284-304, 372-391),
- ``insert`` covers the in-app converter's Created/Changed path
  (cells built in memory, then saved once a directory is chosen).

Asset types plug in with two callables (``parse`` bytes -> asset,
``serialize`` asset -> bytes), the duck-typed equivalent of the ``Asset``
trait (asset.rs:57-65).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Generic, Hashable, TypeVar

from .source import NoSource, Source
from .thread_pool import ThreadPool

Id = TypeVar("Id", bound=Hashable)
T = TypeVar("T")


class AssetEventKind(Enum):
    LOADED = "loaded"
    ERROR = "error"
    CREATED = "created"
    CHANGED = "changed"
    EVICTED = "evicted"


@dataclass
class AssetEvent(Generic[Id]):
    kind: AssetEventKind
    id: Id
    error: Exception | None = None


@dataclass
class _Entry(Generic[T]):
    asset: T
    source: Source
    refcount: int = 0
    is_saved: bool = True


class AssetHandle(Generic[Id]):
    """Refcounting guard; release on drop or explicitly."""

    def __init__(self, manager: "AssetManager", asset_id: Id):
        self._manager = manager
        self.id = asset_id
        self._released = False
        manager._increase(asset_id)

    def clone(self) -> "AssetHandle[Id]":
        return AssetHandle(self._manager, self.id)

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._manager._decrease(self.id)

    def __del__(self):
        try:
            self.release()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()


class AssetManager(Generic[Id, T]):
    def __init__(
        self,
        parse: Callable[[bytes], T],
        serialize: Callable[[T], bytes] | None = None,
        pool: ThreadPool | None = None,
        auto_save: bool = False,
    ):
        self.parse = parse
        self.serialize = serialize
        self.auto_save = auto_save
        self._pool = pool or ThreadPool(2)  # ThreadPoolPlugin size 2
        self._own_pool = pool is None
        self._lock = threading.Lock()
        self._entries: dict[Id, _Entry[T]] = {}
        self._loading: set[Id] = set()
        self._events: list[AssetEvent[Id]] = []
        self._completions: list[tuple[Id, T | None, Source, Exception | None]] = []
        # signalled by loader threads when a completion lands; the frame
        # loop blocks on it instead of a hand-tuned sleep yield (a
        # zero-delay update loop would otherwise starve the pool threads
        # of GIL time and loads would never complete)
        self._completion_event = threading.Event()

    # --- load pipeline (asset.rs:448-576) ------------------------------------

    def load(self, asset_id: Id, source: Source) -> None:
        """Request an async load; duplicate in-flight requests coalesce."""
        with self._lock:
            if asset_id in self._entries or asset_id in self._loading:
                return
            self._loading.add(asset_id)

        def job():
            try:
                data = source.load()
                asset = self.parse(data)
                error = None
            except Exception as err:  # noqa: BLE001 — surfaced as event
                asset, error = None, err
            with self._lock:
                self._completions.append((asset_id, asset, source, error))
                self._completion_event.set()

        self._pool.execute(job)

    def has_completions(self) -> bool:
        """True if finished loads await :meth:`poll_events` (cheap probe;
        callers may yield the GIL when loads are in flight but nothing has
        completed — see viewer/app.py update step 2)."""
        return bool(self._completions)

    def wait_for_completion(self, timeout: float) -> bool:
        """Block until a load completes (or ``timeout`` seconds elapse).

        Returns True if a completion is pending. The event is set by the
        loader threads under the manager lock and cleared by
        :meth:`poll_events` once the queue drains, so the wait wakes
        exactly when work lands — no timing-tuned yields. The timeout is
        a liveness bound (e.g. a load tracked by the caller but issued to
        a different manager), not a tuning knob.
        """
        return self._completion_event.wait(timeout)

    def poll_events(self) -> list[AssetEvent[Id]]:
        """Drain completions into stored assets + events (call per frame)."""
        with self._lock:
            completions = self._completions
            self._completions = []
            self._completion_event.clear()
            for asset_id, asset, source, error in completions:
                self._loading.discard(asset_id)
                if error is None:
                    self._entries[asset_id] = _Entry(asset, source)
                    self._events.append(
                        AssetEvent(AssetEventKind.LOADED, asset_id)
                    )
                else:
                    self._events.append(
                        AssetEvent(AssetEventKind.ERROR, asset_id, error)
                    )
            events = self._events
            self._events = []
            return events

    def load_blocking(self, asset_id: Id, source: Source) -> T:
        """Synchronous load (the reply_sender path, asset.rs:560-567)."""
        with self._lock:
            entry = self._entries.get(asset_id)
            if entry is not None:
                return entry.asset
        data = source.load()
        asset = self.parse(data)
        with self._lock:
            self._loading.discard(asset_id)
            self._entries[asset_id] = _Entry(asset, source)
            self._events.append(AssetEvent(AssetEventKind.LOADED, asset_id))
        return asset

    # --- direct insertion (converter-created assets, asset.rs:330-357) -------

    def insert(self, asset_id: Id, asset: T, source: Source | None = None,
               saved: bool = False) -> AssetHandle[Id]:
        with self._lock:
            self._entries[asset_id] = _Entry(
                asset, source if source is not None else NoSource(),
                is_saved=saved,
            )
            self._events.append(AssetEvent(AssetEventKind.CREATED, asset_id))
        return AssetHandle(self, asset_id)

    # --- access ----------------------------------------------------------------

    def __contains__(self, asset_id: Id) -> bool:
        with self._lock:
            return asset_id in self._entries

    def is_loading(self, asset_id: Id) -> bool:
        with self._lock:
            return asset_id in self._loading

    def get(self, asset_id: Id) -> T | None:
        with self._lock:
            entry = self._entries.get(asset_id)
            return entry.asset if entry else None

    def get_handle(self, asset_id: Id) -> AssetHandle[Id] | None:
        with self._lock:
            if asset_id not in self._entries:
                return None
        return AssetHandle(self, asset_id)

    def get_mut(self, asset_id: Id) -> T | None:
        """Access for mutation: marks dirty + queues Changed (asset.rs:284-304)."""
        with self._lock:
            entry = self._entries.get(asset_id)
            if entry is None:
                return None
            entry.is_saved = False
            self._events.append(AssetEvent(AssetEventKind.CHANGED, asset_id))
            return entry.asset

    def set_source(self, asset_id: Id, source: Source) -> None:
        """Re-point an asset (the converter's "save at" flow rewrites all
        sources, src/plugins/converter.rs:641-721)."""
        with self._lock:
            entry = self._entries.get(asset_id)
            if entry is not None:
                entry.source = source
                entry.is_saved = False

    # --- persistence (asset.rs:372-391) -----------------------------------------

    def _save_entry(self, entry: _Entry[T]) -> None:
        if self.serialize is None:
            raise RuntimeError("asset type has no serializer")
        entry.source.save(self.serialize(entry.asset))
        entry.is_saved = True

    def save_all(self) -> int:
        """Write every dirty asset; returns the count written."""
        written = 0
        with self._lock:
            for entry in self._entries.values():
                if not entry.is_saved and not isinstance(entry.source, NoSource):
                    self._save_entry(entry)
                    written += 1
        return written

    # --- refcounting / eviction (asset.rs:594-637) -------------------------------

    def _increase(self, asset_id: Id) -> None:
        with self._lock:
            entry = self._entries.get(asset_id)
            if entry is not None:
                entry.refcount += 1

    def _decrease(self, asset_id: Id) -> None:
        with self._lock:
            entry = self._entries.get(asset_id)
            if entry is None:
                return
            entry.refcount -= 1
            if entry.refcount <= 0:
                if (
                    self.auto_save
                    and not entry.is_saved
                    and not isinstance(entry.source, NoSource)
                ):
                    self._save_entry(entry)
                del self._entries[asset_id]
                self._events.append(
                    AssetEvent(AssetEventKind.EVICTED, asset_id)
                )

    def close(self) -> None:
        if self._own_pool:
            self._pool.close()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
