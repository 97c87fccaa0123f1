"""The converter: point batches -> multi-hierarchy cell store.

Copy of the reference's ``convert/converter.py``: ``tests/test_torch_host.py``
holds its results equal to the reference's.

Capability parity with the reference's ``Converter``
(reference: point-converter/src/converter.rs:72-246):

- batches extend the store bounding box (the first points replace the
  default box, converter.rs:96-104) and the point counter,
- points group into hierarchy-0 cells, then cascade: each touched cell
  dedups its points on the hex sub-grid, losers stage in the cell's
  overflow buffers, and flushed buffers feed the next-finer hierarchy
  (converter.rs:114-139),
- cells live in a save-on-evict LRU cache backed by the on-disk store
  (converter.rs:160-207); closing the converter flushes cache + metadata
  (converter.rs:241-246),
- running against an output directory that already holds a store loads its
  ``metadata.json`` and merges the new points in (lib.rs:86-101).

TPU-first redesign vs the reference: per-point HashMap inserts become
vectorized batch passes (``Cell.add_points`` does one sort + segmented
argmin); grouping is one lexsort per hierarchy; and the per-batch group
processing order is canonical (sorted by cell index) instead of hash-map
iteration order, making stores deterministic. The cache default is larger
than the reference's 100 (cache size only affects disk traffic, not
results, because cells round-trip losslessly through the codec).
"""

from __future__ import annotations

import logging
import time
from collections import OrderedDict
from pathlib import Path

import numpy as np

from ..core.aabb import Aabb
from ..core.cell import Cell, CellId
from ..core.metadata import FILE_NAME, EXTENSION, Metadata, MetadataConfig, hierarchy_string
from ..core.point import PointBatch
from .pipeline import group_points_host, merge_point_maps

log = logging.getLogger(__name__)

DEFAULT_BATCH_SIZE = 10_000  # lib.rs:32
# The reference keeps 100 cells in RAM (converter.rs:92) because it targets
# desktop heaps; deep hierarchies of dense clouds touch thousands of cells
# per batch and an undersized cache turns into load/evict churn. Cells are
# compact (SoA arrays), so default to a large cache and let users shrink it.
DEFAULT_CACHE_SIZE = 65_536


def update_metadata_bounding_box(metadata: Metadata, batch: PointBatch) -> None:
    """Fold a batch into the metadata bbox (converter.rs:96-104): the first
    points replace the default box, later batches extend it. The f32 fold
    order is parity-sensitive (metadata.json byte compatibility) — every
    converter backend must share this one implementation."""
    aabb = Aabb.from_points(batch.positions)
    if aabb is None:
        return
    if metadata.number_of_points == 0:
        metadata.bounding_box = aabb
    else:
        metadata.bounding_box.extend_aabb(aabb)


def add_points_to_cell(
    config: MetadataConfig, batch: PointBatch, cell: Cell
) -> dict[tuple[int, int, int], PointBatch]:
    """Dedup a batch into ``cell``; return groups flushed to the next
    hierarchy (converter.rs:62-70)."""
    losers = cell.add_points(batch)
    grouped = group_points_host(losers, cell.id.hierarchy + 1, config)
    return cell.add_points_in_overflow(grouped, config)


class CellCache:
    """LRU cell cache; evictions write back to the store directory.

    With a ``writer`` (native/), write-back is asynchronous on C++ worker
    threads; ``flush_path`` is the read barrier for cells that may still
    be in flight (evicted, then missed again before the write landed).

    **Pinning**: a converter level that holds direct references to cells
    while mutating them (the device cascade collects every touched cell
    up front, then merges on worker threads) must pin them; a pinned cell
    is never evicted, so the cache can't write pre-merge bytes to disk and
    then reload that stale copy over the mutated object. Unpinning evicts
    any excess accumulated while pins held entries over capacity.
    """

    def __init__(self, working_directory: Path,
                 capacity: int = DEFAULT_CACHE_SIZE, writer=None):
        self.working_directory = Path(working_directory)
        # floor at 1: with capacity 0 a freshly loaded cell would evict
        # (and save) BEFORE the caller's mutation, and the next get would
        # reload the stale bytes — the same lost-update class the pin
        # mechanism guards against. One resident cell is the minimum for
        # the get-then-mutate contract.
        self.capacity = max(1, capacity)
        self.writer = writer
        self._inflight: set[str] = set()
        self._cells: OrderedDict[CellId, Cell] = OrderedDict()
        import threading

        self._pins: dict[CellId, int] = {}
        self._pin_lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._cells)

    def __contains__(self, cell_id: CellId) -> bool:
        return cell_id in self._cells

    def get(self, cell_id: CellId, pin: bool = False) -> Cell | None:
        cell = self._cells.get(cell_id)
        if cell is not None:
            self._cells.move_to_end(cell_id)
            if pin:
                self.pin(cell_id)
        return cell

    def put(self, cell: Cell, pin: bool = False) -> None:
        self._cells[cell.id] = cell
        self._cells.move_to_end(cell.id)
        if pin:
            self.pin(cell.id)
        self._evict_over_capacity()

    def pin(self, cell_id: CellId) -> None:
        with self._pin_lock:
            self._pins[cell_id] = self._pins.get(cell_id, 0) + 1

    def unpin(self, cell_ids) -> None:
        """Release pins; caller must serialize with get/put (the converter's
        shared lock) because excess entries may evict here."""
        with self._pin_lock:
            for cell_id in cell_ids:
                n = self._pins.get(cell_id, 0) - 1
                if n <= 0:
                    self._pins.pop(cell_id, None)
                else:
                    self._pins[cell_id] = n
        self._evict_over_capacity()

    def _evict_over_capacity(self) -> None:
        # pinned entries requeue at the MRU end (they are hot by
        # definition); len - skipped strictly decreases, so this
        # terminates even when pins alone exceed capacity
        skipped = 0
        while len(self._cells) - skipped > self.capacity:
            cell_id, cell = self._cells.popitem(last=False)
            if self._pins.get(cell_id):
                self._cells[cell_id] = cell
                skipped += 1
                continue
            self.save_cell(cell)

    def save_cell(self, cell: Cell) -> None:
        path = self.working_directory / cell.id.path()
        if self.writer is not None:
            key = str(path)
            if key in self._inflight:
                self.flush()  # keep per-path write order
            self.writer.submit(path, cell.to_bytes())
            self._inflight.add(key)
        else:
            cell.write_to_path(path)

    def flush_path(self, path) -> None:
        """Barrier before reading ``path`` if an async write is queued."""
        if self.writer is not None and str(path) in self._inflight:
            self.flush()

    def flush(self) -> None:
        if self.writer is not None:
            errors = self.writer.flush()
            self._inflight.clear()
            if errors:
                raise OSError(f"{errors} cell write(s) failed")

    def save_all(self) -> None:
        for cell in self._cells.values():
            self.save_cell(cell)
        self.flush()

    def values(self):
        return self._cells.values()


class Converter:
    """Batched converter over a cell store directory.

    Use as a context manager (the equivalent of the reference's ``Drop``
    flush, converter.rs:241-246)::

        with Converter(metadata, out_dir) as conv:
            for batch in reader.batches(10_000):
                conv.add_points_batch(batch)
    """

    def __init__(
        self,
        metadata: Metadata,
        working_directory,
        cache_size: int = DEFAULT_CACHE_SIZE,
        async_io: bool = True,
    ):
        self.metadata = metadata
        self.working_directory = Path(working_directory)
        self.working_directory.mkdir(parents=True, exist_ok=True)
        writer = None
        if async_io:
            from ..native import AsyncStoreWriter

            writer = AsyncStoreWriter(n_threads=4)
        self._writer = writer
        self.cell_cache = CellCache(self.working_directory, cache_size, writer)

    # --- batch entry point (converter.rs:106-112) ---------------------------

    def add_points_batch(self, batch: PointBatch) -> None:
        self._update_bounding_box(batch)
        self.metadata.number_of_points += len(batch)
        grouped = group_points_host(batch, 0, self.metadata.config)
        self._add_points_in_hierarchy(0, grouped)

    def _update_bounding_box(self, batch: PointBatch) -> None:
        update_metadata_bounding_box(self.metadata, batch)

    # --- hierarchy cascade (converter.rs:114-139, iterative) ----------------

    def _add_points_in_hierarchy(
        self, hierarchy: int, grouped: dict[tuple[int, int, int], PointBatch]
    ) -> None:
        from ..utils.tracing import stage

        config = self.metadata.config
        while grouped:
            self._create_hierarchy_folder(hierarchy)
            next_level: dict[tuple[int, int, int], PointBatch] = {}
            # canonical processing order (see module docstring)
            with stage("host_cascade"):
                for cell_index in sorted(grouped):
                    cell = self.get_cell(CellId(hierarchy, cell_index))
                    remaining = add_points_to_cell(
                        config, grouped[cell_index], cell
                    )
                    merge_point_maps(next_level, remaining)
            grouped = next_level
            hierarchy += 1

    def _create_hierarchy_folder(self, hierarchy: int) -> None:
        if self.metadata.hierarchies <= hierarchy:
            self.metadata.hierarchies += 1
            (self.working_directory / hierarchy_string(hierarchy)).mkdir(
                exist_ok=True
            )

    # --- cell access (converter.rs:160-207) ---------------------------------

    def get_cell(self, cell_id: CellId, pin: bool = False) -> Cell:
        cell = self.cell_cache.get(cell_id, pin=pin)
        if cell is None:
            cell = self._load_or_create_cell(cell_id)
            self.cell_cache.put(cell, pin=pin)
        return cell

    def unpin_cells(self, cell_ids) -> None:
        self.cell_cache.unpin(cell_ids)

    def _load_or_create_cell(self, cell_id: CellId) -> Cell:
        path = self.working_directory / cell_id.path()
        self.cell_cache.flush_path(path)
        try:
            return Cell.from_path(path)
        except FileNotFoundError:
            config = self.metadata.config
            cell_size = config.cell_size(cell_id.hierarchy)
            cell_pos = config.cell_pos(
                np.asarray(cell_id.index, np.int32), cell_size
            )
            return Cell(
                cell_id, config.sub_cell_size(cell_size), cell_size, cell_pos
            )

    # --- persistence ---------------------------------------------------------

    def save_cache(self) -> None:
        self.cell_cache.save_all()

    def save_metadata(self) -> None:
        self.metadata.write_to_path(
            self.working_directory / f"{FILE_NAME}.{EXTENSION}"
        )

    def close(self) -> None:
        # idempotent: a second close (explicit close inside a `with`
        # block) must not resubmit writes through the closed writer
        if getattr(self, "_closed", False):
            return
        self._closed = True
        self.save_cache()
        self.save_metadata()
        if self._writer is not None:
            self._writer.close()
            self._writer = None

    def __enter__(self) -> "Converter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def load_metadata(output: Path) -> Metadata:
    """Load an existing store's metadata for incremental merge, or default
    (lib.rs:86-101)."""
    path = Path(output) / f"{FILE_NAME}.{EXTENSION}"
    try:
        metadata = Metadata.from_path(path)
        log.info("Found an existing metadata file.")
        return metadata
    except FileNotFoundError:
        log.info("Found no metadata file. A new one will be created.")
        return Metadata()


class _ReadAhead:
    """One producer thread parses batches ahead of the conversion loop.

    SURVEY §7: file parsing must not bottleneck the converters — the
    reference reads and converts strictly serially (lib.rs:31-52); here
    batch k+1's LAS/LAZ/PLY decode overlaps batch k's conversion on real
    multi-core hosts (this container's single shared core serializes
    them, so the win shows elsewhere). Bounded to ``depth`` in-flight
    batches so memory stays batch-scale. One producer + a FIFO queue
    preserve batch order exactly, so stores stay byte-identical; reader
    exceptions surface on the consuming side where the serial loop would
    have hit them."""

    def __init__(self, reader, batch_size: int, depth: int = 2):
        import queue
        import threading

        self._reader = reader
        self._batch_size = batch_size
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._queue_mod = queue
        self._stop = False
        self._thread = threading.Thread(
            target=self._run, name="pct-read-ahead", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        try:
            while not self._stop and self._reader.remaining_points() > 0:
                batch = self._reader.get_batch(self._batch_size)
                if len(batch) == 0:
                    # a truncated/corrupt source can under-deliver while
                    # still reporting remaining points
                    self._put(
                        ("underdelivery", self._reader.remaining_points())
                    )
                    return
                self._put(("batch", batch))
        except BaseException as err:  # re-raised on the consumer side
            self._put(("error", err))
            return
        self._put(("eof", None))

    def _put(self, item) -> None:
        while not self._stop:
            try:
                self._q.put(item, timeout=0.1)
                return
            except self._queue_mod.Full:
                continue

    def next(self):
        """(kind, payload): 'batch', 'underdelivery', 'error', or 'eof'."""
        return self._q.get()

    def close(self) -> None:
        self._stop = True
        try:  # unblock a producer waiting on a full queue
            while True:
                self._q.get_nowait()
        except self._queue_mod.Empty:
            pass
        self._thread.join()


def convert_from_paths(
    paths,
    output,
    batch_size: int = DEFAULT_BATCH_SIZE,
    cache_size: int = DEFAULT_CACHE_SIZE,
    converter_factory=Converter,
) -> Metadata:
    """Convert/merge input files into the store at ``output`` (lib.rs:11-60).

    ``converter_factory`` lets callers swap in the device-accelerated or
    mesh-sharded converter while keeping the same driver loop.
    """
    from ..io import get_batched_point_reader

    metadata = load_metadata(output)
    t_start = time.monotonic()

    with converter_factory(metadata, output, cache_size=cache_size) as converter:
        for path_index, path in enumerate(paths):
            log.info("Converting file %d/%d, %s", path_index + 1, len(paths), path)
            try:
                reader = get_batched_point_reader(path)
            except Exception as err:
                log.error("Failed to open %s: %s", path, err)
                continue
            if reader is None:
                log.warning("Unsupported file format %r", Path(path).suffix)
                continue

            log.info("Converting %d points", reader.total_points())
            t_log = time.monotonic()
            can_prefetch = hasattr(converter, "prefetch")
            pending = None  # read-ahead batch (device work already dispatched)
            read_ahead = _ReadAhead(reader, batch_size)
            try:
                while True:
                    kind, payload = read_ahead.next()
                    if kind == "batch":
                        if can_prefetch:
                            converter.prefetch(payload)
                            if pending is not None:
                                # Clear ``pending`` BEFORE the add: the
                                # converter mutates metadata/bbox before the
                                # cascade, so a mid-add failure must not be
                                # retried by the except-path flush below
                                # (that would double-count the batch).
                                flush, pending = pending, None
                                converter.add_points_batch(flush)
                            pending = payload
                        else:
                            converter.add_points_batch(payload)
                    elif kind == "underdelivery":
                        log.error(
                            "reader returned no points with %d reported "
                            "remaining; stopping this file",
                            payload,
                        )
                        break
                    elif kind == "error":
                        raise payload
                    else:  # eof
                        break
                    if time.monotonic() - t_log > 5.0:  # lib.rs:44-47
                        log.info(
                            "Remaining points: %d",
                            reader.remaining_points(),
                        )
                        t_log = time.monotonic()
                if pending is not None:
                    flush, pending = pending, None  # no-retry on failure
                    converter.add_points_batch(flush)
            except Exception as err:
                # per-file failure: record and move to the next file,
                # like the reference records FileConversionStatus::Failed
                # and continues (src/plugins/converter.rs:288-312) and
                # like the open-error path above. Every successfully READ
                # batch is kept: the prefetch path's in-flight batch
                # (device work already dispatched) is flushed before the
                # file is abandoned, so the store never silently drops
                # points that parsed cleanly.
                log.error("Failed converting %s: %s", path, err)
                if pending is not None:
                    try:
                        converter.add_points_batch(pending)
                    except Exception as flush_err:
                        log.error(
                            "Dropped the in-flight batch of %s: %s",
                            path, flush_err,
                        )
            finally:
                read_ahead.close()

    log.info(
        "Finished converting after %d ms",
        int((time.monotonic() - t_start) * 1000),
    )
    return metadata
