"""In-app incremental converter: conversion spread across frames.

Capability parity with the reference's converter plugin (reference:
src/plugins/converter.rs, native-only there): conversion of LAS/PLY/own
files proceeds a slice per frame so the viewer stays interactive, and
finished cells feed straight into the renderer via Created/Changed asset
events (src/plugins/cell.rs:268-298):

- one batch read in flight on the thread pool (read + batch AABB + h0
  grouping off-thread, converter.rs:170-222),
- at most ``MAX_TASKS_PER_FRAME`` cell-dedup tasks per frame
  (converter.rs:553-592); overflow cascades become h+1 tasks,
- per-file progress with Failed{error} status (converter.rs:81-93),
- cells stay in RAM until "save at" picks a directory; then auto-save
  turns on, every asset is re-pointed at the store and the in-RAM set is
  capped by an LRU whose evictions write back (converter.rs:475-551,
  641-721),
- metadata counters/bbox update live (UpdateMetadataEvent equivalents,
  src/plugins/metadata.rs:128-166).

Copy of the reference's ``viewer/interactive.py``: ``tests/test_torch_tools.py``
holds its results equal to the reference's.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from enum import Enum
from pathlib import Path

import numpy as np

from ..convert.converter import add_points_to_cell
from ..convert.pipeline import group_points_host
from ..core.aabb import Aabb
from ..core.cell import Cell, CellId
from ..core.metadata import FILE_NAME, EXTENSION, Metadata
from ..core.point import PointBatch
from ..utils.lru import LruCache
from ..utils.source import Directory

DEFAULT_BATCH_SIZE = 50_000  # converter.rs:600-606
BATCH_SIZE_MIN = 10_000
BATCH_SIZE_MAX = 500_000
MAX_TASKS_PER_FRAME = 10  # converter.rs:553-560
RAM_CACHE_LRU = 100  # converter.rs:475-551


class ConversionState(Enum):
    NOT_STARTED = "not_started"
    CONVERTING = "converting"
    FINISHED = "finished"


@dataclass
class FileStatus:
    path: Path
    state: str = "pending"  # pending|converting|finished|failed|no_reader
    total: int = 0
    remaining: int = 0
    error: str | None = None


@dataclass
class CellTask:
    cell_id: CellId
    points: PointBatch


class InteractiveConverter:
    def __init__(self, viewer=None, batch_size: int = DEFAULT_BATCH_SIZE):
        self.viewer = viewer
        self.metadata = viewer.metadata if viewer else Metadata()
        self.batch_size = int(
            np.clip(batch_size, BATCH_SIZE_MIN, BATCH_SIZE_MAX)
        )
        self.state = ConversionState.NOT_STARTED
        self.files: list[FileStatus] = []
        self._file_index = -1
        self._reader = None
        self._reader_lock = threading.Lock()
        self._batch_result: list | None = None
        self._batch_pending = False
        self.tasks: list[CellTask] = []
        self.auto_save = False
        self.save_directory: Path | None = None
        self._cells: dict[CellId, Cell] = {}
        self._lru: LruCache[CellId, None] = LruCache(RAM_CACHE_LRU)

    # --- setup (UI actions, converter.rs:723-848) -----------------------------

    def choose_files(self, paths) -> None:
        self.files.extend(FileStatus(Path(p)) for p in paths)

    def new_cloud(self) -> None:
        self.metadata = Metadata()
        if self.viewer is not None:
            self.viewer.set_metadata(self.metadata)
            # the previously opened store no longer backs the displayed
            # cloud: clearing it keeps store-path consumers (the window
            # viewer's export hotkey) from reading stale data; save_at
            # re-points it at the new store
            self.viewer.working_directory = None
        self._cells.clear()
        self.files.clear()
        self.state = ConversionState.NOT_STARTED

    def set_batch_size(self, value: int) -> None:
        """Points per read batch, clamped to the reference's slider range
        (converter.rs:594-607: 10k-500k, default 50k). Takes effect on
        the next batch request."""
        self.batch_size = int(np.clip(int(value), BATCH_SIZE_MIN,
                                      BATCH_SIZE_MAX))

    def save_at(self, directory) -> None:
        """Choose the store directory: flush everything, enable auto-save
        (converter.rs:641-721)."""
        self.save_directory = Path(directory)
        self.save_directory.mkdir(parents=True, exist_ok=True)
        self.auto_save = True
        for cell in self._cells.values():
            self._write_cell(cell)
        self._write_metadata()
        if self.viewer is not None:
            self.viewer.working_directory = Directory(self.save_directory)

    def start(self) -> None:
        if self.state != ConversionState.CONVERTING and self.files:
            self.state = ConversionState.CONVERTING
            if self._reader is None and not self._batch_pending:
                self._next_file()

    def stop(self) -> None:
        if self.state == ConversionState.CONVERTING:
            self.state = ConversionState.NOT_STARTED

    # --- file/batch pipeline ----------------------------------------------------

    def _next_file(self) -> None:
        from ..io import get_batched_point_reader

        while True:
            self._file_index += 1
            if self._file_index >= len(self.files):
                self._reader = None
                self.state = ConversionState.FINISHED
                return
            status = self.files[self._file_index]
            try:
                reader = get_batched_point_reader(status.path)
            except Exception as err:
                status.state = "failed"
                status.error = str(err)
                continue
            if reader is None:
                status.state = "no_reader"
                continue
            status.state = "converting"
            status.total = reader.total_points()
            status.remaining = status.total
            self._reader = reader
            self._request_batch()
            return

    def _request_batch(self) -> None:
        """One in-flight read on the pool (converter.rs:170-222)."""
        if self._batch_pending or self._reader is None:
            return
        self._batch_pending = True
        reader = self._reader
        size = self.batch_size

        def job():
            try:
                with self._reader_lock:
                    batch = reader.get_batch(size)
                    remaining = reader.remaining_points()
                aabb = Aabb.from_points(batch.positions)
                grouped = group_points_host(batch, 0, self.metadata.config)
                result = ("ok", batch, aabb, grouped, remaining)
            except Exception as err:  # per-file failure (converter.rs:288-312)
                result = ("err", err)
            self._batch_result = result

        pool = self.viewer.pool if self.viewer is not None else None
        if pool is not None:
            pool.execute(job)
        else:
            job()

    # --- per-frame work -----------------------------------------------------------

    def update(self) -> None:
        """One frame of conversion work (the chained systems,
        converter.rs:50-62)."""
        if self.state != ConversionState.CONVERTING:
            return

        # receive_tasks (converter.rs:271-321)
        if self._batch_result is not None:
            result, *rest = self._batch_result
            self._batch_result = None
            self._batch_pending = False
            status = self.files[self._file_index]
            if result == "err":
                status.state = "failed"
                status.error = str(rest[0])
                self._reader = None
                self._next_file()
            else:
                batch, aabb, grouped, remaining = rest
                status.remaining = remaining
                if aabb is not None:
                    if self.metadata.number_of_points == 0:
                        self.metadata.bounding_box = aabb
                    else:
                        self.metadata.bounding_box.extend_aabb(aabb)
                self.metadata.number_of_points += len(batch)
                for index in sorted(grouped):
                    self.tasks.append(
                        CellTask(CellId(0, index), grouped[index])
                    )
                if remaining == 0:
                    status.state = "finished"
                    self._reader = None

        # add_points_to_cell_system (converter.rs:553-592)
        for _ in range(min(MAX_TASKS_PER_FRAME, len(self.tasks))):
            task = self.tasks.pop(0)
            cell = self._get_cell(task.cell_id)
            remaining_map = add_points_to_cell(
                self.metadata.config, task.points, cell
            )
            for index in sorted(remaining_map):
                self.tasks.append(
                    CellTask(
                        CellId(task.cell_id.hierarchy + 1, index),
                        remaining_map[index],
                    )
                )
            self._publish_cell(cell)

        # check_if_tasks_are_finished (converter.rs:224-237)
        if not self.tasks and not self._batch_pending:
            if self._reader is not None:
                self._request_batch()
            elif self.state == ConversionState.CONVERTING:
                self._next_file()
                if self._reader is None and not self.tasks:
                    self._write_metadata()

    # --- cell cache: RAM until save-at, then LRU+write-back ------------------------

    def _get_cell(self, cell_id: CellId) -> Cell:
        cell = self._cells.get(cell_id)
        if cell is None:
            cell = self._load_or_create(cell_id)
            self._cells[cell_id] = cell
            self.metadata.hierarchies = max(
                self.metadata.hierarchies, cell_id.hierarchy + 1
            )
        if self.auto_save:
            evicted_pair = self._lru.put(cell_id, None)
            if evicted_pair is not None:
                victim = self._cells.pop(evicted_pair[0], None)
                if victim is not None:
                    self._write_cell(victim)
        return cell

    def _load_or_create(self, cell_id: CellId) -> Cell:
        config = self.metadata.config
        if self.save_directory is not None:
            path = self.save_directory / cell_id.path()
            if path.exists():
                return Cell.from_path(path)
        cell_size = config.cell_size(cell_id.hierarchy)
        return Cell(
            cell_id,
            config.sub_cell_size(cell_size),
            cell_size,
            config.cell_pos(np.asarray(cell_id.index, np.int32), cell_size),
        )

    def _write_cell(self, cell: Cell) -> None:
        if self.save_directory is None:
            return
        path = self.save_directory / cell.id.path()
        path.parent.mkdir(parents=True, exist_ok=True)
        cell.write_to_path(path)

    def _write_metadata(self) -> None:
        if self.save_directory is not None:
            self.metadata.write_to_path(
                self.save_directory / f"{FILE_NAME}.{EXTENSION}"
            )

    def _publish_cell(self, cell: Cell) -> None:
        """Feed a created/changed cell to the live viewer (cell.rs:268-298)."""
        if self.viewer is None:
            return
        self.viewer.metadata = self.metadata
        self.viewer.streamer.metadata = self.metadata
        self.viewer.streamer.loaded[cell.id] = cell

    def flush(self) -> None:
        """Write every in-RAM cell + metadata (exit/save-all)."""
        for cell in self._cells.values():
            self._write_cell(cell)
        self._write_metadata()

    def progress(self) -> list[FileStatus]:
        return list(self.files)
