"""Own-format reader: re-reads a converted cell store as a point source.

Copy of the reference's ``io/own.py``: ``tests/test_torch_host.py``
holds its results equal to the reference's.

Capability parity with the reference's ``BatchedPointCloudPointReader``
(reference: point-converter/src/converter/own.rs:16-87): given a
``metadata.json`` path, iterate every hierarchy directory ``h_0..h_n``,
read each cell file, and yield the cells' points (grid points + overflow)
— enabling re-conversion and store-to-store merge.

Cells stream lazily (one file in memory at a time); missing hierarchy
directories and unreadable cells are logged and skipped like own.rs:27-49.
"""

from __future__ import annotations

import logging
from pathlib import Path

from ..core.cell import Cell
from ..core.metadata import Metadata, hierarchy_string
from ..core.point import PointBatch
from . import BatchedPointReader

log = logging.getLogger(__name__)


class PointCloudPointReader(BatchedPointReader):
    def __init__(self, metadata_path):
        metadata_path = Path(metadata_path)
        self.metadata = Metadata.from_path(metadata_path)
        self.working_directory = metadata_path.parent
        self._read = 0
        self._pending = PointBatch.empty()
        self._cell_paths = self._iter_cell_paths()

    def _iter_cell_paths(self):
        for hierarchy in range(self.metadata.hierarchies):
            hier_dir = self.working_directory / hierarchy_string(hierarchy)
            try:
                entries = sorted(hier_dir.iterdir())
            except OSError as err:
                log.error("Failed to read dir: %s", err)
                continue
            yield from entries

    def get_batch(self, size: int) -> PointBatch:
        want = min(size, self.remaining_points())
        chunks = []
        have = len(self._pending)
        if have:
            chunks.append(self._pending)
        while have < want:
            path = next(self._cell_paths, None)
            if path is None:
                break
            try:
                cell = Cell.from_path(path)
            except Exception as err:  # corrupt cell: skip (own.rs:44-49)
                log.error("Failed to read cell %s: %s", path, err)
                continue
            points = cell.all_points()
            chunks.append(points)
            have += len(points)
        merged = PointBatch.concat(chunks)
        batch, self._pending = merged[:want], merged[want:]
        self._read += len(batch)
        return batch

    def total_points(self) -> int:
        return int(self.metadata.number_of_points)

    def remaining_points(self) -> int:
        return self.total_points() - self._read

    def exhausted(self) -> bool:
        """True once every cell file is drained. ``get_batch`` caps reads
        at the metadata total, so a store whose cells hold MORE points
        than metadata.json claims would otherwise truncate silently —
        the exporter checks this to fail loudly in both directions."""
        if len(self._pending):
            return False
        nxt = next(self._cell_paths, None)
        if nxt is None:
            return True
        # put the peeked path back; a valid store has no empty cell
        # files, so any remaining path means undrained points
        import itertools

        self._cell_paths = itertools.chain([nxt], self._cell_paths)
        return False
