"""Cell streaming control plane: visibility diffing + prioritized loading.

Copy of the reference's ``render/streaming.py``: ``tests/test_torch_render.py``
holds its results equal to the reference's.

Capability parity with the reference's cell plugin (reference:
src/plugins/cell.rs:173-462), re-designed without an ECS:

- ``compute_visible_cells``: per hierarchy, intersect the streaming
  frustum's AABB with the cloud bbox, enumerate the cell-index lattice and
  plane-cull every candidate **in one vectorized pass** (the reference
  iterates a cartesian product in Rust, cell.rs:361-385),
- ``CellStreamer.update``: set-diffs old vs new visibility; disappeared
  cells are unloaded or their queued/in-flight loads cancelled
  (cell.rs:387-403); newly visible cells enter a priority queue keyed by
  (hierarchy, squared distance to camera) unless negative-cached
  (cell.rs:405-428),
- ``CellStreamer.fill_load_slots``: pops up to ``max_loading - in_flight``
  cells (10 concurrent like cell.rs:204) and hands them to a loader,
- loader completions feed back through ``on_loaded`` / ``on_missing``
  (missing cells go into a 10,000-entry LRU negative cache, cell.rs:186).

Pausing streaming (`StreamState` in the reference, cell.rs:89-99) maps to
simply not calling ``update``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from ..core.cell import Cell, CellId
from ..core.metadata import Metadata
from ..utils.lru import LruCache
from ..utils.sorted_hash import SortedHashMap
from .camera import Frustum
from .transform import Transform

MAX_LOADING_SIZE = 10  # cell.rs:204
MISSING_CACHE_SIZE = 10_000  # cell.rs:186


def cell_index_lattice(min_idx: np.ndarray, max_idx: np.ndarray) -> np.ndarray:
    """All integer cell indices in [min_idx, max_idx], shape (N, 3)."""
    xs = np.arange(min_idx[0], max_idx[0] + 1, dtype=np.int64)
    ys = np.arange(min_idx[1], max_idx[1] + 1, dtype=np.int64)
    zs = np.arange(min_idx[2], max_idx[2] + 1, dtype=np.int64)
    grid = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"), axis=-1)
    return grid.reshape(-1, 3).astype(np.int32)


def compute_visible_cells(
    metadata: Metadata,
    streaming_frustum: Frustum,
    hierarchy: int,
    max_candidates: int = 1_000_000,
) -> np.ndarray:
    """(N, 3) int32 indices of in-frustum cells at ``hierarchy``
    (vectorized equivalent of cell.rs:361-385)."""
    config = metadata.config
    cell_size = config.cell_size(hierarchy)
    half = np.float32(cell_size) / np.float32(2.0)

    aabb = streaming_frustum.aabb()
    aabb.clamp(metadata.bounding_box.min, metadata.bounding_box.max)
    min_idx = config.cell_index(aabb.min, cell_size)
    max_idx = config.cell_index(aabb.max, cell_size)
    if np.any(max_idx < min_idx):
        return np.empty((0, 3), np.int32)
    counts = max_idx.astype(np.int64) - min_idx.astype(np.int64) + 1
    if counts.prod() > max_candidates:
        # degenerate configuration (frustum far larger than cell size);
        # bail out rather than materialize an absurd lattice
        return np.empty((0, 3), np.int32)

    candidates = cell_index_lattice(min_idx, max_idx)
    centers = config.cell_pos(candidates, cell_size)
    culled = streaming_frustum.cull_aabbs(centers - half, centers + half)
    return candidates[~culled]


@dataclass
class StreamerStats:
    loaded_cells: int = 0
    missing_cells: int = 0
    queued_cells: int = 0
    loading_cells: int = 0
    loaded_points: int = 0
    loaded_bytes: int = 0  # 16 bytes per point like cell.rs:464-528


class CellStreamer:
    """Priority-streamed cell set for one camera."""

    def __init__(
        self,
        metadata: Metadata,
        loader: Callable[[CellId], Cell | None] | None = None,
        max_loading: int = MAX_LOADING_SIZE,
    ):
        self.metadata = metadata
        self.loader = loader
        self.max_loading = max_loading
        self.visible: list[set[tuple[int, int, int]]] = []
        self.loaded: dict[CellId, Cell] = {}
        self.missing: LruCache[CellId, None] = LruCache(MISSING_CACHE_SIZE)
        self.should_load: SortedHashMap[CellId, tuple, None] = SortedHashMap()
        self.loading: set[CellId] = set()

    # --- per-frame visibility diff (cell.rs:343-433) -------------------------

    def update(
        self,
        streaming_frustums: list[Frustum],
        camera_transform: Transform,
    ) -> None:
        config = self.metadata.config
        new_visible: list[set[tuple[int, int, int]]] = []

        for hierarchy, frustum in enumerate(streaming_frustums):
            old = (
                self.visible[hierarchy]
                if hierarchy < len(self.visible)
                else set()
            )
            cell_size = config.cell_size(hierarchy)
            indices = compute_visible_cells(self.metadata, frustum, hierarchy)
            visible = {tuple(int(v) for v in idx) for idx in indices}

            for index in old - visible:
                cell_id = CellId(hierarchy, index)
                if cell_id in self.loaded:
                    del self.loaded[cell_id]
                elif self.should_load.remove(cell_id) is None:
                    self.loading.discard(cell_id)

            for index in visible - old:
                cell_id = CellId(hierarchy, index)
                if cell_id in self.missing:
                    continue
                cell_pos = config.cell_pos(np.asarray(index, np.int32), cell_size)
                delta = cell_pos - camera_transform.translation
                # `length_squared() as u32` (cell.rs:412)
                distance = int(
                    min(float(np.dot(delta, delta)), 2**32 - 1)
                )
                self.should_load.insert(
                    cell_id, (hierarchy, distance), None
                )

            new_visible.append(visible)

        self.visible = new_visible

    # --- load slots (cell.rs:435-462) ----------------------------------------

    def fill_load_slots(self) -> list[CellId]:
        """Pop queued cells into the loading set; returns the ids started.

        If a synchronous ``loader`` was provided it is invoked inline and
        completions are applied immediately.
        """
        started = []
        free = self.max_loading - len(self.loading)
        for _ in range(max(0, free)):
            entry = self.should_load.pop_first()
            if entry is None:
                break
            self.loading.add(entry.hash_key)
            started.append(entry.hash_key)

        if self.loader is not None:
            for cell_id in started:
                cell = self.loader(cell_id)
                if cell is None:
                    self.on_missing(cell_id)
                else:
                    self.on_loaded(cell_id, cell)
        return started

    # --- loader completions (cell.rs:256-341) ---------------------------------

    def _is_visible(self, cell_id: CellId) -> bool:
        return (
            cell_id.hierarchy < len(self.visible)
            and tuple(cell_id.index) in self.visible[cell_id.hierarchy]
        )

    def on_loaded(self, cell_id: CellId, cell: Cell) -> None:
        self.loading.discard(cell_id)
        if self._is_visible(cell_id):
            self.loaded[cell_id] = cell

    def on_missing(self, cell_id: CellId) -> None:
        self.loading.discard(cell_id)
        self.missing.put(cell_id, None)

    def cleanup(self) -> None:
        """Full reset on metadata switch (cell.rs:214-233)."""
        self.visible.clear()
        self.loaded.clear()
        self.missing.purge()
        self.should_load.clear()
        self.loading.clear()

    # --- stats (cell.rs:464-528) ----------------------------------------------

    def stats(self) -> StreamerStats:
        points = sum(
            c.number_of_points + c.number_of_overflow_points
            for c in self.loaded.values()
        )
        return StreamerStats(
            loaded_cells=len(self.loaded),
            missing_cells=len(self.missing),
            queued_cells=len(self.should_load),
            loading_cells=len(self.loading),
            loaded_points=points,
            loaded_bytes=points * 16,
        )

    # --- GPU-table exports (src/plugins/cell/shader.rs:209-302) ---------------

    def loaded_cells_table(self) -> np.ndarray:
        """(M, 4) int32 sorted (hierarchy, x, y, z) — the LOD kernel's
        binary-search table (sorted like shader.rs:209-246)."""
        if not self.loaded:
            return np.empty((0, 4), np.int32)
        rows = np.array(
            [[c.hierarchy, *c.index] for c in self.loaded],
            np.int32,
        )
        order = np.lexsort((rows[:, 3], rows[:, 2], rows[:, 1], rows[:, 0]))
        return rows[order]

    def frustum_far_distances(
        self, streaming_frustums: list[Frustum], camera_transform: Transform
    ) -> np.ndarray:
        """Per-hierarchy far-plane distance for the distance-LOD override
        (shader.rs:248-278: distance from camera to the far plane)."""
        cam = camera_transform.translation
        out = np.zeros(len(streaming_frustums), np.float32)
        for i, frustum in enumerate(streaming_frustums):
            far_center = frustum.far.mean(axis=0)
            out[i] = np.linalg.norm(far_center - cam)
        return out
