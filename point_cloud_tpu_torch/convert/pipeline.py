"""Host-side grouping utilities for the conversion pipeline.

Copy of the reference's ``convert/pipeline.py``: ``tests/test_torch_host.py``
holds its results equal to the reference's.

The device pipeline (ops/) computes keys and winners in bulk; these helpers
split structure-of-arrays batches into per-cell groups on the host
(vectorized equivalent of the reference's ``group_points``,
point-converter/src/converter.rs:32-47).
"""

from __future__ import annotations

import numpy as np

from ..core.metadata import MetadataConfig
from ..core.point import PointBatch


def group_points_host(
    batch: PointBatch, hierarchy: int, config: MetadataConfig
) -> dict[tuple[int, int, int], PointBatch]:
    """Group a batch by cell index at ``hierarchy``.

    Vectorized: one cell-index computation + one lexsort; preserves the
    batch's arrival order inside each group (the reference pushes points in
    iteration order, converter.rs:41-44).
    """
    if len(batch) == 0:
        return {}
    cell_size = config.cell_size(hierarchy)
    indices = config.cell_index(batch.positions, cell_size)
    return group_by_index(batch, indices)


def group_by_index(
    batch: PointBatch, indices: np.ndarray
) -> dict[tuple[int, int, int], PointBatch]:
    """Split a batch by precomputed ``(N, 3)`` int32 indices (stable)."""
    if len(batch) == 0:
        return {}
    # stable sort by index triple keeps arrival order within groups
    order = np.lexsort((indices[:, 2], indices[:, 1], indices[:, 0]))
    sorted_idx = indices[order]
    boundaries = np.nonzero(
        np.any(sorted_idx[1:] != sorted_idx[:-1], axis=1)
    )[0] + 1
    groups: dict[tuple[int, int, int], PointBatch] = {}
    for rows in np.split(order, boundaries):
        key = tuple(int(v) for v in indices[rows[0]])
        rows = np.sort(rows)  # arrival order within the group
        groups[key] = batch[rows]
    return groups


def merge_point_maps(
    left: dict[tuple[int, int, int], PointBatch],
    right: dict[tuple[int, int, int], PointBatch],
) -> None:
    """Append ``right``'s groups into ``left`` (converter.rs:49-60)."""
    for key, batch in right.items():
        if key in left:
            left[key] = PointBatch.concat([left[key], batch])
        else:
            left[key] = batch
