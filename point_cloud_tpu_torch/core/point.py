"""The 16-byte point record.

Copy of the reference's ``core/point.py``: ``tests/test_torch_host.py``
holds its results equal to the reference's.

Binary layout parity with the reference (point-converter/src/point.rs:26-54):
``pos: 3 x f32 little-endian`` followed by ``color: 4 x u8 RGBA``.

TPU-first representation: points travel as structure-of-arrays —
``positions (N, 3) float32`` + ``colors (N, 4) uint8`` — so they map
directly onto device buffers. The structured dtype below is only the disk
codec boundary.
"""

from __future__ import annotations

import numpy as np

POINT_DTYPE = np.dtype([("pos", "<f4", 3), ("color", "u1", 4)])
POINT_SIZE = POINT_DTYPE.itemsize  # 16 bytes
assert POINT_SIZE == 16

DEFAULT_COLOR = np.array([0, 0, 0, 255], dtype=np.uint8)  # point.rs:16-23


class PointBatch:
    """A structure-of-arrays batch of points."""

    __slots__ = ("positions", "colors")

    def __init__(self, positions: np.ndarray, colors: np.ndarray | None = None):
        positions = np.ascontiguousarray(positions, dtype=np.float32)
        if positions.ndim != 2 or positions.shape[1] != 3:
            raise ValueError(f"positions must be (N, 3), got {positions.shape}")
        n = positions.shape[0]
        if colors is None:
            colors = np.broadcast_to(DEFAULT_COLOR, (n, 4)).copy()
        colors = np.ascontiguousarray(colors, dtype=np.uint8)
        if colors.shape != (n, 4):
            raise ValueError(f"colors must be (N, 4), got {colors.shape}")
        self.positions = positions
        self.colors = colors

    def __len__(self) -> int:
        return self.positions.shape[0]

    def __getitem__(self, idx) -> "PointBatch":
        return PointBatch(self.positions[idx], self.colors[idx])

    @staticmethod
    def empty() -> "PointBatch":
        return PointBatch(np.empty((0, 3), np.float32), np.empty((0, 4), np.uint8))

    @staticmethod
    def _wrap(positions: np.ndarray, colors: np.ndarray) -> "PointBatch":
        """Unchecked fast constructor for hot loops: caller guarantees
        contiguous (N, 3) f32 / (N, 4) u8 arrays."""
        batch = PointBatch.__new__(PointBatch)
        batch.positions = positions
        batch.colors = colors
        return batch

    @staticmethod
    def concat(batches: list["PointBatch"]) -> "PointBatch":
        batches = [b for b in batches if len(b)]
        if not batches:
            return PointBatch.empty()
        return PointBatch(
            np.concatenate([b.positions for b in batches]),
            np.concatenate([b.colors for b in batches]),
        )

    # --- binary codec (reference layout, point.rs:26-54) ---

    def to_bytes(self) -> bytes:
        rec = np.empty(len(self), dtype=POINT_DTYPE)
        rec["pos"] = self.positions
        rec["color"] = self.colors
        return rec.tobytes()

    @staticmethod
    def from_bytes(data: bytes | memoryview, count: int | None = None) -> "PointBatch":
        rec = np.frombuffer(data, dtype=POINT_DTYPE, count=-1 if count is None else count)
        return PointBatch(rec["pos"].astype(np.float32), rec["color"].copy())

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, PointBatch)
            and np.array_equal(self.positions, other.positions)
            and np.array_equal(self.colors, other.colors)
        )

    def __repr__(self) -> str:
        return f"PointBatch(n={len(self)})"
