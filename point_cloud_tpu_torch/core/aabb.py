"""Axis-aligned bounding boxes (float32).

Copy of the reference's ``core/aabb.py``: ``tests/test_torch_host.py``
holds its results equal to the reference's.

Capability parity with the reference's ``bounding-volume`` crate
(reference: bounding-volume/src/lib.rs:5-53), re-designed for batches: the
reference folds an iterator point-by-point; here AABBs come from vectorized
min/max reductions (order-independent, bit-identical for min/max).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def _zero3() -> np.ndarray:
    return np.zeros(3, dtype=np.float32)


@dataclass
class Aabb:
    min: np.ndarray = field(default_factory=_zero3)
    max: np.ndarray = field(default_factory=_zero3)

    def __post_init__(self) -> None:
        self.min = np.asarray(self.min, dtype=np.float32).copy()
        self.max = np.asarray(self.max, dtype=np.float32).copy()

    def center(self) -> np.ndarray:
        return (self.min + self.max) / np.float32(2.0)

    def extends(self) -> np.ndarray:
        return (self.max - self.min) / np.float32(2.0)

    def extend(self, point: np.ndarray) -> None:
        point = np.asarray(point, dtype=np.float32)
        self.min = np.minimum(self.min, point)
        self.max = np.maximum(self.max, point)

    def extend_aabb(self, other: "Aabb") -> None:
        self.min = np.minimum(self.min, other.min)
        self.max = np.maximum(self.max, other.max)

    def clamp(self, min_v: np.ndarray, max_v: np.ndarray) -> None:
        self.min = np.maximum(self.min, np.asarray(min_v, dtype=np.float32))
        self.max = np.minimum(self.max, np.asarray(max_v, dtype=np.float32))

    def copy(self) -> "Aabb":
        return Aabb(self.min, self.max)

    @staticmethod
    def from_points(points: np.ndarray) -> "Aabb | None":
        """AABB of an ``(N, 3)`` array; ``None`` when empty (lib.rs:38-52).

        Large contiguous batches take the native SSE scan — bit-identical
        to NumPy because nonzero f32 min/max are exact and
        order-independent, and the ambiguous cases (NaN input, a zero
        extremum where min(-0.0, +0.0) is order-dependent) fall back to
        NumPy. NumPy's axis-0 reduce over 3-wide rows costs ~10% of an
        engine conversion, the scan ~2% of that.
        """
        points = np.asarray(points, dtype=np.float32)
        if points.shape[0] == 0:
            return None
        if (points.shape[0] >= 4096 and points.ndim == 2
                and points.shape[1] == 3 and points.flags.c_contiguous):
            from ..native import bbox_f32_native

            native = bbox_f32_native(points)
            if native is not None:
                return Aabb(*native)
        return Aabb(points.min(axis=0), points.max(axis=0))

    def to_json(self) -> dict:
        from .json_compat import F32

        return {
            "min": [F32(v) for v in self.min],
            "max": [F32(v) for v in self.max],
        }

    @staticmethod
    def from_json(data: dict) -> "Aabb":
        return Aabb(np.asarray(data["min"], dtype=np.float32),
                    np.asarray(data["max"], dtype=np.float32))

