"""Store metadata: ``metadata.json`` schema + derived grid quantities.

Copy of the reference's ``core/metadata.py``: ``tests/test_torch_host.py``
holds its results equal to the reference's.

Schema parity with the reference (point-converter/src/metadata.rs:9-88):
``{version, name, number_of_points, hierarchies, bounding_box{min,max},
config{cell_point_overflow_limit, sub_grid_dimension, max_cell_size}}``,
written pretty-printed (metadata.rs:51-53). Our writer reproduces
serde_json's byte layout via :mod:`.json_compat`.

Derived quantities (metadata.rs:91-112) are computed in float32 with the
reference's operation order so cell indexing and sub-grid quantization land
on identical boundaries.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np

from .aabb import Aabb
from .json_compat import F32, dumps_pretty

FILE_NAME = "metadata"
EXTENSION = "json"

_I32_MIN = -(2**31)
_I32_MAX = 2**31 - 1


def hierarchy_string(hierarchy: int) -> str:
    """Directory name for a hierarchy level (metadata.rs:47-49)."""
    return f"h_{hierarchy}"


@dataclass
class MetadataConfig:
    cell_point_overflow_limit: int = 5_000
    sub_grid_dimension: int = 96
    max_cell_size: float = 1000.0

    def cell_size(self, hierarchy: int) -> np.float32:
        """``max_cell_size / 2^h`` in f32 (metadata.rs:91-93)."""
        return np.float32(self.max_cell_size) / np.float32(
            np.uint32(2) ** np.uint32(hierarchy)
        )

    def sub_cell_size(self, cell_size: float) -> np.float32:
        return np.float32(cell_size) / np.float32(self.sub_grid_dimension)

    def cell_index(self, pos: np.ndarray, cell_size: float) -> np.ndarray:
        """``floor(pos / cell_size)`` as saturating i32 (metadata.rs:100-102).

        Vectorized over ``(..., 3)`` positions. NOTE: the renderer's LOD
        kernel must use the same formula (the reference keeps the WGSL copy
        in sync by comment, compute.wgsl:80-83 — we keep it in sync by test).
        """
        from .hex import _np_saturating_i32

        v = np.floor(np.asarray(pos, dtype=np.float32) / np.float32(cell_size))
        return _np_saturating_i32(v)

    def cell_pos(self, cell_index: np.ndarray, cell_size: float) -> np.ndarray:
        """Cell center world position (metadata.rs:104-106)."""
        size = np.float32(cell_size)
        return np.asarray(cell_index, dtype=np.float32) * size + size / np.float32(2.0)

    def cell_spacing(self, cell_size: float) -> np.float32:
        """Per-hierarchy splat radius (metadata.rs:108-112)."""
        sub = np.float32(cell_size) / np.float32(self.sub_grid_dimension)
        radius = sub * np.float32(0.5)
        return np.float32(np.hypot(radius, radius * np.float32(0.5)) * np.float32(1.05))

    def to_json(self) -> dict:
        return {
            "cell_point_overflow_limit": int(self.cell_point_overflow_limit),
            "sub_grid_dimension": int(self.sub_grid_dimension),
            "max_cell_size": F32(np.float32(self.max_cell_size)),
        }

    @staticmethod
    def from_json(data: dict) -> "MetadataConfig":
        return MetadataConfig(
            cell_point_overflow_limit=int(data["cell_point_overflow_limit"]),
            sub_grid_dimension=int(data["sub_grid_dimension"]),
            max_cell_size=float(np.float32(data["max_cell_size"])),
        )


@dataclass
class Metadata:
    version: str = "1.0"
    name: str = "Unknown"
    number_of_points: int = 0
    hierarchies: int = 0
    bounding_box: Aabb = field(default_factory=Aabb)
    config: MetadataConfig = field(default_factory=MetadataConfig)

    def to_json(self) -> dict:
        return {
            "version": self.version,
            "name": self.name,
            "number_of_points": int(self.number_of_points),
            "hierarchies": int(self.hierarchies),
            "bounding_box": self.bounding_box.to_json(),
            "config": self.config.to_json(),
        }

    def dumps(self) -> str:
        """serde_json::to_string_pretty-compatible serialization."""
        return dumps_pretty(self.to_json())

    def write_to_path(self, path) -> None:
        with open(path, "w", encoding="utf-8") as f:
            f.write(self.dumps())

    @staticmethod
    def from_json(data: dict) -> "Metadata":
        return Metadata(
            version=data["version"],
            name=data["name"],
            number_of_points=int(data["number_of_points"]),
            hierarchies=int(data["hierarchies"]),
            bounding_box=Aabb.from_json(data["bounding_box"]),
            config=MetadataConfig.from_json(data["config"]),
        )

    @staticmethod
    def loads(text: str) -> "Metadata":
        return Metadata.from_json(json.loads(text))

    @staticmethod
    def from_path(path) -> "Metadata":
        with open(path, "r", encoding="utf-8") as f:
            return Metadata.loads(f.read())
