"""Core data model: geometry, point/cell/metadata codecs."""

from .aabb import Aabb
from .cell import EXTENSION as CELL_EXTENSION
from .cell import Cell, CellId
from .metadata import EXTENSION as METADATA_EXTENSION
from .metadata import FILE_NAME as METADATA_FILE_NAME
from .metadata import Metadata, MetadataConfig, hierarchy_string
from .point import DEFAULT_COLOR, POINT_DTYPE, PointBatch

__all__ = [
    "Aabb",
    "Cell",
    "CellId",
    "CELL_EXTENSION",
    "DEFAULT_COLOR",
    "Metadata",
    "MetadataConfig",
    "METADATA_EXTENSION",
    "METADATA_FILE_NAME",
    "POINT_DTYPE",
    "PointBatch",
    "hierarchy_string",
]
