"""Batched point readers: LAS/LAZ, PLY, and the own converted-store format.

Copy of the reference's ``io/__init__.py``: ``tests/test_torch_host.py``
holds its results equal to the reference's.

Capability parity with the reference's ``BatchedPointReader`` trait and its
three implementations (reference: point-converter/src/converter.rs:24-30,
converter/las.rs, converter/ply.rs, converter/own.rs), re-designed for a
batched array pipeline: readers yield structure-of-arrays
:class:`~point_cloud_tpu_torch.core.point.PointBatch` objects (the device feed
format) instead of per-point records, and parsing is vectorized NumPy
instead of per-point loops.
"""

from __future__ import annotations

import abc
from pathlib import Path

from ..core.point import PointBatch


class BatchedPointReader(abc.ABC):
    """Pull-based batched reader (converter.rs:24-30)."""

    @abc.abstractmethod
    def get_batch(self, size: int) -> PointBatch:
        """Read up to ``size`` points; empty batch at EOF."""

    @abc.abstractmethod
    def total_points(self) -> int:
        ...

    @abc.abstractmethod
    def remaining_points(self) -> int:
        ...

    def __iter__(self):
        return self

    def batches(self, size: int):
        """Iterate batches of ``size`` until the file is exhausted."""
        while self.remaining_points() > 0:
            yield self.get_batch(size)


def get_batched_point_reader(path) -> BatchedPointReader | None:
    """Dispatch a reader by file extension (lib.rs:62-84).

    ``las``/``laz`` -> LAS reader, ``ply`` -> PLY reader, ``json`` -> the
    own converted-store reader (re-conversion / merge source). Unsupported
    extensions return ``None``.
    """
    path = Path(path)
    ext = path.suffix.lower().lstrip(".")
    if ext in ("las", "laz"):
        from .las import open_las_or_laz

        return open_las_or_laz(path)
    if ext == "ply":
        from .ply import PlyPointReader

        return PlyPointReader(path)
    if ext == "json":
        from .own import PointCloudPointReader

        return PointCloudPointReader(path)
    return None


__all__ = ["BatchedPointReader", "get_batched_point_reader", "PointBatch"]
