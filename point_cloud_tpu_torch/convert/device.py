"""Cross-batch prefetch for the device-backed converters.

Counterpart of ``point_cloud_tpu/convert/device.py:57-112``
(``RESIDENT_ENABLED``, ``DevicePrefetchMixin``), calling the port's
:func:`~point_cloud_tpu_torch.ops.dedup.dispatch_dedup` on the
converter's ``device``. The Python-cell ``DeviceConverter`` is not
ported yet (ROADMAP.md).
"""

from __future__ import annotations

from point_cloud_tpu.core.point import PointBatch

from ..ops.dedup import dispatch_dedup

# device-resident cascade: levels >= 1 upload row indices into the
# level-0 device buffer instead of re-uploading positions
RESIDENT_ENABLED = True


class DevicePrefetchMixin:
    """Dispatch the next batch's level-0 device pass while the host merges
    the current one. Needs ``self.device`` and ``self.metadata``."""

    def prefetch(self, batch: PointBatch) -> None:
        """Start the next batch's level-0 pass; ``add_points_batch`` picks
        the result up by array identity."""
        handles = getattr(self, "_prefetch_handles", None)
        if handles is None:
            handles = self._prefetch_handles = {}
        if id(batch.positions) in handles:
            return  # already dispatched (the entry keeps the array alive,
            # so its id cannot be recycled while present)
        config = self.metadata.config
        cell_size = config.cell_size(0)
        handle = dispatch_dedup(
            batch.positions, cell_size, config.sub_cell_size(cell_size),
            device=self.device,
        )
        handles[id(batch.positions)] = (batch.positions, handle)
        while len(handles) > 4:  # bound stale entries
            # a pipelined worker pops from this dict concurrently
            # (_take_prefetch): tolerate the key vanishing and the resize
            # RuntimeError
            try:
                handles.pop(next(iter(handles)), None)
            except (RuntimeError, StopIteration):
                break

    def _take_prefetch(self, positions):
        handles = getattr(self, "_prefetch_handles", None)
        if not handles:
            return None
        entry = handles.pop(id(positions), None)
        if entry is not None and entry[0] is positions:
            return entry[1]
        return None
