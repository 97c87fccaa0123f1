"""Wavefront-pipelined converter: overlap consecutive batches' cascades.

Counterpart of ``point_cloud_tpu/convert/pipelined.py``, over the port's
:class:`~.device.DeviceConverter` (and its explicit ``device``). The
worker threads share the default CUDA stream: their launches and
non-blocking copies serialize on it, and each level's handle keeps its
pinned readback buffer and event until ``collect_dedup`` copies the
packed rows out.

The cascade's cross-batch ordering constraint is *per level*: cells at
hierarchy ``h`` must see batch k's points before batch k+1's, but batch
k+1's level-0 work is independent of batch k's level-1+ work (different
hierarchies touch disjoint cell sets; level-h staging writes only level-h
cells). So consecutive batches run as a wavefront on two threads: while
batch k blocks on the device transfer for level 2, batch k+1 merges level
0.

Determinism/byte-parity is preserved because the per-level barriers force
exactly the serial order of every cell-state mutation (the parity tests
compare this class's stores against the host oracle byte for byte). Shared
structures (cell cache, hierarchy counter) are lock-protected; bbox/count
updates happen at submission time on the caller's thread, keeping batch
order. The host-tail shortcut is disabled (it would process several levels
without barriers); tails run through the per-level device loop instead.

Usage: drop-in for DeviceConverter — ``add_points_batch`` submits and
returns; ``close()`` drains. Depth is 2: the device is a single stream and
host staging is the other pipeline stage.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor

from ..core.point import PointBatch
from .device import DeviceConverter


class PipelinedConverter(DeviceConverter):
    PIPELINE_DEPTH = 2

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._merge_pool = ThreadPoolExecutor(8)  # eager: no lazy-init race
        self._executor = ThreadPoolExecutor(self.PIPELINE_DEPTH)
        self._futures: list = []
        self._seq = 0
        self._level_progress: dict[int, int] = {}
        self._done_batches: set[int] = set()
        self._cv = threading.Condition()
        self._shared_lock = threading.RLock()
        self._pipe_error: BaseException | None = None

    # --- per-level ordering ----------------------------------------------------

    def _wait_predecessor(self, seq: int, hierarchy: int) -> None:
        if seq == 0:
            return
        with self._cv:
            self._cv.wait_for(
                lambda: (
                    (seq - 1) in self._done_batches
                    or self._level_progress.get(seq - 1, -1) >= hierarchy
                )
            )

    def _mark_level(self, seq: int, hierarchy: int) -> None:
        with self._cv:
            self._level_progress[seq] = hierarchy
            self._cv.notify_all()

    def _mark_done(self, seq: int) -> None:
        with self._cv:
            self._done_batches.add(seq)
            self._level_progress.pop(seq, None)
            self._cv.notify_all()

    # --- lock-protected shared state --------------------------------------------

    def get_cell(self, cell_id, pin: bool = False):
        with self._shared_lock:
            return super().get_cell(cell_id, pin=pin)

    def unpin_cells(self, cell_ids) -> None:
        # unpinning may evict excess entries (cell.to_bytes + write), so it
        # needs the same serialization as get_cell
        with self._shared_lock:
            super().unpin_cells(cell_ids)

    def _create_hierarchy_folder(self, hierarchy: int) -> None:
        with self._shared_lock:
            super()._create_hierarchy_folder(hierarchy)

    # --- pipelined cascade --------------------------------------------------------

    def _cascade_for(self, seq: int, positions, colors) -> None:
        hierarchy = 0
        prefetch = self._take_prefetch(positions)
        ctx: dict = {"resident": None}  # per-batch device-resident buffer
        src = None
        try:
            while len(positions):
                self._wait_predecessor(seq, hierarchy)
                positions, colors, src = self._cascade_level(
                    positions, colors, hierarchy, prefetch, src, ctx
                )
                prefetch = None
                self._mark_level(seq, hierarchy)
                hierarchy += 1
        finally:
            self._mark_done(seq)

    # --- submission -----------------------------------------------------------------

    def add_points_batch(self, batch: PointBatch) -> None:
        if self._pipe_error is not None:
            raise self._pipe_error
        # ordered metadata updates on the caller's thread (replace-on-first
        # bbox depends on the running count)
        self._update_bounding_box(batch)
        self.metadata.number_of_points += len(batch)
        self.prefetch(batch)
        seq = self._seq
        self._seq += 1
        positions, colors = batch.positions, batch.colors

        def job():
            try:
                self._cascade_for(seq, positions, colors)
            except BaseException as err:
                self._pipe_error = err
                raise

        self._futures.append(self._executor.submit(job))
        # bound the queue: wait for older work beyond the pipeline depth
        while len(self._futures) > self.PIPELINE_DEPTH:
            self._futures.pop(0).result()

    def drain(self) -> None:
        for f in self._futures:
            f.result()
        self._futures.clear()
        if self._pipe_error is not None:
            raise self._pipe_error

    def close(self) -> None:
        # drain() re-raises a pipeline error; cleanup must still run or
        # the executor leaks and metadata.json is never written — a
        # later resume would restart from zero over a directory that
        # already holds point-bearing cells (same fix as
        # NativeDevicePipelined.close)
        try:
            self.drain()
        finally:
            self._executor.shutdown()
            super().close()
