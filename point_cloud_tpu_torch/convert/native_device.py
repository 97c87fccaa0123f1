"""Device dedup pass + the reference's C++ merge engine.

Counterpart of ``point_cloud_tpu/convert/native_device.py``
(``NativeDeviceConverter``, ``NativeDevicePipelined``,
``HOST_CASCADE_THRESHOLD``). The classes subclass the port's copy of the
reference's :class:`~.native.NativeConverter`, so the whole host half —
cell state, the LSM winner merge, the key rebuild and suspect audit
inside ``pc_engine_merge_level_raw``, overflow staging, spilling, store
writes — runs in the reference's C++ engine (``native/pc_engine.cpp``).
The per-level device pass is :mod:`point_cloud_tpu_torch.ops.dedup`.

Per batch: while a level is at/above ``HOST_CASCADE_THRESHOLD`` rows,
one device pass -> one ``pc_engine_merge_level_raw`` ->
``pc_engine_take_level`` feeds the next level; the engine finishes the
sub-threshold tail natively (``pc_engine_cascade_from``). Stores are
byte-identical to the host oracle ``Converter`` at equal batch schedule.

``device`` is explicit: ``"cuda"`` without a card raises; ``"cpu"`` runs
the plain versions (the tests).
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..core.point import PointBatch
from ..ops.dedup import dispatch_dedup_auto, packed_host
from ..ops.runtime import resolve_device
from ..utils.tracing import stage
from . import device as device_mod
from .device import DevicePrefetchMixin
from .native import NativeConverter

# levels below this many rows finish in the engine. The reference's
# 2^15, kept until the H100 break-even is measured (ROADMAP.md).
HOST_CASCADE_THRESHOLD = 1 << 15


def _ptr(arr: np.ndarray) -> ctypes.c_void_p:
    return arr.ctypes.data_as(ctypes.c_void_p)


class NativeDeviceConverter(DevicePrefetchMixin, NativeConverter):
    """Device-pass converter whose cell state lives in the C++ engine."""

    def __init__(self, metadata, working_directory,
                 cache_size: int | None = None,
                 n_threads: int | None = None, *, device="cuda"):
        self.device = resolve_device(device)  # raises before any engine
        super().__init__(metadata, working_directory, cache_size=cache_size,
                         n_threads=n_threads)

    def add_points_batch(self, batch: PointBatch) -> None:
        self._update_bounding_box(batch)
        self.metadata.number_of_points += len(batch)
        if len(batch) == 0:
            return
        self._run_cascade(
            np.ascontiguousarray(batch.positions, np.float32),
            np.ascontiguousarray(batch.colors, np.uint8),
            self._take_prefetch(batch.positions),
            seq=0,
        )

    # --- wavefront hooks (no-ops in the serial converter) -----------------

    def _wait_level(self, seq: int, hierarchy: int) -> None:
        """Block until the previous batch finished its ``hierarchy`` merge."""

    def _mark_level(self, seq: int, hierarchy: int) -> None:
        """Record that this batch finished its ``hierarchy`` merge."""

    @contextlib.contextmanager
    def _engine_guard(self):
        """Serialize engine calls (one lock in the pipelined variant)."""
        yield

    def _run_cascade(self, positions, colors, prefetch_handle,
                     seq: int) -> None:
        """One batch's cascade (reference native_device.py:88-161)."""
        config = self.metadata.config
        lib, engine = self._lib, self._engine
        hierarchy = 0
        # src maps this level's rows into the level-0 device buffer (the
        # engine's take_level threads it through the staging)
        resident = None
        src: np.ndarray | None = None
        while len(positions):
            if (
                len(positions) < HOST_CASCADE_THRESHOLD
                and prefetch_handle is None
            ):
                # small tail: the engine finishes every level >= hierarchy,
                # so it waits for the predecessor batch to finish entirely
                self._wait_level(seq, 63)
                with stage("native_tail_cascade"), self._engine_guard():
                    lib.pc_engine_cascade_from(
                        engine, hierarchy, _ptr(positions), _ptr(colors),
                        len(positions),
                    )
                break
            cell_size = config.cell_size(hierarchy)
            sub_cell_size = config.sub_cell_size(cell_size)
            handle, resident, src, src_arr = dispatch_dedup_auto(
                resident, src, positions, cell_size, sub_cell_size,
                prefetch_handle=prefetch_handle,
                enabled=device_mod.RESIDENT_ENABLED,
                device=self.device,
            )
            prefetch_handle = None
            n_rows = handle["n"]
            with stage("d2h_wait"):
                packed = packed_host(handle)
            src_s = np.ascontiguousarray(src_arr, np.int32)
            self._wait_level(seq, hierarchy)
            # the engine gathers the permutation, recomputes the hex keys
            # and re-dedups suspects exactly, all in C++
            with stage("native_merge_level"), self._engine_guard():
                n_out = lib.pc_engine_merge_level_raw(
                    engine, hierarchy, n_rows, _ptr(positions),
                    _ptr(colors), _ptr(src_s), _ptr(packed),
                )
                if n_out < 0:
                    self._raise_load_error()
                positions = np.empty((n_out, 3), np.float32)
                colors = np.empty((n_out, 4), np.uint8)
                src = np.empty(n_out, np.int32)
                lib.pc_engine_take_level(engine, _ptr(positions),
                                         _ptr(colors), _ptr(src))
            self._mark_level(seq, hierarchy)
            hierarchy += 1
        # end-of-batch bookkeeping (spill + error latch) in batch order
        self._wait_level(seq, 63)
        with self._engine_guard():
            if lib.pc_engine_end_batch(engine) < 0:
                self._raise_load_error()
            levels = lib.pc_engine_max_level(engine)
            if levels > self.metadata.hierarchies:
                self.metadata.hierarchies = levels

    def _raise_load_error(self) -> None:
        raise OSError(
            "corrupt or mismatched cell file encountered while lazily "
            "loading the existing store; conversion aborted (the store "
            "is left untouched — no writes happen after a load error)"
        )


class NativeDevicePipelined(NativeDeviceConverter):
    """Wavefront variant (reference native_device.py:171-271): batch k+1's
    device pass and readback overlap batch k's engine merges. Per-level
    barriers keep every engine mutation in the serial order, and one lock
    serializes the engine itself, so stores stay byte-identical.

    The worker threads share the default CUDA stream: their launches and
    non-blocking copies serialize on it, and each handle keeps its pinned
    readback buffer and event until :func:`packed_host` copies it out.
    """

    PIPELINE_DEPTH = 3

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._executor = ThreadPoolExecutor(self.PIPELINE_DEPTH)
        self._futures: list = []
        self._seq = 0
        self._cv = threading.Condition()
        self._level_progress: dict[int, int] = {}
        self._done_batches: set[int] = set()
        self._engine_lock = threading.RLock()
        self._pipe_error: BaseException | None = None

    def _wait_level(self, seq: int, hierarchy: int) -> None:
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

    @contextlib.contextmanager
    def _engine_guard(self):
        with self._engine_lock:
            yield

    def add_points_batch(self, batch: PointBatch) -> None:
        if self._pipe_error is not None:
            raise self._pipe_error
        self._update_bounding_box(batch)
        self.metadata.number_of_points += len(batch)
        if len(batch) == 0:
            return
        self.prefetch(batch)
        seq = self._seq
        self._seq += 1
        positions = np.ascontiguousarray(batch.positions, np.float32)
        colors = np.ascontiguousarray(batch.colors, np.uint8)
        prefetch_handle = self._take_prefetch(batch.positions)

        def job():
            try:
                self._run_cascade(positions, colors, prefetch_handle, seq)
            except BaseException as err:
                self._pipe_error = err
                raise
            finally:
                self._mark_done(seq)

        self._futures.append(self._executor.submit(job))
        while len(self._futures) > self.PIPELINE_DEPTH:
            self._futures.pop(0).result()

    def drain(self) -> None:
        for f in self._futures:
            f.result()
        self._futures.clear()
        if self._pipe_error is not None:
            raise self._pipe_error

    def close(self) -> None:
        # drain() re-raises a pipeline error; cleanup must still run or the
        # executor's threads leak
        try:
            self.drain()
        finally:
            self._executor.shutdown()
            super().close()
