"""NativeConverter: the C++ conversion engine behind the Converter API.

Copy of the reference's ``convert/native.py``, bound to the port's own
build of the engine (``point_cloud_tpu_torch/native``).

The whole cascade (hex dedup, overflow accounting, store serialization)
runs inside native/pc_engine.cpp — per-point flat-hash-table inserts, the
same sequential semantics as the reference's hot loop
(reference: point-converter/src/converter.rs:106-139, cell.rs:70-153) but
~10x the Python host oracle's throughput. Stores are byte-identical to the
host :class:`~.converter.Converter`'s (tests/test_native_engine.py).

When to use which converter (PERF.md gives the H100 measurements):

- ``NativeConverter`` — host-only, zero accelerator transfers. Keeps up
  to ``cache_size`` cells in RAM (~32 B/stored point); beyond that the
  engine spills the coldest cells to their store files between batches
  and reloads lazily.
- ``NativeDeviceConverter`` / ``DeviceConverter`` /
  ``PipelinedConverter`` — the device path: batch dedup as one device
  sort pass per level, the per-cell merge in this engine or in NumPy.

Metadata bookkeeping (bounding box f32 fold order, point counter,
hierarchy counter) stays in Python so ``metadata.json`` is byte-identical
across all converters.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from ..core.metadata import FILE_NAME, EXTENSION, Metadata, hierarchy_string
from ..core.point import PointBatch


class NativeConverter:
    """Drop-in Converter backed by the C++ engine (native/pc_engine.cpp)."""

    def __init__(self, metadata: Metadata, working_directory,
                 cache_size: int | None = None,
                 n_threads: int | None = None):
        # cache_size = cells kept in RAM (like the other converters'
        # LRU): beyond it the engine spills the coldest cells to their
        # store files between batches and reloads them lazily on touch —
        # results are identical at any size, only disk traffic changes
        from ..convert.converter import DEFAULT_CACHE_SIZE
        from ..native import load_native, hex_lockstep_ok

        if n_threads is None:
            # match the visible cores: the engine's cell shards are CPU-
            # bound, and oversubscribing a small host costs context
            # switches
            import os

            n_threads = min(8, len(os.sched_getaffinity(0))
                            if hasattr(os, "sched_getaffinity")
                            else os.cpu_count() or 1)

        lib = load_native()
        if lib is None:
            raise RuntimeError(
                "native engine unavailable (no C++ toolchain); use "
                "Converter/DeviceConverter instead"
            )
        if not hex_lockstep_ok():
            # the same gate hex_keys_native applies: a toolchain whose hex
            # kernel diverges from the NumPy oracle would silently write
            # stores that differ from the other converters (CLAUDE.md
            # invariant #1)
            raise RuntimeError(
                "native hex kernel fails the IEEE-f32 lockstep self-check "
                "on this toolchain; the C++ engine would break store "
                "byte-parity — use Converter/DeviceConverter instead"
            )
        self._lib = lib
        self.metadata = metadata
        self.working_directory = Path(working_directory)
        self.working_directory.mkdir(parents=True, exist_ok=True)
        self.n_threads = n_threads
        config = metadata.config
        self._engine = lib.pc_engine_create(
            int(config.cell_point_overflow_limit),
            ctypes.c_float(np.float32(config.max_cell_size)),
            int(config.sub_grid_dimension),
            int(n_threads),
        )
        # spilling doubles as lazy incremental merge (lib.rs:86-101): a
        # cell miss checks the store directory first, so an existing
        # store's cells stream in on touch instead of loading up front.
        # cache_size=0 means "spill everything between batches" (matching
        # Converter's literal interpretation), None means the default
        budget = DEFAULT_CACHE_SIZE if cache_size is None else cache_size
        lib.pc_engine_set_spill(
            self._engine, str(self.working_directory).encode(), int(budget)
        )

    # --- batch entry point (mirrors Converter.add_points_batch) ----------

    def add_points_batch(self, batch: PointBatch) -> None:
        self._update_bounding_box(batch)
        self.metadata.number_of_points += len(batch)
        if len(batch) == 0:
            return
        pos = np.ascontiguousarray(batch.positions, np.float32)
        col = np.ascontiguousarray(batch.colors, np.uint8)
        levels = self._lib.pc_engine_add_batch(
            self._engine,
            pos.ctypes.data_as(ctypes.c_void_p),
            col.ctypes.data_as(ctypes.c_void_p),
            len(batch),
        )
        if levels < 0:
            raise OSError(
                "corrupt or mismatched cell file encountered while lazily "
                "loading the existing store; conversion aborted (the store "
                "is left untouched — no writes happen after a load error)"
            )
        if levels > self.metadata.hierarchies:
            self.metadata.hierarchies = levels

    def _update_bounding_box(self, batch: PointBatch) -> None:
        from .converter import update_metadata_bounding_box

        update_metadata_bounding_box(self.metadata, batch)

    # --- persistence -------------------------------------------------------

    def save_metadata(self) -> None:
        self.metadata.write_to_path(
            self.working_directory / f"{FILE_NAME}.{EXTENSION}"
        )

    def close(self) -> None:
        if self._engine is None:
            return
        errors = self._lib.pc_engine_save_all(
            self._engine, str(self.working_directory).encode(),
            self.n_threads,
        )
        if errors < 0:
            # a lazy-load error latched: refuse to overwrite the store
            self._lib.pc_engine_destroy(self._engine)
            self._engine = None
            raise OSError(
                "store save aborted: a corrupt cell file was encountered "
                "during this conversion (store left as found)"
            )
        # NOTE: failed spills keep their cells resident, so a successful
        # save_all supersedes transient spill errors
        # folders for every counted hierarchy (engine only creates levels
        # that hold cells; a merged store may count more)
        for h in range(self.metadata.hierarchies):
            (self.working_directory / hierarchy_string(h)).mkdir(
                exist_ok=True
            )
        self.save_metadata()
        self._lib.pc_engine_destroy(self._engine)
        self._engine = None
        if errors:
            raise OSError(f"{errors} cell write(s) failed")

    def __enter__(self) -> "NativeConverter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            if getattr(self, "_engine", None) is not None:
                self._lib.pc_engine_destroy(self._engine)
                self._engine = None
        except Exception:
            pass
