"""ctypes binding for the native C++ runtime (native/pc_native.cpp).

Copy of the reference's ``native/__init__.py``. It builds the same
sources (the repo-root ``native/*.cpp`` and ``*.h``) with the same g++
flags, but into the port's own ``point_cloud_tpu_torch/_build/``: the
library's file name carries a hash of the sources and flags, one build
runs at a time under a file lock (test workers share the directory),
and the finished library is published with an atomic ``os.replace``.
If no toolchain is available everything degrades to a pure-Python thread
pool so the framework stays importable anywhere.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path

log = logging.getLogger(__name__)

_PKG_DIR = Path(__file__).resolve().parents[1]
_NATIVE_DIR = _PKG_DIR.parent / "native"
_SRC = _NATIVE_DIR / "pc_native.cpp"
_SOURCES = [
    _SRC, _NATIVE_DIR / "pc_engine.cpp", _NATIVE_DIR / "pc_laszip.cpp",
]
_HEADERS = [_NATIVE_DIR / "pc_hex.h", _NATIVE_DIR / "pc_io.h"]
_BUILD_DIR = _PKG_DIR / "_build"

_lib = None
_lib_lock = threading.Lock()
_build_failed = False


def _flags() -> list[str]:
    # -ffp-contract=off: GCC defaults to contracting mul+add into FMA on
    # targets where FMA is baseline (e.g. aarch64), which changes rounding
    # of kSqrt3*y+1.0f / dx*dx+dy*dy in pc_hex_keys and silently breaks the
    # bit-for-bit IEEE f32 lockstep with the NumPy/torch paths (CLAUDE.md
    # invariant #2). -fno-fast-math guards against toolchain defaults.
    import platform

    return [
        # -O3 -march=native: ~10% on the conversion engine (the hex keys
        # pass alone runs 35% faster); IEEE lockstep still holds — FMA
        # contraction stays off and GCC does not reassociate/vectorize
        # f32 reductions without -ffast-math — and _check_hex_lockstep
        # re-verifies bit parity against NumPy at every load.
        "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
        "-pthread", "-ffp-contract=off", "-fno-fast-math",
        # SSE4.1 enables the hand-vectorized hex pass (pc_hex.h); lockstep
        # with NumPy still holds (IEEE per-lane ops) and is re-verified at
        # runtime by _check_hex_lockstep
        *(["-msse4.1"] if platform.machine() in ("x86_64", "AMD64") else []),
    ]


def _lib_path(flags: list[str]) -> Path:
    """``_build/libpcnative_<hash>.so``, the hash over flags and sources."""
    h = hashlib.sha256(" ".join(flags).encode())
    for path in (*_SOURCES, *_HEADERS):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return _BUILD_DIR / f"libpcnative_{h.hexdigest()[:16]}.so"


def _build(flags: list[str], lib_path: Path) -> bool:
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    cmd = ["g++", *flags, *[str(s) for s in _SOURCES], "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, FileNotFoundError) as err:
        log.warning("native build failed, using Python fallback: %s", err)
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, lib_path)  # atomic: a reader never sees a partial file
    return True


def _built_library() -> Path | None:
    """The built library's path, building it first if it is missing; one
    process builds while the others wait on the lock, then find it."""
    flags = _flags()
    lib_path = _lib_path(flags)
    if lib_path.exists():
        return lib_path
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(_BUILD_DIR / "libpcnative.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if lib_path.exists() or _build(flags, lib_path):
            return lib_path
    return None


def load_native():
    """The loaded CDLL, or None if unavailable."""
    global _lib, _build_failed
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        if not _SRC.exists():
            _build_failed = True
            return None
        lib_path = _built_library()
        if lib_path is None:
            _build_failed = True
            return None
        lib = ctypes.CDLL(str(lib_path))
        lib.pc_pool_create.restype = ctypes.c_void_p
        lib.pc_pool_create.argtypes = [ctypes.c_int]
        lib.pc_pool_submit_write.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64,
        ]
        lib.pc_pool_pending.restype = ctypes.c_int64
        lib.pc_pool_pending.argtypes = [ctypes.c_void_p]
        lib.pc_pool_error_count.restype = ctypes.c_int64
        lib.pc_pool_error_count.argtypes = [ctypes.c_void_p]
        lib.pc_pool_flush.argtypes = [ctypes.c_void_p]
        lib.pc_pool_destroy.argtypes = [ctypes.c_void_p]
        lib.pc_read_file.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.pc_read_file.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ]
        lib.pc_free.argtypes = [ctypes.c_void_p]
        lib.pc_hex_keys.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ]
        lib.pc_bbox_f32.restype = ctypes.c_int
        lib.pc_bbox_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        lib.pc_staging_sort.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.pc_lsm_probe.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int,
        ]
        lib.pc_engine_create.restype = ctypes.c_void_p
        lib.pc_engine_create.argtypes = [
            ctypes.c_int64, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ]
        lib.pc_engine_destroy.argtypes = [ctypes.c_void_p]
        lib.pc_engine_add_batch.restype = ctypes.c_int32
        lib.pc_engine_add_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64,
        ]
        lib.pc_engine_load_cell.restype = ctypes.c_int
        lib.pc_engine_load_cell.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
        ]
        lib.pc_engine_save_all.restype = ctypes.c_int64
        lib.pc_engine_save_all.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
        ]
        lib.pc_engine_max_level.restype = ctypes.c_int32
        lib.pc_engine_max_level.argtypes = [ctypes.c_void_p]
        lib.pc_engine_num_cells.restype = ctypes.c_int64
        lib.pc_engine_num_cells.argtypes = [ctypes.c_void_p]
        lib.pc_engine_set_spill.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
        ]
        lib.pc_engine_spill_errors.restype = ctypes.c_int64
        lib.pc_engine_spill_errors.argtypes = [ctypes.c_void_p]
        lib.pc_engine_cascade_from.restype = ctypes.c_int32
        lib.pc_engine_cascade_from.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.pc_engine_merge_level.restype = ctypes.c_int64
        lib.pc_engine_merge_level.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.pc_engine_merge_level_raw.restype = ctypes.c_int64
        lib.pc_engine_merge_level_raw.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        lib.pc_engine_take_level.restype = ctypes.c_int64
        lib.pc_engine_take_level.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        lib.pc_engine_end_batch.restype = ctypes.c_int32
        lib.pc_engine_end_batch.argtypes = [ctypes.c_void_p]
        lib.pc_laz_decompress_chunk.restype = ctypes.c_int64
        lib.pc_laz_decompress_chunk.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.pc_laz_compress_chunk.restype = ctypes.c_int64
        lib.pc_laz_compress_chunk.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.pc_laz14_decompress_chunk.restype = ctypes.c_int64
        lib.pc_laz14_decompress_chunk.argtypes = (
            lib.pc_laz_decompress_chunk.argtypes
        )
        lib.pc_laz14_compress_chunk.restype = ctypes.c_int64
        lib.pc_laz14_compress_chunk.argtypes = (
            lib.pc_laz_compress_chunk.argtypes
        )
        lib.pc_laz_decompress_chunk_table.restype = ctypes.c_int64
        lib.pc_laz_decompress_chunk_table.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p,
        ]
        lib.pc_laz_compress_chunk_table.restype = ctypes.c_int64
        lib.pc_laz_compress_chunk_table.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64,
        ]
        _lib = lib
        return _lib


def _ptr(arr):
    import numpy as np

    return arr.ctypes.data_as(ctypes.c_void_p)


_hex_lockstep_ok: bool | None = None


def _check_hex_lockstep(lib) -> bool:
    """One-time probe: the C++ hex pass must be bit-identical to the NumPy
    oracle (CLAUDE.md invariant #2). A toolchain that contracts mul+add
    into FMA (or any other rounding divergence) fails here and the
    converter silently falls back to NumPy instead of corrupting stores.
    """
    import numpy as np

    from ..core import hex as hexgrid
    from ..core.metadata import MetadataConfig

    rng = np.random.default_rng(0x5EED)
    pos = np.concatenate([
        rng.uniform(-1000, 1000, (2048, 3)),
        rng.uniform(-0.01, 0.01, (512, 3)),
        rng.normal(0, 1e6, (512, 3)),
    ]).astype(np.float32)
    config = MetadataConfig()
    cell_size = np.float32(config.max_cell_size)
    radius = np.float32(config.sub_cell_size(cell_size)) / np.float32(2.0)
    next_cell_size = cell_size / np.float32(2.0)

    n = len(pos)
    cell_idx = np.empty((n, 3), np.int32)
    sub_idx = np.empty((n, 3), np.int32)
    dist = np.empty(n, np.float32)
    next_idx = np.empty((n, 3), np.int32)
    lib.pc_hex_keys(
        _ptr(pos), n, ctypes.c_float(cell_size), ctypes.c_float(radius),
        ctypes.c_float(next_cell_size), _ptr(cell_idx), _ptr(sub_idx),
        _ptr(dist), _ptr(next_idx), 2,
    )

    ref_cell = config.cell_index(pos, cell_size)
    ref_next = config.cell_index(pos, next_cell_size)
    ref_sub = hexgrid.offset_from_world(pos, radius)
    centers = hexgrid.offset_to_world(ref_sub, radius)
    d = pos - centers
    with np.errstate(over="ignore"):  # inf on extremes is the IEEE result
        ref_dist = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
    ok = (
        np.array_equal(cell_idx, ref_cell)
        and np.array_equal(next_idx, ref_next)
        and np.array_equal(sub_idx, ref_sub)
        and np.array_equal(
            dist.view(np.uint32), ref_dist.astype(np.float32).view(np.uint32)
        )
    )
    if not ok:
        log.warning(
            "native hex kernel diverges from the NumPy IEEE-f32 oracle on "
            "this toolchain; falling back to NumPy for hex quantization"
        )
    return ok


def hex_lockstep_ok() -> bool:
    """One-time cached result of the IEEE-f32 lockstep self-check; False
    also when the native library is unavailable. Gate for every consumer
    of the C++ hex math (hex_keys_native, the conversion engine)."""
    global _hex_lockstep_ok
    lib = load_native()
    if lib is None:
        return False
    if _hex_lockstep_ok is None:
        _hex_lockstep_ok = _check_hex_lockstep(lib)
    return _hex_lockstep_ok


def hex_keys_native(positions, cell_size, sub_cell_radius, next_cell_size,
                    n_threads: int = 8):
    """C++ hex quantization pass; returns (cell_idx, sub_idx, dist,
    next_idx) bit-identical to the NumPy path, or None if unavailable
    (no toolchain, or the one-time lockstep self-check failed)."""
    lib = load_native()
    if lib is None or not hex_lockstep_ok():
        return None
    import numpy as np

    positions = np.ascontiguousarray(positions, np.float32)
    n = len(positions)
    cell_idx = np.empty((n, 3), np.int32)
    sub_idx = np.empty((n, 3), np.int32)
    dist = np.empty(n, np.float32)
    next_idx = np.empty((n, 3), np.int32)
    lib.pc_hex_keys(
        _ptr(positions), n, ctypes.c_float(cell_size),
        ctypes.c_float(sub_cell_radius), ctypes.c_float(next_cell_size),
        _ptr(cell_idx), _ptr(sub_idx), _ptr(dist), _ptr(next_idx), n_threads,
    )
    return cell_idx, sub_idx, dist, next_idx


def bbox_f32_native(positions):
    """Per-axis (min, max) of a contiguous (N, 3) f32 array via the SSE
    scan in pc_native.cpp — bit-identical to ``positions.min(axis=0)`` /
    ``.max(axis=0)`` (min/max are exact, order-independent IEEE f32 ops).
    Returns None when unavailable or when bit-identity with NumPy is not
    provable from the scan alone: NaN input (NumPy propagates NaN through
    min/max; SSE does not) or a zero extremum (min(-0.0, +0.0) is
    order-dependent even inside NumPy's reduce). Callers fall back to
    NumPy then, so the fold semantics never change."""
    lib = load_native()
    if lib is None:
        return None
    import numpy as np

    out_min = np.empty(3, np.float32)
    out_max = np.empty(3, np.float32)
    rc = lib.pc_bbox_f32(
        _ptr(positions), len(positions), _ptr(out_min), _ptr(out_max)
    )
    if rc != 0:
        return None
    return out_min, out_max


def lsm_probe_native(seg_keys, seg_valid, seg_dist, seg_offsets, queries,
                     n_threads: int = 8):
    """C++ multi-segment incumbent probe (core/cell.py merge_winners);
    returns (inc_dist, inc_seg, inc_loc) or None if unavailable."""
    lib = load_native()
    if lib is None:
        return None
    import numpy as np

    n = len(queries)
    seg_keys = np.ascontiguousarray(seg_keys, np.int64)
    seg_valid = np.ascontiguousarray(seg_valid, np.uint8)
    seg_dist = np.ascontiguousarray(seg_dist, np.float32)
    seg_offsets = np.ascontiguousarray(seg_offsets, np.int64)
    queries = np.ascontiguousarray(queries, np.int64)
    inc_dist = np.empty(n, np.float32)
    inc_seg = np.empty(n, np.int32)
    inc_loc = np.empty(n, np.int64)
    lib.pc_lsm_probe(
        _ptr(seg_keys), _ptr(seg_valid), _ptr(seg_dist), _ptr(seg_offsets),
        len(seg_offsets) - 1, _ptr(queries), n,
        _ptr(inc_dist), _ptr(inc_seg), _ptr(inc_loc), n_threads,
    )
    return inc_dist, inc_seg, inc_loc


def staging_sort_native(cell_key, next_key, pos_bits, color_key):
    """C++ comparison sort of the overflow-staging order; None if
    unavailable."""
    lib = load_native()
    if lib is None:
        return None
    import numpy as np

    n = len(cell_key)
    cell_key = np.ascontiguousarray(cell_key, np.int64)
    next_key = np.ascontiguousarray(next_key, np.int64)
    pos_bits = np.ascontiguousarray(pos_bits, np.int32)
    color_key = np.ascontiguousarray(color_key, np.uint32)
    order = np.empty(n, np.int64)
    lib.pc_staging_sort(
        _ptr(cell_key), _ptr(next_key), _ptr(pos_bits), _ptr(color_key),
        n, _ptr(order),
    )
    return order


class AsyncStoreWriter:
    """Fire-and-forget store writes on native worker threads.

    Writes are atomic (tmp + rename) so a crash never leaves a truncated
    cell; ``flush()`` is the write barrier the converter calls before
    reading a cell back or finishing. Falls back to a Python thread pool
    when the native library is unavailable.
    """

    def __init__(self, n_threads: int = 4):
        self._lib = load_native()
        self._errors_base = 0
        if self._lib is not None:
            self._pool = self._lib.pc_pool_create(n_threads)
            self._executor = None
        else:
            import concurrent.futures

            self._pool = None
            self._executor = concurrent.futures.ThreadPoolExecutor(n_threads)
            self._futures = []
            self._py_errors = 0

    @property
    def native(self) -> bool:
        return self._pool is not None

    def submit(self, path, data: bytes) -> None:
        if self._pool is not None:
            self._lib.pc_pool_submit_write(
                self._pool, str(path).encode(), data, len(data)
            )
        else:
            def write(p=str(path), d=data):
                tmp = p + ".tmp"
                with open(tmp, "wb") as f:
                    f.write(d)
                os.replace(tmp, p)

            self._futures.append(self._executor.submit(write))

    def pending(self) -> int:
        if self._pool is not None:
            return int(self._lib.pc_pool_pending(self._pool))
        return sum(1 for f in self._futures if not f.done())

    def flush(self) -> int:
        """Block until all queued writes finish; returns error count."""
        if self._pool is not None:
            self._lib.pc_pool_flush(self._pool)
            return int(self._lib.pc_pool_error_count(self._pool))
        errors = 0
        for f in self._futures:
            try:
                f.result()
            except OSError:
                errors += 1
        self._futures.clear()
        self._py_errors += errors
        return self._py_errors

    def close(self) -> None:
        if self._pool is not None:
            self._lib.pc_pool_destroy(self._pool)
            self._pool = None
        elif self._executor is not None:
            self.flush()
            self._executor.shutdown()
            self._executor = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def read_file_native(path) -> bytes | None:
    """Read a whole file through the native helper (None on failure)."""
    lib = load_native()
    if lib is None:
        return None
    length = ctypes.c_int64()
    buf = lib.pc_read_file(str(path).encode(), ctypes.byref(length))
    if not buf or length.value < 0:
        return None
    try:
        return ctypes.string_at(buf, length.value)
    finally:
        lib.pc_free(buf)
