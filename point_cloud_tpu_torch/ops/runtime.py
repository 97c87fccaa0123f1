"""Device choice and the lazy CUDA build (counterpart of ops/runtime.py).

The reference's runtime module tunes JAX's compilation cache and probes a
remote TPU's health; neither exists here. What the port needs instead:

- :func:`resolve_device` — an explicit device. Asking for ``"cuda"``
  without a card raises: the main path never drops to the CPU by itself;
  the CPU is used only when a caller passes ``device="cpu"``.
- :func:`load_kernels` — builds ``csrc/*.cu`` (which may include
  ``csrc/*.cuh``) with nvcc into a shared library with a plain C
  interface (``sm_90a``), cached in ``_build/`` by a hash of the
  sources, headers and flags, and loads it with ctypes. One nvcc per
  source, all started together, then one link. The build runs at first
  use, never at import.
- :func:`f32_arg` — a kernel's f32 scalar argument on its device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from ..core.hex import f32_scalar

_PKG_DIR = Path(__file__).resolve().parent.parent
_CSRC = _PKG_DIR / "csrc"
_BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib = None
build_info: dict = {}  # path, seconds (0.0 when cached)


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises if CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain versions explicitly"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def f32_arg(value, device) -> torch.Tensor:
    """A kernel's f32 scalar argument: a number rounded to f32 on
    ``device``, or a one-element f32 tensor already there (any other
    tensor raises)."""
    if isinstance(value, torch.Tensor):
        if value.device != device or value.dtype != torch.float32 \
                or value.numel() != 1:
            raise ValueError(f"a kernel's scalar must be a number or a "
                             f"one-element f32 tensor on {device}")
        return value.contiguous()
    return f32_scalar(value, device)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (Path(cuda_home) / "bin" / "nvcc", shutil.which("nvcc")):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME); cannot build csrc/")


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def _digest(sources) -> str:
    """Hash of the flags, the sources and the headers they include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [*sources, *sorted(_CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _build(sources, out: Path) -> None:
    """Compile each source to an object, all nvcc processes at once, then
    link them into the shared library ``out``."""
    nvcc = _nvcc()
    objs = [out.with_name(f"{out.name}.{src.stem}.o") for src in sources]
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
        for src, obj in zip(sources, objs)
    ]
    errors = []
    for src, proc in zip(sources, procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{src.name} ({proc.returncode}):\n{err}")
    try:
        if errors:
            raise RuntimeError("nvcc failed: " + "\n".join(errors))
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", str(out), *map(str, objs)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)


def load_kernels():
    """The ctypes handle of the built kernel library (builds on first use)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        sources = _sources()
        lib_path = _BUILD_DIR / f"libpct_kernels_{_digest(sources)}.so"
        seconds = 0.0
        if not lib_path.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
            t0 = time.perf_counter()
            _build(sources, tmp)
            seconds = time.perf_counter() - t0
            os.replace(tmp, lib_path)  # atomic: concurrent builds agree
        lib = ctypes.CDLL(str(lib_path))
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.pc_sort4.restype = ctypes.c_int
        lib.pc_sort4.argtypes = [ptr] * 12 + [i64, ptr]
        lib.pc_cull_classify.restype = ctypes.c_int
        lib.pc_cull_classify.argtypes = (
            [ptr] * 8 + [i32, i32, ptr, ptr, i32, ptr, i32, i32, i32]
            + [ptr] * 7 + [i64, ptr])
        lib.pc_splat_raster.restype = ctypes.c_int
        lib.pc_splat_raster.argtypes = [ptr] * 9 + [i32] * 4 + [ptr] * 2
        lib.pc_emit_fragments.restype = ctypes.c_int
        lib.pc_emit_fragments.argtypes = (
            [ptr] * 12 + [i32] * 4 + [ptr, i64, i64, ptr])
        lib.pc_sorted_merge.restype = ctypes.c_int
        lib.pc_sorted_merge.argtypes = [ptr, i64, ptr, ptr, ptr, i64, ptr]
        lib.pc_quantize_sort4.restype = ctypes.c_int
        lib.pc_quantize_sort4.argtypes = [ptr] * 7 + [i64] + [ptr] * 13
        lib.pc_division_check.restype = ctypes.c_int
        lib.pc_division_check.argtypes = [ptr, ptr, i32, ptr, ptr, ptr, ptr]
        lib.pc_division_sweep.restype = ctypes.c_int
        lib.pc_division_sweep.argtypes = [ctypes.c_uint] * 3 + [ptr] * 3
        lib.pc_mark_pack.restype = ctypes.c_int
        lib.pc_mark_pack.argtypes = ([ptr] * 7 + [i64, ptr, ptr, i64, ptr]
                                     + [ctypes.c_uint] * 2 + [ptr])
        lib.pc_class_rank_scratch.restype = i64
        lib.pc_class_rank_scratch.argtypes = [i64, i32]
        lib.pc_class_rank.restype = ctypes.c_int
        lib.pc_class_rank.argtypes = ([ptr, i32, i64, i32, ptr, i64]
                                      + [ptr] * 4 + [i64, ptr])
        lib.pc_lod_select.restype = ctypes.c_int
        lib.pc_lod_select.argtypes = [ptr] * 4 + [i64, i32, ptr, i64, ptr]
        build_info.update(path=str(lib_path), seconds=seconds)
        _lib = lib
        return _lib
