#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port: its main path on one card.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (CUDA_HOME, default /usr/local/cuda) and g++;
builds the port's kernels and the C++ engine from the checkout at first
use. Imports no JAX. Phases, one JSON line each:

1. environment: torch/CUDA versions, the kernel and engine build times;
2. kernel vs plain: ``sort4`` on the card against ``sort4_reference``
   (torch.sort) at every size 2^10..2^22 on eight key shapes (three
   random ones and five that break merge sorts), exact equality, and
   both times at 2^17, 2^18 and 2^20, the lengths the slice sorts most
   (CUDA events, median of 7). The sizes include every bucket the slice
   sorts (2^15..2^21 at batch 2^18);
3. pass: ``get_pipeline("conversion", n=2^20)`` and ``dedup_pass_light``
   on the card against the same inputs through the port on the CPU,
   exact equality, and the pass times on the card;
4. slice: a 2^23-point LiDAR-like cloud (the port's ``synth_cloud``)
   written to PLY and converted by the port's CLI at batch 2^18, in
   subprocesses, three times: ``--device`` (the Python-cell
   ``PipelinedConverter``), ``--device-native`` (the C++ merge engine)
   and ``--native`` (the C++ host engine alone). The three stores must be
   byte-identical, both device runs must have launched the sort kernel,
   and every length they sorted must be one that phase 2 checked. Each
   subprocess counts its launches from zero, so its count is its main
   path's and no other.

Then the card's ``nvidia-smi`` name and power limit, the kernels' JSON
line (with ``sort4``'s byte bound: 16 B read and 16 B written a row at
the H100 SXM's 3.35 TB/s), and the last line ``{"ok": true, "device":
{...}}``. Any failed phase raises and exits non-zero before that line.
The script imports nothing of ``jax``, of ``point_cloud_tpu`` or of
``bench.py``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BATCH = 1 << 18
CLOUD_POINTS = 1 << 23
SORT_SIZES = tuple(range(10, 23))
TIMED_LOG_N = (17, 18, 20)
MAIN_LOG_N = 18  # the slice's dominant sort length (102 of 120 sorts)
TILE_ROWS = 2048  # rows one block of the kernel sorts (csrc/sort4.cu)
I32_MIN, I32_MAX = -(2**31), 2**31 - 1
KEY_SHAPES = ("full_range", "duplicates", "dedup_shaped", "all_equal",
              "presorted", "reversed", "long_runs", "extremes")
# H100 SXM data sheet: HBM3 bandwidth, and the peak rate outside the
# tensor cores (its f32 rate: the sheet gives none for int32)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
CLI_TIMEOUT_S = 600


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int = 7) -> float:
    """Median device time of ``fn()`` in ms over ``reps`` timed runs."""
    import torch

    fn()  # warm-up
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def sort_keys(kind: str, n: int, rng):
    import numpy as np

    arrival = np.arange(n, dtype=np.int32)
    if kind == "extremes":  # MIN and MAX in every column, k4 too
        choices = np.array([I32_MIN, I32_MIN + 1, -1, 0, I32_MAX - 1, I32_MAX],
                           np.int32)
        return [rng.choice(choices, n) for _ in range(4)]
    if kind in ("presorted", "reversed"):
        cols = [rng.integers(-8, 8, n).astype(np.int32) for _ in range(3)]
        order = np.lexsort(cols[::-1])
        cols = [c[order] for c in cols] + [arrival]
        return [c[::-1].copy() for c in cols] if kind == "reversed" else cols
    if kind == "all_equal":
        cols = [np.full(n, v, np.int32) for v in (7, -3, I32_MAX)]
    elif kind == "long_runs":  # k1 runs of 1.5 tiles cross tile and merge bounds
        run = 3 * TILE_ROWS // 2
        k1 = np.repeat(rng.integers(-50, 50, -(-n // run)), run)[:n]
        cols = [k1.astype(np.int32), rng.integers(0, 4, n).astype(np.int32),
                rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)]
    elif kind == "full_range":
        cols = [rng.integers(-(2**31), 2**31, n, dtype=np.int64)
                .astype(np.int32) for _ in range(3)]
        cols[0][:4] = [2**31 - 1, -(2**31), 0, -1]
    elif kind == "duplicates":
        cols = [rng.integers(0, 4, n).astype(np.int32) for _ in range(3)]
    else:  # dedup_shaped: clamped hashes, padding rows at i32::MAX
        cols = [
            rng.integers(0, 2**31 - 1, n).astype(np.int32),
            rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32),
            rng.integers(0, 2**31 - 1, n).astype(np.int32),
        ]
        pad = n // 8
        cols[0][-pad:] = 2**31 - 1
        cols[1][-pad:] = 0
        cols[2][-pad:] = 2**31 - 1
    return cols + [arrival]


def max_abs_err(got, ref) -> int:
    return max(int((g.long() - r.long()).abs().max()) for g, r in zip(got, ref))


def phase_kernel(torch, np, sort) -> dict:
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    checked, worst = [], 0
    for log_n in SORT_SIZES:
        for kind in KEY_SHAPES:
            cols = [torch.from_numpy(c).to(dev)
                    for c in sort_keys(kind, 1 << log_n, rng)]
            before = sort.launches
            got = sort.sort4(*cols)
            torch.cuda.synchronize()
            if sort.launches != before + 1:
                raise RuntimeError("sort4 did not count its launch")
            ref = sort.sort4_reference(*cols)
            err = max_abs_err(got, ref)
            worst = max(worst, err)
            if err != 0:
                raise AssertionError(f"sort4 != plain at 2^{log_n} {kind}")
            checked.append(f"2^{log_n}:{kind}")
    sort_ms, plain_ms = {}, {}
    for log_n in TIMED_LOG_N:
        cols = [torch.from_numpy(c).to(dev)
                for c in sort_keys("dedup_shaped", 1 << log_n, rng)]
        # alternate plain, kernel, kernel, plain on one card
        p1 = cuda_ms(lambda: sort.sort4_reference(*cols))
        k1 = cuda_ms(lambda: sort.sort4(*cols))
        k2 = cuda_ms(lambda: sort.sort4(*cols))
        p2 = cuda_ms(lambda: sort.sort4_reference(*cols))
        sort_ms[1 << log_n] = [k1, k2]
        plain_ms[1 << log_n] = [p1, p2]
    result = {
        "phase": "kernel_vs_plain", "ok": True, "checked": checked,
        "max_abs_err": worst, "sort_ms_by_n": sort_ms,
        "plain_ms_by_n": plain_ms,
    }
    emit(result)
    return result


def sort4_bound_ms(n: int) -> tuple[float, str]:
    """Least time for one ``sort4`` of ``n`` rows: each 16-byte row read
    once and written once, against one 4-column compare (4 i32 ops) per
    row per merge level; the larger of the two and which one it is."""
    bytes_ms = 32 * n / HBM_BYTES_PER_S * 1e3
    ops_ms = 4 * n * math.log2(n) / PEAK_OPS_PER_S * 1e3
    if bytes_ms >= ops_ms:
        return bytes_ms, "bytes"
    return ops_ms, "operations"


def phase_pass(torch, np, dedup, get_pipeline) -> dict:
    from point_cloud_tpu_torch.core.metadata import MetadataConfig
    from point_cloud_tpu_torch.models.synth import synth_cloud

    n = 1 << 20
    fn, args = get_pipeline("conversion", n=n, seed=0, device="cuda")
    cfn, cargs = get_pipeline("conversion", n=n, seed=0, device="cpu")
    got = [o.cpu() for o in fn(*args)]
    ref = cfn(*cargs)
    for i, (g, r) in enumerate(zip(got, ref)):
        same = (torch.equal(g.view(torch.int32), r.view(torch.int32))
                if g.dtype == torch.float32 else torch.equal(g, r))
        if not same:
            raise AssertionError(f"conversion pipeline output {i}: cuda != cpu")
    full_ms = cuda_ms(lambda: fn(*args), reps=5)

    config = MetadataConfig()
    cs = config.cell_size(0)
    pos = synth_cloud(n, seed=1)
    valid = np.ones(n, bool)
    dargs = dedup.pass_args(pos, valid, cs, config.sub_cell_size(cs), "cuda")
    hargs = dedup.pass_args(pos, valid, cs, config.sub_cell_size(cs), "cpu")
    packed = dedup.dedup_pass_light(*dargs).cpu()
    if not torch.equal(packed, dedup.dedup_pass_light(*hargs)):
        raise AssertionError("dedup_pass_light: cuda != cpu")
    light_ms = cuda_ms(lambda: dedup.dedup_pass_light(*dargs), reps=5)
    result = {
        "phase": "pass", "ok": True, "n": n,
        "conversion_pipeline_ms": full_ms, "dedup_pass_light_ms": light_ms,
        "winners": int(((packed >> 30) & 1).sum()),
        "suspects": int(((packed >> 29) & 1).sum()),
    }
    emit(result)
    return result


def run_cli(flag: str, src: Path, out: Path) -> dict:
    cmd = [sys.executable, "-m", "point_cloud_tpu_torch.convert.cli", flag,
           "--batch-size", str(BATCH), "--profile", "-o", str(out),
           "-f", str(src)]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=CLI_TIMEOUT_S)
    if proc.returncode != 0 or "Failed converting" in proc.stderr:
        raise RuntimeError(f"{flag} conversion failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def store_files(root: Path) -> dict:
    return {str(p.relative_to(root)): p for p in sorted(root.rglob("*"))
            if p.is_file()}


def sorted_lengths(run: dict, flag: str, checked_lengths) -> dict:
    """The run's sort4 launches by length; fails if it launched none or
    sorted a length that phase 2 did not check."""
    if run["launches"]["sort4"] <= 0:
        raise AssertionError(f"the {flag} run launched no sort4")
    by_n = {int(n): c for n, c in run["launches_by_n"]["sort4"].items()}
    unchecked = sorted(n for n in by_n if n not in checked_lengths)
    if unchecked:
        raise AssertionError(f"the {flag} run sorted lengths {unchecked} "
                             "that phase 2 did not check")
    return by_n


def phase_slice(np, checked_lengths) -> dict:
    import filecmp

    from point_cloud_tpu_torch.core.point import PointBatch
    from point_cloud_tpu_torch.io.ply import write_ply
    from point_cloud_tpu_torch.models.synth import synth_cloud

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        rng = np.random.default_rng(3)
        src = tmp / "cloud.ply"
        write_ply(src, PointBatch(
            synth_cloud(CLOUD_POINTS, seed=0),
            rng.integers(0, 256, (CLOUD_POINTS, 4), dtype=np.uint8),
        ))
        runs = {flag: run_cli(flag, src, tmp / flag.strip("-"))
                for flag in ("--device", "--device-native", "--native")}
        host = store_files(tmp / "native")
        for flag in ("--device", "--device-native"):
            port = store_files(tmp / flag.strip("-"))
            if not host or set(port) != set(host):
                raise AssertionError(f"{flag}: store file sets differ")
            bad = [k for k in host
                   if not filecmp.cmp(port[k], host[k], shallow=False)]
            if bad:
                raise AssertionError(
                    f"{flag}: {len(bad)} store files differ: {bad[:5]}")
        device, native_device = runs["--device"], runs["--device-native"]
        stages = device["stages"]
        result = {
            "phase": "slice", "ok": True, "points": CLOUD_POINTS,
            "batch_size": BATCH, "store_files": len(host),
            "byte_identical": True,
            "sort4_launches": native_device["launches"]["sort4"],
            "sort4_launches_by_n": sorted_lengths(
                native_device, "--device-native", checked_lengths),
            "device_sort4_launches": device["launches"]["sort4"],
            "device_sort4_launches_by_n": sorted_lengths(
                device, "--device", checked_lengths),
            "device_s": device["convert_s"],
            "device_native_s": native_device["convert_s"],
            "native_s": runs["--native"]["convert_s"],
            "device_mpts_s": CLOUD_POINTS / device["convert_s"] / 1e6,
            "device_native_mpts_s":
                CLOUD_POINTS / native_device["convert_s"] / 1e6,
            "native_mpts_s": CLOUD_POINTS / runs["--native"]["convert_s"] / 1e6,
            "device_stages": {name: stages[name] for name in (
                "d2h_wait", "host_rebuild", "lsm_merge", "overflow_staging",
            ) if name in stages},
        }
    emit(result)
    return result


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from point_cloud_tpu_torch.models import get_pipeline
    from point_cloud_tpu_torch.ops import dedup, runtime, sort

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    runtime.load_kernels()
    t1 = time.perf_counter()
    # the C++ engine (g++, ~20 s) builds here, outside the timed
    # conversions of phase 4
    from point_cloud_tpu_torch.native import hex_lockstep_ok

    if not hex_lockstep_ok():
        raise RuntimeError("C++ engine unavailable or not in IEEE lockstep")
    emit({
        "phase": "environment", "ok": True, "nvidia_smi": smi,
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
        "kernel_build_s": runtime.build_info["seconds"],
        "kernel_load_s": t1 - t0,
        "engine_build_s": time.perf_counter() - t1,
    })

    kernel = phase_kernel(torch, np, sort)
    phase_pass(torch, np, dedup, get_pipeline)
    sliced = phase_slice(np, {1 << log_n for log_n in SORT_SIZES})
    pulled = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "point_cloud_tpu", "bench"))
    if pulled:
        raise AssertionError(f"the port pulled in {pulled[:5]}")

    print(smi)
    main_n = 1 << MAIN_LOG_N
    bound_ms, bound_by = sort4_bound_ms(main_n)
    emit({"kernels": [{
        "name": "sort4", "route": "cuda",
        "source": "point_cloud_tpu_torch/csrc/sort4.cu",
        "replaces": "point_cloud_tpu/ops/sort_pallas.py:220",
        "launches": sliced["sort4_launches"],
        "max_abs_err": kernel["max_abs_err"],
        "ms": statistics.median(kernel["sort_ms_by_n"][main_n]),
        "plain_ms": statistics.median(kernel["plain_ms_by_n"][main_n]),
        "bound_ms": bound_ms, "bound_by": bound_by,
        # no single PyTorch call sorts four i32 columns lexicographically
        "library_ms": None,
        "n": main_n,
        "launches_by_path": {
            "--device-native": {"launches": sliced["sort4_launches"],
                                "by_n": sliced["sort4_launches_by_n"]},
            "--device": {"launches": sliced["device_sort4_launches"],
                         "by_n": sliced["device_sort4_launches_by_n"]},
        },
        "bound_ms_by_n": {n: sort4_bound_ms(n)[0]
                          for n in kernel["sort_ms_by_n"]},
        "ms_by_n": {n: statistics.median(t)
                    for n, t in kernel["sort_ms_by_n"].items()},
        "plain_ms_by_n": {n: statistics.median(t)
                          for n, t in kernel["plain_ms_by_n"].items()},
    }]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
