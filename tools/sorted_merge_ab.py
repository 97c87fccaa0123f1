"""A/B of the sorted raster's merge kernel (K4) on one CUDA card.

Builds, each alone with nvcc and the flags of the port's
``ops/runtime.py`` (plus ``-shared``, and ``-Xptxas -v``, whose register
line it prints): ``point_cloud_tpu_torch/csrc/sorted_merge.cu`` of this
tree once for each variant of its constants ``kUnroll`` and
``kInFlightBytes`` that ``--variants`` names, and the ``sorted_merge.cu``
in the directory ``--parent`` (a parent commit's ``csrc``). All builds
run at once. Then, on three lists of ``--rows`` rows that ``sort4``
orders on the card, made from ``--seed``:

- ``dense``: pixels at random over 1280x720, no ``_NO_ID`` row, so
  nearly every pixel wins;
- ``tail``: ``--valid`` rows at random pixels below ``--tail-pixels``,
  the rest ``_NO_ID`` (K3's padding), the shape of the sorted arm's
  largest bucket;
- ``scan``: the dense list merged into a one-pixel plane, so only
  pixel 0's run wins: the pixel column's read alone.

Every library's plane must equal ``sorted_merge_reference``'s bit for
bit on each list. Then each list is timed plain, parent, the variants,
the variants in reverse, parent, plain, in this one process: device time
a launch by ``torch.profiler`` (``chip_smoke.device_kernel_ms``), each
launch after an L2 flush and the plane's copy, beside the byte bound
``chip_smoke.merge_bound_ms`` of the valid prefix. One JSON line a list.

    git archive <parent> point_cloud_tpu_torch/csrc | \\
        tar -x -C .chip_work/parent
    python tools/sorted_merge_ab.py \\
        --parent .chip_work/parent/point_cloud_tpu_torch/csrc \\
        --variants 4:64 2:64 --valid 14828593 --tail-pixels 312246

A variant ``U:KB`` sets ``kUnroll = U`` and ``kInFlightBytes = KB << 10``;
``--alt NAME=PATH`` adds another source with the same C entry point (a
candidate redesign). The first variant is also timed with the device's
L2 fetch granularity set to 32 bytes, then set back
(``cudaLimitMaxL2FetchGranularity``): how much of a winner's time is the
sectors it fetches. The tail list's defaults are the sorted arm's
largest bucket in ``chip_smoke.py`` phase 7 (its ``valid_rows`` and
``winners``). Needs a card; imports neither ``jax`` nor
``point_cloud_tpu``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "point_cloud_tpu_torch" / "csrc" / "sorted_merge.cu"
WIDTH, HEIGHT = 1280, 720
KERNEL = "sorted_merge_kernel"


def variant_source(text: str, unroll: int, kb: int) -> str:
    for name, value in (("kUnroll", unroll), ("kInFlightBytes", kb << 10)):
        text, hits = re.subn(rf"constexpr int {name} = [^;]+;",
                             f"constexpr int {name} = {value};", text)
        if hits != 1:
            raise SystemExit(f"{SOURCE.name}: no single {name} to set")
    return text


def build_all(sources: dict, out_dir: Path) -> dict:
    """Each ``name: source path`` built into its own shared library, every
    nvcc at once; the libraries by name, after printing each kernel's
    register line."""
    from point_cloud_tpu_torch.ops.runtime import NVCC_FLAGS, _nvcc

    nvcc, procs = _nvcc(), {}
    for name, src in sources.items():
        lib = out_dir / f"lib_{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{err}")
        regs = [ln.strip() for ln in err.splitlines() if "registers" in ln]
        print(f"{name}: {' | '.join(regs)}", flush=True)
        lib = ctypes.CDLL(str(path))
        ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
        lib.pc_sorted_merge.restype = ctypes.c_int
        lib.pc_sorted_merge.argtypes = [ptr, i64, ptr, ptr, ptr, i64, ptr]
        libs[name] = lib
    return libs


def launcher(torch, lib, fb, cols):
    pix, bits, ids = cols

    def launch():
        rc = lib.pc_sorted_merge(
            fb.data_ptr(), fb.shape[0], pix.data_ptr(), bits.data_ptr(),
            ids.data_ptr(), pix.shape[0],
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"pc_sorted_merge: cudaError {rc}")
    return launch


def l2_fetch_limit(torch):
    """The device's cudaLimitMaxL2FetchGranularity in bytes, and a
    function that sets it (through the toolkit's runtime library)."""
    from point_cloud_tpu_torch.ops.runtime import _nvcc

    rt = ctypes.CDLL(str(Path(_nvcc()).parent.parent / "lib64"
                         / "libcudart.so"))
    limit = 0x05  # cudaLimitMaxL2FetchGranularity
    torch.cuda.synchronize()
    value = ctypes.c_size_t()
    if rt.cudaDeviceGetLimit(ctypes.byref(value), limit) != 0:
        raise RuntimeError("cudaDeviceGetLimit failed")

    def set_limit(n: int) -> None:
        torch.cuda.synchronize()
        if rt.cudaDeviceSetLimit(limit, ctypes.c_size_t(n)) != 0:
            raise RuntimeError("cudaDeviceSetLimit failed")
    return value.value, set_limit


def make_lists(torch, np, splat, rows: int, valid: int, tail_pixels: int,
               seed: int) -> dict:
    rng = np.random.default_rng(seed)
    n_pix = WIDTH * HEIGHT

    def sorted_cols(pix):
        bits = rng.integers(0, 0x3F800001, rows).astype(np.int32)
        ids = rng.integers(1, 1 << 23, rows).astype(np.int32)
        bits[pix == int(splat._NO_ID)] = int(splat._NO_ID)
        return splat._sort4_frags(*(torch.from_numpy(c).cuda()
                                    for c in (pix, bits, ids)))[:3]

    dense = sorted_cols(rng.integers(0, n_pix, rows).astype(np.int32))
    tail_pix = np.full(rows, int(splat._NO_ID), np.int32)
    tail_pix[:valid] = rng.integers(0, tail_pixels, valid)
    return {"dense": (dense, n_pix), "tail": (sorted_cols(tail_pix), n_pix),
            "scan": (dense, 1)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="directory holding the parent's sorted_merge.cu")
    ap.add_argument("--variants", nargs="+", default=["4:64"],
                    help="U:KB, kUnroll and kInFlightBytes in KiB")
    ap.add_argument("--alt", nargs="*", default=[],
                    help="NAME=PATH: another source with the same entry "
                    "point, built and timed beside the variants")
    ap.add_argument("--rows", type=int, default=1 << 26)
    ap.add_argument("--valid", type=int, default=14_828_593)
    ap.add_argument("--tail-pixels", type=int, default=312_246)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=Path, default=ROOT / ".chip_work" / "ab")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("sorted_merge_ab: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from point_cloud_tpu_torch.render import splat

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    args.out.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    sources = {"parent": args.parent / "sorted_merge.cu"}
    for v in args.variants:
        unroll, kb = (int(x) for x in v.split(":"))
        path = args.out / f"sorted_merge_u{unroll}_{kb}k.cu"
        path.write_text(variant_source(text, unroll, kb))
        sources[f"u{unroll}_{kb}k"] = path
    for alt in args.alt:
        name, path = alt.split("=", 1)
        sources[name] = Path(path)
    libs = build_all(sources, args.out)
    names = list(libs)  # parent first, then the variants

    lists = make_lists(torch, np, splat, args.rows, args.valid,
                       args.tail_pixels, args.seed)
    flush = cs.l2_flush(torch)
    default_fetch, set_fetch = l2_fetch_limit(torch)
    for list_name, (cols, n_pix) in lists.items():
        fb0 = splat.make_framebuffer(1, n_pix, "cuda").packed
        fb0[::3] = (0x3F000000 << 32) | 5  # a plane that holds words
        want = fb0.clone()
        splat.sorted_merge_reference(want, *cols)
        pix = cols[0]
        valid = int((pix != int(splat._NO_ID)).sum())
        first = torch.ones_like(pix, dtype=torch.bool)
        first[1:] = pix[1:] != pix[:-1]
        winners = int((first & (pix != int(splat._NO_ID)) & (pix >= 0)
                       & (pix < n_pix)).sum())
        fb = fb0.clone()
        for name in names:
            fb.copy_(fb0)
            launcher(torch, libs[name], fb, cols)()
            torch.cuda.synchronize()
            if not torch.equal(fb, want):
                raise AssertionError(f"{name} != plain on the {list_name} "
                                     "list")

        def timed(fn):
            return cs.device_kernel_ms(
                torch, lambda: (flush(), fb.copy_(fb0), fn()),
                {KERNEL: 1}, reps=args.reps)

        def plain():
            fb.copy_(fb0)
            splat.sorted_merge_reference(fb, *cols)

        runs = {name: [] for name in names}
        p1 = cs.cuda_ms(plain, reps=3, setup=flush)
        for name in names + names[::-1]:
            runs[name].append(timed(launcher(torch, libs[name], fb, cols)))
        p2 = cs.cuda_ms(plain, reps=3, setup=flush)
        # the first variant again with the L2 fetching 32-byte sectors (a
        # device limit this tool sets only here; the port never does)
        fetch = {}
        for limit in (32, default_fetch):
            set_fetch(limit)
            fetch[limit] = timed(launcher(torch, libs[names[1]], fb, cols))
        bound, by = cs.merge_bound_ms(valid, pix.shape[0], winners)
        cs.emit({"list": list_name, "rows": int(pix.shape[0]),
                 "valid_rows": valid, "winners": winners, "n_pix": n_pix,
                 "bound_ms": bound, "bound_by": by,
                 "plain_ms_runs": [p1, p2], "ms_runs": runs,
                 "l2_fetch_bytes_default": default_fetch,
                 f"{names[1]}_ms_by_l2_fetch_bytes": fetch,
                 "share_of_bound": {k: bound / (sum(v) / len(v))
                                    for k, v in runs.items()},
                 "device": smi})
    return 0


if __name__ == "__main__":
    sys.exit(main())
