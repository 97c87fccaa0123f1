"""A/B of the port's hand-written kernels against a parent commit's, on one
CUDA card, in one process.

Every source is built into a shared library of its own with nvcc and the
flags of the port's ``ops/runtime.py`` (plus ``-shared``, and ``-Xptxas
-v``, whose register lines it prints), all builds at once; each library
must give its plain version's result bit for bit before it is timed
(each library's static SASS counts by kernel are printed too:
instructions, MUFU, FCHK, CALL, FFMA, ..., from ``cuobjdump -sass``).
Then the libraries are timed parent, the others, the others in reverse,
parent, in this one process: device time a launch by ``torch.profiler``
(``chip_smoke.device_kernel_ms``). One JSON line a list or kernel, with
the card's ``nvidia-smi`` name and power limit. Needs a card; imports
neither ``jax`` nor ``point_cloud_tpu``. ``--parent`` is a parent commit's
``csrc`` directory:

    git archive <parent> point_cloud_tpu_torch/csrc | \\
        tar -x -C .chip_work/parent
    P=.chip_work/parent/point_cloud_tpu_torch/csrc

``merge``: the sorted raster's merge kernel (K4, ``sorted_merge.cu``),
this tree's once for each variant of its constants ``kUnroll`` and
``kInFlightBytes`` that ``--variants`` names (``U:KB`` sets ``kUnroll =
U`` and ``kInFlightBytes = KB << 10``), on three lists of ``--rows`` rows
that ``sort4`` orders on the card, made from ``--seed``:

- ``dense``: pixels at random over 1280x720, no ``_NO_ID`` row, so
  nearly every pixel wins;
- ``tail``: ``--valid`` rows at random pixels below ``--tail-pixels``,
  the rest ``_NO_ID`` (K3's padding), the shape of the sorted arm's
  largest bucket (the defaults are its ``valid_rows`` and ``winners`` in
  ``chip_smoke.py`` phase 7);
- ``scan``: the dense list merged into a one-pixel plane, so only
  pixel 0's run wins: the pixel column's read alone.

Each launch runs after an L2 flush and the plane's copy, beside the plain
version's event time and the byte bound ``chip_smoke.merge_bound_ms`` of
the valid prefix. The first variant is also timed with the device's L2
fetch granularity set to 32 bytes, then set back
(``cudaLimitMaxL2FetchGranularity``): how much of a winner's time is the
sectors it fetches.

    python tools/kernel_ab.py merge --parent $P --variants 4:64 2:64

``frame``: the frame's cull (K1, ``cull.cu``) and raster (K2,
``splat.cu``), built together. It converts the chip smoke's cloud
(``chip_smoke.py`` phase 4: ``synth_cloud`` seed 0 through the CLI's
``--native``), renders phase 5's first frame at 1280x720 with default
settings and ``--footprint``, and takes the frame's largest bucket: K1 is
timed from a flushed L2, K2 over the bucket's segment table
(``splat.bucket_segments``) from the bucket's input plane. A parent whose
K2 takes the table by value as four host arrays (``kMaxSegments`` in its
``splat.cu``, at most 32 segments and 32 rungs: footprints up to 28) is
bound so.

    python tools/kernel_ab.py frame --parent $P --footprint 5

``pass``: the conversion pass's mark/audit/pack kernel (B3,
``mark_pack.cu`` with ``hex_keys.cuh``) on the sorted columns of the
fused front end (``quantize_sort4``) on the card, as ``chip_smoke.py``
phase 3 times it: the LiDAR-like cloud (``pass_case("synth")``, seed 1,
hierarchy 0) at 2^16, 2^18, 2^20 and 2^22 rows, ``uniform`` at 2^20
(few rows share a hash pair: little to gather) and ``all_equal`` at
2^20 (every row one run: the look-back's and the fix-up's worst case). Each
library's packed rows must equal ``mark_pack_reference``'s before it is
timed; then device time a call (``torch.profiler``: a parent built
before the one-launch design runs two kernels and a memset, whose
kernels it sums) and CUDA event time, beside the plain version's and
the byte bound ``chip_smoke.b3_bytes``. A parent's source is recognised
by its ``mark_pack_resolve`` kernel and bound with its own C signature.

    python tools/kernel_ab.py pass --parent $P

``front``: the conversion pass's front end, B2 (``quantize_hash.cu``
with ``hex_keys.cuh``) and ``sort4`` (``sort4.cu``, with
``sort4_tile.cuh`` where the tree has it), each tree's pair built into
one library. Each tree's ways to the sorted columns: where its source
has the standalone B2 (``pc_quantize_hash``, as before the fusion), B2
then its ``sort4`` (``unfused``; the parent's is ``parent``); where it
has the fused front end, B2 as the load stage of ``sort4``'s tile
kernel (``fused``, ``pc_quantize_sort4``). On the LiDAR-like cloud
(``pass_case("synth")``, seed 1, hierarchy 0) and in gather mode
(``resident_case``) at 2^15, 2^18 and 2^20 rows; each way's sorted
columns (and gathered rows) must equal the plain version's before it is
timed, then device time a call (``torch.profiler``, the kernels of each
way summed) in the order of the ways and back, and CUDA event time,
beside the byte bounds of the fused function (13 B read and 16 B
written a row) and of the unfused pair (61 B), and the fused tile
kernel's own time. Then B2 alone (trees that have it) and ``sort4``
alone, in the same turns: ``sort4``'s tile kernel after its move into
the header should not change.

    python tools/kernel_ab.py front --parent $P

``--alt NAME=PATH`` adds another source (``merge``: a ``sorted_merge.cu``;
``frame``: a directory with ``cull.cu`` and ``splat.cu``; ``pass``: a
directory with ``mark_pack.cu`` and ``hex_keys.cuh``; ``front``: one
with ``quantize_hash.cu``, ``sort4.cu`` and their headers) with this
tree's C entry points, timed beside the others: a candidate change.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "point_cloud_tpu_torch" / "csrc"
WIDTH, HEIGHT = 1280, 720


def build_all(sources: dict, out_dir: Path) -> dict:
    """Each ``name: [source paths]`` built into its own shared library,
    every nvcc at once; the libraries by name, after printing each
    kernel's register line."""
    from point_cloud_tpu_torch.ops.runtime import NVCC_FLAGS, _nvcc

    nvcc, procs = _nvcc(), {}
    for name, srcs in sources.items():
        lib = out_dir / f"lib_ab_{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o", str(lib),
             *map(str, srcs)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{err}")
        regs = [ln.split(":", 1)[-1].strip() for ln in err.splitlines()
                if "registers" in ln]
        print(f"{name}: {' | '.join(regs)}", flush=True)
        libs[name] = ctypes.CDLL(str(path))
        print(json.dumps({"library": name, "sass": sass_counts(path)}),
              flush=True)
    return libs


SASS_OPS = ("MUFU", "FCHK", "CALL", "FFMA", "FMUL", "FADD", "LDG", "STG",
            "LDL", "STL")


def sass_counts(lib: Path) -> dict:
    """{kernel: {"instructions": n, op: n for SASS_OPS}} of a built
    library's SASS (``cuobjdump -sass``): static counts, every branch's
    instructions once."""
    from point_cloud_tpu_torch.ops.runtime import _nvcc

    out = subprocess.run([str(Path(_nvcc()).parent / "cuobjdump"), "-sass",
                          str(lib)], capture_output=True, text=True,
                         check=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = dict.fromkeys(("instructions", *SASS_OPS), 0)
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)",
                      line)
        if name and m:
            counts[name]["instructions"] += 1
            if m.group(1) in SASS_OPS:
                counts[name][m.group(1)] += 1
    return counts


def interleaved(names: list, time_one) -> dict:
    """``time_one(name)`` for every library, in the order names, then
    names reversed: {name: [two times]}."""
    runs = {name: [] for name in names}
    for name in names + names[::-1]:
        runs[name].append(time_one(name))
    return runs


# --- merge: K4 ---------------------------------------------------------------


def variant_source(text: str, unroll: int, kb: int) -> str:
    for name, value in (("kUnroll", unroll), ("kInFlightBytes", kb << 10)):
        text, hits = re.subn(rf"constexpr int {name} = [^;]+;",
                             f"constexpr int {name} = {value};", text)
        if hits != 1:
            raise SystemExit(f"sorted_merge.cu: no single {name} to set")
    return text


def merge_launcher(torch, lib, fb, cols):
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


def ab_merge(args, torch, np, cs, smi: str) -> None:
    from point_cloud_tpu_torch.render import splat

    text = (CSRC / "sorted_merge.cu").read_text()
    sources = {"parent": [args.parent / "sorted_merge.cu"]}
    for v in args.variants:
        unroll, kb = (int(x) for x in v.split(":"))
        path = args.out / f"sorted_merge_u{unroll}_{kb}k.cu"
        path.write_text(variant_source(text, unroll, kb))
        sources[f"u{unroll}_{kb}k"] = [path]
    for alt in args.alt:
        name, path = alt.split("=", 1)
        sources[name] = [Path(path)]
    libs = build_all(sources, args.out)
    ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
    for lib in libs.values():
        lib.pc_sorted_merge.restype = ctypes.c_int
        lib.pc_sorted_merge.argtypes = [ptr, i64, ptr, ptr, ptr, i64, ptr]
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
            merge_launcher(torch, libs[name], fb, cols)()
            torch.cuda.synchronize()
            if not torch.equal(fb, want):
                raise AssertionError(f"{name} != plain on the {list_name} "
                                     "list")

        def timed(fn):
            return cs.device_kernel_ms(
                torch, lambda: (flush(), fb.copy_(fb0), fn()),
                {"sorted_merge_kernel": 1}, reps=args.reps)

        def plain():
            fb.copy_(fb0)
            splat.sorted_merge_reference(fb, *cols)

        p1 = cs.cuda_ms(plain, reps=3, setup=flush)
        runs = interleaved(names, lambda name: timed(
            merge_launcher(torch, libs[name], fb, cols)))
        p2 = cs.cuda_ms(plain, reps=3, setup=flush)
        # the first variant again with the L2 fetching 32-byte sectors (a
        # device limit this tool sets only here; the port never does)
        fetch = {}
        for limit in (32, default_fetch):
            set_fetch(limit)
            fetch[limit] = timed(merge_launcher(torch, libs[names[1]], fb,
                                                cols))
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


# --- frame: K1 and K2 --------------------------------------------------------


def bind_frame(lib, by_value: bool) -> None:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.pc_cull_classify.restype = ctypes.c_int
    lib.pc_cull_classify.argtypes = (
        [ptr] * 8 + [i32, i32, ptr, ptr, i32, ptr, i32, i32, i32]
        + [ptr] * 7 + [i64, ptr])
    lib.pc_splat_raster.restype = ctypes.c_int
    lib.pc_splat_raster.argtypes = ([ptr] * 9 + [i32] * 4
                                    + [ptr] * (5 if by_value else 2))


def cull_launcher(torch, lib, cargs, ckw):
    """A launch of ``lib``'s K1 on the bucket's inputs (the arguments of
    ``kernel.cull_classify``) and its seven outputs."""
    (positions, hier_base, valid, view, proj, cam_pos, spacings, fars, sbd,
     maxh, thresholds, width, height) = cargs
    depth, coarse = ckw["depth"], ckw["coarse"]
    n, dev = positions.shape[0], positions.device
    outs = (torch.empty(n, dtype=torch.bool, device=dev),
            torch.empty(n, dtype=torch.int32, device=dev),
            torch.empty((n, 4), dtype=torch.float32, device=dev),
            torch.empty((n, 3), dtype=torch.float32, device=dev),
            torch.empty(n, dtype=torch.float32, device=dev),
            torch.empty(n, dtype=torch.float32, device=dev),
            torch.empty(n, dtype=torch.int32, device=dev))
    null = ctypes.c_void_p(None)

    def launch():
        rc = lib.pc_cull_classify(
            positions.data_ptr(), hier_base.data_ptr(), valid.data_ptr(),
            view.data_ptr(), proj.data_ptr(), cam_pos.data_ptr(),
            spacings.data_ptr(), fars.data_ptr(), int(bool(sbd)), int(maxh),
            depth.data_ptr() if depth is not None else null,
            coarse.data_ptr() if coarse is not None else null,
            coarse.shape[1] if coarse is not None else 0,
            thresholds.data_ptr(), thresholds.numel(), width, height,
            *(t.data_ptr() for t in outs), n,
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"pc_cull_classify: cudaError {rc}")
    return launch, outs


def raster_launcher(torch, splat, lib, by_value: bool, fb, inp, segments):
    """A launch of ``lib``'s K2 over ``segments`` into the plane ``fb``."""
    if by_value:
        table = tuple((ctypes.c_int * len(segments))(*(int(v) for v in col))
                      for col in zip(*segments))
    else:
        table = (ctypes.c_void_p(splat._device_table("segments", tuple(
            (s.k, s.rung, s.cap, int(s.tail)) for s in segments),
            fb.device).data_ptr()),)

    def launch():
        rc = lib.pc_splat_raster(
            fb.data_ptr(), inp["view_pos"].data_ptr(), inp["ndc"].data_ptr(),
            inp["radius"].data_ptr(), inp["point_id"].data_ptr(),
            inp["perm"].data_ptr(), inp["offsets"].data_ptr(),
            inp["counts"].data_ptr(), inp["projection"].data_ptr(),
            inp["width"], inp["height"], int(bool(inp["voronoi"])),
            len(segments), *table, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"pc_splat_raster: cudaError {rc}")
    return launch


def largest_bucket(torch, np, cs, footprint: int):
    """(input plane, arguments, keywords) of ``render_bucket_pass`` for
    the largest bucket of phase 5's first frame at ``footprint``."""
    from point_cloud_tpu_torch.core.point import PointBatch
    from point_cloud_tpu_torch.io.ply import write_ply
    from point_cloud_tpu_torch.models.synth import synth_cloud
    from point_cloud_tpu_torch.render import splat
    from point_cloud_tpu_torch.render.renderer import RenderSettings
    from point_cloud_tpu_torch.viewer import Viewer

    with tempfile.TemporaryDirectory(prefix="kernel_ab_") as tmp:
        tmp = Path(tmp)
        rng = np.random.default_rng(3)
        write_ply(tmp / "cloud.ply", PointBatch(
            synth_cloud(cs.CLOUD_POINTS, seed=0),
            rng.integers(0, 256, (cs.CLOUD_POINTS, 4), dtype=np.uint8)))
        cs.run_cli("--native", tmp / "cloud.ply", tmp / "store")
        viewer = Viewer(RenderSettings(width=cs.FRAME_W, height=cs.FRAME_H,
                                       footprint=footprint), device="cuda")
        viewer.load_metadata(tmp / "store" / "metadata.json")
        cs.settle(viewer)
        captured = []
        bucket_pass = splat.render_bucket_pass

        def capture(framebuffer, *a, **kw):
            captured.append((framebuffer.packed.clone(), a, kw))
            return bucket_pass(framebuffer, *a, **kw)

        splat.render_bucket_pass = capture
        try:
            viewer.render()
        finally:
            splat.render_bucket_pass = bucket_pass
        viewer.close()
    return max(captured, key=lambda e: e[1][0].shape[0])


def ab_frame(args, torch, np, cs, smi: str) -> None:
    from point_cloud_tpu_torch.render import kernel, splat

    dirs = {"parent": args.parent, "new": CSRC}
    dirs.update((name, Path(d)) for name, d in
                (alt.split("=", 1) for alt in args.alt))
    libs = build_all({name: [d / "cull.cu", d / "splat.cu"]
                      for name, d in dirs.items()}, args.out)
    by_value = {name: "kMaxSegments" in (d / "splat.cu").read_text()
                for name, d in dirs.items()}
    for name, lib in libs.items():
        bind_frame(lib, by_value[name])

    big = largest_bucket(torch, np, cs, args.footprint)
    cargs, ckw = cs.cull_inputs(splat, kernel, *big)
    inp = cs.raster_inputs(splat, kernel, *big)
    segments = splat.bucket_segments(inp["rungs"], inp["footprint"],
                                     inp["view_pos"].shape[0])
    fb_in = big[0]
    flush = cs.l2_flush(torch)
    want_cull = kernel.cull_classify_reference(*cargs, **ckw)
    want_fb = fb_in.clone()
    splat.splat_raster_segments_reference(
        want_fb, inp["view_pos"], inp["ndc"], inp["radius"],
        inp["point_id"], inp["perm"], inp["offsets"], inp["counts"],
        inp["projection"], inp["height"], inp["width"], segments,
        inp["voronoi"])
    culls, rasters = {}, {}
    for name, lib in libs.items():
        launch, outs = cull_launcher(torch, lib, cargs, ckw)
        launch()
        torch.cuda.synchronize()
        if not all(cs.same_bits(torch, g, r) for g, r in zip(outs,
                                                                want_cull)):
            raise AssertionError(f"{name}'s K1 != plain")
        culls[name] = launch
        fb = fb_in.clone()
        launch = raster_launcher(torch, splat, lib, by_value[name], fb, inp,
                                 segments)
        launch()
        torch.cuda.synchronize()
        if not torch.equal(fb, want_fb):
            raise AssertionError(f"{name}'s K2 != plain")
        rasters[name] = (launch, fb)

    def k2_ms(name):
        launch, fb = rasters[name]
        return cs.device_kernel_ms(torch, lambda: (fb.copy_(fb_in), launch()),
                                   {"splat_raster_kernel": 1}, reps=args.reps)

    names = list(libs)
    k1 = interleaved(names, lambda name: cs.device_kernel_ms(
        torch, lambda: (flush(), culls[name]()), {"cull_classify_kernel": 1},
        reps=args.reps))
    k2 = interleaved(names, k2_ms)
    common = {"footprint": args.footprint, "n": int(big[1][0].shape[0]),
              "rungs": len(inp["rungs"]), "segments": len(segments),
              "order": names + names[::-1], "device": smi}
    for kname, runs in (("cull_classify", k1), ("splat_raster", k2)):
        mean = {name: sum(v) / len(v) for name, v in runs.items()}
        cs.emit({"kernel": kname, **common, "ms_runs": runs,
                 "over_parent": {name: m / mean["parent"]
                                 for name, m in mean.items()},
                 "equal_to_plain": True})


# --- pass: B3 ----------------------------------------------------------------

PASS_INPUTS = (("synth", 16), ("synth", 18), ("synth", 20), ("synth", 22),
               ("uniform", 20), ("all_equal", 20))


def mark_pack_launcher(torch, tmark, lib, two_kernels: bool, cols, pos,
                       scalars):
    """A launch of ``lib``'s B3 on the sorted columns and its output. A
    two-kernel parent takes a scratch of 2 ceil(n / 512) + 1 ints; this
    tree's kernel a tile counter and status words of its own, kept as
    the wrapper keeps them (``ops.mark_pack._Scratch``)."""
    ptr, i64, u32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint
    lib.pc_mark_pack.restype = ctypes.c_int
    n = cols[0].shape[0]
    out = torch.empty(n, dtype=torch.int32, device="cuda")
    args = [t.data_ptr() for t in (*cols, pos, *scalars)]
    stream = torch.cuda.current_stream().cuda_stream
    if two_kernels:
        lib.pc_mark_pack.argtypes = [ptr] * 7 + [i64, ptr, ptr, ptr]
        scratch = torch.empty(2 * -(-n // 512) + 1, dtype=torch.int32,
                              device="cuda")

        def call():
            return lib.pc_mark_pack(*args, n, out.data_ptr(),
                                    scratch.data_ptr(), stream)
    else:
        lib.pc_mark_pack.argtypes = ([ptr] * 7 + [i64, ptr, ptr, i64, ptr]
                                     + [u32] * 2 + [ptr])
        state = tmark._Scratch(torch.device("cuda"))
        words, tiles = state.words.data_ptr(), -(-n // tmark.TILE_ROWS)

        def call():
            base, epoch = state.take(tiles)
            return lib.pc_mark_pack(*args, n, out.data_ptr(), words,
                                    tmark.MAX_TILES,
                                    words + 8 * tmark.MAX_TILES, base, epoch,
                                    stream)

    def launch():
        rc = call()
        if rc != 0:
            raise RuntimeError(f"pc_mark_pack: cudaError {rc}")
    return launch, out


def ab_pass(args, torch, np, cs, smi: str) -> None:
    from point_cloud_tpu_torch.core.metadata import MetadataConfig
    from point_cloud_tpu_torch.models.synth import pass_case
    from point_cloud_tpu_torch.ops import dedup, quantize_hash
    from point_cloud_tpu_torch.ops import mark_pack as tmark

    dirs = {"parent": args.parent, "new": CSRC}
    dirs.update((name, Path(d)) for name, d in
                (alt.split("=", 1) for alt in args.alt))
    libs = build_all({name: [d / "mark_pack.cu"] for name, d in dirs.items()},
                     args.out)
    two_kernels = {name: "mark_pack_resolve" in (d / "mark_pack.cu")
                   .read_text() for name, d in dirs.items()}
    kernels = {name: ({"mark_pack_tiles": 1, "mark_pack_resolve": 1}
                      if two_kernels[name] else {"mark_pack_kernel": 1})
               for name in libs}
    names = list(libs)
    config = MetadataConfig()
    cell_size = config.cell_size(0)
    for kind, log_n in PASS_INPUTS:
        n = 1 << log_n
        pargs = dedup.pass_args(*pass_case(kind, n, seed=1), cell_size,
                                config.sub_cell_size(cell_size), "cuda")
        pos, scalars = pargs[0], pargs[2:]
        cols = quantize_hash.quantize_sort4(*pargs)
        want = dedup.mark_pack_reference(*cols, pos, *scalars)
        launches = {}
        for name in names:
            launch, out = mark_pack_launcher(torch, tmark, libs[name],
                                             two_kernels[name], cols, pos,
                                             scalars)
            for _ in range(3):  # a scratch used again holds no stale state
                out.fill_(-1)
                launch()
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise AssertionError(f"{name}'s B3 != plain on {kind} "
                                         f"2^{log_n}")
            launches[name] = launch

        def plain():
            return dedup.mark_pack_reference(*cols, pos, *scalars)

        p1 = cs.cuda_ms(plain, reps=3)
        ms = interleaved(names, lambda name: (
            cs.device_kernel_ms(torch, launches[name], kernels[name],
                                reps=args.reps)))
        event = interleaved(names, lambda name: cs.cuda_ms(launches[name]))
        p2 = cs.cuda_ms(plain, reps=3)
        moved, keyed = cs.b3_bytes(torch, cols[0], cols[1])
        bound, by = cs.pass_bound_ms(moved, cs.B3_OPS_PER_ROW * n)
        mean = {name: sum(v) / len(v) for name, v in ms.items()}
        cs.emit({"kernel": "mark_pack", "input": kind, "n": n,
                 "keyed_rows": keyed, "order": names + names[::-1],
                 "ms_runs": ms, "event_ms_runs": event,
                 "plain_ms_runs": [p1, p2], "bound_ms": bound,
                 "bound_by": by,
                 "share_of_bound": {k: bound / m for k, m in mean.items()},
                 "over_parent": {k: m / mean["parent"]
                                 for k, m in mean.items()},
                 "equal_to_plain": True, "device": smi})


# --- front: B2 and sort4, fused or not ------------------------------------

FRONT_LOG_N = (15, 18, 20)
# the standalone B2 of a tree before the fusion: its kernel, and the bytes
# the unfused pair moves beyond the fused function (sort4 reads and
# writes the four columns, 32 B a row)
STANDALONE_B2 = {"quantize_hash_kernel": 1}
UNFUSED_EXTRA_BYTES_PER_ROW = 32


def bind_front(lib, fused: bool, standalone: bool) -> None:
    ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
    if standalone:
        lib.pc_quantize_hash.restype = ctypes.c_int
        lib.pc_quantize_hash.argtypes = [ptr] * 7 + [i64] + [ptr] * 9
    lib.pc_sort4.restype = ctypes.c_int
    lib.pc_sort4.argtypes = [ptr] * 12 + [i64, ptr]
    if fused:
        lib.pc_quantize_sort4.restype = ctypes.c_int
        lib.pc_quantize_sort4.argtypes = [ptr] * 7 + [i64] + [ptr] * 13


def front_inputs(torch, np, dedup, mode: str, n: int) -> dict:
    """The pass's inputs on the card: ``direct`` the LiDAR-like cloud,
    ``gather`` a resident level; with the plain B2 columns, and the plain
    sorted columns (and gathered rows) that every way must give."""
    from point_cloud_tpu_torch.core.metadata import MetadataConfig
    from point_cloud_tpu_torch.models.synth import pass_case, resident_case

    config = MetadataConfig()
    cell_size = config.cell_size(0)
    sub_size = config.sub_cell_size(cell_size)
    if mode == "direct":
        pos, valid, *scalars = dedup.pass_args(
            *pass_case("synth", n, seed=1), cell_size, sub_size, "cuda")
        ptrs, keep = [pos.data_ptr(), valid.data_ptr(), None, None, None], (
            pos, valid)
        want = dedup.quantize_sort4_reference(pos, valid, *scalars)
    else:
        res, src, ext = (torch.from_numpy(a).cuda()
                         for a in resident_case(n, seed=1))
        scalars = dedup.pass_args(np.zeros((1, 3), np.float32),
                                  np.ones(1, bool), cell_size, sub_size,
                                  "cuda")[2:]
        ptrs, keep = [None, None, src.data_ptr(), res.data_ptr(),
                      ext.data_ptr()], (res, src, ext)
        want = dedup.quantize_sort4_resident_reference(res, src, ext,
                                                       *scalars)
        pos, valid = dedup.resident_rows_reference(res, src, ext)
    return {"ptrs": ptrs, "scalars": scalars, "keep": keep, "want": want,
            "b2": torch.stack(dedup.quantize_hash_reference(
                pos, valid, *scalars)).contiguous()}


def front_launcher(torch, lib, inp: dict, n: int, way: str):
    """A launch of one way to the sorted columns (``unfused``: B2, then
    sort4 on its columns; ``fused``; ``b2``: B2 alone; ``sort4``: sort4
    alone on the plain B2 columns), and a function that returns its
    columns and gathered rows (None where the way gathers none)."""
    out = torch.empty((4, n), dtype=torch.int32, device="cuda")
    cols, scratch = torch.empty_like(out), torch.empty_like(out)
    gather = inp["ptrs"][2] is not None and way != "sort4"
    pos_out = (torch.empty((n, 3), dtype=torch.float32, device="cuda")
               if gather else None)
    pos_ptr = None if pos_out is None else pos_out.data_ptr()
    cs, radius = (s.data_ptr() for s in inp["scalars"])
    col_ptrs = [c.data_ptr() for c in cols]
    out_ptrs = [c.data_ptr() for c in out] + [c.data_ptr() for c in scratch]

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def b2():
        return lib.pc_quantize_hash(*inp["ptrs"], cs, radius, n, *col_ptrs,
                                    None, None, None, pos_ptr, stream())

    def sort_cols(ptrs):
        return lib.pc_sort4(*ptrs, *out_ptrs, n, stream())

    def fused():
        return lib.pc_quantize_sort4(*inp["ptrs"], cs, radius, n, *out_ptrs,
                                     None, None, None, pos_ptr, stream())

    calls = {"unfused": [b2, lambda: sort_cols(col_ptrs)], "fused": [fused],
             "b2": [b2],
             "sort4": [lambda: sort_cols([c.data_ptr()
                                          for c in inp["b2"]])]}[way]

    def launch():
        for call in calls:
            rc = call()
            if rc != 0:
                raise RuntimeError(f"{way}: cudaError {rc}")

    return launch, lambda: (cols if way == "b2" else out, pos_out)


def front_kernels(cs, way: str, n: int) -> dict:
    return {"unfused": {**STANDALONE_B2, **cs.sort4_kernels(n)},
            "fused": cs.front_kernels(n), "b2": STANDALONE_B2,
            "sort4": cs.sort4_kernels(n)}[way]


def device_ms_or_none(torch, cs, launcher, kernels: dict, reps: int):
    """``device_kernel_ms`` of a launcher's launch, None where the
    profiler kept too few of its kernels (it drops some late in a long
    process; the event times beside it stand)."""
    try:
        return cs.device_kernel_ms(torch, launcher[0], kernels, reps=reps)
    except AssertionError as exc:
        print(f"no device time: {exc}", flush=True)
        return None


def ab_front(args, torch, np, cs, smi: str) -> None:
    from point_cloud_tpu_torch.ops import dedup

    dirs = {"parent": args.parent, "new": CSRC}
    dirs.update((name, Path(d)) for name, d in
                (alt.split("=", 1) for alt in args.alt))
    libs = build_all({name: [d / "quantize_hash.cu", d / "sort4.cu"]
                      for name, d in dirs.items()}, args.out)
    text = {name: (d / "quantize_hash.cu").read_text()
            for name, d in dirs.items()}
    fused_tree = {name: "pc_quantize_sort4" in s for name, s in text.items()}
    b2_tree = {name: "pc_quantize_hash(" in s for name, s in text.items()}
    for name, lib in libs.items():
        bind_front(lib, fused_tree[name], b2_tree[name])
    for mode in ("direct", "gather"):
        for log_n in FRONT_LOG_N:
            n = 1 << log_n
            inp = front_inputs(torch, np, dedup, mode, n)
            ways = {}  # label: ((launch, result), kernels)
            for name, lib in libs.items():
                own = (("unfused",) if b2_tree[name] else ()) + (
                    ("fused",) if fused_tree[name] else ())
                for way in own:
                    label = ("parent" if name == "parent" else
                             way if name == "new" else f"{name}_{way}")
                    ways[label] = (front_launcher(torch, lib, inp, n, way),
                                   front_kernels(cs, way, n))
                for way in (("b2", "sort4") if b2_tree[name]
                            else ("sort4",)):
                    ways[f"{way}_{name}"] = (
                        front_launcher(torch, lib, inp, n, way),
                        front_kernels(cs, way, n))
            for label, ((launch, result), _) in ways.items():
                want = inp["b2"] if label.startswith("b2_") else inp["want"]
                for _ in range(2):  # run again: no state carried over
                    launch()
                    torch.cuda.synchronize()
                    got, pos = result()
                    if not all(torch.equal(g, w) for g, w in zip(got, want)):
                        raise AssertionError(f"{label} != plain on {mode} "
                                             f"2^{log_n}")
                    if pos is not None and not torch.equal(pos,
                                                           inp["want"][4]):
                        raise AssertionError(f"{label}: gathered rows != "
                                             f"plain on 2^{log_n}")
            main = [k for k in ways if not k.startswith(("b2_", "sort4_"))]
            ms = interleaved(main, lambda label: cs.device_kernel_ms(
                torch, ways[label][0][0], ways[label][1], reps=args.reps))
            event = interleaved(main, lambda label: cs.cuda_ms(
                ways[label][0][0]))
            alone = {}
            for way in ("b2", "sort4"):
                names = [k for k in ways if k.startswith(f"{way}_")]
                if not names:
                    continue
                alone[way] = interleaved(names, lambda label: (
                    device_ms_or_none(torch, cs, *ways[label], args.reps)))
                alone[f"{way}_event"] = interleaved(names, lambda label: (
                    cs.cuda_ms(ways[label][0][0])))
            tile = {label: cs.device_kernel_ms(
                torch, ways[label][0][0], {"quantize_tile": 1},
                reps=args.reps) for label in main
                if ways[label][1] == cs.front_kernels(n)}
            mean = {k: sum(v) / len(v) for k, v in ms.items()}
            # gather mode: a 4 B source and 12 B of row in, 12 B of row
            # out, in place of 13 B of position and valid
            fused_bytes = (cs.FRONT_GATHER_BYTES_PER_ROW if mode == "gather"
                           else cs.FRONT_BYTES_PER_ROW)
            cs.emit({"kernel": "front", "input": mode, "n": n,
                     "order": main + main[::-1], "ms_runs": ms,
                     "event_ms_runs": event, "fused_tile_ms": tile,
                     "alone_ms_runs": alone,
                     "fused_bound_ms": fused_bytes * n
                     / cs.HBM_BYTES_PER_S * 1e3,
                     "unfused_bound_ms": (fused_bytes
                                          + UNFUSED_EXTRA_BYTES_PER_ROW)
                     * n / cs.HBM_BYTES_PER_S * 1e3,
                     "over_parent": {k: m / mean["parent"]
                                     for k, m in mean.items()},
                     "equal_to_plain": True, "device": smi})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="kernel", required=True)
    merge = sub.add_parser("merge", help="K4, sorted_merge.cu")
    merge.add_argument("--variants", nargs="+", default=["4:64"],
                       help="U:KB, kUnroll and kInFlightBytes in KiB")
    merge.add_argument("--rows", type=int, default=1 << 26)
    merge.add_argument("--valid", type=int, default=14_828_593)
    merge.add_argument("--tail-pixels", type=int, default=312_246)
    merge.add_argument("--seed", type=int, default=0)
    frame = sub.add_parser("frame", help="K1 and K2, cull.cu and splat.cu")
    frame.add_argument("--footprint", type=int, default=5)
    pass_ = sub.add_parser("pass", help="B3, mark_pack.cu")
    front = sub.add_parser("front", help="B2 and sort4, fused or not: "
                           "quantize_hash.cu and sort4.cu")
    for p in (merge, frame, pass_, front):
        p.add_argument("--parent", required=True, type=Path,
                       help="a parent commit's csrc directory")
        p.add_argument("--alt", nargs="*", default=[],
                       help="NAME=PATH: another source with this tree's "
                       "entry points, built and timed beside the others")
        p.add_argument("--reps", type=int, default=20)
        p.add_argument("--out", type=Path, default=ROOT / ".chip_work" / "ab")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    args.out.mkdir(parents=True, exist_ok=True)
    run = {"merge": ab_merge, "frame": ab_frame, "pass": ab_pass,
           "front": ab_front}
    run[args.kernel](args, torch, np, cs, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
