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
   (CUDA events, median of 7), with the kernel's own device time
   (``torch.profiler``), and at 2^18 the library call
   ``torch.unique(..., dim=0)`` (:func:`sort4_library_ms`). The sizes
   include every bucket the slice sorts (2^15..2^21 at batch 2^18);
3. pass: ``get_pipeline("conversion", n=2^20)`` and ``dedup_pass_light``
   on the card against the same inputs through the port on the CPU,
   exact equality, also for the light pass on every finite shape of
   ``PASS_SHAPES`` and the resident pass at 2^16; the fused front end
   (``quantize_sort4``: B2 as the load stage of ``sort4``'s tile kernel,
   with and without its keys, and in its gather mode) and B3
   (``mark_pack``) bit-exact against their plain versions on the card at
   every length 2^15..2^22 over ``PASS_SHAPES``, forced hash collisions
   and a resident mix; the division helper of ``csrc/hex_keys.cuh``
   against ``__fdiv_rn`` for every f32 numerator over every divisor of
   hierarchies 0-7, and for every numerator significand over 73,728
   divisor significands (both ends of [1, 2) and a stride through it);
   a ``torch.profiler`` window over one light and one resident pass whose
   device work must be the fused tile kernel (``quantize_tile``),
   ``sort4``'s merges and B3 only (no copy, no memset, no scan), and one
   over B3 alone: its one kernel, no memset; the fused front end (beside
   its tile kernel alone), B3, the light pass and its plain twin timed
   at 2^18 and 2^20 (device time, CUDA events, bounds);
   then K6 (``lod_select``, the renderer's LOD walk: :func:`phase_lod`)
   bit-exact against its plain version at the indoor orbit's bucket
   sizes (2^12-2^18 rows over twelve hierarchies) and on the edge cases
   of ``LOD_EDGES``, one launch a call, and timed at every size from a
   flushed L2 beside the plain version and its bound, with a walking
   frame's sum;
4. slice: a 2^23-point LiDAR-like cloud (the port's ``synth_cloud``)
   written to PLY and converted by the port's CLI at batch 2^18, in
   subprocesses, three times: ``--device`` (the Python-cell
   ``PipelinedConverter``), ``--device-native`` (the C++ merge engine)
   and ``--native`` (the C++ host engine alone). The three stores must be
   byte-identical, both device runs must have sorted, every length they
   sorted through the fused front end must be one that phase 3 checked
   (through ``sort4``, one that phase 2 checked), and every pass of
   theirs must be the fused front end, then B3 (their launch counts
   equal, and no ``sort4`` call of its own). Each subprocess
   counts its launches from zero, so its count
   is its main path's and no other. One more ``--device-native``
   conversion in this process under ``torch.profiler`` gives the card's
   busy share (its store checked too).

5. frame: the ``--device-native`` store of phase 4 through the port's
   ``Viewer`` at 1280x720, default settings. 5a captures every bucket of
   one frame and holds the cull kernel (``cull_classify``) and the raster
   kernel (``splat_raster``, one launch a bucket) against their plain
   versions on the card: every K1 output and the framebuffer after each
   bucket bit-exact, on the frame's buckets and on a synthetic bucket
   that fills the 9-, 17-, 33- and 65-px rungs past their caps; then the
   raster alone on three more rankings of the synthetic rows
   (``EDGE_BUCKETS``: every rung filled with two overflow rungs past
   their caps, no row at all, one 65-px splat on the frame's corner).
   K5 (``class_rank``, the class ranking under ``compact_classes``,
   ``compact_perm`` and ``budget_table``) is held bit-exact against its
   plain version (``perm`` with its pad, ``counts``, ``offsets``,
   ``dest``) on every ranking of the frame and of the synthetic and edge
   buckets (:class:`RankCapture`), and every K6 walk of that first frame
   (:class:`LodCapture`: every bucket walks) against its plain version,
   and on a sweep (:func:`rank_sweep`):
   N = 2^10..2^22, 1000 and 3, C = 1, 2, 13, 130, 9000, rows of no class
   and one class holding every row, caps 0, 1, N/3 and N; where the plain
   version's (C+1) x N one-hot passes RANK_PLAIN_SLOTS, against a stable
   ``torch.sort`` (:func:`rank_oracle`). K5 is timed on the largest
   bucket (:func:`time_rank`: device time by kernel, events, the plain
   version, the bound, and ``torch.sort(stable=True)`` plus
   ``torch.bincount`` as ``library_ms``).
   5b renders the same frame with
   ``device="cpu"`` and requires the rgb and id planes identical and the
   depth equal by value. 5c zeroes the launch counts and runs
   ``render_orbit`` for 8 frames: ``render`` times, ``render_pipelined``
   steady time, points, buckets, launches per frame, and the device busy
   share of one frame under ``torch.profiler``, whose kernels must hold
   K5's three and none of the torch ranking's (``RANK_FORBIDDEN``: cub's
   scan, the scatter).
6. serve: the same store behind the port's store server (``serve``, on the
   card, 640x480, in a thread), driven over HTTP from zero launch counts:
   the static files, four orbit poses and one fly pose, eight timed
   ``/render`` after a warm one (median and spread in ms; one more
   request's device busy share and host profile, without HTTP), footprint 1
   (the multi-dispatch arm, as in the reference: every K1 and K2 call of
   that frame captured and held bit-exact against the plain versions on
   its inputs), the in-app converter on a
   2^18-point PLY (the store it writes must validate clean) and a PLY
   ``/export`` (its vertex count must equal the store's). Every PNG must
   be byte-identical to the one ``StoreServer(..., device="cpu")`` makes
   after the same requests. Then ``WindowLoop`` runs 8 frames on the card
   with a stub back end (the machine has no display), a movement key and a
   hotkey pressed: every frame must blit.
7. arms: every other render arm (``ARMS``) on the same store at
   1280x720, 4 frames each from zero launch counts; steady frames equal
   within their groups, first frames equal to the CPU renderer's, and
   every bucket the sorted arms sort held through K3, ``sort4`` and K4
   against their plain versions, and every K5 call of every arm (the
   budget arm's ``dest`` and capped calls too) against its plain version;
   K4 also on a dense list of 2^26 rows
   with no ``_NO_ID`` tail (``dense_merge_list``), bit for bit, then
   timed there and on the largest bucket from a flushed L2.
8. mesh, the multi-device path, on four logical shards of the one card
   (``make_mesh(devices=[cuda:0] * 4)``): (a) phase 4's PLY through
   ``MeshConverter`` from zero ``sort4``, front end and B3 counts, the
   first call of ``sort4`` and of the fused front end at every sorted
   length held against its plain version, one fused front end for every
   hash sort (stage A's ``_hash_sort``, stage B's ``quantize_sort4``),
   one B3 launch for each (both stages mark their sorted rows with B3)
   and as many ``sort4`` calls (the routing and arrival sorts), the store
   byte-identical to phase 4's ``--native``
   one; ``--mesh 1`` through the CLI, the same; a forced-spill pass
   (capacity 1, 2^18 points) against the host ``Converter``; the
   owner-sharded pass timed alone at 2^20 rows with its device time by
   kernel, and one cascade level profiled. (b) The store at 1280x720 from
   phase 7's pose through ``MeshPointRenderer`` from zero K1 and K2
   counts (one launch of each a shard and bucket, K5's capped ranking
   too, each call held against its plain version): bit-equal to the
   single-device plain raster arm, to the same mesh on the CPU and to
   1- and 3-shard meshes; the default arm's capped rungs reported.
   (c) The cloud as four PLY files, converted by two ``--multihost
   --device-native`` CLI workers on a gloo process group at a localhost
   coordinator: rank 0's merged store holds the point multiset of one
   ``--device-native`` conversion of the four files. Four shards on one
   card run one after another: no number here is a scaling measurement.
9. footprints: the store at 1280x720 from phase 7's pose at footprints
   29, 31, 64, 128 and 129 (ladders of 31 to 129 rungs, tables of 33 to
   129 segments, a 129-px window), default settings, from zero launch
   counts: every bucket's K1 and K2 bit-exact against their plain
   versions, the frame equal to the CPU renderer's at 29 and 129, device
   ms a frame and K1's and K2's device time on the largest bucket against
   their bounds at 29, 64 and 129 (K5 there too, at 31 to 129 classes),
   every K5 call of the phase's frames against its plain version; the
   multi-dispatch, budget, sorted and
   fusion arms at 64 and 129 (steady frames within phase 7's groups, the
   sorted arm's K3, sort4 and K4 bit-exact on every bucket, every K1 and
   K2 call of the multi-dispatch arm's last frame bit-exact, and at 129
   K2's device time on that frame's widest class raster against its
   bound); the mesh at 129 on four logical shards bit-equal to the
   single-device plain arm.
   ``python3 chip_smoke.py --phase footprints`` runs this phase alone on
   a ``--native`` store of phase 4's cloud.

Then the card's ``nvidia-smi`` name and power limit, the kernels' JSON
line, and the last line ``{"ok": true, "device": {...}}``. In the
kernels' line ``ms`` is the kernel's own device time a call
(``torch.profiler``, :func:`device_kernel_ms`), ``wrapper_ms`` the CUDA
event time around the wrapper call (host work between launches
included), ``plain_ms`` the event time of the plain version, and
``bound_ms`` the byte bound at the H100 SXM's HBM rate, 3.35 TB/s
(``bound_memory``: every byte counted once from HBM; a reading below it
means the inputs were still in the 50 MB L2), with ``sort4`` 16 B read
and 16 B written a row, ``cull_classify`` as ``cull_bound_ms`` says and
``sorted_merge`` the rows up to the ``_NO_ID`` tail (``merge_bound_ms``),
``quantize_sort4`` (the fused front end) its 13 B read and 16 B of
sorted columns written a row (with ``sort4_bound_ms`` beside it) and
``mark_pack`` (B3) what ``b3_bytes`` counts on the run's sorted columns,
``class_rank`` (K5) its rung column read and its 2N perm slots written
(:func:`rank_bound_ms`), each against its operations at the card's f32
rate. K5's ``launches_by_path`` counts it on the orbit, serve, window,
arms, mesh and footprint frames, each more than 0; K6's counts its walks
there (a walk runs only where the loaded set changed, so a path may read
0; the orbit's changes, so its count, K6's ``launches``, is more than 0).
Every timed block starts on a card held busy for WARM_S seconds (an idle
H100 clocks 840 of 1,980 MHz), and K1, K3 and K4 are timed from an L2
flushed before each call, as a frame finds it. ``splat_raster``'s is
the larger of its byte bound (``raster_bound_ms``) and its instruction bound (``raster_instr_bound_ms``: the
fragments it lights and those it only tests, each times its instructions
a fragment, over the card's lanes at the clock ``nvidia-smi`` reports
under the kernel's load); the ``raster_bound`` line before it prints both,
and the kernel's device time on the synthetic bucket (``synthetic_ms``). Any failed phase raises and
exits non-zero before that line.
The script imports nothing of ``jax``, of ``point_cloud_tpu`` or of
``bench.py``.
"""

from __future__ import annotations

import contextlib
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
WARM_S = 0.25  # busy time before each timed block
L2_FLUSH_BYTES = 64 << 20  # past the H100's 50 MB L2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def warm_clock(torch, seconds: float = WARM_S) -> None:
    """Keep the card busy with f32 matrix products for ``seconds``, so that
    a timed block starts at the clock of a loaded card, not an idle one."""
    a = torch.ones(4096, 4096, device="cuda")
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        for _ in range(4):
            a @ a
        torch.cuda.synchronize()


def l2_flush(torch):
    """A function that overwrites L2_FLUSH_BYTES of device memory, so that
    the next kernel reads its inputs from HBM."""
    scratch = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    return scratch.zero_


def cuda_ms(fn, reps: int = 7, setup=None) -> float:
    """Median CUDA event time of ``fn()`` in ms over ``reps`` timed runs,
    on a warmed card; ``setup()``, if given, runs before each, outside the
    timed span."""
    import torch

    warm_clock(torch)
    fn()  # warm-up
    times = []
    for _ in range(reps):
        if setup is not None:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


PROFILE_TRIES = 5
# fragments a chunk of the checks' plain K2 expansions (the reference's
# chunks hold 2^16: 8 rows of a 129-px window); the plane is a minimum,
# so it does not depend on the chunking
PLAIN_CHUNK_FRAGMENTS = 1 << 24
PROFILE_LEAD_S = 0.05  # calls in the profiler's warm-up step
profile_spans: list = []  # per profile: {kernel: [spans seen, launched]}


def device_kernel_ms(torch, fn, per_call: dict, reps: int = 20) -> float:
    """Device time a call of ``fn`` spends in its kernels: ``per_call``
    maps a name that a kernel's name holds to how many such kernels a
    call launches. ``fn()`` runs for PROFILE_LEAD_S in the profiler's
    warm-up step, whose events the profiler discards, then ``reps`` times
    in its one recorded step; the time is, summed over the names, the
    mean span of that name's kernels in the recorded step times their
    count a call. The wrapper's host work and any other device work in
    ``fn`` are left out. The profiler drops kernels, most at the start of
    a profile late in a long process (0-7 of 20 short kernels kept in some
    of phase 9's profiles on the H100; a profile of the same calls taken
    again kept all 20): the warm-up step starts its tracing before the
    counted calls, and a mean over the kernels it kept is unbiased by the
    ones it dropped where a sum over ``reps`` is not. A profile whose
    recorded step kept fewer kernels of some name than half of what the
    ``reps`` calls launch, or more than they launch (one more than 20 of
    K5's scatter once on the H100: a kernel of the warm-up step counted
    in the recorded one), is taken again, up to PROFILE_TRIES profiles,
    and raises after that: a ``per_call`` that undercounts ``fn``'s
    kernels shows in every profile. ``profile_spans`` keeps what each
    recorded step saw."""
    from torch.profiler import ProfilerActivity, profile, schedule

    warm_clock(torch)
    fn()  # warm-up
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            lead_end = time.perf_counter() + PROFILE_LEAD_S
            while time.perf_counter() < lead_end:
                fn()
                torch.cuda.synchronize()
            prof.step()  # the warm-up step ends: only what follows counts
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = {name: [] for name in per_call}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                for name in per_call:
                    if name in e.name:
                        spans[name].append(e.time_range.elapsed_us())
        profile_spans.append({name: [len(spans[name]), reps * count]
                              for name, count in per_call.items()})
        if all(reps * count >= len(spans[name]) >= reps * count / 2
               for name, count in per_call.items()):
            return sum(statistics.fmean(spans[name]) * count
                       for name, count in per_call.items() if count) / 1e3
    raise AssertionError(f"the profiler kept too few or more than launched "
                         f"of {per_call} in {PROFILE_TRIES} profiles: "
                         f"{profile_spans[-PROFILE_TRIES:]}")


def sort4_kernels(n: int) -> dict:
    """The kernels one ``sort4`` of ``n`` rows launches: the tile sort,
    then one merge a doubling from TILE_ROWS to ``n`` (csrc/sort4.cu)."""
    return {"sort4_tile": 1,
            "sort4_merge": max(0, n.bit_length() - TILE_ROWS.bit_length())}


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
    sort_ms, plain_ms, device_ms = {}, {}, {}
    for log_n in TIMED_LOG_N:
        cols = [torch.from_numpy(c).to(dev)
                for c in sort_keys("dedup_shaped", 1 << log_n, rng)]
        # alternate plain, kernel, kernel, plain on one card
        p1 = cuda_ms(lambda: sort.sort4_reference(*cols))
        k1 = cuda_ms(lambda: sort.sort4(*cols))
        d = device_kernel_ms(torch, lambda: sort.sort4(*cols),
                             sort4_kernels(1 << log_n))
        k2 = cuda_ms(lambda: sort.sort4(*cols))
        p2 = cuda_ms(lambda: sort.sort4_reference(*cols))
        sort_ms[1 << log_n] = [k1, k2]
        plain_ms[1 << log_n] = [p1, p2]
        device_ms[1 << log_n] = d
        if log_n == MAIN_LOG_N:
            library_ms = sort4_library_ms(torch, cols, sort.sort4(*cols))
    result = {
        "phase": "kernel_vs_plain", "ok": True, "checked": checked,
        "max_abs_err": worst, "sort_ms_by_n": sort_ms,
        "plain_ms_by_n": plain_ms, "sort_device_ms_by_n": device_ms,
        "library_ms": library_ms,
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


def sort4_library_ms(torch, cols, sorted_cols, reps: int = 7) -> float:
    """CUDA event time of ``torch.unique(torch.stack(cols, 1), dim=0)``,
    the one PyTorch call that computes ``sort4``'s function here: the
    fourth column is an arrival iota, so every row is unique and the call
    returns ``sort4``'s output as rows. Checked equal to ``sorted_cols``
    (``sort4``'s output) first. The port never calls it."""
    def call():
        return torch.unique(torch.stack(cols, 1), dim=0)

    if not torch.equal(call(), torch.stack(sorted_cols, 1)):
        raise AssertionError(f"torch.unique(dim=0) != sort4 at "
                             f"{cols[0].shape[0]} rows")
    return cuda_ms(call, reps=reps)


# --- phase 3: the conversion pass, B2 in sort4's tile kernel -> B3 --------

PASS_LOG_N = tuple(range(15, 23))  # every bucket the slice and mesh sort
PASS_TIMED_LOG_N = (18, 20)
PASS_FINITE = ("synth", "uniform", "all_equal", "lattice", "far",
               "saturate")  # models.synth.PASS_SHAPES but "nonfinite"
PASS_CPU_LOG_N = 16  # the light pass on the card against the CPU's
# Bytes a row each kernel must move as a function (each input read once,
# each output written once). The fused front end (ops.quantize_hash.
# quantize_sort4: B2 as the load stage of sort4's tile kernel, then
# sort4's merges) reads 12 B of position and 1 B of valid and writes the
# four 4-byte sorted columns; its gather mode reads a 4 B source and 12 B
# of position and writes the columns and the 12 B gathered position.
# B3's depend on the data (b3_bytes).
FRONT_BYTES_PER_ROW = 29
FRONT_GATHER_BYTES_PER_ROW = 44
# Operations a row, counted from the kernels' source (an IEEE division or
# square root, a floor, a compare, a select, an integer multiply, add,
# shift or logic operation each one): B2's hex math ~45 f32, seven
# saturating casts ~28, the offset 5, the two hashes and their masks ~47;
# B3's keys ~53 on a row that shares its hash pair, the near-tie test ~12,
# the neighbour compares and the run bits ~35 on every row. Over the
# H100's 67 TFLOP/s f32 rate (PEAK_OPS_PER_S) both are a fifth or less of
# their byte time.
FRONT_OPS_PER_ROW = 125
B3_OPS_PER_ROW = 100
PASS_KERNELS = {"b3": {"mark_pack_kernel": 1}}
# divisor significands of the division sweep: both ends of [1, 2), where
# RN(1/b) is farthest from 1/b in ulps of the quotient, and a stride
# through it (the test suite's cuda case sweeps all 2^23)
DIVISION_SWEEP = ((0, 1, 4096), ((1 << 23) - 4096, 1, 4096), (1, 128, 65536))


def front_kernels(n: int) -> dict:
    """The kernels one fused front end of ``n`` rows launches: B2's tile
    sort (``quantize_tile``), then sort4's merges."""
    return {"quantize_tile": 1, "sort4_merge": sort4_kernels(n)["sort4_merge"]}


def division_check(torch, qh) -> dict:
    """hex_keys.cuh's division helper against __fdiv_rn on the card: every
    f32 numerator bit pattern over the five divisors of each of
    MetadataConfig's hierarchies 0-7; fails on any differing bit."""
    import numpy as np

    from point_cloud_tpu_torch.core.metadata import MetadataConfig

    config = MetadataConfig()
    cell_sizes = [config.cell_size(h) for h in range(8)]
    radii = [float(np.float32(config.sub_cell_size(cs)) / np.float32(2.0))
             for cs in cell_sizes]
    t0 = time.perf_counter()
    bad, first, taken = qh.division_mismatches(cell_sizes, radii)
    seconds = time.perf_counter() - t0
    if int(bad.sum()):
        raise AssertionError(f"the division helper != __fdiv_rn: {bad} "
                             f"(first numerators {first})")
    # every numerator in [2^-60, 2^61) and +-0 takes the fast quotient
    if not bool((taken == 121 * 2**24 + 2).all()):
        raise AssertionError(f"the fast quotient took {taken} numerators")
    # every numerator significand over divisor significands of any config
    t1 = time.perf_counter()
    for first, stride, count in DIVISION_SWEEP:
        wrong, pair = qh.division_sweep(first, stride, count)
        if wrong:
            raise AssertionError(f"the division helper != __fdiv_rn on "
                                 f"{wrong} significand pairs (first: "
                                 f"divisor, numerator bits {pair})")
    return {"divisors": int(bad.numel()), "numerators_each": 1 << 32,
            "fast_numerators_each": 121 * 2**24 + 2, "mismatches": 0,
            "hierarchies": 8, "seconds": seconds,
            "sweep_divisor_significands": sum(c for *_, c in DIVISION_SWEEP),
            "sweep_numerator_significands": 1 << 23, "sweep_mismatches": 0,
            "sweep_seconds": time.perf_counter() - t1}


def bits_err(torch, got, ref) -> int:
    """Largest |difference| of the int32 bits of two tuples of tensors (0
    when bit-identical; f32 tensors compare as their bits)."""
    return max(int((g.view(torch.int32).long() - r.view(torch.int32).long())
                   .abs().max()) for g, r in zip(got, ref))


def collide_columns(torch, ch, sh):
    """Forced hash collisions (tests/test_torch_dedup.py's ``_hash_cols``
    cut to its low bit): every real cell hash 0, every slot hash 0 or 1."""
    real = ch != I32_MAX
    return (torch.where(real, torch.zeros_like(ch), ch),
            torch.where(real, sh & 1, sh))


def pass_bound_ms(bytes_moved: float, ops: float) -> tuple[float, str]:
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                          "operations")


def b3_bytes(torch, ch_s, sh_s) -> tuple[int, int]:
    """(bytes, keyed rows) B3 must move on these sorted columns: every
    row's cell hash, slot hash and perm read and packed row written; the
    distance bits of a row that shares its hash pair with the row before
    (the near-tie test reads its pair); the 12 B position of every real
    row that shares its hash pair with a neighbour (its keys)."""
    same = torch.zeros_like(ch_s, dtype=torch.bool)
    same[1:] = (ch_s[1:] == ch_s[:-1]) & (sh_s[1:] == sh_s[:-1])
    valid = ch_s != I32_MAX
    audit = int((same & valid).sum())
    near = same.clone()
    near[:-1] |= same[1:]
    keyed = int((near & valid).sum())
    n = ch_s.shape[0]
    return 16 * n + 4 * audit + 12 * keyed, keyed


def check_pass_kernels(torch, np, dedup, qh, mp, sort) -> dict:
    """The fused front end and B3 against their plain versions on the
    card, bit for bit, at every length of PASS_LOG_N over PASS_SHAPES
    (the front end with and without its keys), forced collisions (B3, on
    the plain B2 columns cut to their low bit and sorted by ``sort4``) and
    the resident gather (the front end's gather mode, then B3 on its
    rows)."""
    from point_cloud_tpu_torch.core.metadata import MetadataConfig
    from point_cloud_tpu_torch.models.synth import (
        PASS_SHAPES, pass_case, resident_case,
    )

    config = MetadataConfig()
    checked, worst = [], {"front": 0, "b3": 0}
    for log_n in PASS_LOG_N:
        n = 1 << log_n
        cs = config.cell_size(log_n % 8)
        scs = config.sub_cell_size(cs)
        for kind in (*PASS_SHAPES, "collide", "resident"):
            if kind == "resident":
                res, src, ext = (torch.from_numpy(a).cuda() for a in
                                 resident_case(n, seed=log_n))
                scalars = dedup.pass_args(np.zeros((1, 3), np.float32),
                                          np.ones(1, bool), cs, scs,
                                          "cuda")[2:]
                fronts = [(qh.quantize_sort4_resident(res, src, ext,
                                                      *scalars),
                           dedup.quantize_sort4_resident_reference(
                               res, src, ext, *scalars))]
            else:
                shape = "uniform" if kind == "collide" else kind
                args = dedup.pass_args(*pass_case(shape, n, seed=log_n),
                                       cs, scs, "cuda")
                scalars = args[2:]
                fronts = [] if kind == "collide" else [
                    (qh.quantize_sort4(*args, keys=keys),
                     dedup.quantize_sort4_reference(*args, keys=keys))
                    for keys in (False, True)]
            torch.cuda.synchronize()
            for front, plain in fronts:
                err = bits_err(torch, front, plain)
                worst["front"] = max(worst["front"], err)
                if err or len(front) != len(plain):
                    raise AssertionError(f"the fused front end != plain at "
                                         f"2^{log_n} {kind}")
            if kind == "resident":
                *cols, pos = fronts[0][0]
            elif kind == "collide":
                pos = args[0]
                ch, sh, db, arrival = dedup.quantize_hash_reference(*args)
                cols = sort.sort4(*collide_columns(torch, ch, sh), db,
                                  arrival)
            else:
                pos, cols = args[0], fronts[0][0]
            b3 = mp.mark_pack(*cols, pos, *scalars)
            torch.cuda.synchronize()
            err = bits_err(torch, (b3,), (dedup.mark_pack_reference(
                *cols, pos, *scalars),))
            worst["b3"] = max(worst["b3"], err)
            if err:
                raise AssertionError(f"B3 != plain at 2^{log_n} {kind}")
            if kind == "all_equal" and int(((b3 >> 29) & 1).sum()) != n:
                raise AssertionError("all_equal: one run, not all suspect")
            checked.append(f"2^{log_n}:{kind}")
    return {"checked": checked, "max_abs_err": worst}


def pass_kernel_names(torch, fns, per_round: dict, reps: int = 10) -> dict:
    """{device event name: count} that the profiler kept of ``reps``
    rounds of ``fns`` (each called once a round). As in
    ``device_kernel_ms``, the rounds run in the recorded step of a profile
    whose warm-up step has traced the same calls for PROFILE_LEAD_S,
    because the profiler drops kernels at the start of a profile (the one
    kernel of a single recorded call can be lost). ``per_round`` maps a
    name that a kernel's name holds to how many such kernels a round
    launches: a profile that kept more raises, one that kept fewer than
    half is taken again, up to PROFILE_TRIES profiles."""
    from torch.profiler import ProfilerActivity, profile, schedule

    def one_round():
        for fn in fns:
            fn()

    one_round()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            lead_end = time.perf_counter() + PROFILE_LEAD_S
            while time.perf_counter() < lead_end:
                one_round()
                torch.cuda.synchronize()
            prof.step()  # the warm-up step ends: only what follows counts
            for _ in range(reps):
                one_round()
            torch.cuda.synchronize()
        names = {}
        for e in prof.events():  # the step markers are not device work
            if e.device_type == torch.autograd.DeviceType.CUDA \
                    and not e.name.startswith("ProfilerStep"):
                names[e.name] = names.get(e.name, 0) + 1
        kept = {k: sum(v for name, v in names.items() if k in name)
                for k in per_round}
        if any(kept[k] > reps * c for k, c in per_round.items()):
            raise AssertionError(f"{reps} rounds ran more kernels than "
                                 f"{per_round} a round: {names}")
        if all(2 * kept[k] >= reps * c for k, c in per_round.items()):
            return names
    raise AssertionError(f"the profiler kept too few kernels of {per_round} "
                         f"in {PROFILE_TRIES} profiles: {names}")


def check_pass_profile(torch, np, dedup, mp, sort, n: int) -> dict:
    """Rounds of one light pass and one resident pass on the card: their
    device work must be the fused front end (B2 inside sort4's tile
    kernel, ``quantize_tile``), sort4's merges and at most one B3 kernel a
    pass, nothing else (no standalone B2, no copy, no memset, no scan);
    then B3 alone: its one kernel and nothing else."""
    from point_cloud_tpu_torch.core.metadata import MetadataConfig
    from point_cloud_tpu_torch.models.synth import pass_case, resident_case

    config = MetadataConfig()
    cs = config.cell_size(0)
    scs = config.sub_cell_size(cs)
    args = dedup.pass_args(*pass_case("synth", n, seed=5), cs, scs,
                           "cuda")
    res = [torch.from_numpy(a).cuda()
           for a in resident_case(n, seed=6)]
    ours = ("quantize_tile", "sort4_merge", "mark_pack_kernel")
    per_pass = {**front_kernels(n), "mark_pack_kernel": 1}
    names = pass_kernel_names(torch, [
        lambda: dedup.dedup_pass_light(*args),
        lambda: dedup.dedup_pass_resident(*res, *args[2:])],
        {k: 2 * c for k, c in per_pass.items() if c})
    other = {k: v for k, v in names.items()
             if not any(o in k for o in ours)}
    if other:
        raise AssertionError(f"the pass ran other device work: {other}")
    missing = [o for o in ours if not any(o in k for k in names)]
    if missing:
        raise AssertionError(f"the profile shows no {missing}: {names}")
    cols = sort.sort4(*dedup.quantize_hash_reference(*args))
    alone = pass_kernel_names(torch, [
        lambda: mp.mark_pack(*cols, args[0], *args[2:])],
        {"mark_pack_kernel": 1})
    if len(alone) != 1 or "mark_pack_kernel" not in next(iter(alone)):
        raise AssertionError(f"B3 is not one kernel and nothing else: "
                             f"{alone}")
    return {"passes": names, "b3_alone": alone}


def time_pass(torch, np, dedup, qh, mp, sort, n: int) -> dict:
    """The fused front end, B3, the light pass and its plain twin at ``n``
    rows of the LiDAR-like cloud at hierarchy 0: the kernels' own device
    time (``device_kernel_ms``), CUDA event times of the wrappers and of
    the plain versions on the card (plain, kernel, kernel, plain), and
    the bounds from this input. Beside the fused front end, its tile
    kernel alone, and ``sort4`` alone on its columns."""
    from point_cloud_tpu_torch.core.metadata import MetadataConfig
    from point_cloud_tpu_torch.models.synth import pass_case

    config = MetadataConfig()
    cs = config.cell_size(0)
    args = dedup.pass_args(*pass_case("synth", n, seed=1), cs,
                           config.sub_cell_size(cs), "cuda")
    pos, scalars = args[0], args[2:]
    cols = qh.quantize_sort4(*args)
    b3_moved, keyed = b3_bytes(torch, cols[0], cols[1])

    def plain_pass():
        return dedup.mark_pack_reference(
            *dedup.quantize_sort4_reference(*args), pos, *scalars)

    out = {}
    for name, fn, plain, kernels in (
            ("front", lambda: qh.quantize_sort4(*args),
             lambda: dedup.quantize_sort4_reference(*args), front_kernels(n)),
            ("b3", lambda: mp.mark_pack(*cols, pos, *scalars),
             lambda: dedup.mark_pack_reference(*cols, pos, *scalars),
             PASS_KERNELS["b3"]),
            ("light_pass", lambda: dedup.dedup_pass_light(*args), plain_pass,
             {**front_kernels(n), **PASS_KERNELS["b3"]})):
        p1 = cuda_ms(plain)
        w1 = cuda_ms(fn)
        d = device_kernel_ms(torch, fn, kernels)
        w2 = cuda_ms(fn)
        p2 = cuda_ms(plain)
        out[name] = {"ms": d, "wrapper_ms": statistics.median([w1, w2]),
                     "plain_ms": statistics.median([p1, p2]),
                     "wrapper_ms_runs": [w1, w2], "plain_ms_runs": [p1, p2]}
    out["b3"]["bound_ms"], out["b3"]["bound_by"] = pass_bound_ms(
        b3_moved, B3_OPS_PER_ROW * n)
    out["b3"]["keyed_rows"] = keyed
    front = out["front"]
    front["bound_ms"], front["bound_by"] = pass_bound_ms(
        FRONT_BYTES_PER_ROW * n, FRONT_OPS_PER_ROW * n)
    front["sort4_bound_ms"] = sort4_bound_ms(n)[0]
    front["tile_ms"] = device_kernel_ms(torch, lambda: qh.quantize_sort4(*args),
                                        {"quantize_tile": 1})
    out["light_pass"]["bound_ms"] = front["bound_ms"] + out["b3"]["bound_ms"]
    out["light_pass"]["sort4_ms"] = device_kernel_ms(
        torch, lambda: sort.sort4(*cols), sort4_kernels(n))
    return out


def phase_pass(torch, np, dedup, get_pipeline) -> dict:
    """Phase 3: the full pass (``conversion``) and the light pass on the
    card against the CPU port; the fused front end and B3 against their
    plain versions on every shape and length; the division helper; a
    profile of the light and resident passes; the kernels and the pass
    timed at PASS_TIMED_LOG_N."""
    from point_cloud_tpu_torch.core.metadata import MetadataConfig
    from point_cloud_tpu_torch.models.synth import (
        pass_case, resident_case, synth_cloud,
    )
    from point_cloud_tpu_torch.ops import mark_pack as mp
    from point_cloud_tpu_torch.ops import quantize_hash as qh
    from point_cloud_tpu_torch.ops import sort

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
    # the light pass on the card against the CPU's on every finite shape
    m = 1 << PASS_CPU_LOG_N
    for kind in PASS_FINITE:
        case = pass_case(kind, m, seed=2)
        got = dedup.dedup_pass_light(*dedup.pass_args(
            *case, cs, config.sub_cell_size(cs), "cuda")).cpu()
        if not torch.equal(got, dedup.dedup_pass_light(*dedup.pass_args(
                *case, cs, config.sub_cell_size(cs), "cpu"))):
            raise AssertionError(f"dedup_pass_light on {kind}: cuda != cpu")
    res = resident_case(m, seed=3)
    got = dedup.dedup_pass_resident(
        *(torch.from_numpy(a).cuda() for a in res), *dargs[2:]).cpu()
    if not torch.equal(got, dedup.dedup_pass_resident(
            *(torch.from_numpy(a) for a in res), *hargs[2:])):
        raise AssertionError("dedup_pass_resident: cuda != cpu")

    kernels = check_pass_kernels(torch, np, dedup, qh, mp, sort)
    division = division_check(torch, qh)
    names = check_pass_profile(torch, np, dedup, mp, sort, 1 << 18)
    timed = {1 << log_n: time_pass(torch, np, dedup, qh, mp, sort, 1 << log_n)
             for log_n in PASS_TIMED_LOG_N}
    result = {
        "phase": "pass", "ok": True, "n": n,
        "conversion_pipeline_ms": full_ms,
        "dedup_pass_light_ms": timed[n]["light_pass"]["wrapper_ms"],
        "winners": int(((packed >> 30) & 1).sum()),
        "suspects": int(((packed >> 29) & 1).sum()),
        "cpu_equal_shapes": [*PASS_FINITE, "resident"],
        "kernels_checked": kernels["checked"],
        "max_abs_err": kernels["max_abs_err"],
        "division_check": division,
        "profiled_device_work": names,
        "timed": timed,
    }
    emit(result)
    return result


def cli_command(flags, src, out: Path) -> list:
    """The port's CLI converting ``src`` (one path or several) into
    ``out`` at batch BATCH with ``--profile``."""
    srcs = [src] if isinstance(src, Path) else list(src)
    return [sys.executable, "-m", "point_cloud_tpu_torch.convert.cli",
            *flags.split(), "--batch-size", str(BATCH), "--profile",
            "-o", str(out), "-f", *map(str, srcs)]


def run_cli(flag: str, src, out: Path) -> dict:
    proc = subprocess.run(cli_command(flag, src, out), cwd=ROOT,
                          capture_output=True, text=True,
                          timeout=CLI_TIMEOUT_S)
    if proc.returncode != 0 or "Failed converting" in proc.stderr:
        raise RuntimeError(f"{flag} conversion failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def store_files(root: Path) -> dict:
    return {str(p.relative_to(root)): p for p in sorted(root.rglob("*"))
            if p.is_file()}


def same_store(a: Path, b: Path, what: str) -> int:
    """Fails unless the stores at ``a`` and ``b`` hold the same files with
    the same bytes; returns the file count."""
    import filecmp

    fa, fb = store_files(a), store_files(b)
    if not fa or set(fa) != set(fb):
        raise AssertionError(f"{what}: store file sets differ "
                             f"({len(fa)} / {len(fb)} files)")
    bad = [k for k in fa if not filecmp.cmp(fa[k], fb[k], shallow=False)]
    if bad:
        raise AssertionError(f"{what}: {len(bad)} store files differ: "
                             f"{bad[:5]}")
    return len(fa)


def sorted_lengths(run: dict, flag: str, checked: dict) -> dict:
    """The run's sorts by length, ``sort4``'s and the fused front end's
    (and the front end's gather calls among them); fails if it sorted
    nothing, or a length that the phase checking that kernel did not
    check (``checked``: lengths by kernel)."""
    launches = run["launches"]
    if launches["sort4"] + launches["quantize_sort4"] <= 0:
        raise AssertionError(f"the {flag} run sorted nothing")
    by_n = {k: {int(n): c for n, c in v.items()}
            for k, v in run["launches_by_n"].items()}
    for kernel in ("sort4", "quantize_sort4"):
        unchecked = sorted(n for n in by_n[kernel]
                           if n not in checked[kernel])
        if unchecked:
            raise AssertionError(f"the {flag} run sorted lengths {unchecked} "
                                 f"through {kernel}, which no phase checked")
    return by_n


def pass_launches(run: dict, flag: str, mesh: bool = False) -> dict:
    """The run's front end, ``sort4`` and B3 launch counts: every pass is
    the fused front end (B2 inside sort4's tile kernel), then B3, so those
    two counts agree; a single-device run calls no ``sort4`` of its own,
    a mesh run one for each front end (its routing and arrival sorts)."""
    launches = run["launches"]
    fused, sorts = launches["quantize_sort4"], launches["sort4"]
    if not fused == launches["mark_pack"] > 0 \
            or sorts != (fused if mesh else 0):
        raise AssertionError(f"the {flag} run's passes were not the fused "
                             f"front end -> B3: {launches}")
    return {k: launches[k] for k in ("quantize_sort4", "sort4", "mark_pack")}


def phase_slice(torch, np, checked: dict, tmp: Path) -> dict:
    """Phase 4, in ``tmp``; the PLY and the three stores stay there (phase
    8 converts the PLY again and compares with the ``--native`` store)."""
    from point_cloud_tpu_torch.core.point import PointBatch
    from point_cloud_tpu_torch.io.ply import write_ply
    from point_cloud_tpu_torch.models.synth import synth_cloud

    rng = np.random.default_rng(3)
    src = tmp / "cloud.ply"
    write_ply(src, PointBatch(
        synth_cloud(CLOUD_POINTS, seed=0),
        rng.integers(0, 256, (CLOUD_POINTS, 4), dtype=np.uint8),
    ))
    runs = {flag: run_cli(flag, src, tmp / flag.strip("-"))
            for flag in ("--device", "--device-native", "--native")}
    for flag in ("--device", "--device-native"):
        files = same_store(tmp / "native", tmp / flag.strip("-"), flag)
    # the card's busy share over one more --device-native conversion, in
    # this process under torch.profiler (its store checked too)
    from point_cloud_tpu_torch.convert.cli import main as cli_main

    busy = busy_share(torch, lambda: cli_main([
        "--device-native", "--batch-size", str(BATCH),
        "-o", str(tmp / "profiled"), "-f", str(src)]))
    same_store(tmp / "native", tmp / "profiled", "profiled --device-native")
    device, native_device = runs["--device"], runs["--device-native"]
    stages = device["stages"]
    result = {
        "phase": "slice", "ok": True, "points": CLOUD_POINTS,
        "batch_size": BATCH, "store_files": files,
        "byte_identical": True,
        "sort4_launches": native_device["launches"]["sort4"],
        "launches_by_n": sorted_lengths(
            native_device, "--device-native", checked),
        "device_sort4_launches": device["launches"]["sort4"],
        "device_launches_by_n": sorted_lengths(device, "--device", checked),
        "device_native_busy": busy,
        "pass_launches": pass_launches(native_device, "--device-native"),
        "device_pass_launches": pass_launches(device, "--device"),
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


# --- phase 5: the frame path ----------------------------------------------

FRAME_W, FRAME_H = 1280, 720
ORBIT_FRAMES = 8
# one rung per window size the synthetic bucket fills, with the band of
# pixel half-extents its rows get (the 9-rung band is [4, 4.5))
SYNTH_BANDS = {9: (4.05, 4.45), 17: (5.0, 8.0), 33: (9.0, 16.0),
               65: (20.0, 40.0)}
SYNTH_ROWS = 4096  # per band: above the 33 and 65 rungs' caps at 2^14
# rankings of the synthetic rows that the raster alone is held on
EDGE_BUCKETS = ("filled", "empty", "corner")
# SASS instructions of csrc/splat.cu that one tested fragment costs a lane,
# counted in one trip of raster_unit's loop over window rows as ``cuobjdump
# -sass`` shows it (the voronoi copy of the loop; count them again after a
# change to that loop). A fragment outside the circle or off the screen
# takes 12: UMOV, VIADD, BRA.DIV, SHFL x2, LOP3, FADD, BSSY, ISETP, FSETP,
# BRA, BSYNC. A lit fragment that loses the early-out read takes 38: the
# first 11 of those, then FADD, BSSY, FMUL, FADD (the moved depth), MUFU.RCP,
# FFMA x2, FMUL, FADD, FCHK, FFMA x3, BRA, BSYNC (the IEEE divide), FSETP x2,
# BRA (depth in [0, 1]), LDC, IMAD.IADD, IMAD.WIDE, LDG, LOP3, ISETP x2, BRA
# (the read and the compare), BSYNC. A winner's two moves and its atomic,
# the loop's counter and a row's set-up are left out: the bound stays below
# what any run needs.
K2_INSTR_LIT = 38
K2_INSTR_REJECTED = 12
LANES_PER_SM = 128


def settle(viewer, limit: int = 4000) -> None:
    """Update until streaming has loaded every visible cell."""
    for _ in range(limit):
        viewer.update()
        if not viewer.streamer.loading and len(viewer.streamer.should_load) == 0:
            return
    raise RuntimeError("streaming did not settle")


def synth_bucket(torch, np, kw_like: dict):
    """A bucket at 1280x720 whose splats fill the 9-, 17-, 33- and 65-px
    rungs, the last two beyond their caps (the tests' chunked-raster
    pattern at full width): SYNTH_ROWS rows per band of SYNTH_BANDS."""
    from point_cloud_tpu_torch.render.camera import Camera
    from point_cloud_tpu_torch.render.kernel import MAX_HIERARCHIES

    dev = torch.device("cuda")
    cam = Camera()
    cam.projection.far = 5000.0
    cam.projection.aspect_ratio = FRAME_W / FRAME_H
    proj = cam.projection_matrix().astype(np.float32)
    t = cam.transform
    rng = np.random.default_rng(11)
    slope = cam.projection.slope()
    pos = []
    for lo, hi in SYNTH_BANDS.values():
        rmax = rng.uniform(lo, hi, SYNTH_ROWS)
        # radius 1: ry = P11 / d * H / 2, so d = P11 * H / 2 / rmax
        d = proj[1, 1] * (FRAME_H / 2) / rmax
        sx, sy = (rng.uniform(-0.9, 0.9, SYNTH_ROWS) for _ in range(2))
        pos.append(t.translation + d[:, None] * t.forward()
                   + (sx * d * slope * cam.projection.aspect_ratio)[:, None]
                   * t.right() + (sy * d * slope)[:, None] * t.up())
    pos = np.concatenate(pos).astype(np.float32)
    n = len(pos)
    spacings = np.zeros(MAX_HIERARCHIES, np.float32)
    spacings[0] = 1.0
    as_dev = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    args = (as_dev(pos), torch.zeros(n, dtype=torch.int32, device=dev),
            torch.ones(n, dtype=torch.bool, device=dev),
            torch.arange(1, n + 1, dtype=torch.int32, device=dev),
            as_dev(cam.view_matrix().astype(np.float32)), as_dev(proj),
            as_dev(np.asarray(t.translation, np.float32)), as_dev(spacings),
            torch.zeros(MAX_HIERARCHIES, dtype=torch.float32, device=dev),
            False, 0, kw_like["thresholds"])
    kw = {k: v for k, v in kw_like.items() if k != "thresholds"}
    return args, kw


def cull_inputs(splat, kernel, fb_in, args, kw):
    """K1's arguments for a captured bucket, as render_bucket_pass forms
    them."""
    (positions, hier_base, valid, _ids, view, proj, cam_pos, spacings,
     fars, sbd, maxh, thresholds) = args
    depth = coarse = None
    if kw["use_occlusion"]:
        depth = splat.framebuffer_depth(splat.Framebuffer(fb_in),
                                        kw["height"], kw["width"])
        if kw["use_pyramid"]:
            coarse = kernel.coarse_depth_grid(depth)
    return ((positions, hier_base, valid, view, proj, cam_pos, spacings, fars,
             sbd, maxh, thresholds, kw["width"], kw["height"]),
            dict(depth=depth, coarse=coarse))


def same_bits(torch, a, b) -> bool:
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def abs_err(torch, a, b) -> float:
    """Largest |a - b| (inf where one side is NaN and the other not)."""
    d = (a.double() - b.double()).abs()
    both_nan = a.double().isnan() & b.double().isnan()
    return float(torch.where(both_nan, 0.0, d).nan_to_num(nan=math.inf).max())


def check_bucket(torch, splat, kernel, fb_in, args, kw) -> dict:
    """K1 against its plain version, then the bucket's whole chain with
    the kernels against the chain with the plain versions, from the same
    input framebuffer: every output and the framebuffer bits equal. The
    largest differences found go into ``cull_err`` (K1's outputs) and
    ``raster_err`` (the framebuffer's depth and id planes after the
    bucket, and the bucket's counts)."""
    cargs, ckw = cull_inputs(splat, kernel, fb_in, args, kw)
    got = kernel.cull_classify(*cargs, **ckw)
    ref = kernel.cull_classify_reference(*cargs, **ckw)
    cull_err = max(abs_err(torch, g, r) for g, r in zip(got, ref))
    for name, g, r in zip(("keep", "hierarchy", "view_pos", "ndc", "radius",
                           "rmax", "rung"), got, ref):
        if not same_bits(torch, g, r):
            raise AssertionError(f"cull_classify != plain in {name}: "
                                 f"max abs err {cull_err}")
    fb_k = splat.Framebuffer(fb_in.clone())
    fb_p = splat.Framebuffer(fb_in.clone())
    _, vec_k = splat.render_bucket_pass(fb_k, *args, **kw)
    _, vec_p = splat.render_bucket_pass(
        fb_p, *args, **kw, cull=kernel.cull_classify_reference,
        raster=splat.splat_raster_reference)
    torch.cuda.synchronize()
    raster_err = max(abs_err(torch, vec_k, vec_p),
                     abs_err(torch, fb_k.depth, fb_p.depth),
                     abs_err(torch, fb_k.point_id, fb_p.point_id))
    if not torch.equal(vec_k, vec_p):
        raise AssertionError("bucket counts: kernels != plain")
    if not torch.equal(fb_k.packed, fb_p.packed):
        raise AssertionError("framebuffer after the bucket: kernels != plain"
                             f": max abs err {raster_err}")
    return {"n": int(args[0].shape[0]), "kept": int(vec_k[0]),
            "rung_counts": vec_k[1:].tolist(),
            "lit_pixels": int((fb_k.packed != fb_in).sum()),
            "cull_err": cull_err, "raster_err": raster_err}


def plain_raster(splat):
    """``splat.splat_raster_reference`` with chunks of at least
    PLAIN_CHUNK_FRAGMENTS fragments: the plain version of K2 a check runs
    (a ``raster`` of ``splat_raster_segments_reference``)."""
    def raster(*args):
        *head, k, voronoi, chunk_rows = args
        return splat.splat_raster_reference(
            *head, k, voronoi,
            max(chunk_rows, PLAIN_CHUNK_FRAGMENTS // (k * k)))
    return raster


class KernelCapture:
    """Wraps K1's and K2's wrappers (``kernel.cull_classify``,
    ``splat.splat_raster_segments``) while it is installed: every call's
    arguments, and K2's input plane, kept for :meth:`check` after the run.
    The wrappers count nothing of the kernels: the kernels' own wrappers
    do."""

    def __init__(self, kernel, splat):
        self.kernel, self.splat = kernel, splat
        self.real = (kernel.cull_classify, splat.splat_raster_segments)
        self.culls, self.rasters = [], []

    def __enter__(self):
        cull, raster = self.real

        def cull_wrap(*args, **kw):
            self.culls.append((args, kw))
            return cull(*args, **kw)

        def raster_wrap(fb, *args):
            self.rasters.append((fb.clone(), args))
            return raster(fb, *args)

        self.kernel.cull_classify = cull_wrap
        self.splat.splat_raster_segments = raster_wrap
        return self

    def __exit__(self, *exc):
        self.kernel.cull_classify, self.splat.splat_raster_segments = self.real

    def check(self, torch) -> dict:
        """K1 and K2 against their plain versions on the card, on every
        captured call's inputs: every K1 output and every plane bit for
        bit. The largest differences go into ``cull_err`` and
        ``raster_err``."""
        cull, raster = self.real
        cull_err = raster_err = 0.0
        for args, kw in self.culls:
            got = cull(*args, **kw)
            ref = self.kernel.cull_classify_reference(*args, **kw)
            err = max(abs_err(torch, g, r) for g, r in zip(got, ref))
            cull_err = max(cull_err, err)
            if not all(same_bits(torch, g, r) for g, r in zip(got, ref)):
                raise AssertionError(f"cull_classify != plain: max abs err "
                                     f"{err}")
        for fb_in, args in self.rasters:
            fb_k, fb_p = fb_in.clone(), fb_in.clone()
            raster(fb_k, *args)
            self.splat.splat_raster_segments_reference(
                fb_p, *args, raster=plain_raster(self.splat))
            torch.cuda.synchronize()
            got = self.splat.Framebuffer(fb_k)
            ref = self.splat.Framebuffer(fb_p)
            err = max(abs_err(torch, got.depth, ref.depth),
                      abs_err(torch, got.point_id, ref.point_id))
            raster_err = max(raster_err, err)
            if not torch.equal(fb_k, fb_p):
                raise AssertionError(f"splat_raster != plain: max abs err "
                                     f"{err}")
        return {"k1_calls": len(self.culls), "k2_calls": len(self.rasters),
                "cull_err": cull_err, "raster_err": raster_err}


def call_rows(splat, args) -> int:
    """Rows a captured K2 call draws (reads its counts)."""
    return sum(int(splat.segment_bounds(seg, args[5], args[6])[1])
               for seg in args[10])


def raster_inputs(splat, kernel, fb_in, args, kw):
    """The raster stage's inputs for a bucket: K1's outputs and the rung
    ranking, computed once."""
    cargs, ckw = cull_inputs(splat, kernel, fb_in, args, kw)
    keep, _, view_pos, ndc, radius, _, rung = kernel.cull_classify(*cargs, **ckw)
    rungs = tuple(kw["sub_ks"]) + (kw["footprint"],) + tuple(kw["overflow_ks"])
    perm, counts, offsets = splat.compact_classes(rung, len(rungs))
    return dict(view_pos=view_pos, ndc=ndc, radius=radius, point_id=args[3],
                perm=perm, counts=counts, offsets=offsets, projection=args[5],
                height=kw["height"], width=kw["width"], rungs=rungs,
                footprint=kw["footprint"], voronoi=kw["voronoi"],
                kept=int(keep.sum()))


def run_rungs(splat, fb, inp, raster):
    return splat.raster_rungs(
        fb, inp["view_pos"], inp["ndc"], inp["radius"], inp["point_id"],
        inp["perm"], inp["counts"], inp["offsets"], inp["projection"],
        height=inp["height"], width=inp["width"], rungs=inp["rungs"],
        footprint=inp["footprint"], voronoi=inp["voronoi"], raster=raster)


def time_kernel(torch, kernel_fn, plain_fn, name, plain_reps: int,
                setup=None) -> dict:
    """Plain, kernel, kernel, plain on one card, for a kernel that
    ``kernel_fn`` launches once (``name``; or a ``per_call`` map of
    :func:`device_kernel_ms`). ``ms``: its own device time a call
    (:func:`device_kernel_ms`, twice); ``wrapper_ms``:
    CUDA events around the wrapper call between them; ``plain_ms``: CUDA
    events around the plain version, before and after. ``setup()`` runs
    before each timed call (outside the event span)."""
    def with_setup(fn):
        return fn if setup is None else lambda: (setup(), fn())

    per_call = name if isinstance(name, dict) else {name: 1}
    p1 = cuda_ms(plain_fn, reps=plain_reps, setup=setup)
    d1 = device_kernel_ms(torch, with_setup(kernel_fn), per_call)
    wrapper = cuda_ms(kernel_fn, setup=setup)
    d2 = device_kernel_ms(torch, with_setup(kernel_fn), per_call)
    p2 = cuda_ms(plain_fn, reps=plain_reps, setup=setup)
    return {"ms": (d1 + d2) / 2, "ms_runs": [d1, d2], "wrapper_ms": wrapper,
            "plain_ms": (p1 + p2) / 2, "plain_ms_runs": [p1, p2]}


def lit_fragments(torch, splat, inp) -> tuple[int, int]:
    """The fragments the bucket's rung rasters light (inside the circle,
    on screen, depth in [0, 1]) and the distinct pixels they land on,
    counted with the plain expansion."""
    return count_lit(torch, splat, inp["height"] * inp["width"],
                     inp["perm"].device,
                     lambda count: run_rungs(splat, inp["perm"], inp, count))


def call_lit_fragments(torch, splat, args) -> tuple[int, int]:
    """:func:`lit_fragments` of one captured K2 call (the arguments of
    ``splat_raster_segments`` after the plane)."""
    return count_lit(
        torch, splat, args[8] * args[9], args[4].device,
        lambda count: splat.splat_raster_segments_reference(
            args[4], *args, raster=count))


def call_tested_fragments(splat, args) -> int:
    """count * k * k summed over a captured K2 call's segments."""
    offsets, counts, segments = args[5], args[6], args[10]
    return sum(seg.k * seg.k
               * int(splat.segment_bounds(seg, offsets, counts)[1])
               for seg in segments)


def count_lit(torch, splat, pixels: int, device, run) -> tuple[int, int]:
    """Lit fragments and distinct pixels of the rasters ``run(raster)``
    hands to ``raster`` (the plain raster's signature; it writes
    nothing)."""
    total = [0]
    touched = torch.zeros(pixels, dtype=torch.bool, device=device)

    def count(fb, vp, ndc, radius, pid, perm, start, cnt, proj, h, w, k,
              voronoi, chunk_rows):
        s, c = int(start[0]), int(cnt[0])
        chunk_rows = max(chunk_rows, PLAIN_CHUNK_FRAGMENTS // (k * k))
        for c0 in range(0, c, chunk_rows):
            rows = perm[s + c0 : s + min(c0 + chunk_rows, c)].long()
            idx, _, valid = splat.fragments(vp[rows], ndc[rows], radius[rows],
                                            pid[rows], proj, h, w, k, voronoi)
            total[0] += int(valid.sum())
            touched[idx[valid]] = True
        return fb

    run(count)
    return total[0], int(touched.sum())


def cull_bound_ms(n: int, inside: int, occlusion: bool, pyramid: bool,
                  pixels: int, coarse_cells: int) -> float:
    """Least time for K1 over n points, in bytes at the HBM rate (every
    byte from HBM; K1 is timed from a flushed L2 to match): each
    point reads its position, hierarchy and valid flag (17 B) and writes
    the outputs the bucket pass reads, keep, view_pos, ndc, radius and
    rung (37 B; the hierarchy and rmax it also writes are discarded
    there). Only the ``inside`` points (valid, inside the NDC box) need
    the depth plane (f32) and the coarse grid (f32), each of those read at
    most once: 4 B * min(inside, plane size) and 4 B * min(inside, grid
    size). Its ~60 f32 operations a point are far below the f32 peak."""
    moved = n * (17 + 37)
    if occlusion:
        moved += 4 * min(inside, pixels)
        if pyramid:
            moved += 4 * min(inside, coarse_cells)
    return moved / HBM_BYTES_PER_S * 1e3


def raster_bound_ms(rows: int, touched: int) -> float:
    """Least time for one bucket's K2 launch, in bytes at the HBM rate
    (HBM for the rows and the first touch of a pixel, L2 for the rest):
    each rastered row reads its perm entry, view_pos.z, ndc, radius and id
    (28 B), and each framebuffer word that a lit fragment lands on is read
    once and written once (2 * 8 B * ``touched`` distinct pixels, at most
    the whole 8 B * H * W plane). Fragments that hit a word again stay in
    the card's 50 MB L2, which holds the plane (7.4 MB at 1280x720), so
    they are not charged to HBM."""
    return (28 * rows + 16 * touched) / HBM_BYTES_PER_S * 1e3


def raster_instr_bound_ms(tested: int, lit: int, sms: int,
                          clock_mhz: float) -> float:
    """Least time for one bucket's K2 launch, in instruction slots. Of the
    ``tested`` fragments (the sum of count * k * k over the bucket's
    segments) the ``lit`` ones (inside the circle, on screen, depth in
    [0, 1]) cost K2_INSTR_LIT each and the others K2_INSTR_REJECTED, over
    the card's lanes (``sms`` x 128, one instruction a lane a cycle) at
    ``clock_mhz``."""
    slots = lit * K2_INSTR_LIT + (tested - lit) * K2_INSTR_REJECTED
    return slots / (sms * LANES_PER_SM * clock_mhz * 1e6) * 1e3


def segment_rows(splat, inp) -> list:
    """(segment, its row count) for each of the bucket's segments (reads
    the counts)."""
    segs = splat.bucket_segments(inp["rungs"], inp["footprint"],
                                 inp["view_pos"].shape[0])
    return [(seg, int(splat.segment_bounds(seg, inp["offsets"],
                                           inp["counts"])[1]))
            for seg in segs]


def tested_fragments(splat, inp) -> int:
    """count * k * k summed over the bucket's segments."""
    return sum(seg.k * seg.k * rows for seg, rows in segment_rows(splat, inp))


def sm_clock_under_load(torch, fn, seconds: float = 1.5) -> float:
    """The SM clock in MHz that nvidia-smi reports while ``fn`` keeps the
    card busy: a thread calls it for ``seconds``, the query runs in its
    second half."""
    import threading

    stop = threading.Event()

    def load():
        while not stop.is_set():
            for _ in range(64):
                fn()
            torch.cuda.synchronize()

    worker = threading.Thread(target=load)
    worker.start()
    try:
        time.sleep(seconds / 2)
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True).stdout
    finally:
        stop.set()
        worker.join()
    return float(out.strip().splitlines()[0])


def edge_bucket(torch, splat, inp: dict, name: str) -> dict:
    """The synthetic bucket's rows under another ranking (the raster clips
    a splat to whatever window its rung gives it). ``filled``: every rung
    holds rows, the 33 and 65 rungs beyond their caps; ``empty``: no row
    in any rung; ``corner``: one row, in the 65 rung, centred on the
    frame's first pixel."""
    n, rungs = inp["view_pos"].shape[0], inp["rungs"]
    out = dict(inp)
    if name == "filled":
        i33, i65 = rungs.index(33), rungs.index(65)
        rest = [j for j in range(len(rungs)) if j not in (i33, i65)]
        rung = torch.tensor(rest, dtype=torch.int32, device="cuda")[
            torch.arange(n, device="cuda") % len(rest)]
        rung[:3000] = i33
        rung[3000:4000] = i65
    else:
        rung = torch.full((n,), -1, dtype=torch.int32, device="cuda")
        if name == "corner":
            row = n - 7  # one of the widest band's rows
            rung[row] = rungs.index(65)
            out["ndc"] = inp["ndc"].clone()
            out["ndc"][row, 0], out["ndc"][row, 1] = -1.0, 1.0
    out["perm"], out["counts"], out["offsets"] = splat.compact_classes(
        rung, len(rungs))
    return out


def check_edge_bucket(torch, splat, inp: dict, name: str) -> dict:
    """The one-launch kernel against the plain loop on an edge bucket,
    from a clear plane: the words equal."""
    fb_k = splat.make_framebuffer(inp["height"], inp["width"], "cuda").packed
    fb_p = fb_k.clone()
    before = splat.launches
    run_rungs(splat, fb_k, inp, None)
    if splat.launches != before + 1:
        raise AssertionError("a bucket's raster is one launch")
    run_rungs(splat, fb_p, inp, splat.splat_raster_reference)
    torch.cuda.synchronize()
    got, ref = splat.Framebuffer(fb_k), splat.Framebuffer(fb_p)
    err = max(abs_err(torch, got.depth, ref.depth),
              abs_err(torch, got.point_id, ref.point_id))
    if not torch.equal(fb_k, fb_p):
        raise AssertionError(f"edge bucket {name}: kernel != plain: "
                             f"max abs err {err}")
    counts = inp["counts"].tolist()
    rows = segment_rows(splat, inp)
    lit = int((fb_k != splat._CLEAR_WORD).sum())
    tails = sum(1 for seg, r in rows if seg.tail and r > 0)
    if name == "filled" and (min(counts) == 0 or tails != 2):
        raise AssertionError(f"edge bucket filled: counts {counts}, "
                             f"{tails} tails")
    if name == "empty" and (sum(counts) or lit):
        raise AssertionError("edge bucket empty drew something")
    if name == "corner" and (sum(counts) != 1 or lit < 50
                             or int(fb_k[0]) == splat._CLEAR_WORD):
        raise AssertionError(f"edge bucket corner: {lit} lit pixels")
    return {"name": name, "rung_counts": counts,
            "segment_rows": [r for _, r in rows], "lit_pixels": lit,
            "raster_err": err}


# --- K5, the class ranking --------------------------------------------------

RANK_KERNELS = {"class_rank_hist": 1, "class_rank_scan": 1,
                "class_rank_scatter": 1}
RANK_SWEEP_N = tuple(1 << k for k in range(10, 23)) + (1000, 3)
RANK_SWEEP_C = (1, 2, 13, 130, 9000)
RANK_EDGE_C = (1, 13, 9000)
# the plain version's (C+1) x N one-hot up to this many slots; past it the
# checks hold K5 to a stable sort on the card (:func:`rank_oracle`)
RANK_PLAIN_SLOTS = 1 << 28
# integer operations a row: the class test, the group's popcount and the
# counter update in the histogram; the same, the lane mask and the slot in
# the scatter
RANK_OPS_PER_ROW = 12
# kernels the ranking's torch version launched in a frame (cub's scan and
# the scatter): none but K5's own may show in the orbit frame's profile
RANK_FORBIDDEN = ("DeviceScan", "tensor_kernel_scan", "scatter")


def rank_oracle(torch, rung, n_classes: int, out_size=None,
                with_dest: bool = False):
    """(perm, counts, offsets, dest) of a stable class ranking by
    ``torch.sort(stable=True)`` and ``torch.bincount``, independent of the
    port's code: the check where the plain version's one-hot does not
    fit. ``rung`` is a bool mask of one class where ``out_size`` is
    given."""
    n = rung.shape[0]
    if rung.dtype == torch.bool:
        cls = torch.where(rung, 0, 1)
    else:
        cls = torch.where((rung >= 0) & (rung < n_classes), rung.long(),
                          n_classes)
    order = torch.sort(cls, stable=True).indices.to(torch.int32)
    counts = torch.bincount(cls, minlength=n_classes + 1)[:n_classes].to(
        torch.int32)
    offsets = (torch.cumsum(counts, 0, dtype=torch.int32) - counts)
    kept = int(counts.sum())
    size = 2 * n if out_size is None else out_size
    perm = torch.zeros(size, dtype=torch.int32, device=rung.device)
    take = min(kept, size)
    perm[:take] = order[:take]
    dest = None
    if with_dest:
        dest = torch.full((n,), size, dtype=torch.int32, device=rung.device)
        dest[order[:kept].long()] = torch.arange(
            kept, dtype=torch.int32, device=rung.device)
    return perm, counts, offsets, dest


def check_rank(torch, splat, rung, n_classes: int, out_size=None,
               with_dest: bool = False) -> dict:
    """K5 against its plain version on the card (past RANK_PLAIN_SLOTS,
    against :func:`rank_oracle`): perm (pad included), counts, offsets and
    dest bit for bit. Raises on a difference."""
    n = rung.shape[0]
    got = splat.class_rank(rung, n_classes, out_size, with_dest)
    plain = (n_classes + 1) * n <= RANK_PLAIN_SLOTS
    ref = (splat.class_rank_reference(rung, n_classes, out_size, with_dest)
           if plain else rank_oracle(torch, rung, n_classes, out_size,
                                     with_dest))
    torch.cuda.synchronize()
    err = 0.0
    for name, g, r in zip(("perm", "counts", "offsets", "dest"), got, ref):
        if (g is None) != (r is None):
            raise AssertionError(f"class_rank: {name} given by one side only")
        if g is None:
            continue
        e = abs_err(torch, g, r) if g.numel() else 0.0
        err = max(err, e)
        if g.dtype != torch.int32 or not torch.equal(g, r):
            raise AssertionError(
                f"class_rank != {'plain' if plain else 'stable sort'} in "
                f"{name} at n={n}, C={n_classes}, out_size={out_size}: max "
                f"abs err {e}")
    return {"n": n, "classes": n_classes, "out_size": out_size,
            "dest": with_dest, "against": "plain" if plain else "sort",
            "err": err}


class RankCapture:
    """Wraps K5's wrapper (``splat.class_rank``) while it is installed:
    every call's arguments (the rung cloned) kept for :meth:`check`. The
    checks' own launches are taken off ``splat.rank_launches`` again."""

    def __init__(self, splat):
        self.splat = splat
        self.real = splat.class_rank
        self.calls = []

    def __enter__(self):
        real = self.real

        def wrap(rung, n_classes, out_size=None, with_dest=False):
            self.calls.append((rung.clone(), n_classes, out_size, with_dest))
            return real(rung, n_classes, out_size, with_dest)

        self.splat.class_rank = wrap
        return self

    def __exit__(self, *exc):
        self.splat.class_rank = self.real

    def check(self, torch) -> dict:
        """Every captured call through :func:`check_rank`, then forgotten:
        calls, the class counts and caps seen, the largest error."""
        held = self.splat.rank_launches
        try:
            checks = [check_rank(torch, self.splat, *c) for c in self.calls]
        finally:
            self.splat.rank_launches = held
        self.calls.clear()
        return {"calls": len(checks),
                "classes": sorted({c["classes"] for c in checks}),
                "capped": sum(c["out_size"] is not None for c in checks),
                "with_dest": sum(c["dest"] for c in checks),
                "max_rows": max((c["n"] for c in checks), default=0),
                "max_abs_err": max((c["err"] for c in checks), default=0.0)}


def rank_sweep(torch, splat) -> dict:
    """K5 on random rungs at every N of RANK_SWEEP_N and C of RANK_SWEEP_C
    (with dest), on rows of no class and on one class holding every row at
    RANK_EDGE_C, and in cap mode (one class of a mask) at caps 0, 1, N/3
    and N: every output against the plain version or the stable sort."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(15)
    checks = []
    held = splat.rank_launches
    for n in RANK_SWEEP_N:
        for c in RANK_SWEEP_C:
            rung = torch.randint(-1, c, (n,), generator=gen, device="cuda",
                                 dtype=torch.int32)
            checks.append(check_rank(torch, splat, rung, c, with_dest=True))
        for c in RANK_EDGE_C:
            for fill in (-1, c - 1):
                rung = torch.full((n,), fill, dtype=torch.int32,
                                  device="cuda")
                checks.append(check_rank(torch, splat, rung, c,
                                         with_dest=True))
        keep = torch.rand(n, generator=gen, device="cuda") < 0.6
        for cap in sorted({0, 1, n // 3, n}):
            checks.append(check_rank(torch, splat, keep, 1, out_size=cap))
    splat.rank_launches = held
    return {"cases": len(checks),
            "against_sort": sum(c["against"] == "sort" for c in checks),
            "n": list(RANK_SWEEP_N), "classes": list(RANK_SWEEP_C),
            "edge_classes": list(RANK_EDGE_C),
            "max_abs_err": max(c["err"] for c in checks)}


def rank_bound_ms(n: int, n_classes: int, slots: int) -> tuple[float, str]:
    """K5's bound as ``compact_classes`` calls it: the i32 rung column read
    once, every perm slot, counts and offsets written once, at the HBM
    rate; or RANK_OPS_PER_ROW a row at the card's rate, whichever is
    larger."""
    return pass_bound_ms(4 * n + 4 * slots + 8 * n_classes,
                         RANK_OPS_PER_ROW * n)


def time_rank(torch, splat, rung, n_classes: int) -> dict:
    """K5 as ``compact_classes`` calls it, on a rung column K1 has just
    written (a warm L2, as in the frame): plain, kernel, kernel, plain
    (:func:`time_kernel`), each of its three kernels' device time
    (:func:`device_kernel_ms` a name), the bound, the library's stable
    ``torch.sort`` plus ``torch.bincount`` of the same classes (checked
    equal to K5's perm and counts first), and the device time by kernel
    of one call of the plain version (the torch ranking K5 replaced in
    the frame)."""
    def kernel_fn():
        return splat.class_rank(rung, n_classes)

    def plain_fn():
        return splat.class_rank_reference(rung, n_classes)

    held = splat.rank_launches
    t = time_kernel(torch, kernel_fn, plain_fn, RANK_KERNELS, plain_reps=5)
    plain_kernels = busy_share(torch, plain_fn, top=None)["top_device_ms"]
    by_kernel = {name: device_kernel_ms(torch, kernel_fn, {name: 1})
                 for name in RANK_KERNELS}
    perm, counts, _, _ = kernel_fn()
    splat.rank_launches = held
    cls = torch.where((rung >= 0) & (rung < n_classes), rung.long(),
                      n_classes)

    def library():
        return (torch.sort(cls, stable=True),
                torch.bincount(cls, minlength=n_classes + 1))

    (_, order), bins = library()
    kept = int(counts.sum())
    if not (torch.equal(order[:kept].to(torch.int32), perm[:kept])
            and torch.equal(bins[:n_classes].to(torch.int32), counts)):
        raise AssertionError("torch.sort + bincount != class_rank")
    n = rung.shape[0]
    bound, by = rank_bound_ms(n, n_classes, 2 * n)
    return {**t, "n": n, "classes": n_classes, "kept": kept,
            "ms_by_kernel": by_kernel, "bound_ms": bound, "bound_by": by,
            "library_ms": cuda_ms(library),
            "plain_kernels_ms": plain_kernels}


# --- K6, the LOD walk -------------------------------------------------------

LOD_KERNEL = "lod_select_kernel"
LOD_LEVELS = 12  # the indoor area's store (models.synth.LOD_LEVELS)
LOD_LOG_N = tuple(range(12, 19))  # the indoor orbit's padded bucket sizes
# one walking frame of the indoor orbit: 0.25-0.34 M rows in 5-7 buckets
LOD_FRAME_LOG_N = (18, 16, 15, 14, 13, 12)
# models.synth.LOD_CASES but "deep", and the card's "extreme"
LOD_EDGES = ("own_out_of_range", "gap", "empty_table", "padding", "extreme")
# a probe: three IEEE divides and floors, the four-round row hash, four
# row compares (~50 operations)
LOD_OPS_PER_PROBE = 50
LOD_BY_PATH: dict = {}  # K6's launches on each frame path


def lod_inputs(torch, kernel, n: int, case: str = "deep",
               seed: int = 0) -> tuple:
    """One bucket's LOD walk arguments on the card: ``models.synth``'s
    :func:`lod_case` (the tests' cases, shaped like the indoor orbit's
    buckets over LOD_LEVELS hierarchies) with its hash table built."""
    from point_cloud_tpu_torch.models.synth import lod_case

    positions, point_h, sizes, table, _ = lod_case(case, n, seed=seed)

    def dev(a):
        return torch.as_tensor(a, device="cuda").contiguous()

    return (dev(positions), dev(point_h), dev(sizes), LOD_LEVELS,
            dev(kernel.build_loaded_cells_hash(table)))


def lod_err(torch, kernel, args, got) -> int:
    """K6's result against the plain version's on the same arguments."""
    ref = kernel.lod_select_reference(*args)
    torch.cuda.synchronize()
    if got.dtype != torch.int32 or got.shape != ref.shape:
        raise AssertionError(f"lod_select gave {got.dtype} {tuple(got.shape)}")
    return int((got - ref).abs().max()) if got.numel() else 0


class LodCapture:
    """Wraps the renderer's K6 wrapper (``renderer.lod_select``) while it
    is installed and keeps each call's arguments and result, so that
    ``check`` holds every walk of the frame against the plain version."""

    def __init__(self, renderer_module):
        self.module, self.calls = renderer_module, []
        self.real = renderer_module.lod_select

    def __enter__(self):
        def wrap(*args):
            out = self.real(*args)
            self.calls.append((args, out))
            return out

        self.module.lod_select = wrap
        return self

    def __exit__(self, *exc):
        self.module.lod_select = self.real

    def check(self, torch, kernel) -> dict:
        errs = [lod_err(torch, kernel, args, out) for args, out in self.calls]
        if not errs or max(errs):
            raise AssertionError(f"the frame's K6 calls: errors {errs}")
        return {"calls": len(errs), "max_abs_err": max(errs),
                "rows": [args[0].shape[0] for args, _ in self.calls],
                "levels": self.calls[0][0][3]}


def lod_bound_ms(torch, args, result) -> tuple[float, str, int]:
    """K6's bound on one walk: 12 B of position and 4 B of hierarchy read
    and 4 B written a row, the cell sizes and the table read once, at the
    HBM rate; or LOD_OPS_PER_PROBE a probe the walk made (its hits, plus
    the miss that ended it short of the last level) at the card's rate,
    whichever is larger. Also returns the probes."""
    positions, hier, sizes, levels, table = args
    last = levels - 1
    base = hier.clamp(max=last).clamp(min=0)  # the walk starts past it
    hits = (result - base).clamp(min=0)
    probes = int((hits + ((result < last) & (base < last)).int()).sum())
    moved = 20 * positions.shape[0] + 4 * sizes.numel() + 4 * table.numel()
    bound, by = pass_bound_ms(moved, LOD_OPS_PER_PROBE * probes)
    return bound, by, probes


def phase_lod(torch, np) -> dict:
    """K6 against its plain version on the card at the indoor orbit's
    bucket sizes (deep, 2^12-2^18 rows) and on LOD_EDGES at 2^14, one
    launch a call; then plain, kernel, kernel, plain at every size from a
    flushed L2 (a landing finds its bucket cold), with the bound, and a
    walking frame's sum over LOD_FRAME_LOG_N."""
    from point_cloud_tpu_torch.render import kernel

    held = kernel.lod_launches
    errs = {}
    for log_n in LOD_LOG_N:
        args = lod_inputs(torch, kernel, 1 << log_n, seed=log_n)
        errs[f"deep_{log_n}"] = lod_err(torch, kernel, args,
                                        kernel.lod_select(*args))
    for case in LOD_EDGES:
        args = lod_inputs(torch, kernel, 1 << 14, case, seed=99)
        errs[case] = lod_err(torch, kernel, args, kernel.lod_select(*args))
    if kernel.lod_launches != held + len(errs):
        raise AssertionError(f"K6 launched {kernel.lod_launches - held} "
                             f"times for {len(errs)} calls")
    if max(errs.values()):
        raise AssertionError(f"lod_select != plain: {errs}")
    flush = l2_flush(torch)
    by_n = {}
    for log_n in LOD_LOG_N:
        n = 1 << log_n
        args = lod_inputs(torch, kernel, n, seed=log_n)
        result = kernel.lod_select(*args)
        t = time_kernel(torch, lambda: kernel.lod_select(*args),
                        lambda: kernel.lod_select_reference(*args),
                        LOD_KERNEL, plain_reps=3, setup=flush)
        bound, by, probes = lod_bound_ms(torch, args, result)
        by_n[n] = {**t, "bound_ms": bound, "bound_by": by, "probes": probes,
                   "row_levels": n * (LOD_LEVELS - 1),
                   "table_buckets": args[4].shape[0]}
    kernel.lod_launches = held
    frame_ns = [1 << log_n for log_n in LOD_FRAME_LOG_N]
    result = {"phase": "lod", "ok": True, "levels": LOD_LEVELS,
              "max_abs_err": max(errs.values()), "checked": sorted(errs),
              "by_n": by_n,
              "walking_frame": {
                  "rows": sum(frame_ns),
                  **{k: sum(by_n[n][k] for n in frame_ns)
                     for k in ("ms", "wrapper_ms", "plain_ms", "bound_ms")}}}
    emit(result)
    return result


def lod_kernel_entry(lod: dict, frame_check: dict) -> dict:
    """K6's entry of the kernels line: timed at the orbit's largest
    bucket, 2^18 rows over twelve hierarchies; launched by the orbit."""
    top = lod["by_n"][1 << max(LOD_LOG_N)]
    return {
        "name": "lod_select", "route": "cuda",
        "source": "point_cloud_tpu_torch/csrc/lod_select.cu",
        "replaces": "point_cloud_tpu/render/kernel.py:172-196",
        "also_replaces": ["point_cloud_tpu/render/kernel.py:126-136"],
        "launches": LOD_BY_PATH["orbit"],
        "max_abs_err": max(lod["max_abs_err"], frame_check["max_abs_err"]),
        **{k: top[k] for k in ("ms", "wrapper_ms", "plain_ms", "bound_ms",
                               "bound_by", "ms_runs", "plain_ms_runs")},
        "bound_memory": "HBM", "timed_from": "a flushed L2",
        # no one PyTorch call walks a row's levels with an early exit
        "library_ms": None,
        "launches_by_path": dict(LOD_BY_PATH),
        "n": 1 << max(LOD_LOG_N), "levels": lod["levels"],
        "by_n": lod["by_n"], "walking_frame": lod["walking_frame"],
        "frame_check": frame_check,
        "unit": "one walk of a bucket (one launch); bound: 20 B a row, the "
                "table once",
    }


def busy_share(torch, fn, top: int | None = 8) -> dict:
    """Run ``fn`` once under torch.profiler: the device time of its
    kernels and copies over the host wall time of the call, and the
    ``top`` largest device times by name (every name when None)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_kernel = [], {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            by_kernel[e.name] = (by_kernel.get(e.name, 0.0)
                                 + e.time_range.elapsed_us() / 1e3)
    device_us, reach = 0.0, None  # the union of the device spans
    for lo, hi in sorted(spans):
        if reach is None or lo > reach:
            device_us += hi - lo
            reach = hi
        elif hi > reach:
            device_us += hi - reach
            reach = hi
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:top]
    return {"wall_ms": wall_ms, "device_ms": device_us / 1e3,
            "busy_share": device_us / 1e3 / wall_ms if device_us else None,
            "top_device_ms": dict(top)}


def host_profile(fn, top: int = 14) -> dict:
    """Run ``fn`` once under cProfile: the host functions with the most
    cumulative time, in ms."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    fn()
    prof.disable()
    stats = pstats.Stats(prof).stats
    rows = sorted(((v[3], f"{k[0].rsplit('/', 1)[-1]}:{k[1]}({k[2]})")
                   for k, v in stats.items()), reverse=True)[:top]
    return {name: cum * 1e3 for cum, name in rows}


def phase_frame(torch, np, store: Path, tmp: Path) -> dict:
    from point_cloud_tpu_torch.render import kernel, splat
    from point_cloud_tpu_torch.render import renderer as renderer_module
    from point_cloud_tpu_torch.render.renderer import (
        PointRenderer, RenderSettings,
    )
    from point_cloud_tpu_torch.viewer import Viewer
    from point_cloud_tpu_torch.viewer.offscreen import render_orbit

    t_phase = time.perf_counter()
    viewer = Viewer(RenderSettings(width=FRAME_W, height=FRAME_H),
                    device="cuda")
    viewer.load_metadata(store / "metadata.json")
    settle(viewer)
    load_s = time.perf_counter() - t_phase

    # 5a: capture every bucket's inputs from one frame, then hold the
    # kernels against their plain versions on them
    captured = []
    bucket_pass = splat.render_bucket_pass

    def capture(framebuffer, *args, **kw):
        captured.append((framebuffer.packed.clone(), args, kw))
        return bucket_pass(framebuffer, *args, **kw)

    ranks = RankCapture(splat)  # K5's calls of the frame and the buckets
    lods = LodCapture(renderer_module)  # the first frame walks every bucket
    splat.render_bucket_pass = capture
    try:
        with ranks, lods:
            rgb_gpu, depth_gpu, stats_gpu = viewer.render()
    finally:
        splat.render_bucket_pass = bucket_pass
    lod_check = lods.check(torch, kernel)
    if not captured:
        raise AssertionError("the frame rendered no bucket")
    frame_ranks = ranks.check(torch)
    if frame_ranks["calls"] != len(captured):
        raise AssertionError(f"{frame_ranks['calls']} K5 calls for "
                             f"{len(captured)} buckets")
    buckets = [check_bucket(torch, splat, kernel, *entry) for entry in captured]
    synth_args, synth_kw = synth_bucket(torch, np, {**captured[0][2],
                                                   "thresholds": captured[0][1][-1]})
    synth_fb = splat.make_framebuffer(FRAME_H, FRAME_W, "cuda").packed
    with ranks:
        synth = check_bucket(torch, splat, kernel, synth_fb, synth_args,
                             synth_kw)
    rungs = (tuple(synth_kw["sub_ks"]) + (synth_kw["footprint"],)
             + tuple(synth_kw["overflow_ks"]))
    n_synth = synth["n"]
    for k in SYNTH_BANDS:
        rows = synth["rung_counts"][rungs.index(k)]
        cap = splat.rung_chunk_rows(k, n_synth) * splat.RUNG_CAP_CHUNKS
        if rows == 0 or (k in (33, 65) and rows <= cap):
            raise AssertionError(f"the synthetic bucket missed rung {k}: "
                                 f"{rows} rows, cap {cap}")
    with ranks:
        synth_inp = raster_inputs(splat, kernel, synth_fb, synth_args,
                                  synth_kw)
        edge_inputs = [edge_bucket(torch, splat, synth_inp, name)
                       for name in EDGE_BUCKETS]
    edges = [check_edge_bucket(torch, splat, inp, name)
             for inp, name in zip(edge_inputs, EDGE_BUCKETS)]
    # K5 on the synthetic and edge buckets' rankings, then the sweep
    rank_checks = {"frame": frame_ranks, "synthetic_and_edges":
                   ranks.check(torch), "sweep": rank_sweep(torch, splat)}
    emit({"phase": "frame_kernels", "ok": True, "exact": True,
          "buckets": buckets, "synthetic": synth, "edge_buckets": edges,
          "class_rank": rank_checks})

    # 5b: the same frame on the CPU, through the plain versions
    t0 = time.perf_counter()
    cpu = PointRenderer(viewer.metadata, RenderSettings(
        width=FRAME_W, height=FRAME_H), device="cpu")
    rgb_cpu, depth_cpu, stats_cpu = cpu.render(
        viewer.streamer, viewer.camera, viewer._frustums)
    cpu_s = time.perf_counter() - t0
    ids_gpu = viewer.renderer.framebuffer.point_id.cpu()
    if not np.array_equal(rgb_gpu, rgb_cpu):
        raise AssertionError("frame rgb: cuda != cpu")
    if not torch.equal(ids_gpu, cpu.framebuffer.point_id):
        raise AssertionError("frame ids: cuda != cpu")
    if not np.array_equal(depth_gpu, depth_cpu):  # by value: +-0 agree
        raise AssertionError("frame depth: cuda != cpu")
    if stats_gpu["points_visible"] != stats_cpu["points_visible"]:
        raise AssertionError("frame visible points: cuda != cpu")
    lit = int((ids_gpu != int(splat._NO_ID)).sum())
    if stats_gpu["points_visible"] <= 0 or lit == 0:
        raise AssertionError("the frame shows no point")
    emit({"phase": "frame_cpu", "ok": True, "identical": True,
          "points_visible": stats_gpu["points_visible"], "lit_pixels": lit,
          "cpu_frame_s": cpu_s})

    # kernel times at the main path's shapes, the frame's largest bucket:
    # plain, kernel, kernel, plain on one card
    big = max(captured, key=lambda e: e[1][0].shape[0])
    cargs, ckw = cull_inputs(splat, kernel, *big)
    cull_t = time_kernel(
        torch, lambda: kernel.cull_classify(*cargs, **ckw),
        lambda: kernel.cull_classify_reference(*cargs, **ckw),
        "cull_classify_kernel", plain_reps=3, setup=l2_flush(torch))
    inp = raster_inputs(splat, kernel, *big)
    fb_big = big[0].clone()
    raster_t = time_kernel(
        torch, lambda: run_rungs(splat, fb_big, inp, None),
        lambda: run_rungs(splat, fb_big, inp, splat.splat_raster_reference),
        "splat_raster_kernel", plain_reps=2,
        setup=lambda: fb_big.copy_(big[0]))
    rank_t = time_rank(torch, splat, kernel.cull_classify(*cargs, **ckw)[6],
                       len(inp["rungs"]))
    # the large windows' time: the synthetic bucket, each run from its own
    # plane
    fb_synth = synth_fb.clone()
    synth_ms = device_kernel_ms(
        torch, lambda: (fb_synth.copy_(synth_fb),
                        run_rungs(splat, fb_synth, synth_inp, None)),
        {"splat_raster_kernel": 1})
    frags, touched = lit_fragments(torch, splat, inp)
    tested = tested_fragments(splat, inp)
    clock_mhz = sm_clock_under_load(
        torch, lambda: run_rungs(splat, fb_big, inp, None))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n_big = int(big[1][0].shape[0])
    # the points K1's occlusion tests read the depth for: valid, inside
    # the NDC box
    ndc = inp["ndc"]
    inside = int(((ndc[:, 0].abs() <= 1.0) & (ndc[:, 1].abs() <= 1.0)
                  & ((ndc[:, 2] - 0.5).abs() <= 0.5) & big[1][2]).sum())
    coarse_cells = (-(-FRAME_H // kernel.PYRAMID_TILE)
                    * -(-FRAME_W // kernel.PYRAMID_TILE))

    # 5c: the orbit, the main path's run: every count starts at 0 here
    kernel.launches = kernel.lod_launches = 0
    splat.launches = splat.rank_launches = 0
    times = []
    render = viewer.render

    def timed_render():
        t0 = time.perf_counter()
        out = render()
        times.append((time.perf_counter() - t0) * 1e3)
        return out

    viewer.render = timed_render
    try:
        paths = render_orbit(viewer, tmp / "orbit", n_frames=ORBIT_FRAMES)
    finally:
        viewer.render = render
    launches = {"cull_classify": kernel.launches,
                "splat_raster": splat.launches,
                "class_rank": splat.rank_launches}
    LOD_BY_PATH["orbit"] = kernel.lod_launches
    if len(paths) != ORBIT_FRAMES or min(launches.values()) <= 0:
        raise AssertionError(f"the orbit did not run its kernels: {launches}")
    if kernel.lod_launches <= 0:  # its loaded set changes, so it walks
        raise AssertionError("the orbit launched no LOD walk (K6)")
    if launches["splat_raster"] != launches["cull_classify"]:
        raise AssertionError(f"not one raster launch a bucket: {launches}")
    frame = render()
    if frame[0].shape != (FRAME_H, FRAME_W, 3) or frame[0].dtype != np.uint8:
        raise AssertionError("orbit frame shape")
    if not np.isfinite(frame[1]).all() or frame[2]["points_visible"] <= 0:
        raise AssertionError("orbit frame: non-finite depth or nothing visible")

    # render_pipelined at the last orbit camera: steady frames
    viewer.render_pipelined()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = 0
    for _ in range(ORBIT_FRAMES):
        done += viewer.render_pipelined() is not None
    done += viewer.render_flush() is not None
    pipelined_ms = (time.perf_counter() - t0) * 1e3 / done
    # one frame's profile: none of the torch ranking's kernels (cub's scan,
    # the scatter), and K5's three (taken again, up to PROFILE_TRIES
    # times, if the profiler dropped one of them)
    for _ in range(PROFILE_TRIES):
        profiled = busy_share(torch, render, top=None)
        by_name = profiled["top_device_ms"]
        forbidden = [k for k in by_name
                     if any(f in k for f in RANK_FORBIDDEN)
                     and not any(r in k for r in RANK_KERNELS)]
        if forbidden:
            raise AssertionError(f"the frame's profile holds {forbidden}")
        rank_seen = {name: sum(ms for k, ms in by_name.items() if name in k)
                     for name in RANK_KERNELS}
        if all(rank_seen.values()):
            break
    else:
        raise AssertionError(f"the frame's profile lacks K5: {rank_seen}")
    profiled.update(top_device_ms=dict(list(by_name.items())[:8]),
                    kernels_seen=len(by_name), class_rank_ms=rank_seen,
                    kernel_names=sorted(by_name))
    profiled["host_cumulative_ms"] = host_profile(render)
    result = {
        "phase": "frame", "ok": True, "width": FRAME_W, "height": FRAME_H,
        "frames": ORBIT_FRAMES, "render_ms": times,
        "render_ms_median_after_first": statistics.median(times[1:]),
        "render_pipelined_ms": pipelined_ms,
        "points_loaded": viewer.streamer.stats().loaded_points,
        "points_in": frame[2]["points_in"],
        "points_visible": frame[2]["points_visible"],
        "buckets_per_frame": frame[2]["buckets"],
        "launches": launches,
        "launches_per_frame": {k: v / ORBIT_FRAMES for k, v in launches.items()},
        "profiled_frame": profiled, "load_s": load_s,
        "phase_s": time.perf_counter() - t_phase,
    }
    emit(result)
    checked = buckets + [synth] + edges
    bytes_ms = raster_bound_ms(inp["kept"], touched)
    instr_ms = raster_instr_bound_ms(tested, frags, sms, clock_mhz)
    return {
        "frame": result,
        "lod": lod_check,
        "rank": {**rank_t, "checks": rank_checks},
        "cull": {**cull_t, "n": n_big, "inside": inside,
                 "max_abs_err": max(b["cull_err"] for b in buckets + [synth]),
                 "bound_ms": cull_bound_ms(
                     n_big, inside, big[2]["use_occlusion"],
                     big[2]["use_pyramid"], FRAME_H * FRAME_W, coarse_cells)},
        "raster": {**raster_t, "n": n_big, "rows": inp["kept"],
                   "fragments": frags, "touched_pixels": touched,
                   "tested_fragments": tested, "sms": sms,
                   "synthetic_ms": synth_ms,
                   "synthetic_tested_fragments": tested_fragments(
                       splat, synth_inp),
                   "sm_clock_mhz_under_load": clock_mhz,
                   "max_abs_err": max(b["raster_err"] for b in checked),
                   "bytes_bound_ms": bytes_ms, "instr_bound_ms": instr_ms,
                   "bound_ms": max(bytes_ms, instr_ms),
                   "bound_by": ("bytes" if bytes_ms >= instr_ms
                                else "operations")},
    }


# --- phase 6: the store server ----------------------------------------------

SERVE_W, SERVE_H = 640, 480  # the server's defaults
SERVE_POSES = ("yaw=0.5&pitch=-0.4", "yaw=2.1&pitch=-0.5",
               "yaw=3.6&pitch=-0.3", "yaw=5.2&pitch=-0.6")
TIMED_RENDERS = 8
CONVERT_POINTS = 1 << 18
WINDOW_FRAMES = 8
HTTP_TIMEOUT_S = 600


def http(url: str, payload=None):
    """(status, headers, body) of a GET, or of a POST of ``payload`` as
    JSON; an error status raises."""
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data,
                                 method="GET" if data is None else "POST")
    with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT_S) as resp:
        return resp.status, resp.headers, resp.read()


def http_json(url: str, payload=None):
    status, _, body = http(url, payload)
    if status != 200:
        raise AssertionError(f"{url}: HTTP {status}")
    return json.loads(body)


def png_pixels(np, data: bytes):
    """(H, W, 3) u8 pixels of a PNG written by viewer/offscreen.write_png
    (8-bit RGB, filter 0 on every row)."""
    import struct
    import zlib

    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError("not a PNG")
    pos, idat, size = 8, b"", None
    while pos < len(data):
        length = struct.unpack(">I", data[pos:pos + 4])[0]
        tag, chunk = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            size = struct.unpack(">II", chunk[:8])
        elif tag == b"IDAT":
            idat += chunk
        pos += 12 + length
    w, h = size
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 3 * w + 1)
    return rows[:, 1:].reshape(h, w, 3)


def lit_pixels(np, png: bytes) -> int:
    """Pixels of a SERVE_W x SERVE_H frame that differ from its corner."""
    rgb = png_pixels(np, png)
    if rgb.shape != (SERVE_H, SERVE_W, 3):
        raise AssertionError(f"frame of shape {rgb.shape}")
    return int((rgb != rgb[0, 0]).any(axis=2).sum())


class StubBackend:
    """A window back end without a display: scripted event batches in,
    blitted frames counted."""

    def __init__(self, batches):
        self.batches = list(batches)
        self.blits = []
        self.alive = True

    def poll_events(self):
        return self.batches.pop(0) if self.batches else []

    def blit(self, rgb):
        self.blits.append(rgb.shape)

    def set_title(self, title):
        pass

    def close(self):
        self.alive = False


def phase_window(torch, np, store: Path) -> dict:
    """WindowLoop on the card for WINDOW_FRAMES frames, W held and the
    voronoi hotkey pressed: every frame blits, the camera moves, the
    toggle lands. Counts the frame kernels' launches from zero."""
    from point_cloud_tpu_torch.render import kernel, splat
    from point_cloud_tpu_torch.render.renderer import RenderSettings
    from point_cloud_tpu_torch.viewer import Viewer
    from point_cloud_tpu_torch.viewer.window import WindowEvent, WindowLoop

    viewer = Viewer(RenderSettings(width=SERVE_W, height=SERVE_H),
                    device="cuda")
    try:
        viewer.load_metadata(store / "metadata.json")
        settle(viewer)
        start = np.array(viewer.camera.transform.translation)
        backend = StubBackend([[WindowEvent("key_down", key="w"),
                                WindowEvent("key_down", key="v"),
                                WindowEvent("key_up", key="v")]])
        kernel.launches = kernel.lod_launches = 0
        splat.launches = splat.rank_launches = 0
        t0 = time.perf_counter()
        frames = WindowLoop(viewer, backend).run(max_frames=WINDOW_FRAMES)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        launches = {"cull_classify": kernel.launches,
                    "splat_raster": splat.launches,
                    "class_rank": splat.rank_launches}
        LOD_BY_PATH["window"] = kernel.lod_launches
        moved = float(np.linalg.norm(
            np.array(viewer.camera.transform.translation) - start))
        voronoi = viewer.settings.voronoi
    finally:
        viewer.close()
    if frames != WINDOW_FRAMES or len(backend.blits) != WINDOW_FRAMES:
        raise AssertionError(f"{frames} frames, {len(backend.blits)} blits")
    if set(backend.blits) != {(SERVE_H, SERVE_W, 3)}:
        raise AssertionError(f"blits of shapes {set(backend.blits)}")
    if voronoi or moved <= 0.0 or min(launches.values()) <= 0:
        raise AssertionError(f"window loop: voronoi {voronoi}, moved {moved},"
                             f" launches {launches}")
    return {"frames": frames, "blits": len(backend.blits), "loop_s": loop_s,
            "camera_moved": moved, "launches": launches}


def phase_serve(torch, np, store: Path, tmp: Path, smi: str,
                clock_mhz: float) -> dict:
    import threading

    from point_cloud_tpu_torch.core.point import PointBatch
    from point_cloud_tpu_torch.io.ply import write_ply
    from point_cloud_tpu_torch.models.synth import synth_cloud
    from point_cloud_tpu_torch.render import kernel, splat
    from point_cloud_tpu_torch.serve import StoreServer, serve
    from point_cloud_tpu_torch.validate import validate_store

    t_phase = time.perf_counter()
    root = tmp / "convert_root"
    root.mkdir()
    rng = np.random.default_rng(6)
    write_ply(root / "cloud.ply", PointBatch(
        synth_cloud(CONVERT_POINTS, seed=5),
        rng.integers(0, 256, (CONVERT_POINTS, 4), dtype=np.uint8)))
    meta_bytes = (store / "metadata.json").read_bytes()
    n_points = json.loads(meta_bytes)["number_of_points"]
    cell = sorted((store / "h_0").iterdir())[0]

    fp1 = KernelCapture(kernel, splat)
    # the main path's run: every count starts at 0 here
    kernel.launches = kernel.lod_launches = 0
    splat.launches = splat.rank_launches = 0
    httpd = serve(store, host="127.0.0.1", port=0, convert_root=root)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        stats = http_json(f"{url}/stats")
        settings = http_json(f"{url}/settings")
        if (stats["number_of_points"] != n_points
                or (settings["footprint"], settings["voronoi"]) != (5, True)):
            raise AssertionError(f"stats {stats}, settings {settings}")
        if (http(f"{url}/metadata.json")[2] != meta_bytes
                or http(f"{url}/h_0/{cell.name}")[2] != cell.read_bytes()):
            raise AssertionError("a static file differs from the store's")
        # the fly pose: from inside the cloud's box, towards its centre
        center, d = np.array(stats["center"]), stats["auto_distance"]
        eye = center + np.array([0.25, -0.2, 0.1]) * d
        look = center - eye
        fly = (f"px={eye[0]}&py={eye[1]}&pz={eye[2]}"
               f"&yaw={math.atan2(look[1], look[0])}"
               f"&pitch={math.asin(look[2] / np.linalg.norm(look))}")
        queries = list(SERVE_POSES) + [fly]
        pngs = [http(f"{url}/render?{q}")[2] for q in queries]
        lit = [lit_pixels(np, png) for png in pngs]
        if min(lit) < 1000:
            raise AssertionError(f"frames with few lit pixels: {lit}")
        # timed: what a client waits for a frame, through HTTP
        warm = http(f"{url}/render?{SERVE_POSES[0]}")[2]
        render_ms = []
        for _ in range(TIMED_RENDERS):
            t0 = time.perf_counter()
            if http(f"{url}/render?{SERVE_POSES[0]}")[2] != warm:
                raise AssertionError("one pose rendered two frames")
            render_ms.append((time.perf_counter() - t0) * 1e3)
        # one request's work without HTTP: the device's share of it and
        # the host's top functions
        server = httpd.registry.get(httpd.registry.default)
        profiled = busy_share(torch, lambda: server.render_png(yaw=0.5,
                                                               pitch=-0.4))
        profiled["host_cumulative_ms"] = host_profile(
            lambda: server.render_png(yaw=0.5, pitch=-0.4))
        points_loaded = server.viewer.stats()["points"]["loaded"]
        # footprint 1 (the multi-dispatch arm: K1, then K2 on the kept
        # rows, a bucket), its K1 and K2 calls captured
        if http_json(f"{url}/settings", {"footprint": 1})["footprint"] != 1:
            raise AssertionError("footprint 1 not applied")
        with fp1:
            png_fp1 = http(f"{url}/render?{SERVE_POSES[0]}")[2]
        http_json(f"{url}/settings", {"footprint": 5})
        lit_fp1 = lit_pixels(np, png_fp1)
        if (not fp1.rasters or len(fp1.culls) != len(fp1.rasters)
                or not 0 < lit_fp1 < lit[0]):
            raise AssertionError(f"footprint 1: {len(fp1.culls)} K1 and "
                                 f"{len(fp1.rasters)} K2 calls, {lit_fp1} "
                                 f"lit pixels against {lit[0]}")
        # export of the served store
        t0 = time.perf_counter()
        status, headers, body = http(f"{url}/export?format=ply")
        export_s = time.perf_counter() - t0
        head = body[:body.index(b"end_header\n")].decode()
        vertices = int(head.split("element vertex ")[1].split()[0])
        if status != 200 or vertices != n_points or len(body) != (
                len(head) + len("end_header\n") + 16 * n_points):
            raise AssertionError(f"export: HTTP {status}, {vertices} "
                                 f"vertices, {len(body)} bytes")
        # the in-app converter over HTTP
        t0 = time.perf_counter()
        for action in ({"action": "new_cloud"},
                       {"action": "choose", "files": ["cloud.ply"]},
                       {"action": "save_at", "directory": "converted"},
                       {"action": "start"}):
            http_json(f"{url}/convert", action)
        while True:
            status_json = http_json(f"{url}/convert")
            if status_json["state"] == "finished":
                break
            if time.perf_counter() - t0 > HTTP_TIMEOUT_S:
                raise AssertionError(f"conversion stuck: {status_json}")
            time.sleep(0.05)
        for pump in [t for t in threading.enumerate()
                     if t.name == "pct-convert-pump"]:
            pump.join(timeout=HTTP_TIMEOUT_S)  # the pump's last flush
            if pump.is_alive():
                raise AssertionError("the converter's pump did not end")
        convert_s = time.perf_counter() - t0
        launches = {"cull_classify": kernel.launches,
                    "splat_raster": splat.launches,
                    "class_rank": splat.rank_launches}
        LOD_BY_PATH["serve"] = kernel.lod_launches
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    if min(launches.values()) <= 0 or (
            launches["splat_raster"] != launches["cull_classify"]):
        raise AssertionError(f"the server did not run its kernels: {launches}")
    report = validate_store(root / "converted")
    if report.issues or report.points + report.overflow_points != (
            CONVERT_POINTS) or json.loads((root / "converted" / "metadata.json")
                                          .read_text())["number_of_points"] != (
            CONVERT_POINTS):
        raise AssertionError(f"converted store: {report.issues[:5]}, "
                             f"{report.points} + {report.overflow_points}")

    # the same requests to the port's server on the CPU: the same PNGs
    t0 = time.perf_counter()
    cpu = StoreServer(store, device="cpu")
    try:
        for q, png in zip(queries, pngs):
            args = {k: float(v) for k, v in
                    (kv.split("=") for kv in q.split("&"))}
            eye_arg = ([args.pop("px"), args.pop("py"), args.pop("pz")]
                       if "px" in args else None)
            if cpu.render_png(eye=eye_arg, **args) != png:
                raise AssertionError(f"/render?{q}: cuda PNG != cpu PNG")
        # the card's last frame before footprint 1: the multi-dispatch
        # arm sizes its budgets from the frame before
        cpu.render_png(yaw=0.5, pitch=-0.4)
        cpu.apply_settings({"footprint": 1})
        if cpu.render_png(yaw=0.5, pitch=-0.4) != png_fp1:
            raise AssertionError("footprint 1: cuda PNG != cpu PNG")
    finally:
        cpu.viewer.close()
    cpu_s = time.perf_counter() - t0

    # K1 and K2 against their plain versions on every footprint-1 bucket
    fp1_check = fp1.check(torch)
    big = max(fp1.rasters, key=lambda e: call_rows(splat, e[1]))
    fb_big = big[0].clone()
    fp1_ms = device_kernel_ms(
        torch, lambda: (fb_big.copy_(big[0]), fp1.real[1](fb_big, *big[1])),
        {"splat_raster_kernel": 1})
    frags, touched = call_lit_fragments(torch, splat, big[1])
    rows = call_rows(splat, big[1])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    fp1_bound = {
        "rows": rows, "fragments": frags, "touched_pixels": touched,
        "bytes_bound_ms": raster_bound_ms(rows, touched),
        "instr_bound_ms": raster_instr_bound_ms(
            call_tested_fragments(splat, big[1]), frags, sms, clock_mhz)}
    window = phase_window(torch, np, store)
    result = {
        "phase": "serve", "ok": True, "nvidia_smi": smi,
        "width": SERVE_W, "height": SERVE_H, "points": n_points,
        "poses": queries, "lit_pixels": lit, "cpu_png_identical": True,
        "render_ms": render_ms,
        "render_ms_median": statistics.median(render_ms),
        "render_ms_min": min(render_ms), "render_ms_max": max(render_ms),
        "points_loaded": points_loaded, "profiled_render": profiled,
        "footprint1": {"lit_pixels": lit_fp1, **fp1_check,
                       "largest_bucket_k2_ms": fp1_ms, **fp1_bound},
        "export_s": export_s, "export_vertices": vertices,
        "convert_s": convert_s, "convert_points": CONVERT_POINTS,
        "converted_cells": report.cells, "launches": launches,
        "window": window, "cpu_s": cpu_s,
        "phase_s": time.perf_counter() - t_phase,
    }
    emit(result)
    print(f"serve /render {SERVE_W}x{SERVE_H} over HTTP: median "
          f"{result['render_ms_median']:.1f} ms (min {min(render_ms):.1f}, "
          f"max {max(render_ms):.1f}, {TIMED_RENDERS} requests) on {smi}",
          flush=True)
    return result


# --- phase 7: the render arms -------------------------------------------------

ARM_FRAMES = 4
ARM_YAW, ARM_PITCH = 0.5, -0.4  # the first orbit pose of phase 6
# name: the arm's settings. Each renders ARM_FRAMES frames at one pose;
# frames 2 and later take the classed, sorted and budget paths
ARMS = {
    "multi_dispatch": dict(megakernel=False),
    "classing_true": dict(megakernel=False, classing=True),
    "classing_false": dict(megakernel=False, classing=False),
    "cascade": dict(megakernel=False, fused_compaction=False),
    "no_compaction": dict(compact_raster=False),
    "budget": dict(chunked_raster=False),
    "fusion": dict(frame_fusion=True),
    "sorted": dict(raster_mode="sorted"),
    "sorted_classing_true": dict(raster_mode="sorted", classing=True),
}
# the sorted arms: "auto" sorts the buckets where a splat overflows the
# footprint, classing on sorts every bucket with kept rows
SORTED_ARMS = ("sorted", "sorted_classing_true")
# The arms fall into three groups whose steady frames (frame 4) are equal
# within a group (the reference's image identities): the chunked
# megakernel's, whose overflow rungs draw at most their caps of rows and
# the rest clipped through the footprint window (the default arm, and
# frame fusion); the ladders with no cap (the multi-dispatch arms, the
# budget megakernel, the sorted raster), which draw every row of a rung
# through its own window; and the arms that draw every kept row through
# the footprint window. The first two agree when no rung passes its cap,
# all three when no splat is wider than the footprint.
ARM_GROUPS = {
    "default": ("fusion",),
    "multi_dispatch": ("classing_true", "cascade", "budget", "sorted",
                       "sorted_classing_true"),
    "classing_false": ("no_compaction",),
}
# arms equal to another arm on every frame, the first (no history) too
EVERY_FRAME = {"fusion": "default", "sorted": "multi_dispatch",
               "sorted_classing_true": "classing_true"}
# f32 operations a fragment of K3 does (two subtracts, two divides, two
# multiplies and an add for |p|^2, the circle and screen tests; the
# voronoi depth's subtract, multiply, add, multiply, add and divide)
K3_OPS_PER_FRAGMENT = 20


def arm_pose(viewer) -> None:
    """The camera of phase 6's first pose (yaw ARM_YAW, pitch ARM_PITCH,
    twice the cloud's extent from its centre), streamed in."""
    import numpy as np

    from point_cloud_tpu_torch.render.fly_cam import FlyCam

    bbox = viewer.metadata.bounding_box
    center = bbox.center()
    d = float(np.linalg.norm(bbox.extends())) * 2.0
    pos = center + np.array([
        d * np.cos(ARM_YAW) * np.cos(ARM_PITCH),
        d * np.sin(ARM_YAW) * np.cos(ARM_PITCH),
        -d * np.sin(ARM_PITCH)], np.float32)
    viewer.camera.transform.translation = pos.astype(np.float32)
    viewer.camera.transform.look_at(center,
                                    np.array([0.0, 0.0, 1.0], np.float32))
    viewer.fly_cam = FlyCam.from_transform(viewer.camera.transform)
    viewer._camera_dirty = True
    settle(viewer)


class SortedCapture:
    """Wraps the sorted raster's three stages in ``splat`` while it is
    installed: every bucket's K3 arguments and columns, the sorted columns
    and the plane before the merge, kept for the checks after the run.
    The wrappers count nothing of the kernels: the kernels' own wrappers
    do."""

    def __init__(self, splat):
        self.splat = splat
        self.real = (splat.emit_fragment_columns, splat._sort4_frags,
                     splat.sorted_merge)
        self.buckets = []

    def __enter__(self):
        emit, sort_frags, merge = self.real

        def emit_wrap(*args):
            cols = emit(*args)
            self.buckets.append({"args": args, "cols": cols})
            return cols

        def sort_wrap(*cols):
            out = sort_frags(*cols)
            self.buckets[-1]["sorted"] = out
            return out

        def merge_wrap(fb, pix, bits, ids):
            self.buckets[-1]["fb_in"] = fb.clone()
            out = merge(fb, pix, bits, ids)
            self.buckets[-1]["fb_out"] = fb.clone()
            return out

        (self.splat.emit_fragment_columns, self.splat._sort4_frags,
         self.splat.sorted_merge) = emit_wrap, sort_wrap, merge_wrap
        return self

    def __exit__(self, *exc):
        (self.splat.emit_fragment_columns, self.splat._sort4_frags,
         self.splat.sorted_merge) = self.real


def capped_rungs(renderer, scene) -> list:
    """[bucket, k, rows, cap] for each overflow rung of ``renderer``'s
    last frame whose landed rows passed the chunked megakernel's cap
    (splat.rung_chunk_rows(k, n) * RUNG_CAP_CHUNKS, n the bucket's padded
    rows)."""
    from point_cloud_tpu_torch.render import splat

    cells = renderer.gather_points(scene[0], scene[1])
    fp = renderer.settings.footprint
    out = []
    for bucket in sorted({c[0] for c in cells}):
        n = renderer._bucket_device_arrays(
            [c for c in cells if c[0] == bucket])[0].shape[0]
        for k in renderer._overflow_ladder():
            rows = renderer._survivor_counts.get((bucket, k), 0)
            cap = splat.rung_chunk_rows(k, n) * splat.RUNG_CAP_CHUNKS
            if k > fp and rows > cap:
                out.append([bucket, k, rows, cap])
    return out


def frame_planes(renderer, out) -> tuple:
    rgb, depth, stats = out
    return rgb, depth, renderer.framebuffer.point_id.cpu(), stats


def same_frame(np, torch, a, b) -> bool:
    """rgb and ids identical, depth equal by value (+-0 agree)."""
    return (np.array_equal(a[0], b[0]) and torch.equal(a[2], b[2])
            and np.array_equal(a[1], b[1])
            and a[3]["points_visible"] == b[3]["points_visible"])


def fragments_bound_ms(length: int, rows: int, fragments: int):
    """Least time for K3 on one bucket: bytes at the HBM rate (each of
    the ``length`` slots written once, 16 B; each of the ``rows`` drawn
    rows read once, 28 B: its perm entry, view_pos.z, ndc, radius and id)
    against K3_OPS_PER_FRAGMENT f32 operations for each of the
    ``fragments`` slots of drawn rows at the f32 peak; the larger and
    which it is."""
    bytes_ms = (16 * length + 28 * rows) / HBM_BYTES_PER_S * 1e3
    ops_ms = K3_OPS_PER_FRAGMENT * fragments / PEAK_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                          "operations")


def merge_bound_ms(valid: int, n: int, winners: int):
    """Least time for K4 on ``n`` sorted rows whose first ``valid`` are not
    ``_NO_ID``: bytes at the HBM rate (the pixel column read once up to
    the row that starts the tail, 4 B a row; a winner's depth bits and id,
    8 B, and its framebuffer word read and written, 16 B) against two
    integer compares a row read at the f32 peak; the larger and which it
    is. No row of the tail can win, so the work needs none of it."""
    rows = min(valid + 1, n)
    bytes_ms = (4 * rows + 24 * winners) / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * rows / PEAK_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                          "operations")


DENSE_MERGE_ROWS = 1 << 26  # the sorted arm's largest fragment length


def run_starts(torch, pix):
    """Where a sorted pixel column starts a run."""
    first = torch.ones_like(pix, dtype=torch.bool)
    first[1:] = pix[1:] != pix[:-1]
    return first


def dense_merge_list(torch, np, splat):
    """K4's dense list: DENSE_MERGE_ROWS fragment rows at random pixels
    over the frame (seed 0), none ``_NO_ID``, ordered by ``sort4``, so
    nearly every pixel wins and the whole pixel column is needed."""
    rng = np.random.default_rng(0)
    n = DENSE_MERGE_ROWS
    cols = (rng.integers(0, FRAME_W * FRAME_H, n).astype(np.int32),
            rng.integers(0, 0x3F800001, n).astype(np.int32),
            rng.integers(1, 1 << 23, n).astype(np.int32))
    return splat._sort4_frags(*(torch.from_numpy(c).cuda()
                                for c in cols))[:3]


def check_sorted_bucket(torch, splat, sort, entry) -> dict:
    """K3, sort4 and K4 of one captured bucket against their plain
    versions on the card, on the same inputs: every column and the plane
    bit for bit."""
    args, cols = entry["args"], entry["cols"]
    want = splat.emit_fragment_columns_reference(*args)
    for name, g, r in zip(("pix", "bits", "ids", "arrival"), cols, want):
        if not torch.equal(g, r):
            raise AssertionError(f"emit_fragments != plain in {name}: max "
                                 f"abs err {abs_err(torch, g, r)}")
    ref_sorted = sort.sort4_reference(*cols)
    for g, r in zip(entry["sorted"], ref_sorted):
        if not torch.equal(g, r):
            raise AssertionError(f"sort4 != plain at {cols[0].shape[0]} "
                                 "fragment rows")
    fb_plain = entry["fb_in"].clone()
    splat.sorted_merge_reference(fb_plain, *entry["sorted"][:3])
    torch.cuda.synchronize()
    if not torch.equal(fb_plain, entry["fb_out"]):
        raise AssertionError("sorted_merge != plain: max abs err "
                             f"{abs_err(torch, fb_plain, entry['fb_out'])}")
    pix = entry["sorted"][0]
    first = run_starts(torch, pix)
    classes, counts = args[10], args[6]
    rows = [min(int(counts[c.cls]), c.rows) for c in classes]
    return {"length": int(pix.shape[0]),
            "fragments": splat.fragment_total(classes),
            "classes": [[c.k, c.rows] for c in classes],
            "rows": sum(rows),
            "tested": sum(r * c.k * c.k for r, c in zip(rows, classes)),
            "lit": int((cols[0] != int(splat._NO_ID)).sum()),
            "winners": int((first & (pix != int(splat._NO_ID))).sum()),
            "max_abs_err": 0}


def phase_arms(torch, np, store: Path, sort_checked: set) -> dict:
    """Phase 7: every render arm for ARM_FRAMES frames at one pose on the
    2^23-point store at 1280x720, from zero launch counts; then the
    frames against the default arm's and against the CPU, and K3, sort4
    and K4 on every bucket of the sorted frames against their plain
    versions."""
    from point_cloud_tpu_torch.ops import sort
    from point_cloud_tpu_torch.render import kernel, splat
    from point_cloud_tpu_torch.render.renderer import (
        PointRenderer, RenderSettings,
    )
    from point_cloud_tpu_torch.viewer import Viewer

    t_phase = time.perf_counter()
    viewer = Viewer(RenderSettings(width=FRAME_W, height=FRAME_H),
                    device="cuda")
    viewer.load_metadata(store / "metadata.json")
    arm_pose(viewer)
    scene = (viewer.streamer, viewer.camera, viewer._frustums)

    def settings(arm: dict):
        return RenderSettings(width=FRAME_W, height=FRAME_H, **arm)

    def run(arm: dict, device="cuda"):
        renderer = PointRenderer(viewer.metadata, settings(arm),
                                 device=device)
        frames, ms = [], []
        for _ in range(ARM_FRAMES if device == "cuda" else 1):
            t0 = time.perf_counter()
            out = renderer.render(*scene)
            ms.append((time.perf_counter() - t0) * 1e3)
            frames.append(frame_planes(renderer, out))
        return frames, ms, renderer

    default, default_ms, default_r = run({})
    # the main path's run: every count starts at 0 here
    kernel.launches = kernel.lod_launches = 0
    splat.launches = splat.rank_launches = 0
    splat.fragment_launches = splat.merge_launches = 0
    sort.launches = 0
    sort.launches_by_n.clear()
    runs = {}
    capture = SortedCapture(splat)
    sorted_launches = {}
    ranks, rank_checks = RankCapture(splat), {}
    for name, arm in ARMS.items():
        if name not in SORTED_ARMS:
            with ranks:
                runs[name] = run(arm)
            rank_checks[name] = ranks.check(torch)
            continue
        before = (len(capture.buckets), splat.fragment_launches,
                  sort.launches, splat.merge_launches)
        with capture, ranks:
            runs[name] = run(arm)
        rank_checks[name] = ranks.check(torch)
        sorted_launches[name] = {
            "buckets_sorted": len(capture.buckets) - before[0],
            "emit_fragments": splat.fragment_launches - before[1],
            "sort4": sort.launches - before[2],
            "sorted_merge": splat.merge_launches - before[3]}
    torch.cuda.synchronize()
    launches = {"cull_classify": kernel.launches,
                "splat_raster": splat.launches,
                "class_rank": splat.rank_launches,
                "emit_fragments": splat.fragment_launches,
                "sorted_merge": splat.merge_launches, "sort4": sort.launches}
    LOD_BY_PATH["arms"] = kernel.lod_launches
    if not rank_checks["budget"]["with_dest"] or not any(
            c["capped"] for c in rank_checks.values()):
        raise AssertionError(f"the arms' K5 calls: {rank_checks}")
    arms_by_n = dict(sort.launches_by_n)
    if min(launches.values()) <= 0:
        raise AssertionError(f"the arms did not run every kernel: {launches}")
    for counts in sorted_launches.values():
        if len(set(counts.values())) != 1:
            raise AssertionError("a sorted arm launched K3, sort4 and K4 not "
                                 f"once a non-empty bucket: {sorted_launches}")
    if not capture.buckets:
        raise AssertionError("the sorted arms sorted no bucket")

    # the frames: steady frames within their group, the sorted and fused
    # arms every frame against their twins, the first frame against the
    # port's CPU renderer
    frames_of = {"default": default, **{k: v[0] for k, v in runs.items()}}
    for lead, members in ARM_GROUPS.items():
        for name in members:
            if not same_frame(np, torch, frames_of[name][-1],
                              frames_of[lead][-1]):
                raise AssertionError(f"arm {name}: steady frame != {lead}'s")
    for name, twin in EVERY_FRAME.items():
        for i, (a, b) in enumerate(zip(frames_of[name], frames_of[twin])):
            if not same_frame(np, torch, a, b):
                raise AssertionError(f"arm {name}: frame {i + 1} != {twin}'s")
    capped = capped_rungs(default_r, scene)
    overflow = any(v > 0 for (_, k), v in default_r._survivor_counts.items()
                   if isinstance(k, int) and k > default_r.settings.footprint)
    agree = {"default=multi_dispatch": same_frame(
        np, torch, default[-1], frames_of["multi_dispatch"][-1]),
        "multi_dispatch=classing_false": same_frame(
            np, torch, frames_of["multi_dispatch"][-1],
            frames_of["classing_false"][-1])}
    if not capped and not agree["default=multi_dispatch"]:
        raise AssertionError("no rung passes its cap, yet the chunked and "
                             "the uncapped ladders' frames differ")
    if not overflow and not agree["multi_dispatch=classing_false"]:
        raise AssertionError("no splat overflows the footprint, yet the "
                             "footprint-only frames differ")
    checks = {}
    cpu_s = 0.0
    for name, (frames, ms, _) in runs.items():
        t0 = time.perf_counter()
        cpu_frames, _, _ = run(ARMS[name], device="cpu")
        cpu_s += time.perf_counter() - t0
        if not same_frame(np, torch, frames[0], cpu_frames[0]):
            raise AssertionError(f"arm {name}: frame 1 cuda != cpu")
        if frames[-1][3]["points_visible"] <= 0:
            raise AssertionError(f"arm {name} shows nothing")
        checks[name] = {
            "frame_ms": ms, "median_ms_after_first": statistics.median(ms[1:]),
            "points_visible": frames[-1][3]["points_visible"],
            "buckets": frames[-1][3]["buckets"],
            "lit_pixels": int((frames[-1][2] != int(splat._NO_ID)).sum()),
            "group": next(lead for lead, members in ARM_GROUPS.items()
                          if name == lead or name in members)}

    # K3, sort4 and K4 on every bucket of the sorted frames
    buckets = [check_sorted_bucket(torch, splat, sort, e)
               for e in capture.buckets]
    lengths = {b["length"] for b in buckets}
    if set(arms_by_n) - lengths:
        raise AssertionError(f"lengths {sorted(set(arms_by_n) - lengths)} "
                             "sorted but not checked")
    sort_checked.update(lengths)
    big = max(capture.buckets, key=lambda e: e["cols"][0].shape[0])
    big_stats = max(buckets, key=lambda b: b["length"])
    flush = l2_flush(torch)
    emit_t = time_kernel(
        torch, lambda: splat.emit_fragment_columns(*big["args"]),
        lambda: splat.emit_fragment_columns_reference(*big["args"]),
        "emit_fragments_kernel", plain_reps=3, setup=flush)

    def time_merge(fb0, cols):
        fb = fb0.clone()
        return time_kernel(
            torch, lambda: splat.sorted_merge(fb, *cols),
            lambda: splat.sorted_merge_reference(fb, *cols),
            "sorted_merge_kernel", plain_reps=3,
            setup=lambda: (flush(), fb.copy_(fb0)))

    merge_t = time_merge(big["fb_in"], big["sorted"][:3])
    dense = dense_merge_list(torch, np, splat)
    fb_clear = splat.make_framebuffer(FRAME_H, FRAME_W, "cuda").packed
    fb_k, fb_p = fb_clear.clone(), fb_clear.clone()
    splat.sorted_merge(fb_k, *dense)
    splat.sorted_merge_reference(fb_p, *dense)
    torch.cuda.synchronize()
    if not torch.equal(fb_k, fb_p):
        raise AssertionError("sorted_merge != plain on the dense list: max "
                             f"abs err {abs_err(torch, fb_k, fb_p)}")
    dense_t = time_merge(fb_clear, dense)
    dense_winners = int(run_starts(torch, dense[0]).sum())
    sort_library = sort4_library_ms(torch, big["cols"], big["sorted"],
                                    reps=3)
    sort_by_n = {}
    for n in sorted(lengths):
        cols = next(e["cols"] for e in capture.buckets
                    if e["cols"][0].shape[0] == n)
        sort_by_n[n] = {
            "ms": device_kernel_ms(torch, lambda: sort.sort4(*cols),
                                   sort4_kernels(n)),
            "wrapper_ms": cuda_ms(lambda: sort.sort4(*cols)),
            "plain_ms": cuda_ms(lambda: sort.sort4_reference(*cols), reps=3),
            "bound_ms": sort4_bound_ms(n)[0]}
    e_bound, e_by = fragments_bound_ms(big_stats["length"], big_stats["rows"],
                                       big_stats["tested"])
    m_bound, m_by = merge_bound_ms(big_stats["lit"], big_stats["length"],
                                   big_stats["winners"])
    d_bound = merge_bound_ms(DENSE_MERGE_ROWS, DENSE_MERGE_ROWS,
                             dense_winners)[0]
    result = {
        "phase": "arms", "ok": True, "width": FRAME_W, "height": FRAME_H,
        "pose": {"yaw": ARM_YAW, "pitch": ARM_PITCH}, "frames": ARM_FRAMES,
        "default_ms": default_ms, "arms": checks, "launches": launches,
        "sorted_launches": sorted_launches, "sort4_launches_by_n": arms_by_n,
        "sorted_buckets": buckets, "default_overflows": overflow,
        "capped_rungs": capped, "groups_agree": agree,
        "class_rank_checks": rank_checks,
        "cpu_s": cpu_s, "phase_s": time.perf_counter() - t_phase,
    }
    emit(result)
    for name, c in checks.items():
        print(f"arm {name}: median frame {c['median_ms_after_first']:.1f} ms "
              f"(frames 2-{ARM_FRAMES}), {c['points_visible']} points "
              f"visible, {c['buckets']} buckets", flush=True)
    print(f"arms {', '.join(SORTED_ARMS)}: fragment rows a sorted bucket "
          f"{[b['length'] for b in buckets]} (sorted buckets by arm: "
          f"{ {k: v['buckets_sorted'] for k, v in sorted_launches.items()} })",
          flush=True)
    viewer.close()
    return {
        "result": result,
        "rank_err": max(c["max_abs_err"] for c in rank_checks.values()),
        "emit": {**emit_t, "length": big_stats["length"],
                 "rows": big_stats["rows"], "tested": big_stats["tested"],
                 "bound_ms": e_bound, "bound_by": e_by},
        "merge": {**merge_t, "length": big_stats["length"],
                  "valid_rows": big_stats["lit"],
                  "winners": big_stats["winners"], "bound_ms": m_bound,
                  "bound_by": m_by, "dense_rows": DENSE_MERGE_ROWS,
                  "dense_winners": dense_winners, "dense_bound_ms": d_bound,
                  "dense_ms": dense_t["ms"],
                  "dense_ms_runs": dense_t["ms_runs"],
                  "dense_wrapper_ms": dense_t["wrapper_ms"],
                  "dense_plain_ms": dense_t["plain_ms"]},
        "sort_by_n": sort_by_n,
        "sort_library_ms": {big_stats["length"]: sort_library},
    }


# --- phase 8: the multi-device path -----------------------------------------

MESH_SHARDS = 4  # logical shards of the one card
MESH_PASS_N = 1 << 20  # the owner-sharded pass timed alone
SPILL_POINTS = 1 << 18
MESH_FRAMES = 4
MULTIHOST_FILES = 4
MULTIHOST_WORKERS = 2


class SortCapture:
    """Wraps a sorting function (``name``) where the owner-sharded pass
    calls it while installed: ``sort4`` in ``parallel.owner_cascade`` (the
    routing and arrival sorts), the fused front end ``quantize_sort4`` in
    ``ops.dedup`` and ``parallel.owner_cascade`` (stage A's and stage B's
    hash sorts). The first call at each length
    keeps its inputs and outputs, held against the plain version after
    the run. It counts nothing: the kernels count their own launches."""

    def __init__(self, modules, name: str = "sort4"):
        self.modules, self.name = modules, name
        self.real = [getattr(m, name) for m in modules]
        self.calls = {}

    def __enter__(self):
        for m, real in zip(self.modules, self.real):
            setattr(m, self.name, self._wrap(real))
        return self

    def _wrap(self, real):
        def wrap(*args, **kwargs):
            out = real(*args, **kwargs)
            n = args[0].shape[0]
            if n not in self.calls:
                self.calls[n] = ([a.clone() if hasattr(a, "clone") else a
                                  for a in args], dict(kwargs),
                                 [o.clone() for o in out])
            return out

        return wrap

    def __exit__(self, *exc):
        for m, real in zip(self.modules, self.real):
            setattr(m, self.name, real)

    def check(self, plain) -> dict:
        """{length: max abs error of the bits} of every captured call
        against ``plain`` on the same inputs; raises on any difference."""
        import torch

        errs = {}
        for n, (args, kwargs, out) in sorted(self.calls.items()):
            errs[n] = bits_err(torch, out, plain(*args, **kwargs))
            if errs[n]:
                raise AssertionError(f"{self.name} on the mesh path at n={n} "
                                     "differs from its plain version")
        return errs


class CallCount:
    """Counts the calls of module functions while installed: ``targets``
    maps a module to the names of its functions to count."""

    def __init__(self, targets: dict):
        self.targets = targets
        self.calls = {name: 0 for names in targets.values() for name in names}
        self.real = {}

    def __enter__(self):
        for module, names in self.targets.items():
            for name in names:
                real = getattr(module, name)
                self.real[(module, name)] = real
                setattr(module, name, self._wrap(name, real))
        return self

    def _wrap(self, name, real):
        def wrap(*args, **kwargs):
            self.calls[name] += 1
            return real(*args, **kwargs)

        return wrap

    def __exit__(self, *exc):
        for (module, name), real in self.real.items():
            setattr(module, name, real)


def phase_mesh_convert(torch, np, tmp: Path, checked: dict) -> dict:
    """Phase 8a: the phase-4 PLY through MeshConverter on a four-shard mesh
    of the one card, from zero launch counts (every sort4 and front end
    length of the run held against the plain version), the store
    byte-identical to
    phase 4's ``--native`` one; ``--mesh 1`` through the CLI; a
    forced-spill pass against the host Converter; the owner-sharded pass
    timed alone at 2^20 rows and one profiled cascade level."""
    from point_cloud_tpu_torch.convert.converter import (
        Converter, convert_from_paths,
    )
    from point_cloud_tpu_torch.core.metadata import Metadata, MetadataConfig
    from point_cloud_tpu_torch.core.point import PointBatch
    from point_cloud_tpu_torch.models.synth import synth_cloud
    from point_cloud_tpu_torch.ops import dedup, mark_pack, quantize_hash, sort
    from point_cloud_tpu_torch.parallel import owner_cascade
    from point_cloud_tpu_torch.parallel.dedup import shard_rows, shard_slices
    from point_cloud_tpu_torch.parallel.mesh import make_mesh
    from point_cloud_tpu_torch.parallel.mesh_converter import MeshConverter
    from point_cloud_tpu_torch.utils.tracing import StageTimer

    t_phase = time.perf_counter()
    mesh = make_mesh(devices=[torch.device("cuda:0")] * MESH_SHARDS)
    made = []

    def factory(metadata, working_directory, cache_size=None):
        conv = MeshConverter(metadata, working_directory,
                             cache_size=cache_size, mesh=mesh)
        made.append(conv)
        return conv

    # the main path's run: every count starts at 0 here
    sort.launches = 0
    sort.launches_by_n.clear()
    quantize_hash.launches = 0
    quantize_hash.launches_by_n.clear()
    quantize_hash.gather_launches_by_n.clear()
    mark_pack.launches = 0
    capture = SortCapture((owner_cascade,))
    fronts = SortCapture((dedup, owner_cascade), "quantize_sort4")
    hashes = CallCount({dedup: ("_hash_sort",),
                        owner_cascade: ("quantize_sort4",)})
    with capture, fronts, hashes, StageTimer() as timer:
        t0 = time.perf_counter()
        convert_from_paths([tmp / "cloud.ply"], tmp / "mesh4",
                           batch_size=BATCH, converter_factory=factory)
        mesh_s = time.perf_counter() - t0
    launches, by_n = sort.launches, dict(sort.launches_by_n)
    fused, fused_by_n = quantize_hash.launches, dict(
        quantize_hash.launches_by_n)
    b3 = mark_pack.launches
    # one fused front end for every hash sort (stage A's _hash_sort, stage
    # B's quantize_sort4), one B3 launch for each (its sorted rows'
    # flags), and as many sort4 calls (the routing and arrival sorts)
    hash_sorts = hashes.calls["_hash_sort"] + hashes.calls["quantize_sort4"]
    if not fused == hash_sorts == b3 == launches > 0 \
            or not hashes.calls["_hash_sort"] == hashes.calls[
                "quantize_sort4"]:
        raise AssertionError(f"mesh launches: front end {fused}, B3 {b3}, "
                             f"sort4 {launches}, hash sorts {hashes.calls}")
    files = same_store(tmp / "native", tmp / "mesh4", "4-shard mesh")
    sort_err = capture.check(sort.sort4_reference)
    front_err = fronts.check(dedup.quantize_sort4_reference)
    if set(by_n) != set(sort_err) or set(fused_by_n) != set(front_err):
        raise AssertionError(f"mesh sort lengths {sorted(by_n)} and "
                             f"{sorted(fused_by_n)} but checked "
                             f"{sorted(sort_err)} and {sorted(front_err)}")
    checked["sort4"].update(by_n)
    checked["quantize_sort4"].update(fused_by_n)
    sideband = {"sideband_spilled": made[0].sideband_spilled,
                "sideband_suspect": made[0].sideband_suspect}
    stages = timer.report()

    cli = run_cli("--mesh 1", tmp / "cloud.ply", tmp / "mesh1")
    same_store(tmp / "native", tmp / "mesh1", "--mesh 1")
    cli_by_n = sorted_lengths(cli, "--mesh 1", checked)
    cli_launches = pass_launches(cli, "--mesh 1", mesh=True)

    rng = np.random.default_rng(5)
    spill = PointBatch(synth_cloud(SPILL_POINTS, seed=1),
                       rng.integers(0, 256, (SPILL_POINTS, 4), np.uint8))
    t0 = time.perf_counter()
    with Converter(Metadata(), tmp / "spill-host") as host:
        host.add_points_batch(spill)
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with MeshConverter(Metadata(), tmp / "spill-mesh", mesh=mesh,
                       capacity=1) as spilled:
        spilled.add_points_batch(spill)
    spill_s = time.perf_counter() - t0
    same_store(tmp / "spill-host", tmp / "spill-mesh", "forced spill")
    if spilled.sideband_spilled <= 0:
        raise AssertionError("capacity=1 spilled nothing")

    # the pass alone at 2^20 rows: on tensors already on the card, and
    # through the host wrapper (upload, four shards, readback)
    config = MetadataConfig()
    cell_size = config.cell_size(0)
    sub_size = config.sub_cell_size(cell_size)
    pos = synth_cloud(MESH_PASS_N, seed=2)
    owner = owner_cascade.OwnerShardedPass(mesh)
    n_pad = shard_rows(mesh, MESH_PASS_N)
    capacity = owner._capacity_for(n_pad // MESH_SHARDS)
    stage_b = dedup.pad_to_bucket(MESH_SHARDS * capacity, minimum=1024)
    pos_sh = shard_slices(mesh, pos)
    valid_sh = shard_slices(mesh, np.ones(MESH_PASS_N, bool))
    radius = np.float32(sub_size) / np.float32(2.0)

    def device_pass():
        return owner_cascade.owner_pass(
            mesh, pos_sh, valid_sh, np.float32(cell_size), radius,
            capacity=capacity, stage_b_pad=stage_b)

    pass_ms = cuda_ms(device_pass)
    host_pass_ms = cuda_ms(lambda: owner(pos, cell_size, sub_size), reps=5)
    pass_busy = busy_share(torch, device_pass, top=None)
    # one cascade level (a fresh store's level 0 at batch 2^18) twice:
    # under torch.profiler, and under cProfile for the host's functions
    batch = PointBatch(synth_cloud(BATCH, seed=3),
                       rng.integers(0, 256, (BATCH, 4), np.uint8))
    levels = [MeshConverter(Metadata(), tmp / f"level{i}", mesh=mesh)
              for i in range(2)]
    level_busy = busy_share(torch, lambda: levels[0]._cascade_level(
        batch.positions, batch.colors, 0))
    level_host = host_profile(lambda: levels[1]._cascade_level(
        batch.positions, batch.colors, 0))
    for level in levels:
        level.close()
    result = {
        "phase": "mesh_convert", "ok": True, "shards": MESH_SHARDS,
        "devices": [str(d) for d in mesh.devices], "points": CLOUD_POINTS,
        "batch_size": BATCH, "store_files": files, "byte_identical": True,
        "mesh_s": mesh_s, "mesh_mpts_s": CLOUD_POINTS / mesh_s / 1e6,
        "sort4_launches": launches, "sort4_launches_by_n": by_n,
        "front_launches_by_n": fused_by_n,
        "sort4_max_abs_err_by_n": sort_err,
        "front_max_abs_err_by_n": front_err,
        "pass_launches": {"quantize_sort4": fused, "sort4": launches,
                          "mark_pack": b3},
        "hash_calls": hashes.calls,
        **sideband,
        "stages": {k: v for k, v in stages.items() if k.startswith("mesh")
                   or k in ("lsm_merge", "overflow_staging")},
        "mesh1_cli": {"convert_s": cli["convert_s"],
                      "sort4_launches": cli["launches"]["sort4"],
                      "sort4_launches_by_n": cli_by_n["sort4"],
                      "front_launches_by_n": cli_by_n["quantize_sort4"],
                      "pass_launches": cli_launches,
                      "byte_identical": True},
        "forced_spill": {"points": SPILL_POINTS, "capacity": 1,
                         "sideband_spilled": spilled.sideband_spilled,
                         "sideband_suspect": spilled.sideband_suspect,
                         "mesh_s": spill_s, "host_s": host_s,
                         "byte_identical": True},
        "owner_pass": {"n": MESH_PASS_N, "shard_rows": n_pad // MESH_SHARDS,
                       "capacity": capacity, "stage_b_rows": stage_b,
                       "device_ms": pass_ms, "host_wrapper_ms": host_pass_ms,
                       "busy": pass_busy},
        "profiled_level": {"rows": BATCH, **level_busy,
                           "host_cumulative_ms": level_host},
        "phase_s": time.perf_counter() - t_phase,
    }
    emit(result)
    return result


def phase_mesh_frame(torch, np, store: Path) -> dict:
    """Phase 8b: the phase-4 store at 1280x720 from phase 7's pose through
    MeshPointRenderer on four shards of the card, from zero K1 and K2
    counts; its frames against the single-device plain raster arm on the
    card and against the same mesh on the CPU, the card's 1- and 3-shard
    meshes against it, and the default arm's capped rungs."""
    from point_cloud_tpu_torch.parallel.mesh import make_mesh
    from point_cloud_tpu_torch.render import kernel, splat
    from point_cloud_tpu_torch.render.parallel import MeshPointRenderer
    from point_cloud_tpu_torch.render.renderer import (
        PointRenderer, RenderSettings,
    )
    from point_cloud_tpu_torch.viewer import Viewer

    t_phase = time.perf_counter()
    viewer = Viewer(RenderSettings(width=FRAME_W, height=FRAME_H),
                    device="cuda")
    viewer.load_metadata(store / "metadata.json")
    arm_pose(viewer)
    scene = (viewer.streamer, viewer.camera, viewer._frustums)
    plain = RenderSettings(width=FRAME_W, height=FRAME_H,
                           compact_raster=False, megakernel=False,
                           classing=False)
    card = [torch.device("cuda:0")]

    def frames_of(renderer, n):
        out, ms = [], []
        for _ in range(n):
            t0 = time.perf_counter()
            got = renderer.render(*scene)
            ms.append((time.perf_counter() - t0) * 1e3)
            out.append(frame_planes(renderer, got))
        return out, ms

    single_r = PointRenderer(viewer.metadata, plain, device="cuda")
    single, single_ms = frames_of(single_r, MESH_FRAMES)
    # the main path's run: every count starts at 0 here
    kernel.launches = kernel.lod_launches = 0
    splat.launches = splat.rank_launches = 0
    mesh_r = MeshPointRenderer(viewer.metadata,
                               make_mesh(devices=card * MESH_SHARDS),
                               settings=plain)
    ranks = RankCapture(splat)
    with ranks:
        frames, mesh_ms = frames_of(mesh_r, MESH_FRAMES)
    torch.cuda.synchronize()
    launches = {"cull_classify": kernel.launches,
                "splat_raster": splat.launches,
                "class_rank": splat.rank_launches}
    LOD_BY_PATH["mesh"] = kernel.lod_launches
    rank_check = ranks.check(torch)
    buckets = frames[0][3]["buckets"]
    expect = MESH_FRAMES * MESH_SHARDS * buckets
    if buckets <= 0 or set(launches.values()) != {expect}:
        raise AssertionError(f"mesh frames launched {launches}, expected "
                             f"{expect} of each ({buckets} buckets)")
    for i, f in enumerate(frames):
        if not same_frame(np, torch, f, single[0]):
            raise AssertionError(f"mesh frame {i + 1} != the single-device "
                                 "plain arm's")
    if frames[0][3]["points_visible"] <= 0:
        raise AssertionError("the mesh frame shows nothing")
    t0 = time.perf_counter()
    cpu_r = MeshPointRenderer(viewer.metadata,
                              make_mesh(MESH_SHARDS, device="cpu"),
                              settings=plain)
    if not same_frame(np, torch, frames[0], frame_planes(
            cpu_r, cpu_r.render(*scene))):
        raise AssertionError("the card's mesh frame != the CPU mesh frame")
    cpu_s = time.perf_counter() - t0
    widths = {}
    for n in (1, 3):
        r = MeshPointRenderer(viewer.metadata, make_mesh(devices=card * n),
                              settings=plain)
        widths[n] = same_frame(np, torch, frames[0],
                               frame_planes(r, r.render(*scene)))
        if not widths[n]:
            raise AssertionError(f"the {n}-shard mesh frame differs")
    default_r = PointRenderer(viewer.metadata,
                              RenderSettings(width=FRAME_W, height=FRAME_H),
                              device="cuda")
    default, _ = frames_of(default_r, 2)
    busy = busy_share(torch, lambda: mesh_r.render(*scene))
    result = {
        "phase": "mesh_frame", "ok": True, "width": FRAME_W,
        "height": FRAME_H, "pose": {"yaw": ARM_YAW, "pitch": ARM_PITCH},
        "shards": MESH_SHARDS, "frames": MESH_FRAMES, "buckets": buckets,
        "points_visible": frames[0][3]["points_visible"],
        "lit_pixels": int((frames[0][2] != int(splat._NO_ID)).sum()),
        "launches": launches, "class_rank_check": rank_check,
        "equals_single_device_plain_arm": True, "equals_cpu_mesh": True,
        "equal_at_widths": widths,
        "matches": "the plain raster arm (compact_raster, megakernel and "
                   "classing off: every kept row through the footprint)",
        "equals_default_arm": same_frame(np, torch, frames[0], default[-1]),
        "default_capped_rungs": capped_rungs(default_r, scene),
        "mesh_ms": mesh_ms,
        "mesh_ms_median_after_first": statistics.median(mesh_ms[1:]),
        "single_plain_ms": single_ms,
        "single_plain_ms_median_after_first": statistics.median(single_ms[1:]),
        "profiled_frame": busy, "cpu_mesh_s": cpu_s,
        "phase_s": time.perf_counter() - t_phase,
    }
    emit(result)
    viewer.close()
    return result


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def point_multiset(np, store: Path):
    """Every point of a store (grid winners and staged overflow) as
    (position bytes, color) rows of two u64 words, sorted."""
    from point_cloud_tpu_torch.core.cell import Cell

    chunks = []
    for path in sorted(store.rglob("c_*.bin")):
        pts = Cell.from_path(path).all_points()
        if len(pts):
            chunks.append(np.concatenate(
                [pts.positions.view(np.uint8).reshape(len(pts), 12),
                 pts.colors], axis=1))
    rows = np.ascontiguousarray(np.concatenate(chunks)).view(np.uint64)
    return rows[np.lexsort((rows[:, 1], rows[:, 0]))]


def phase_multihost(np, tmp: Path, checked: dict) -> dict:
    """Phase 8c: the phase-4 cloud as four PLY files, converted by two
    ``--multihost --device-native`` CLI workers on the card that meet on a
    gloo process group at a localhost coordinator; rank 0's merged store
    must hold the point multiset of one ``--device-native`` conversion of
    the four files."""
    import os

    from point_cloud_tpu_torch.core.metadata import Metadata
    from point_cloud_tpu_torch.core.point import PointBatch
    from point_cloud_tpu_torch.io.ply import write_ply
    from point_cloud_tpu_torch.models.synth import synth_cloud

    t_phase = time.perf_counter()
    rng = np.random.default_rng(3)  # phase 4's cloud and colors
    pos = synth_cloud(CLOUD_POINTS, seed=0)
    col = rng.integers(0, 256, (CLOUD_POINTS, 4), dtype=np.uint8)
    part = CLOUD_POINTS // MULTIHOST_FILES
    files = []
    for i in range(MULTIHOST_FILES):
        files.append(tmp / f"part{i}.ply")
        write_ply(files[-1], PointBatch(pos[i * part:(i + 1) * part],
                                        col[i * part:(i + 1) * part]))
    del pos, col
    port = free_port()
    out = tmp / "multihost"
    procs, logs = [], []
    t0 = time.perf_counter()
    try:
        for rank in range(MULTIHOST_WORKERS):
            env = dict(os.environ, PCT_NUM_PROCESSES=str(MULTIHOST_WORKERS),
                       PCT_PROCESS_ID=str(rank),
                       PCT_COORDINATOR_ADDRESS=f"localhost:{port}")
            logs.append((tmp / f"worker{rank}.out", tmp / f"worker{rank}.err"))
            with open(logs[-1][0], "w") as so, open(logs[-1][1], "w") as se:
                procs.append(subprocess.Popen(
                    cli_command("--multihost --device-native", files, out),
                    cwd=ROOT, env=env, stdout=so, stderr=se))
        for p in procs:
            p.wait(timeout=CLI_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    multihost_s = time.perf_counter() - t0
    runs = []
    for p, (so, se) in zip(procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"multihost worker failed ({p.returncode}):\n"
                               f"{se.read_text()[-4000:]}")
        runs.append(json.loads(so.read_text().strip().splitlines()[-1]))
    by_rank = [sorted_lengths(r, f"multihost rank {i}", checked)
               for i, r in enumerate(runs)]
    single = run_cli("--device-native", files, tmp / "parts-device-native")
    merged, direct = (point_multiset(np, out),
                      point_multiset(np, tmp / "parts-device-native"))
    if merged.shape != direct.shape or not np.array_equal(merged, direct):
        raise AssertionError("the merged store's point multiset differs from "
                             "one --device-native conversion's")
    ma = Metadata.from_path(out / "metadata.json")
    mb = Metadata.from_path(tmp / "parts-device-native" / "metadata.json")
    if (ma.number_of_points != mb.number_of_points
            or not np.array_equal(ma.bounding_box.min, mb.bounding_box.min)
            or not np.array_equal(ma.bounding_box.max, mb.bounding_box.max)):
        raise AssertionError("merged metadata differs")
    if (out / "_staging").exists():
        raise AssertionError("rank 0 left its staging stores")
    result = {
        "phase": "multihost", "ok": True, "workers": MULTIHOST_WORKERS,
        "files": MULTIHOST_FILES, "points": CLOUD_POINTS,
        "backend": "gloo", "multiset_equal": True,
        "points_in_store": int(len(merged)),
        "multihost_s": multihost_s,
        "worker_s": [r["multihost_s"] for r in runs],
        "sort4_launches_by_rank": [r["launches"]["sort4"] for r in runs],
        "pass_launches_by_rank": [pass_launches(r, f"multihost rank {i}")
                                  for i, r in enumerate(runs)],
        "sort4_launches_by_n_by_rank": [r["sort4"] for r in by_rank],
        "front_launches_by_n_by_rank": [r["quantize_sort4"]
                                        for r in by_rank],
        "single_device_native_s": single["convert_s"],
        "phase_s": time.perf_counter() - t_phase,
    }
    emit(result)
    return result


# --- phase 9: every footprint -------------------------------------------------

# default settings at each; 29 and 31 were the first footprints the old
# K2 (32 segments a launch) and K1 (32 rungs) refused, 129 the first
# window past 128 px
FOOTPRINTS = (29, 31, 64, 128, 129)
FOOTPRINT_TIMED = (29, 64, 129)  # device ms a frame, K1 and K2 timed
FOOTPRINT_CPU = (29, 129)  # the card's frame against the CPU renderer's
FOOTPRINT_ARMS_AT = (64, 129)
# the other arms at FOOTPRINT_ARMS_AT; the sorted arm classes every splat
# (with classing "auto", once one splat overflows the footprint, the
# footprint class takes every kept row at k * k slots: at 64 px a bucket
# of more than 524,288 kept rows passes the 2^31 slots of a launch)
FOOTPRINT_ARMS = {
    "multi_dispatch": dict(megakernel=False),
    "budget": dict(chunked_raster=False),
    "sorted": dict(raster_mode="sorted", classing=True),
    "fusion": dict(frame_fusion=True),
}
# steady frames equal within a group, phase 7's: the capped chunked
# megakernel's, and the uncapped ladders' (which equal it where no
# overflow rung passes its cap)
FOOTPRINT_GROUPS = {"default": ("fusion",),
                    "multi_dispatch": ("budget", "sorted")}
FOOTPRINT_MESH_AT = 129
# K2 timed on the multi-dispatch arm's widest class raster at this one
FOOTPRINT_WIDE_TIMED = 129


def widest_call(splat, rasters):
    """Of captured K2 calls (:class:`KernelCapture`), the one whose
    widest window draws rows, the most rows among those: a class raster
    of the multi-dispatch arm."""
    def key(entry):
        args = entry[1]
        drawn = [seg.k for seg in args[10]
                 if int(splat.segment_bounds(seg, args[5], args[6])[1])]
        return max(drawn, default=0), call_rows(splat, args)

    return max(rasters, key=key)


def phase_footprints(torch, np, store: Path, sort_checked: set) -> dict:
    """Phase 9: the phase-4 store at 1280x720 from phase 7's pose at every
    footprint of FOOTPRINTS under default settings, from zero launch
    counts: every bucket's K1 and K2 bit-exact against their plain
    versions (:func:`check_bucket`), the frame against the CPU renderer's
    at FOOTPRINT_CPU, device ms a frame and K1's and K2's device time on
    the largest bucket against their bounds at FOOTPRINT_TIMED; the other
    arms at FOOTPRINT_ARMS_AT, steady frames equal within
    FOOTPRINT_GROUPS and the sorted arm's K3, sort4 and K4 bit-exact on
    every bucket (every sorted length checked), every K1 and K2 call of
    the multi-dispatch arm's last frame bit-exact, and at
    FOOTPRINT_WIDE_TIMED K2's device time on that frame's widest class
    raster (:func:`widest_call`) against its bound; the mesh frame at
    FOOTPRINT_MESH_AT on four logical shards bit-equal to the
    single-device plain arm."""
    from point_cloud_tpu_torch.ops import sort
    from point_cloud_tpu_torch.parallel.mesh import make_mesh
    from point_cloud_tpu_torch.render import kernel, splat
    from point_cloud_tpu_torch.render.parallel import MeshPointRenderer
    from point_cloud_tpu_torch.render.renderer import (
        PointRenderer, RenderSettings,
    )
    from point_cloud_tpu_torch.viewer import Viewer

    t_phase = time.perf_counter()
    viewer = Viewer(RenderSettings(width=FRAME_W, height=FRAME_H),
                    device="cuda")
    viewer.load_metadata(store / "metadata.json")
    arm_pose(viewer)
    scene = (viewer.streamer, viewer.camera, viewer._frustums)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    coarse_cells = (-(-FRAME_H // kernel.PYRAMID_TILE)
                    * -(-FRAME_W // kernel.PYRAMID_TILE))

    def settings(fp: int, **arm):
        return RenderSettings(width=FRAME_W, height=FRAME_H, footprint=fp,
                              **arm)

    def counts() -> dict:
        return {"cull_classify": kernel.launches,
                "splat_raster": splat.launches,
                "class_rank": splat.rank_launches,
                "emit_fragments": splat.fragment_launches,
                "sorted_merge": splat.merge_launches, "sort4": sort.launches}

    # the main path's run: every count starts at 0 here, and only the
    # frames add to it (:func:`driven`), not the checks and timings
    kernel.launches = kernel.lod_launches = 0
    splat.launches = splat.rank_launches = 0
    splat.fragment_launches = splat.merge_launches = 0
    sort.launches = 0
    sort.launches_by_n.clear()
    launches = dict.fromkeys(counts(), 0)
    by_n: dict = {}
    ranks, rank_checks = RankCapture(splat), {}

    def driven(fn):
        """``fn()``, a frame of the main path; its launches added to the
        phase's counts, its K5 calls kept for ``ranks.check``."""
        before, before_n = counts(), dict(sort.launches_by_n)
        with ranks:
            out = fn()
        for name, count in counts().items():
            launches[name] += count - before[name]
        for n, count in sort.launches_by_n.items():
            if count > before_n.get(n, 0):
                by_n[n] = by_n.get(n, 0) + count - before_n.get(n, 0)
        return out

    sorted_capture = SortedCapture(splat)
    by_fp, checked, sorted_buckets, call_checks = {}, [], [], []
    for fp in FOOTPRINTS:
        renderer = PointRenderer(viewer.metadata, settings(fp), device="cuda")
        captured = []
        bucket_pass = splat.render_bucket_pass

        def capture(framebuffer, *args, **kw):
            captured.append((framebuffer.packed.clone(), args, kw))
            return bucket_pass(framebuffer, *args, **kw)

        splat.render_bucket_pass = capture
        try:
            t0 = time.perf_counter()
            first = frame_planes(renderer,
                                 driven(lambda: renderer.render(*scene)))
            ms = [(time.perf_counter() - t0) * 1e3]
        finally:
            splat.render_bucket_pass = bucket_pass
        t0 = time.perf_counter()
        driven(lambda: renderer.render(*scene))
        ms.append((time.perf_counter() - t0) * 1e3)
        if first[3]["points_visible"] <= 0 or not captured:
            raise AssertionError(f"footprint {fp}: nothing rendered")
        buckets = [check_bucket(torch, splat, kernel, *e) for e in captured]
        checked += buckets
        kw = captured[0][2]
        rungs = tuple(kw["sub_ks"]) + (fp,) + tuple(kw["overflow_ks"])
        entry = {
            "rungs": len(rungs), "largest_window": max(rungs),
            "segments_a_bucket": [len(splat.bucket_segments(
                rungs, fp, e[1][0].shape[0])) for e in captured],
            "buckets": len(captured), "frame_ms": ms,
            "points_visible": first[3]["points_visible"],
            "lit_pixels": int((first[2] != int(splat._NO_ID)).sum()),
            "bucket_checks": buckets}
        if fp in FOOTPRINT_TIMED:
            busy = busy_share(torch, lambda: renderer.render(*scene))
            big = max(captured, key=lambda e: e[1][0].shape[0])
            cargs, ckw = cull_inputs(splat, kernel, *big)
            flush = l2_flush(torch)
            k1_ms = device_kernel_ms(
                torch, lambda: (flush(), kernel.cull_classify(*cargs, **ckw)),
                {"cull_classify_kernel": 1})
            inp = raster_inputs(splat, kernel, *big)
            fb_big = big[0].clone()
            entry["k5"] = time_rank(
                torch, splat, kernel.cull_classify(*cargs, **ckw)[6],
                len(inp["rungs"]))

            def k2():
                return run_rungs(splat, fb_big, inp, None)

            k2_ms = device_kernel_ms(
                torch, lambda: (fb_big.copy_(big[0]), k2()),
                {"splat_raster_kernel": 1})
            frags, touched = lit_fragments(torch, splat, inp)
            clock_mhz = sm_clock_under_load(torch, k2)
            bytes_ms = raster_bound_ms(inp["kept"], touched)
            instr_ms = raster_instr_bound_ms(tested_fragments(splat, inp),
                                             frags, sms, clock_mhz)
            ndc = inp["ndc"]
            inside = int(((ndc[:, 0].abs() <= 1.0) & (ndc[:, 1].abs() <= 1.0)
                          & ((ndc[:, 2] - 0.5).abs() <= 0.5)
                          & big[1][2]).sum())
            entry.update(
                device_ms_a_frame=busy["device_ms"],
                busy_share=busy["busy_share"],
                top_device_ms=busy["top_device_ms"],
                largest_bucket_n=int(big[1][0].shape[0]),
                k1_ms=k1_ms, k1_bound_ms=cull_bound_ms(
                    int(big[1][0].shape[0]), inside,
                    big[2]["use_occlusion"], big[2]["use_pyramid"],
                    FRAME_H * FRAME_W, coarse_cells),
                k2_ms=k2_ms, k2_rows=inp["kept"], k2_fragments=frags,
                k2_tested_fragments=tested_fragments(splat, inp),
                k2_touched_pixels=touched, sm_clock_mhz_under_load=clock_mhz,
                k2_bytes_bound_ms=bytes_ms, k2_instr_bound_ms=instr_ms,
                k2_bound_ms=max(bytes_ms, instr_ms),
                k2_bound_by="bytes" if bytes_ms >= instr_ms else "operations")
        if fp in FOOTPRINT_CPU:
            t0 = time.perf_counter()
            cpu = PointRenderer(viewer.metadata, settings(fp), device="cpu")
            if not same_frame(np, torch, first,
                              frame_planes(cpu, cpu.render(*scene))):
                raise AssertionError(f"footprint {fp}: cuda frame != cpu")
            entry["cpu_frame_s"] = time.perf_counter() - t0
        if fp in FOOTPRINT_ARMS_AT:
            frames = {"default": first}
            arm_ms = {}
            big_sorted = None  # (its check, K3's arguments)
            for name, arm in FOOTPRINT_ARMS.items():
                r = PointRenderer(viewer.metadata, settings(fp, **arm),
                                  device="cuda")
                arm_ms[name] = []
                calls = KernelCapture(kernel, splat)
                for i in range(ARM_FRAMES):
                    # the multi-dispatch arm's last frame: every K1 and K2
                    # call kept for the check below
                    last_md = name == "multi_dispatch" and i == ARM_FRAMES - 1
                    t0 = time.perf_counter()
                    with sorted_capture, (calls if last_md
                                          else contextlib.nullcontext()):
                        out = driven(lambda: r.render(*scene))
                    arm_ms[name].append((time.perf_counter() - t0) * 1e3)
                    # K3, sort4 and K4 on every bucket sorted (plain
                    # versions only: no launch), then let it go
                    for e in sorted_capture.buckets:
                        sorted_buckets.append(check_sorted_bucket(
                            torch, splat, sort, e))
                        if (big_sorted is None or sorted_buckets[-1]["length"]
                                > big_sorted[0]["length"]):
                            big_sorted = (sorted_buckets[-1], e["args"])
                    sorted_capture.buckets.clear()
                frames[name] = frame_planes(r, out)
                if calls.rasters:
                    entry["multi_dispatch_calls"] = calls.check(torch)
                    call_checks.append(entry["multi_dispatch_calls"])
                if calls.rasters and fp == FOOTPRINT_WIDE_TIMED:
                    wide = widest_call(splat, calls.rasters)
                    fb_wide = wide[0].clone()

                    def wide_k2():
                        return calls.real[1](fb_wide, *wide[1])

                    def wide_reset():
                        fb_wide.copy_(wide[0])

                    wide_ms = device_kernel_ms(
                        torch, lambda: (wide_reset(), wide_k2()),
                        {"splat_raster_kernel": 1})
                    # the wrapper's event time and the clock under this
                    # launch's own load: its bound is counted at that clock
                    wide_event_ms = cuda_ms(wide_k2, setup=wide_reset)
                    wide_clock = sm_clock_under_load(
                        torch, lambda: (wide_reset(), wide_k2()))
                    rows = call_rows(splat, wide[1])
                    frags, touched = call_lit_fragments(torch, splat, wide[1])
                    tested = call_tested_fragments(splat, wide[1])
                    bytes_ms = raster_bound_ms(rows, touched)
                    instr_ms = raster_instr_bound_ms(tested, frags, sms,
                                                     wide_clock)
                    entry["multi_dispatch_wide_k2"] = {
                        "window": max(seg.k for seg in wide[1][10]),
                        "rows": rows, "ms": wide_ms,
                        "wrapper_ms": wide_event_ms,
                        "sm_clock_mhz_under_load": wide_clock,
                        "fragments": frags,
                        "tested_fragments": tested, "touched_pixels": touched,
                        "bytes_bound_ms": bytes_ms, "instr_bound_ms": instr_ms,
                        "bound_ms": max(bytes_ms, instr_ms),
                        "bound_by": ("bytes" if bytes_ms >= instr_ms
                                     else "operations")}
            if big_sorted is not None:  # K3 on the largest sorted bucket
                stats, k3_args = big_sorted
                flush = l2_flush(torch)
                k3_bound, k3_by = fragments_bound_ms(
                    stats["length"], stats["rows"], stats["tested"])
                entry.update(
                    k3_ms=device_kernel_ms(
                        torch, lambda: (flush(),
                                        splat.emit_fragment_columns(*k3_args)),
                        {"emit_fragments_kernel": 1}),
                    k3_length=stats["length"], k3_classes=stats["classes"],
                    k3_bound_ms=k3_bound, k3_bound_by=k3_by)
            capped = capped_rungs(renderer, scene)
            groups = dict(FOOTPRINT_GROUPS)
            if not capped:  # one group: the caps do not bind
                groups = {"default": ("fusion", "multi_dispatch", "budget",
                                      "sorted")}
            for lead, members in groups.items():
                for name in members:
                    if not same_frame(np, torch, frames[name],
                                      frames[lead]):
                        raise AssertionError(f"footprint {fp}, arm {name}: "
                                             f"steady frame != {lead}'s")
            entry.update(arm_frame_ms=arm_ms, capped_rungs=capped,
                         groups=groups)
        # K5 on every ranking of this footprint's frames
        rank_checks[fp] = entry["class_rank_check"] = ranks.check(torch)
        by_fp[fp] = entry
        wide_k2 = entry.get("multi_dispatch_wide_k2")
        print(f"footprint {fp}: {len(rungs)} rungs, "
              f"{max(entry['segments_a_bucket'])} segments a launch, "
              f"largest window {max(rungs)}, {len(captured)} buckets, frame "
              f"{ms[-1]:.1f} ms"
              + (f", {entry['device_ms_a_frame']:.3f} ms on the card, K2 "
                 f"{entry['k2_ms']:.4f} ms on the largest bucket against "
                 f"{entry['k2_bound_ms']:.4f}" if fp in FOOTPRINT_TIMED
                 else "")
              + (f", K3 {entry['k3_ms']:.4f} ms at {entry['k3_length']} "
                 f"slots against {entry['k3_bound_ms']:.4f}"
                 if "k3_ms" in entry else "")
              + (f", multi-dispatch K2 {wide_k2['ms']:.4f} ms on its "
                 f"{wide_k2['window']}-px class raster of {wide_k2['rows']} "
                 f"rows against {wide_k2['bound_ms']:.4f}" if wide_k2 else ""),
              flush=True)

    # the mesh at FOOTPRINT_MESH_AT against the single-device plain arm
    plain = settings(FOOTPRINT_MESH_AT, compact_raster=False,
                     megakernel=False, classing=False)
    card = torch.device("cuda", torch.cuda.current_device())
    mesh_r = MeshPointRenderer(viewer.metadata,
                               make_mesh(devices=[card] * MESH_SHARDS),
                               settings=plain)
    t0 = time.perf_counter()
    mesh_frame = frame_planes(mesh_r, driven(lambda: mesh_r.render(*scene)))
    mesh_ms = (time.perf_counter() - t0) * 1e3
    single_r = PointRenderer(viewer.metadata, plain, device="cuda")
    if not same_frame(np, torch, mesh_frame, frame_planes(
            single_r, driven(lambda: single_r.render(*scene)))):
        raise AssertionError(f"mesh frame at footprint {FOOTPRINT_MESH_AT} "
                             "!= the single-device plain arm's")
    torch.cuda.synchronize()
    rank_checks["mesh"] = ranks.check(torch)
    if min(launches.values()) <= 0:
        raise AssertionError(f"the footprints did not run every kernel: "
                             f"{launches}")

    # every length sorted was checked, bucket by bucket, above
    lengths = {b["length"] for b in sorted_buckets}
    if set(by_n) - lengths:
        raise AssertionError(f"lengths {sorted(set(by_n) - lengths)} sorted "
                             "but not checked")
    sort_checked.update(lengths)
    LOD_BY_PATH["footprints"] = kernel.lod_launches
    result = {
        "phase": "footprints", "ok": True, "width": FRAME_W,
        "height": FRAME_H, "pose": {"yaw": ARM_YAW, "pitch": ARM_PITCH},
        "footprints": by_fp, "launches": launches, "sort4_launches_by_n": by_n,
        "sorted_buckets": sorted_buckets,
        "mesh": {"footprint": FOOTPRINT_MESH_AT, "shards": MESH_SHARDS,
                 "frame_ms": mesh_ms,
                 "equals_single_device_plain_arm": True,
                 "class_rank_check": rank_checks["mesh"]},
        "phase_s": time.perf_counter() - t_phase,
    }
    emit(result)
    viewer.close()
    return {"result": result, "by_n": by_n,
            "rank_err": max(c["max_abs_err"] for c in rank_checks.values()),
            "cull_err": max(b["cull_err"] for b in checked + call_checks),
            "raster_err": max(b["raster_err"]
                              for b in checked + call_checks)}


def footprints_alone(torch, np, smi: str) -> int:
    """``--phase footprints``: phase 4's cloud through the CLI's --native
    (byte-identical to the --device-native store), then phase 9 on it."""
    from point_cloud_tpu_torch.core.point import PointBatch
    from point_cloud_tpu_torch.io.ply import write_ply
    from point_cloud_tpu_torch.models.synth import synth_cloud

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        rng = np.random.default_rng(3)
        write_ply(tmp / "cloud.ply", PointBatch(
            synth_cloud(CLOUD_POINTS, seed=0),
            rng.integers(0, 256, (CLOUD_POINTS, 4), dtype=np.uint8)))
        run_cli("--native", tmp / "cloud.ply", tmp / "native")
        phase_footprints(torch, np, tmp / "native", set())
    print(smi)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


# name: (key in phase 3's results, source, the reference code it
# replaces); ``launches`` is the slice's --device-native run's
PASS_KERNEL_SOURCES = {
    "quantize_sort4": ("front", "point_cloud_tpu_torch/csrc/quantize_hash.cu",
                       "point_cloud_tpu/ops/sort_pallas.py:220"),
    "mark_pack": ("b3", "point_cloud_tpu_torch/csrc/mark_pack.cu",
                  "point_cloud_tpu/ops/dedup.py:351-422"),
}


def pass_kernel_entry(name: str, passed: dict, sliced: dict, meshed: dict,
                      multihost: dict) -> dict:
    """The kernels line's entry of the fused front end or B3: times and
    bounds from phase 3 at MAIN_LOG_N and by length, launches by path;
    ``launches`` is the slice's ``--device-native`` run's (phase 4)."""
    main_n = 1 << MAIN_LOG_N
    timed = passed["timed"]
    key, source, replaces = PASS_KERNEL_SOURCES[name]
    main_path = "--device-native"
    t = timed[main_n][key]
    by_path = {
        "--device-native": sliced["pass_launches"][name],
        "--device": sliced["device_pass_launches"][name],
        "mesh": meshed["pass_launches"][name],
        "--mesh 1": meshed["mesh1_cli"]["pass_launches"][name],
        "multihost": [r[name] for r in multihost["pass_launches_by_rank"]],
    }
    entry = {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces,
        "launches": by_path[main_path], "launches_path": main_path,
        "max_abs_err": passed["max_abs_err"][key],
        "ms": t["ms"], "wrapper_ms": t["wrapper_ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "bound_memory": "HBM",
        # no single PyTorch call quantizes, hashes and sorts, or marks,
        # audits and packs the sorted rows
        "library_ms": None,
        "n": main_n,
        "launches_by_path": by_path,
        "checked": len(passed["kernels_checked"]),
        "ms_by_n": {n: timed[n][key]["ms"] for n in timed},
        "wrapper_ms_by_n": {n: timed[n][key]["wrapper_ms"] for n in timed},
        "plain_ms_by_n": {n: timed[n][key]["plain_ms"] for n in timed},
        "bound_ms_by_n": {n: timed[n][key]["bound_ms"] for n in timed},
        "unit": "one call on the LiDAR-like cloud's bucket, as the pass "
                "calls it (one launch each, no memset)",
    }
    if key == "front":
        entry.update({
            "also_replaces": "point_cloud_tpu/ops/dedup.py:184-260",
            "unit": "one call on the LiDAR-like cloud's bucket: the tile "
                    "kernel with B2 as its loader (quantize_tile), then "
                    "sort4's merges; bound: 13 B read and 16 B written a row",
            "division_check": passed["division_check"],
            **{f"{k}_by_n": {n: timed[n][key][k] for n in timed} for k in (
                "tile_ms", "sort4_bound_ms")},
            # calls by sorted length on each slice path, and the gather
            # mode's (resident cascade levels) among them
            "launches_by_n_by_path": {
                path: {"all": run["quantize_sort4"],
                       "gather": run["quantize_sort4_gather"]}
                for path, run in (("--device-native", sliced["launches_by_n"]),
                                  ("--device",
                                   sliced["device_launches_by_n"]))},
        })
    return entry


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase", choices=["footprints"],
                    help="run this phase alone, on a store that the CLI's "
                         "--native writes from phase 4's cloud")
    args = ap.parse_args(argv)
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

    if args.phase == "footprints":
        return footprints_alone(torch, np, smi)
    kernel = phase_kernel(torch, np, sort)
    passed = phase_pass(torch, np, dedup, get_pipeline)
    lod = phase_lod(torch, np)
    sort_checked = {1 << log_n for log_n in SORT_SIZES}
    # lengths checked by kernel: sort4's in phase 2, the front end's in 3
    checked = {"sort4": sort_checked,
               "quantize_sort4": {1 << log_n for log_n in PASS_LOG_N}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        sliced = phase_slice(torch, np, checked, tmp)
        framed = phase_frame(torch, np, tmp / "device-native", tmp)
        served = phase_serve(torch, np, tmp / "device-native", tmp, smi,
                             framed["raster"]["sm_clock_mhz_under_load"])
        armed = phase_arms(torch, np, tmp / "device-native", sort_checked)
        meshed = phase_mesh_convert(torch, np, tmp, checked)
        mesh_frame = phase_mesh_frame(torch, np, tmp / "device-native")
        multihost = phase_multihost(np, tmp, checked)
        footprints = phase_footprints(torch, np, tmp / "device-native",
                                      sort_checked)
    pulled = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "point_cloud_tpu", "bench"))
    if pulled:
        raise AssertionError(f"the port pulled in {pulled[:5]}")

    emit({"phase": "profiler", "spans_seen_of_launched": profile_spans})
    emit({"phase": "raster_bound", **{k: framed["raster"][k] for k in (
        "rows", "touched_pixels", "tested_fragments", "fragments", "sms",
        "sm_clock_mhz_under_load", "bytes_bound_ms", "instr_bound_ms",
        "bound_ms", "bound_by", "synthetic_ms",
        "synthetic_tested_fragments")},
        "instructions_per_lit_fragment": K2_INSTR_LIT,
        "instructions_per_rejected_fragment": K2_INSTR_REJECTED})
    print(smi)
    main_n = 1 << MAIN_LOG_N
    bound_ms, bound_by = sort4_bound_ms(main_n)
    frame_launches = framed["frame"]["launches"]
    cull, raster = framed["cull"], framed["raster"]
    arm_launches = armed["result"]["launches"]
    fp_launches = footprints["result"]["launches"]
    by_path = {name: {"orbit": frame_launches[name],
                      "serve": served["launches"][name],
                      "window": served["window"]["launches"][name],
                      "arms": arm_launches[name],
                      "mesh": mesh_frame["launches"][name],
                      "footprints": fp_launches[name]}
               for name in frame_launches}
    if min(by_path["class_rank"].values()) <= 0:
        raise AssertionError(f"a path ran no K5: {by_path['class_rank']}")
    by_fp = footprints["result"]["footprints"]
    fp1 = served["footprint1"]
    rank = framed["rank"]
    emit_k, merge_k = armed["emit"], armed["merge"]
    sort_ms_by_n = {n: statistics.median(t)
                    for n, t in kernel["sort_ms_by_n"].items()}
    sort_plain_by_n = {n: statistics.median(t)
                       for n, t in kernel["plain_ms_by_n"].items()}
    sort_device_by_n = dict(kernel["sort_device_ms_by_n"])
    for n, t in armed["sort_by_n"].items():
        sort_ms_by_n[n] = t["wrapper_ms"]
        sort_plain_by_n[n] = t["plain_ms"]
        sort_device_by_n[n] = t["ms"]
    emit({"kernels": [{
        "name": "sort4", "route": "cuda",
        "source": "point_cloud_tpu_torch/csrc/sort4.cu",
        "replaces": "point_cloud_tpu/ops/sort_pallas.py:220",
        # the slice sorts through the fused front end (its entry below);
        # sort4 itself sorts the mesh's routing and arrival columns
        "launches": meshed["sort4_launches"], "launches_path": "mesh",
        "max_abs_err": kernel["max_abs_err"],
        "ms": kernel["sort_device_ms_by_n"][main_n],
        "wrapper_ms": statistics.median(kernel["sort_ms_by_n"][main_n]),
        "plain_ms": statistics.median(kernel["plain_ms_by_n"][main_n]),
        "bound_ms": bound_ms, "bound_by": bound_by, "bound_memory": "HBM",
        # torch.unique(torch.stack(cols, 1), dim=0) on the same columns:
        # every row is unique (the arrival iota), so it returns sort4's
        # output as rows (checked equal); the port never calls it
        "library_ms": kernel["library_ms"],
        "library_ms_by_n": {main_n: kernel["library_ms"],
                            **armed["sort_library_ms"]},
        "n": main_n,
        "launches_by_path": {
            "--device-native": {"launches": sliced["sort4_launches"],
                                "by_n": sliced["launches_by_n"]["sort4"]},
            "--device": {"launches": sliced["device_sort4_launches"],
                         "by_n": sliced["device_launches_by_n"]["sort4"]},
            "arms": {"launches": arm_launches["sort4"],
                     "by_n": armed["result"]["sort4_launches_by_n"]},
            "mesh": {"launches": meshed["sort4_launches"],
                     "by_n": meshed["sort4_launches_by_n"]},
            "--mesh 1": {
                "launches": meshed["mesh1_cli"]["sort4_launches"],
                "by_n": meshed["mesh1_cli"]["sort4_launches_by_n"]},
            "multihost": {
                "launches": multihost["sort4_launches_by_rank"],
                "by_n": multihost["sort4_launches_by_n_by_rank"]},
            "footprints": {"launches": fp_launches["sort4"],
                           "by_n": footprints["by_n"]},
        },
        "checked_n": sorted(sort_checked),
        "bound_ms_by_n": {n: sort4_bound_ms(n)[0] for n in sort_ms_by_n},
        "ms_by_n": sort_device_by_n,
        "wrapper_ms_by_n": sort_ms_by_n,
        "plain_ms_by_n": sort_plain_by_n,
    }, {
        "name": "cull_classify", "route": "cuda",
        "source": "point_cloud_tpu_torch/csrc/cull.cu",
        "replaces": "point_cloud_tpu/render/kernel.py:205",
        "launches": frame_launches["cull_classify"],
        "max_abs_err": max(cull["max_abs_err"], fp1["cull_err"],
                           footprints["cull_err"]),
        "ms": cull["ms"], "wrapper_ms": cull["wrapper_ms"],
        "plain_ms": cull["plain_ms"],
        "bound_ms": cull["bound_ms"], "bound_by": "bytes",
        "bound_memory": "HBM", "timed_from": "a flushed L2",
        "launches_by_path": by_path["cull_classify"],
        # no single PyTorch call projects, culls and classifies points
        "library_ms": None,
        "n": cull["n"], "inside": cull["inside"],
        "ms_runs": cull["ms_runs"], "plain_ms_runs": cull["plain_ms_runs"],
        # phase 9: the largest bucket's K1 at ladders of 31, 64 and 129
        # rungs (footprints 29, 64, 129), from a flushed L2
        "footprints": {fp: {k: by_fp[fp][k] for k in (
            "rungs", "largest_bucket_n", "k1_ms", "k1_bound_ms")}
            for fp in FOOTPRINT_TIMED},
    }, {
        "name": "splat_raster", "route": "cuda",
        "source": "point_cloud_tpu_torch/csrc/splat.cu",
        "replaces": "point_cloud_tpu/render/splat.py:614",
        "launches": frame_launches["splat_raster"],
        "max_abs_err": max(raster["max_abs_err"], fp1["raster_err"],
                           footprints["raster_err"]),
        "ms": raster["ms"], "wrapper_ms": raster["wrapper_ms"],
        "plain_ms": raster["plain_ms"],
        "bound_ms": raster["bound_ms"], "bound_by": raster["bound_by"],
        "bound_memory": "HBM",
        "bytes_bound_ms": raster["bytes_bound_ms"],
        "instr_bound_ms": raster["instr_bound_ms"],
        "launches_by_path": by_path["splat_raster"],
        # the multi-dispatch arm's class raster at footprint 1 (phase 6)
        "footprint1": {
            "calls_checked": fp1["k2_calls"],
            "max_abs_err": fp1["raster_err"],
            "largest_bucket_ms": fp1["largest_bucket_k2_ms"],
            **{k: fp1[k] for k in ("rows", "fragments", "touched_pixels",
                                   "bytes_bound_ms", "instr_bound_ms")}},
        # no single PyTorch call expands splats into fragments; the
        # scatter_reduce_ of the plain version is only its last step
        "library_ms": None,
        "n": raster["n"], "rows": raster["rows"],
        "fragments": raster["fragments"],
        "tested_fragments": raster["tested_fragments"],
        "touched_pixels": raster["touched_pixels"],
        "ms_runs": raster["ms_runs"],
        "plain_ms_runs": raster["plain_ms_runs"],
        "unit": "the one raster launch of the frame's largest bucket",
        # phase 9: the largest bucket's one launch at footprints 29, 64, 129
        "footprints": {fp: {k: by_fp[fp][k] for k in (
            "rungs", "largest_window", "segments_a_bucket", "k2_ms",
            "k2_rows", "k2_tested_fragments", "k2_bound_ms", "k2_bound_by")}
            for fp in FOOTPRINT_TIMED},
        # phase 9: the multi-dispatch arm's widest class raster at 129
        "multi_dispatch_wide": {
            FOOTPRINT_WIDE_TIMED:
                by_fp[FOOTPRINT_WIDE_TIMED]["multi_dispatch_wide_k2"]},
    }, {
        "name": "emit_fragments", "route": "cuda",
        "source": "point_cloud_tpu_torch/csrc/fragments.cu",
        "replaces": "point_cloud_tpu/render/splat.py:372",
        "launches": arm_launches["emit_fragments"], "max_abs_err": 0,
        "ms": emit_k["ms"], "wrapper_ms": emit_k["wrapper_ms"],
        "plain_ms": emit_k["plain_ms"], "bound_ms": emit_k["bound_ms"],
        "bound_by": emit_k["bound_by"], "bound_memory": "HBM",
        "timed_from": "a flushed L2",
        "launches_by_path": {
            "arms": arm_launches["emit_fragments"],
            "footprints": fp_launches["emit_fragments"]},
        # no single PyTorch call expands splats into fragment columns
        "library_ms": None,
        "length": emit_k["length"], "rows": emit_k["rows"],
        "tested_fragments": emit_k["tested"],
        "ms_runs": emit_k["ms_runs"], "plain_ms_runs": emit_k["plain_ms_runs"],
        "unit": "one launch on the sorted frame's largest bucket",
        # phase 9: the sorted arm's largest bucket at footprints 64 and 129
        "footprints": {fp: {k: by_fp[fp][k] for k in (
            "k3_ms", "k3_length", "k3_classes", "k3_bound_ms", "k3_bound_by")}
            for fp in FOOTPRINT_ARMS_AT if "k3_ms" in by_fp[fp]},
    }, {
        "name": "sorted_merge", "route": "cuda",
        "source": "point_cloud_tpu_torch/csrc/sorted_merge.cu",
        "replaces": "point_cloud_tpu/render/splat.py:537",
        "launches": arm_launches["sorted_merge"], "max_abs_err": 0,
        "ms": merge_k["ms"], "wrapper_ms": merge_k["wrapper_ms"],
        "plain_ms": merge_k["plain_ms"], "bound_ms": merge_k["bound_ms"],
        "bound_by": merge_k["bound_by"], "bound_memory": "HBM",
        "timed_from": "a flushed L2",
        "launches_by_path": {
            "arms": arm_launches["sorted_merge"],
            "footprints": fp_launches["sorted_merge"]},
        # scatter_reduce_(..., "amin") over the winners is only the plain
        # version's last step, not the same function
        "library_ms": None,
        **{k: merge_k[k] for k in (
            "length", "valid_rows", "winners", "ms_runs", "plain_ms_runs",
            "dense_rows", "dense_winners", "dense_bound_ms", "dense_ms",
            "dense_ms_runs", "dense_wrapper_ms", "dense_plain_ms")},
        "unit": "one launch on the sorted frame's largest bucket; bound_ms "
                "counts its rows up to the _NO_ID tail",
    }, {
        "name": "class_rank", "route": "cuda",
        "source": "point_cloud_tpu_torch/csrc/class_rank.cu",
        "replaces": "point_cloud_tpu/render/splat.py:96-139",
        "also_replaces": ["point_cloud_tpu/render/splat.py:62-94",
                          "point_cloud_tpu/render/splat.py:791-835"],
        "launches": frame_launches["class_rank"],
        "max_abs_err": max(
            rank["checks"]["frame"]["max_abs_err"],
            rank["checks"]["synthetic_and_edges"]["max_abs_err"],
            rank["checks"]["sweep"]["max_abs_err"], armed["rank_err"],
            mesh_frame["class_rank_check"]["max_abs_err"],
            footprints["rank_err"]),
        "ms": rank["ms"], "wrapper_ms": rank["wrapper_ms"],
        "plain_ms": rank["plain_ms"], "bound_ms": rank["bound_ms"],
        "bound_by": rank["bound_by"], "bound_memory": "HBM",
        # torch.sort(cls, stable=True) and torch.bincount(cls): the same
        # permutation and counts (checked equal); the port never calls them
        "library_ms": rank["library_ms"],
        "timed_from": "a warm L2 (K1 has just written the rung column)",
        "launches_by_path": by_path["class_rank"],
        "n": rank["n"], "classes": rank["classes"], "kept": rank["kept"],
        "ms_by_kernel": rank["ms_by_kernel"], "ms_runs": rank["ms_runs"],
        "plain_ms_runs": rank["plain_ms_runs"],
        "sweep": rank["checks"]["sweep"],
        "plain_kernels_ms": rank["plain_kernels_ms"],
        "unit": "one compact_classes call on the orbit frame's largest "
                "bucket: three launches (histogram, scan, scatter); bound: "
                "4 B read a row, 4 B written a perm slot (2N)",
        # phase 9: the largest bucket's ranking at footprints 29, 64, 129
        "footprints": {fp: {k: by_fp[fp]["k5"][k] for k in (
            "n", "classes", "kept", "ms", "wrapper_ms", "plain_ms",
            "bound_ms", "library_ms", "ms_by_kernel")}
            for fp in FOOTPRINT_TIMED},
    }, lod_kernel_entry(lod, framed["lod"]),
        *(pass_kernel_entry(name, passed, sliced, meshed, multihost)
          for name in PASS_KERNEL_SOURCES)]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
