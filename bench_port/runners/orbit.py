"""The viewer's frame loop on an orbit around a block of inputs' store.

Set-up writes the store of the configuration's inputs ``mix["inputs"]``
with the reference's one-batch store writer (``reference/store.py``),
opens it in a ``Viewer`` at the mix's size with default settings, settles
the view at frame 0's pose and renders a few frames there. Each frame of the window
sets the camera to frame k's pose (on the circle of radius
``radius_extent`` x the cloud's extent at ``height_extent`` x the extent,
``deg_per_frame`` degrees on from a start angle drawn from the seed,
looking at the centre), then runs ``update(dt)`` and ``render_pipelined()``
as the window loop does; loads stay asynchronous. A traced run also
runs the window under the program's ``StageTimer``: its spans on the main
thread inside the window join the benchmark's, and its counters go on the
run record as ``program_counters``.

The check: every frame whose index the seed picks, and the last, against
the reference frame of the cells the viewer held when it started that
frame (the streaming layer is followed from the program's state); then
the streaming layer alone: after the window the view settles at the last
pose, its loaded set must be the reference's visible set, and its frame
the reference frame of that set.
"""

from __future__ import annotations

import contextlib
import threading
import time

import numpy as np

from .. import gen
from ..reference import frame as ref_frame
from ..reference import store as ref_store
from ..reference import view as ref_view

MAX_FRAMES = 1 << 20
K2_OPS_PER_FRAGMENT = 20
K1_OPS_PER_ROW = 60


def picks(seed: int, tag: int, n: int, every: int) -> np.ndarray:
    """Which of items 0..n-1 the check takes: about one in ``every``,
    drawn from the seed."""
    return gen.rng_for(seed, 4, tag).integers(every, size=n) == 0


def settle(viewer, dt: float, limit: int = 20_000) -> None:
    for _ in range(limit):
        viewer.update(dt)
        if not viewer.streamer.loading and \
                len(viewer.streamer.should_load) == 0:
            return
    raise RuntimeError("the view did not settle")


def run(ctx) -> dict:
    import torch

    from point_cloud_tpu_torch.ops.runtime import load_kernels
    from point_cloud_tpu_torch.render.renderer import RenderSettings
    from point_cloud_tpu_torch.render.transform import Transform
    from point_cloud_tpu_torch.utils import tracing
    from point_cloud_tpu_torch.viewer.app import Viewer

    scene, mix = ctx.config["scene"], ctx.mix
    width, height, dt = int(mix["width"]), int(mix["height"]), mix["dt"]
    with ctx.phase("inputs"):
        cloud = gen.decoded_inputs(scene, ctx.seed, mix["inputs"],
                                   ctx.device)
    store_dir = ctx.workdir / "store"
    with ctx.phase("store"):
        meta = ref_store.build_store(store_dir, *cloud,
                                     ctx.config["metadata"], ctx.device)
    del cloud
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(ctx.device)

    bmin = np.asarray(meta["bounding_box"]["min"], np.float32)
    bmax = np.asarray(meta["bounding_box"]["max"], np.float32)
    center = (bmin + bmax) / np.float32(2.0)
    extent = float(np.linalg.norm((bmax - bmin) / np.float32(2.0)))
    radius = extent * mix["radius_extent"]
    lift = extent * mix["height_extent"]
    start = float(gen.rng_for(ctx.seed, 3).uniform(0.0, 2 * np.pi))
    step = np.deg2rad(mix["deg_per_frame"])
    up = np.array([0.0, 0.0, 1.0], np.float32)

    def eye(k: int) -> np.ndarray:
        a = start + k * step
        return center + np.array([radius * np.cos(a), radius * np.sin(a),
                                  lift], np.float32)

    viewer = Viewer(RenderSettings(width=width, height=height),
                    device=ctx.device)
    renderer_counts = []
    try:
        viewer.load_metadata(store_dir / "metadata.json")

        def set_pose(k: int) -> None:
            t = Transform.from_translation(eye(k))
            t.look_at(center, up)
            viewer.fly_cam.transform = t
            viewer._camera_dirty = True

        set_pose(0)
        if ctx.device.type == "cuda":
            # the kernels' build (a checkout's first run) is its own step
            with ctx.phase("build"):
                load_kernels()
        with ctx.phase("settle"):
            settle(viewer, dt)
        with ctx.phase("warm"):
            for _ in range(int(mix["warm_frames"])):
                viewer.update(dt)
                viewer.render_pipelined()
            viewer.render_flush()
        if ctx.traced:
            _count_landings(viewer.renderer, renderer_counts)

        pick = picks(ctx.seed, 0, MAX_FRAMES, int(mix["check_every"]))
        held, kept, done = {}, {}, []
        last = None
        k = 0
        # a traced run also keeps the program's own spans and counters
        timer = tracing.StageTimer() if ctx.traced else None
        with timer or contextlib.nullcontext():
            t0 = ctx.start_window()
            while True:
                set_pose(k)
                with ctx.spans.span("frame.update"):
                    viewer.update(dt)
                held[k] = list(viewer.streamer.loaded)
                with ctx.spans.span("frame.render"):
                    out = viewer.render_pipelined()
                now = time.perf_counter()
                if out is not None:
                    done.append((now, out[2]))
                    last = (k - 1, out[0])
                    if pick[k - 1]:
                        kept[k - 1] = out[0]
                k += 1
                # the window closes once its time is up and a frame is back
                if (now - t0 >= ctx.seconds and done) or k == MAX_FRAMES:
                    break
            t1 = time.perf_counter()
        ctx.dtrace.stop()
        program_counters = _program_spans(timer, ctx.spans, t0, t1)
        peak = ctx.peak_bytes()
        del renderer_counts[len(done):]  # landings of the window's frames
        viewer.render_flush()
        kept[last[0]] = last[1]

        # the streaming layer alone, at the last pose, settled
        settle(viewer, dt)
        final_loaded = list(viewer.streamer.loaded)
        final_rgb = viewer.render()[0]
    finally:
        viewer.close()

    aspect = width / height
    far = float(ctx.config["metadata"]["max_cell_size"]) * 5.0
    cells = ref_frame.CellFiles(store_dir)
    worst = 0.0
    for j, rgb in kept.items():
        pose = ref_view.Pose.looking_at(eye(j), center)
        loaded = [(c.hierarchy, tuple(c.index)) for c in held[j]]
        ref = ref_frame.render(cells, loaded, meta, pose, width, height,
                               ctx.device)
        worst = max(worst, _differ_pct(rgb, ref))
    last_pose = ref_view.Pose.looking_at(eye(k - 1), center)
    visible = [c for c in ref_view.visible_cells(meta, last_pose, aspect, far)
               if cells.exists(*c)]
    got = {(c.hierarchy, tuple(c.index)) for c in final_loaded}
    set_differ = len(got.symmetric_difference(visible))
    ref = ref_frame.render(cells, visible, meta, last_pose, width, height,
                           ctx.device)
    settled = _differ_pct(final_rgb, ref)
    ref_store.remove_tree(store_dir)
    limits = mix["limits"]
    times = [t for t, _ in done]
    return {
        "program_counters": program_counters,
        "window": (t0, t1), "frames": len(done),
        "intervals": list(np.diff([t0] + times)),
        "attempted": len(done), "failed": 0,
        "compared": {
            "frame_px_differ_pct": (worst, limits["frame_px_differ_pct"]),
            "settled_px_differ_pct": (settled,
                                      limits["settled_px_differ_pct"]),
            "settled_cells_differ": (set_differ,
                                     limits["settled_cells_differ"]),
        },
        "memory_peak_bytes": peak,
        "frame_work": (_frame_work(done, renderer_counts, width, height)
                       if ctx.traced else None),
        "notes": [f"frames checked: {len(kept)} of {len(done)}; "
                  f"intervals for the p95: {len(done)}"],
    }


def _differ_pct(a: np.ndarray, b: np.ndarray) -> float:
    if a.shape != b.shape:
        return 100.0
    return 100.0 * float(np.any(a != b, axis=-1).mean())


def _program_spans(timer, spans, t0: float, t1: float) -> dict | None:
    """Add the main thread's program spans that lie in the window to
    ``spans`` under their own names; return the program's counters (None
    in an untraced run, which keeps no timer)."""
    if timer is None:
        return None
    main = threading.get_ident()
    for name, s0, s1, tid in timer.intervals:
        if tid == main and t0 <= s0 and s1 <= t1:
            spans.items.append((name, s0, s1))
    return dict(timer.counters)


def _count_landings(renderer, sink: list) -> None:
    """Record each frame's landed rung counts (the renderer's counters of
    kept rows a bucket and rung) as the renderer lands them."""
    land = renderer._land_count_vecs

    def counted(vec_meta, flat):
        sink.append((vec_meta, np.array(flat, np.int64)))
        return land(vec_meta, flat)

    renderer._land_count_vecs = counted


def _frame_work(done, landings, width: int, height: int) -> dict:
    """Bytes and f32 operations the window's frames need at least: K1
    reads a row's position, hierarchy and valid flag and writes what the
    bucket pass reads (54 B) for every row in; K5 reads the rung and
    writes two perm slots (12 B) a row; K2 reads a rastered row (28 B)
    and lands on each pixel at most once (16 B, read and written), for
    at most the fragments its window holds; the resolve reads the plane
    and writes rgb (11 B a pixel)."""
    rows_in = sum(stats["points_in"] for _, stats in done)
    byte_total = 66 * rows_in + 11 * width * height * len(done)
    ops = K1_OPS_PER_ROW * rows_in
    for vec_meta, flat in landings:
        pos = 0
        for _bucket, ks, length, kind in vec_meta:
            counts = flat[pos + 1: pos + length]
            pos += length
            if kind != "excl":
                continue
            frags = sum(int(c) * k * k for c, k in zip(counts, ks))
            byte_total += 28 * int(counts.sum()) + 16 * min(
                frags, width * height)
            ops += K2_OPS_PER_FRAGMENT * frags
    return {"bytes": byte_total, "ops": ops}
