"""Frame orchestration: streamed cells -> culled splats -> image
(counterpart of render/renderer.py).

Visible cells are sorted by camera distance and grouped into
ilog2(distance) buckets (reference point.rs:128-143); buckets render near
to far, and each bucket's cull tests occlusion against the depth the
nearer buckets left in the framebuffer. The frame ends in one packed
device-to-host copy into pinned memory (image, the buckets' counts,
optionally the depth plane) that :meth:`PointRenderer.render_finish`
waits for; nothing before it waits on the card.

Every render arm of the reference runs (renderer.py:536-1005):

- the bucket megakernel (``megakernel``, ``compact_raster``, not
  ``raster_mode="sorted"``): one
  :func:`~point_cloud_tpu_torch.render.splat.render_bucket_pass` a bucket
  (K1, the rung ranking, one K2 launch), with chunked rungs
  (``chunked_raster``) or static row budgets from the sticky pow2 ladder
  (:meth:`PointRenderer._survivor_buffer_size`); with ``frame_fusion``
  every bucket's chain and the packed resolve in one
  :func:`~point_cloud_tpu_torch.render.splat.render_frame_pass` call;
- the multi-dispatch ladder otherwise (:meth:`PointRenderer._multi_dispatch`):
  K1 ranks the kept rows into the ``classing`` windows and lands the
  "cum" counts; the classes raster through K2 (one launch over every
  class's region of ``compact_classes``, or ``compact_rows`` class by
  class without ``fused_compaction``), or with ``raster_mode="sorted"``
  through the sorted raster: K3 emits every class's fragments as the four
  sort columns, ``sort4`` orders them, K4 merges the first fragment of
  each pixel run. A bucket without history, and ``compact_raster`` off,
  raster every kept row through the footprint window.

Every footprint renders, in every arm, as the reference draws it: K1
takes a ladder of any length (a footprint F gives F - 1 sub-rungs), K2 a
table of any number of segments and windows of any size, K3 any number of
classes. At footprint 1 the megakernel is off, as in the reference
(renderer.py:536-541): the multi-dispatch arm runs, with a budget sized
from the last frame. Only a footprint below 1 raises ``ValueError``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.metadata import Metadata
from ..ops.dedup import pad_to_bucket
from ..ops.runtime import resolve_device
from ..utils.tracing import count, stage
from . import kernel, splat
from .camera import Camera
from .kernel import MAX_HIERARCHIES, build_loaded_cells_hash, lod_select
from .streaming import CellStreamer

# overflow windows for splats wider than the footprint (renderer.py:37-45)
LARGE_WINDOWS = (9, 17, 33, 65)
# sub-footprint rungs of the odd ladder (renderer.py:47-56)
SMALL_WINDOWS = (1, 3, 5, 7)


def raster_bucket(n: int, minimum: int = 1 << 10) -> int:
    """Power-of-two raster buffer size (renderer.py:59-75)."""
    return pad_to_bucket(n, minimum)


@dataclass
class RenderSettings:
    """The reference's settings (renderer.py:78-197), every field with the
    same default; see there for each knob's measured rationale. Every
    ``footprint`` of 1 or more renders on either device."""

    width: int = 1280
    height: int = 720
    voronoi: bool = True
    size_by_distance: bool = False
    max_hierarchy: int = 0
    occlusion: bool = True
    depth_pyramid: bool = True
    footprint: int = 5
    hidden_hierarchies: set = field(default_factory=set)
    transfer_depth: bool = True
    compact_raster: bool = True
    raster_mode: str = "auto"
    fused_compaction: bool = True
    classing: object = "auto"
    megakernel: bool = True
    sub_rungs: bool = True
    even_sub_rungs: bool = True
    even_overflow_rungs: bool = True
    chunked_raster: bool = True
    frame_fusion: bool = False


def check_ported(settings: RenderSettings) -> None:
    """Raise for a footprint below 1, the one setting no renderer draws."""
    if settings.footprint < 1:
        raise ValueError(f"footprint {settings.footprint}: a splat window is "
                         "at least 1 pixel")


def hierarchy_tables(metadata: Metadata) -> tuple[np.ndarray, np.ndarray]:
    """(cell_size, spacing) per hierarchy, padded to MAX_HIERARCHIES
    (renderer.py:200-209)."""
    sizes = np.zeros(MAX_HIERARCHIES, np.float32)
    spacings = np.zeros(MAX_HIERARCHIES, np.float32)
    for h in range(min(metadata.hierarchies, MAX_HIERARCHIES)):
        cs = metadata.config.cell_size(h)
        sizes[h] = cs
        spacings[h] = metadata.config.cell_spacing(cs)
    return sizes, spacings


def read_bucket_points(bucket_cells) -> tuple:
    """(positions, colors, hierarchy) of a bucket's rows: each gathered
    cell's points (:meth:`Cell.point_columns`) read once, in gather order,
    and copied once (one ``render.cells_read`` a cell)."""
    count("render.cells_read", len(bucket_cells))
    positions, colors, hierarchy = [], [], []
    for c in bucket_cells:
        pos, col = c[3].point_columns()
        positions += pos
        colors += col
        hierarchy.append(np.full(sum(len(p) for p in pos), c[2].hierarchy,
                                 np.int32))
    return (np.concatenate(positions), np.concatenate(colors),
            np.concatenate(hierarchy))


def _bounded_put(cache: dict, key, value, limit: int) -> None:
    if len(cache) > limit:
        cache.pop(next(iter(cache)))
    cache[key] = value


class PointRenderer:
    """Renders one frame from a CellStreamer's loaded set on ``device``
    (``"cuda"`` unless the caller asks for the CPU)."""

    def __init__(self, metadata: Metadata,
                 settings: RenderSettings | None = None, device="cuda"):
        self.metadata = metadata
        self.settings = settings or RenderSettings()
        self.device = resolve_device(device)
        self.framebuffer = None  # the last frame's, for inspection
        self._bucket_cache: dict = {}
        self._lod_cache: dict = {}
        self._ids_cache: dict = {}
        self._color_cache: dict = {}
        self._hash_cache = None
        self._const_cache = None
        self._threshold_cache: dict = {}
        self._survivor_counts: dict = {}
        self._buffer_sizes: dict = {}

    def gather_points(self, streamer: CellStreamer, camera: Camera):
        """Loaded cells as (bucket, distance, cell_id, cell, generation),
        sorted by (bucket, distance) (renderer.py:219-240). Reads no point:
        a cell is empty by its header counters, its generation is taken
        before any read, and a bucket reads its cells' points only when it
        misses the device cache (:func:`read_bucket_points`)."""
        cells = []
        cam = camera.transform.translation
        for cell_id, cell in streamer.loaded.items():
            if cell_id.hierarchy in self.settings.hidden_hierarchies:
                continue
            generation = cell.generation
            if cell.number_of_points + cell.number_of_overflow_points == 0:
                continue
            distance = float(np.linalg.norm(cell.pos - cam))
            bucket = max(int(distance).bit_length() - 1, 0)
            cells.append((bucket, distance, cell_id, cell, generation))
        cells.sort(key=lambda c: (c[0], c[1]))
        return cells

    def _upload(self, array: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(array), device=self.device)

    def _bucket_device_arrays(self, bucket_cells):
        """(positions, hierarchy, valid, colors, n_real) for one bucket,
        padded to a pow2 row count and cached by the bucket's cells
        (renderer.py:242-300): a steady orbit reads and uploads no
        points."""
        key = tuple((c[2], c[4]) for c in bucket_cells)
        hit = self._bucket_cache.get(key)
        if hit is not None:
            count("render.bucket_hit")
            return hit
        count("render.bucket_miss")
        with stage("render.upload"):
            positions, colors, point_hier = read_bucket_points(bucket_cells)
            n_real = len(positions)
            n = pad_to_bucket(max(n_real, 1), minimum=1 << 12)
            if n != n_real:
                positions = np.concatenate(
                    [positions, np.zeros((n - n_real, 3), np.float32)])
                point_hier = np.concatenate(
                    [point_hier, np.zeros(n - n_real, np.int32)])
            valid = np.zeros(n, bool)
            valid[:n_real] = True
            entry = (self._upload(positions.astype(np.float32, copy=False)),
                     self._upload(point_hier), self._upload(valid), colors,
                     n_real)
        _bounded_put(self._bucket_cache, key, entry, 64)
        return entry

    def _small_ladder(self) -> tuple:
        s = self.settings
        if s.even_sub_rungs:
            return tuple(range(1, s.footprint))
        return tuple(k for k in SMALL_WINDOWS if k < s.footprint)

    def _overflow_ladder(self) -> tuple:
        s = self.settings
        ks = []
        if s.even_overflow_rungs:
            ks += list(range(s.footprint + 1, LARGE_WINDOWS[0]))
        ks += [k for k in LARGE_WINDOWS if k > s.footprint]
        return tuple(k for k in ks if k > s.footprint)

    def _thresholds(self, ks: tuple) -> torch.Tensor:
        """The (R,) f32 device thresholds k/2 of the rungs ``ks`` (one
        rung, inf, for ``ks == ()``: every kept row in class 0), uploaded
        once a ladder."""
        dev = self._threshold_cache.get(ks)
        if dev is None:
            dev = self._threshold_cache[ks] = self._upload(np.asarray(
                [k / 2.0 for k in ks] or [math.inf], np.float32))
        return dev

    def _rungs(self) -> tuple[tuple, tuple, torch.Tensor]:
        """(sub rungs, overflow rungs, thresholds) of the megakernel's
        ladder."""
        s = self.settings
        subs = self._small_ladder() if s.sub_rungs else ()
        overs = self._overflow_ladder()
        return subs, overs, self._thresholds(subs + (s.footprint,) + overs)

    def _ladder(self) -> tuple:
        """The full window ladder (renderer.py:358-375): every small rung,
        the footprint, the overflow rungs. The multi-dispatch arm's "cum"
        counts count the kept splats that fit each."""
        return (self._small_ladder() + (self.settings.footprint,)
                + self._overflow_ladder())

    def _survivor_buffer_size(self, key, n: int, minimum: int = 1 << 10):
        """Sticky pow2 raster budget from the latest landed count of
        ``key``; None until the key has one (renderer.py:310-332). The held
        size changes only when the count outgrows it (under 15% headroom)
        or shrinks well below it (under half used)."""
        count = self._survivor_counts.get(key)
        if count is None:
            return None
        held = self._buffer_sizes.get(key)
        if held is not None and count * 1.15 <= held <= count * 2.6:
            return held
        held = raster_bucket(max(int(count * 1.3), 1), minimum)
        self._buffer_sizes[key] = held
        return held

    def _mega_static(self, bucket: int, n: int, subs: tuple,
                     overs: tuple) -> tuple:
        """(out_size, overflow_rows, overflow_ks, sub_rows, sub_ks) of a
        bucket's megakernel pass (renderer.py:545-616): no budgets for
        chunked rungs; else the footprint raster's sticky budget (its own
        landed count with sub rungs, the kept total without) and each
        rung's on a coarse ladder."""
        s = self.settings
        if s.chunked_raster:
            return (0, (), overs, (), subs)
        held = self._survivor_buffer_size(
            (bucket, s.footprint if subs else "a"), n)

        def rung_budget(k, ladder=(64, 1024, 16384, 65536)):
            held_k = self._survivor_buffer_size((bucket, k), n,
                                                minimum=ladder[0])
            v = min(held_k or ladder[0], n)
            for c in ladder:
                if v <= c:
                    return min(c, n)
            return n

        return (min(held, n) if held else n,
                tuple(rung_budget(k) for k in overs), overs,
                tuple(rung_budget(k, ladder=(1024, 16384, 65536))
                      for k in subs), subs)

    def _frame_constants(self, camera: Camera, far_distances: np.ndarray):
        """view, projection, camera position and far distances on the
        device, through one non-blocking copy from pinned memory."""
        host = np.concatenate([
            camera.view_matrix().astype(np.float32).reshape(-1),
            camera.projection_matrix().astype(np.float32).reshape(-1),
            np.asarray(camera.transform.translation, np.float32),
            far_distances.astype(np.float32),
        ])
        if self.device.type == "cuda":
            pinned = torch.empty(host.shape, dtype=torch.float32,
                                 pin_memory=True)
            pinned.numpy()[:] = host
            dev = pinned.to(self.device, non_blocking=True)
        else:
            dev = torch.from_numpy(host)
        return (dev[0:16].view(4, 4), dev[16:32].view(4, 4), dev[32:35],
                dev[35:35 + MAX_HIERARCHIES])

    def render(self, streamer: CellStreamer, camera: Camera,
               streaming_frustums=None, paused: bool = False):
        """Returns (rgb (H,W,3) u8, depth (H,W) f32 or None, stats dict);
        synchronous. For overlapped frames use :meth:`render_pipelined`."""
        return self.render_finish(
            self.render_start(streamer, camera, streaming_frustums, paused))

    def render_start(self, streamer: CellStreamer, camera: Camera,
                     streaming_frustums=None, paused: bool = False) -> dict:
        """Queue a frame's whole device chain without waiting for it;
        returns a handle for :meth:`render_finish`."""
        s = self.settings
        check_ported(s)
        dev = self.device
        # spans: the walks over every loaded cell (render.gather), each
        # cache miss's host arrays and copies (render.upload), the queued
        # device chain (render.dispatch)
        with stage("render.gather"):
            loaded_table = streamer.loaded_cells_table()
            table_key = loaded_table.tobytes()
            cells = self.gather_points(streamer, camera)
        if self._hash_cache is None or self._hash_cache[0] != table_key:
            with stage("render.upload"):
                self._hash_cache = (
                    table_key,
                    self._upload(build_loaded_cells_hash(loaded_table)))
        loaded_hash = self._hash_cache[1]

        far_distances = np.zeros(MAX_HIERARCHIES, np.float32)
        if streaming_frustums is not None:
            fd = streamer.frustum_far_distances(
                streaming_frustums, camera.transform)
            far_distances[: len(fd)] = fd

        # the metadata tables, keyed by the hierarchy count: in-app
        # conversion grows metadata.hierarchies in place
        const_key = (id(self.metadata), int(self.metadata.hierarchies))
        if self._const_cache is None or self._const_cache[0] != const_key:
            sizes, spacings = hierarchy_tables(self.metadata)
            self._const_cache = (const_key, self._upload(sizes),
                                 self._upload(spacings))
        _, sizes_dev, spacings_dev = self._const_cache
        view_dev, proj_dev, cam_dev, fars_dev = self._frame_constants(
            camera, far_distances)
        consts = (view_dev, proj_dev, cam_dev, spacings_dev, fars_dev)
        use_occ = s.occlusion and not paused
        use_pyr = use_occ and s.depth_pyramid
        subs, overs, thresholds = self._rungs()
        use_mega = (s.megakernel and s.compact_raster and s.footprint > 1
                    and s.raster_mode != "sorted")
        fused = use_mega and s.frame_fusion

        framebuffer = splat.make_framebuffer(s.height, s.width, dev)
        all_colors = [np.zeros((1, 4), np.uint8)]
        id_base = 1
        total_in = 0
        frame_vecs: list = []
        frame_bucket_keys: list = []
        fused_args: list = []
        fused_static: list = []
        i = 0
        while i < len(cells):
            bucket = cells[i][0]
            bucket_cells = []
            while i < len(cells) and cells[i][0] == bucket:
                bucket_cells.append(cells[i])
                i += 1
            pos_dev, hier_dev, valid_dev, colors, n_real = (
                self._bucket_device_arrays(bucket_cells))
            n = pos_dev.shape[0]
            total_in += n_real
            bucket_key = tuple((c[2], c[4]) for c in bucket_cells)
            ikey = (bucket_key, id_base)
            ids_dev = self._ids_cache.get(ikey)
            if ids_dev is None:
                with stage("render.upload"):
                    point_ids = np.zeros(n, np.int32)
                    point_ids[:n_real] = np.arange(
                        id_base, id_base + n_real, dtype=np.int32)
                    ids_dev = self._upload(point_ids)
                _bounded_put(self._ids_cache, ikey, ids_dev, 64)
            with stage("render.dispatch"):
                lkey = (bucket_key, table_key)
                hier_base = self._lod_cache.get(lkey)
                if hier_base is None:
                    hier_base = lod_select(
                        pos_dev, hier_dev, sizes_dev,
                        max(int(self.metadata.hierarchies), 1), loaded_hash)
                    _bounded_put(self._lod_cache, lkey, hier_base, 64)
                rows = (pos_dev, hier_base, valid_dev, ids_dev)
                if use_mega:
                    static = self._mega_static(bucket, n, subs, overs)
                    counts_vec = None  # the fused pass lands it in the pack
                    if fused:
                        fused_args.append(rows)
                        fused_static.append(static)
                    else:
                        framebuffer, counts_vec = self._bucket_pass(
                            framebuffer, rows, static, consts, thresholds,
                            use_occ, use_pyr)
                    frame_vecs.append((bucket,
                                       subs + (s.footprint,) + overs,
                                       counts_vec, "excl"))
                else:
                    counts_vec = self._multi_dispatch(
                        framebuffer, bucket, rows, consts, use_occ, use_pyr)
                    frame_vecs.append((bucket, self._ladder(), counts_vec,
                                       "cum"))
            all_colors.append(colors)
            frame_bucket_keys.append(bucket_key)
            id_base += n_real

        # the color table, padded to pow2 and cached per frame composition
        ckey = tuple(frame_bucket_keys)
        color_dev = self._color_cache.get(ckey)
        if color_dev is None:
            with stage("render.upload"):
                color_table = np.concatenate(all_colors)
                padded = pad_to_bucket(len(color_table), minimum=1 << 10)
                color_table = np.concatenate(
                    [color_table,
                     np.zeros((padded - len(color_table), 4), np.uint8)])
                color_dev = self._upload(color_table)
            _bounded_put(self._color_cache, ckey, color_dev, 16)

        vec_meta = [(b, ks, len(ks) + 1, kind) for b, ks, _, kind in frame_vecs]
        total_counts = sum(m[2] for m in vec_meta)
        stats = {"cells": len(cells), "points_in": total_in,
                 "buckets": len(frame_vecs)}
        if fused_args and total_counts > splat.PACK_COUNTS:
            # the packed tail cannot carry this frame's counts: the same
            # chains bucket by bucket, then the synchronous readback
            # (renderer.py:926-951)
            with stage("render.dispatch"):
                for bi, (rows, static) in enumerate(zip(fused_args,
                                                        fused_static)):
                    framebuffer, counts_vec = self._bucket_pass(
                        framebuffer, rows, static, consts, thresholds,
                        use_occ, use_pyr)
                    b, ks, _, kind = frame_vecs[bi]
                    frame_vecs[bi] = (b, ks, counts_vec, kind)
            fused_args = []
        if total_counts <= splat.PACK_COUNTS:
            with stage("render.dispatch"):
                if fused_args:
                    packed, framebuffer = splat.render_frame_pass(
                        tuple(fused_args), *consts, s.size_by_distance,
                        s.max_hierarchy, color_dev, thresholds,
                        height=s.height, width=s.width,
                        footprint=s.footprint, voronoi=s.voronoi,
                        use_occlusion=use_occ,
                        bucket_static=tuple(fused_static),
                        with_depth=s.transfer_depth,
                        chunked=s.chunked_raster, use_pyramid=use_pyr)
                else:
                    counts = (torch.cat([v for _, _, v, _ in frame_vecs])
                              if frame_vecs
                              else torch.zeros(1, dtype=torch.int32,
                                               device=dev))
                    packed = splat.pack_frame(framebuffer, color_dev, counts,
                                              s.height, s.width,
                                              s.transfer_depth)
                readback = _start_readback(packed)
            self.framebuffer = framebuffer
            return {"vec_meta": vec_meta, "stats": stats, "height": s.height,
                    "width": s.width, "with_depth": s.transfer_depth,
                    **readback}
        # more counts than the packed tail holds: resolve and read back
        # synchronously (renderer.py:989-1005)
        self.framebuffer = framebuffer
        with stage("render.dispatch"):
            rgb, depth = splat.resolve_framebuffer(framebuffer, color_dev,
                                                   s.height, s.width)
            flat = torch.cat([v for _, _, v, _ in frame_vecs]).cpu().numpy()
            rgb = rgb.cpu().numpy()
            depth = depth.cpu().numpy() if s.transfer_depth else None
        stats["points_visible"] = self._land_count_vecs(vec_meta, flat)
        return {"rgb": rgb, "depth": depth, "stats": stats}

    def _bucket_pass(self, framebuffer, rows, static, consts, thresholds,
                     use_occ: bool, use_pyr: bool):
        """One bucket's megakernel pass (:func:`splat.render_bucket_pass`)
        with the frame's settings; returns (framebuffer, counts_vec)."""
        s = self.settings
        out_size, orows, oks, srows, sks = static
        return splat.render_bucket_pass(
            framebuffer, *rows[:4], *consts, s.size_by_distance,
            s.max_hierarchy, thresholds, height=s.height, width=s.width,
            footprint=s.footprint, voronoi=s.voronoi, use_occlusion=use_occ,
            use_pyramid=use_pyr, overflow_ks=oks, sub_ks=sks,
            out_size=out_size, overflow_rows=orows, sub_rows=srows,
            chunked=s.chunked_raster)

    def _multi_dispatch(self, framebuffer, bucket: int, rows, consts,
                        use_occ: bool, use_pyr: bool):
        """One bucket of the multi-dispatch ladder (renderer.py:648-889),
        rastered into ``framebuffer`` in place; returns its "cum" counts
        vector over the full ladder (:func:`kernel.fit_counts`).

        Footprint classing: ``classing="auto"`` turns the ladder (the
        footprint class, which then holds every small splat, and the
        overflow rungs) on for a bucket the frame after an overflow count
        lands; ``True`` always runs it, sub-footprint rungs included;
        ``False`` never. K1 ranks the kept rows into the classes. A class
        whose landed count is 0 is skipped; a bucket without landed counts
        (its first sight), or with classing off, rasters its kept rows
        through the footprint window, at most the kept total's sticky
        budget of them when ``compact_raster`` is on."""
        s = self.settings
        pos_dev, hier_base, valid_dev, ids_dev = rows
        view_dev, proj_dev, cam_dev, spacings_dev, fars_dev = consts
        n = pos_dev.shape[0]
        h, w, fp = s.height, s.width, s.footprint
        landed = self._survivor_counts
        overflow_ks = self._overflow_ladder()
        auto = s.classing == "auto"
        if auto:
            wanted = any((landed.get((bucket, k)) or 0) > 0
                         for k in overflow_ks)
        else:
            wanted = bool(s.classing)
        use_classes = s.compact_raster and fp > 1 and wanted
        windows = ()
        if use_classes:
            windows = ((fp,) if auto else self._small_ladder() + (fp,))
            windows += overflow_ks
        depth = coarse = None
        if use_occ:
            depth = splat.framebuffer_depth(framebuffer, h, w)
            if use_pyr:
                coarse = kernel.coarse_depth_grid(depth)
        keep, _, view_pos, ndc, radius, rmax, rung = kernel.cull_classify(
            pos_dev, hier_base, valid_dev, view_dev, proj_dev, cam_dev,
            spacings_dev, fars_dev, s.size_by_distance, s.max_hierarchy,
            self._thresholds(windows), w, h, depth=depth, coarse=coarse)
        counts_vec = kernel.fit_counts(keep, rmax,
                                       self._thresholds(self._ladder()))
        row_args = (view_pos, ndc, radius, ids_dev)

        def class_key(k):
            # the auto ladder's footprint class holds every small splat:
            # it sizes and skips from the bucket's kept total
            return (bucket, "a") if auto and k == fp else (bucket, k)

        outs = [self._survivor_buffer_size(
            class_key(k), n, minimum=4 if k > fp else 1 << 10)
            for k in windows]
        if not use_classes or None in outs:
            out_all = n  # no history, or no compaction: every kept row
            if not use_classes and s.compact_raster:
                held = self._survivor_buffer_size((bucket, "a"), n)
                if held is not None and held < n:
                    out_all = held
            splat.raster_compacted(framebuffer, *row_args, keep, proj_dev, h,
                                   w, fp, s.voronoi, out_all)
            return counts_vec
        live = [(ci, k, out_k) for ci, (k, out_k) in enumerate(zip(windows,
                                                                   outs))
                if landed.get(class_key(k)) != 0]
        if not s.fused_compaction and s.raster_mode != "sorted":
            for ci, k, out_k in live:  # class by class: compact, raster
                splat.raster_compacted(framebuffer, *row_args, rung == ci,
                                       proj_dev, h, w, k, s.voronoi,
                                       min(out_k, n))
            return counts_vec
        if not live:  # every class skipped: nothing to raster
            return counts_vec
        perm, counts, offsets = splat.compact_classes(rung, len(windows))
        if s.raster_mode == "sorted":
            classes = tuple(splat.FragmentClass(k, ci, out_k)
                            for ci, k, out_k in live)
            length = pad_to_bucket(splat.fragment_total(classes),
                                   minimum=1 << 10)
            cols = splat.emit_fragment_columns(
                *row_args, perm, offsets, counts, proj_dev, h, w, classes,
                s.voronoi, length)
            pix, bits, ids, _ = splat._sort4_frags(*cols)
            splat.sorted_merge(framebuffer.packed, pix, bits, ids)
            return counts_vec
        # every class's slice in one K2 launch; a budget at or past the
        # bucket drops nothing (renderer.py:857-874)
        segments = tuple(
            splat.Segment(k, ci, out_k if out_k < n else splat.NO_CAP, False)
            for ci, k, out_k in live)
        splat.splat_raster_segments(framebuffer.packed, *row_args, perm,
                                    offsets, counts, proj_dev, h, w,
                                    segments, s.voronoi)
        return counts_vec

    def _land_count_vecs(self, vec_meta, flat) -> int:
        """Land a frame's counts vectors in ``_survivor_counts`` and return
        its visible total (renderer.py:1007-1044): (bucket, "a") is the
        kept total, (bucket, k) the k-rung's exclusive count."""
        counts = self._survivor_counts
        visible = 0
        pos = 0
        for bucket, ks, length, kind in vec_meta:
            vals = flat[pos : pos + length]
            pos += length
            keep_total = int(vals[0])
            visible += keep_total
            counts[(bucket, "a")] = keep_total
            if kind == "excl":
                for i, k in enumerate(ks):
                    counts[(bucket, k)] = int(vals[1 + i])
                continue
            prev = 0
            for i, k in enumerate(ks):
                cum = int(vals[1 + i])
                counts[(bucket, k)] = (keep_total - prev if k == ks[-1]
                                       else cum - prev)
                prev = cum
        return visible

    def render_finish(self, handle: dict):
        """Wait for a frame started by :meth:`render_start`; returns (rgb,
        depth, stats) and lands the frame's counts."""
        if "rgb" in handle:
            return handle["rgb"], handle["depth"], handle["stats"]
        height, width = handle["height"], handle["width"]
        stats = handle["stats"]
        with stage("render.wait"):
            if handle["event"] is not None:
                handle["event"].synchronize()
        buf = handle["host"].numpy()
        hw3 = height * width * 3
        rgb = buf[:hw3].reshape(height, width, 3).copy()
        cvals = buf[hw3 : hw3 + 4 * splat.PACK_COUNTS].view(np.int32)
        stats["points_visible"] = self._land_count_vecs(
            handle["vec_meta"], cvals)
        depth = None
        if handle["with_depth"]:
            off = hw3 + 4 * splat.PACK_COUNTS
            depth = buf[off:].view(np.float32).reshape(height, width).copy()
        return rgb, depth, stats

    def render_pipelined(self, streamer: CellStreamer, camera: Camera,
                         streaming_frustums=None, paused: bool = False):
        """Queue this frame, return the PREVIOUS frame's image (None on the
        first call): frame k+1's device work overlaps frame k's readback
        (renderer.py:1072-1091). :meth:`render_flush` drains the last."""
        handle = self.render_start(streamer, camera, streaming_frustums,
                                   paused)
        prev = getattr(self, "_inflight_frame", None)
        self._inflight_frame = handle
        if prev is None:
            return None
        return self.render_finish(prev)

    def render_flush(self):
        """Finish the in-flight pipelined frame (None if none)."""
        prev = getattr(self, "_inflight_frame", None)
        self._inflight_frame = None
        if prev is None:
            return None
        return self.render_finish(prev)


def _start_readback(packed: torch.Tensor) -> dict:
    """Start the packed frame's copy to the host: on the card a
    non-blocking copy into pinned memory and an event that render_finish
    waits on (the handle keeps both alive)."""
    if packed.device.type == "cuda":
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return {"packed": packed, "host": host, "event": event}
    return {"packed": packed, "host": packed, "event": None}
