"""Frame orchestration: streamed cells -> culled splats -> image
(counterpart of render/renderer.py).

Visible cells are sorted by camera distance and grouped into
ilog2(distance) buckets (reference point.rs:128-143); buckets render near
to far, and each bucket's cull tests occlusion against the depth the
nearer buckets left in the framebuffer. Each bucket is one
:func:`~point_cloud_tpu_torch.render.splat.render_bucket_pass`: the cull
and classify kernel, the rung ranking and one raster launch per window
rung, all queued without a host sync. The frame ends in one packed
device-to-host copy into pinned memory (image, the buckets' counts,
optionally the depth plane) that :meth:`PointRenderer.render_finish`
waits for.

The port renders the reference's default arm: the per-bucket megakernel
with the chunked rung raster (renderer.py:536-580), and its footprint-1
arm (renderer.py:879-886): every kept row through the 1x1 window, one
segment of the same raster kernel. Settings that select another arm raise
``NotImplementedError`` (ROADMAP.md): ``megakernel``, ``chunked_raster``
and ``compact_raster`` off, ``raster_mode="sorted"`` and ``frame_fusion``
on. ``classing`` and ``fused_compaction`` steer only the multi-dispatch
arm, so they change nothing here.

Two differences from the reference are deliberate. A ``footprint`` outside
1 to ``splat.MAX_WINDOW`` raises ``ValueError`` where the reference draws
any window. At footprint 1 the reference compacts the kept rows into a
budget sized from the last frame (splat.py:65-93) and so can drop rows on
the one frame after a jump in visibility; the port rasters every kept
row.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.metadata import Metadata
from ..ops.dedup import pad_to_bucket
from ..ops.runtime import resolve_device
from . import splat
from .camera import Camera
from .kernel import MAX_HIERARCHIES, build_loaded_cells_hash, lod_select
from .streaming import CellStreamer

# overflow windows for splats wider than the footprint (renderer.py:37-45)
LARGE_WINDOWS = (9, 17, 33, 65)
# sub-footprint rungs of the odd ladder (renderer.py:47-56)
SMALL_WINDOWS = (1, 3, 5, 7)


@dataclass
class RenderSettings:
    """The reference's settings (renderer.py:78-197), every field with the
    same default; see there for each knob's measured rationale. The raster
    kernel draws windows of 1 to ``splat.MAX_WINDOW`` pixels: the ladder
    ends at 65, so only a ``footprint`` outside that range is refused."""

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
    """Raise for a setting whose render arm the port does not have, or a
    footprint outside the raster kernel's windows."""
    if not 1 <= settings.footprint <= splat.MAX_WINDOW:
        raise ValueError(f"footprint {settings.footprint}: the raster kernel "
                         f"draws windows of 1 to {splat.MAX_WINDOW} pixels")
    unported = {
        "megakernel=False": not settings.megakernel,
        "chunked_raster=False": not settings.chunked_raster,
        "compact_raster=False": not settings.compact_raster,
        'raster_mode="sorted"': settings.raster_mode == "sorted",
        "frame_fusion=True": bool(settings.frame_fusion),
    }
    bad = [name for name, on in unported.items() if on]
    if bad:
        raise NotImplementedError(
            f"render arm not ported yet ({', '.join(bad)}): the port renders "
            "the chunked megakernel arm and footprint 1 only (ROADMAP.md)")


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
        self._thresholds_cache = None
        self._survivor_counts: dict = {}

    def gather_points(self, streamer: CellStreamer, camera: Camera):
        """Loaded cells as (bucket, distance, cell_id, points, generation),
        sorted by (bucket, distance) (renderer.py:219-240)."""
        cells = []
        cam = camera.transform.translation
        for cell_id, cell in streamer.loaded.items():
            if cell_id.hierarchy in self.settings.hidden_hierarchies:
                continue
            pts = cell.all_points()
            if len(pts) == 0:
                continue
            distance = float(np.linalg.norm(cell.pos - cam))
            bucket = max(int(distance).bit_length() - 1, 0)
            cells.append((bucket, distance, cell_id, pts, cell.generation))
        cells.sort(key=lambda c: (c[0], c[1]))
        return cells

    def _upload(self, array: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(array), device=self.device)

    def _bucket_device_arrays(self, bucket_cells):
        """(positions, hierarchy, valid, colors, n_real) for one bucket,
        padded to a pow2 row count and cached by the bucket's cells
        (renderer.py:242-300): a steady orbit uploads no points."""
        key = tuple((c[2], c[4]) for c in bucket_cells)
        hit = self._bucket_cache.get(key)
        if hit is not None:
            return hit
        positions = np.concatenate([c[3].positions for c in bucket_cells])
        colors = np.concatenate([c[3].colors for c in bucket_cells])
        point_hier = np.concatenate(
            [np.full(len(c[3]), c[2].hierarchy, np.int32)
             for c in bucket_cells])
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
                 self._upload(point_hier), self._upload(valid), colors, n_real)
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

    def _rungs(self) -> tuple[tuple, tuple, torch.Tensor]:
        """(sub rungs, overflow rungs, (R,) f32 device thresholds k/2 of
        the whole ladder), the tensor uploaded once per ladder."""
        s = self.settings
        subs = self._small_ladder() if s.sub_rungs else ()
        overs = self._overflow_ladder()
        ks = subs + (s.footprint,) + overs
        cached = self._thresholds_cache
        if cached is None or cached[0] != ks:
            cached = self._thresholds_cache = (
                ks, self._upload(np.asarray([k / 2.0 for k in ks], np.float32)))
        return subs, overs, cached[1]

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
        loaded_table = streamer.loaded_cells_table()
        table_key = loaded_table.tobytes()
        if self._hash_cache is None or self._hash_cache[0] != table_key:
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
        use_occ = s.occlusion and not paused
        use_pyr = use_occ and s.depth_pyramid
        subs, overs, thresholds = self._rungs()
        ladder = subs + (s.footprint,) + overs

        cells = self.gather_points(streamer, camera)
        framebuffer = splat.make_framebuffer(s.height, s.width, dev)
        all_colors = [np.zeros((1, 4), np.uint8)]
        id_base = 1
        total_in = 0
        frame_vecs: list = []
        frame_bucket_keys: list = []
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
            lkey = (bucket_key, table_key)
            hier_base = self._lod_cache.get(lkey)
            if hier_base is None:
                hier_base = lod_select(
                    pos_dev, hier_dev, sizes_dev,
                    max(int(self.metadata.hierarchies), 1), loaded_hash)
                _bounded_put(self._lod_cache, lkey, hier_base, 64)
            ikey = (bucket_key, id_base)
            ids_dev = self._ids_cache.get(ikey)
            if ids_dev is None:
                point_ids = np.zeros(n, np.int32)
                point_ids[:n_real] = np.arange(
                    id_base, id_base + n_real, dtype=np.int32)
                ids_dev = self._upload(point_ids)
                _bounded_put(self._ids_cache, ikey, ids_dev, 64)
            framebuffer, counts_vec = splat.render_bucket_pass(
                framebuffer, pos_dev, hier_base, valid_dev, ids_dev,
                view_dev, proj_dev, cam_dev, spacings_dev, fars_dev,
                s.size_by_distance, s.max_hierarchy, thresholds,
                height=s.height, width=s.width, footprint=s.footprint,
                voronoi=s.voronoi, use_occlusion=use_occ,
                use_pyramid=use_pyr, overflow_ks=overs, sub_ks=subs)
            # at footprint 1 the reference lands the cull's cumulative fit
            # counts (renderer.py:667-669); exclusive counts of the same
            # ladder land the same per-rung values
            frame_vecs.append((bucket, ladder, counts_vec, "excl"))
            all_colors.append(colors)
            frame_bucket_keys.append(bucket_key)
            id_base += n_real

        # the color table, padded to pow2 and cached per frame composition
        ckey = tuple(frame_bucket_keys)
        color_dev = self._color_cache.get(ckey)
        if color_dev is None:
            color_table = np.concatenate(all_colors)
            padded = pad_to_bucket(len(color_table), minimum=1 << 10)
            color_table = np.concatenate(
                [color_table,
                 np.zeros((padded - len(color_table), 4), np.uint8)])
            color_dev = self._upload(color_table)
            _bounded_put(self._color_cache, ckey, color_dev, 16)

        self.framebuffer = framebuffer
        vec_meta = [(b, ks, len(ks) + 1, kind) for b, ks, _, kind in frame_vecs]
        total_counts = sum(m[2] for m in vec_meta)
        stats = {"cells": len(cells), "points_in": total_in,
                 "buckets": len(frame_vecs)}
        counts = (torch.cat([v for _, _, v, _ in frame_vecs]) if frame_vecs
                  else torch.zeros(1, dtype=torch.int32, device=dev))
        if total_counts <= splat.PACK_COUNTS:
            packed = splat.pack_frame(framebuffer, color_dev, counts,
                                      s.height, s.width, s.transfer_depth)
            return {"vec_meta": vec_meta, "stats": stats, "height": s.height,
                    "width": s.width, "with_depth": s.transfer_depth,
                    **_start_readback(packed)}
        # more counts than the packed tail holds: resolve and read back
        # synchronously (renderer.py:989-1005)
        rgb, depth = splat.resolve_framebuffer(framebuffer, color_dev,
                                               s.height, s.width)
        stats["points_visible"] = self._land_count_vecs(
            vec_meta, counts.cpu().numpy())
        return {"rgb": rgb.cpu().numpy(),
                "depth": depth.cpu().numpy() if s.transfer_depth else None,
                "stats": stats}

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
