"""Mesh-sharded frame rendering (counterpart of render/parallel.py).

The frame hot loop — LOD, cull with occlusion, splat raster — runs data
parallel over a :class:`~point_cloud_tpu_torch.parallel.mesh.Mesh`. Each
bucket's points shard across the mesh, and every shard keeps a private
framebuffer. Per shard and bucket, near to far: the port's
:func:`~.kernel.lod_select`, the cull through K1 (:func:`~.kernel._cull_body`
on ``cull_classify``), then the raster of every kept row through the
footprint window with K2 (:func:`~.splat.rasterize_splats`, the
reference's ``_rasterize_body``).

- Between buckets, with occlusion on, the shards' depth planes ``pmin``:
  every shard's next cull tests against the depth of ALL nearer points,
  as the single-device bucket loop does.
- At the end, the two-phase (depth, id) merge: ``pmin`` of the depth,
  then ``pmin`` of ``where(depth == gdepth, id, NO_ID)`` — the raster's
  own tie rule (equal depths take the smallest point id).

By induction each bucket sees the same merged depth as the single-device
frame, hence culls the same points and emits the same fragments, so the
image equals the single-device renderer's plain raster arm
(``compact_raster``, ``megakernel`` and ``classing`` off) bit for bit
(tests/test_torch_render_parallel.py). No speed-up across devices is
claimed: a mesh of logical shards on one card runs them one after
another.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.metadata import Metadata
from ..ops.dedup import pad_to_bucket
from ..parallel.mesh import Mesh, make_mesh, pmin, psum
from . import splat
from .camera import Camera
from .kernel import (
    MAX_HIERARCHIES, _cull_body, build_loaded_cells_hash, lod_select,
)
from .renderer import (
    PointRenderer, RenderSettings, _bounded_put, _start_readback,
    check_ported, hierarchy_tables, read_bucket_points,
)

_NO_ID = int(splat._NO_ID)


def merge_framebuffers(depths, ids) -> list:
    """The two-phase (depth, id) merge of per-shard planes
    (render/parallel.py:109-111): ``gdepth = pmin(depth)``, then ``pmin``
    of each shard's id where its depth is the global one. Returns the
    per-shard packed framebuffers of the merged planes."""
    gdepth = pmin(depths)
    cand = [torch.where(d == g, i, _NO_ID) for d, g, i in zip(depths, gdepth,
                                                               ids)]
    gid = pmin(cand)
    return [splat.Framebuffer(
        (g.view(torch.int32).to(torch.int64) << 32)
        | (i.to(torch.int64) & 0xFFFFFFFF)) for g, i in zip(gdepth, gid)]


class MeshPointRenderer:
    """Data-parallel counterpart of :class:`renderer.PointRenderer`.

    Renders one frame from a streamer's loaded set with each bucket's
    points sharded across ``mesh`` (by default ``make_mesh(device=device)``).
    Images equal the single-device renderer's plain raster arm
    (``compact_raster`` / ``megakernel`` / ``classing`` off): the sharding
    changes where fragments raster, never what wins a pixel. Only the
    settings that reach that arm apply (width/height, footprint, voronoi,
    occlusion, depth pyramid, size_by_distance, max_hierarchy,
    hidden_hierarchies, transfer_depth).
    """

    # the gather reads only settings.hidden_hierarchies
    gather_points = PointRenderer.gather_points

    def __init__(self, metadata: Metadata, mesh: Mesh | None = None,
                 axis: str | None = None,
                 settings: RenderSettings | None = None, *, device="cuda"):
        self.mesh = mesh or make_mesh(device=device)
        self.metadata = metadata
        self.axis = axis or self.mesh.axis_names[0]
        self.settings = settings or RenderSettings()
        self.device = self.mesh.devices[0]  # merge, resolve and readback
        self.framebuffer = None  # the last frame's merged planes
        self._bucket_cache: dict = {}
        self._lod_cache: dict = {}
        self._color_cache: dict = {}
        self._const_cache = None
        self._hash_cache = None
        self._n_dev = self.mesh.size

    def _pad_rows(self, n_real: int) -> int:
        n = pad_to_bucket(max(n_real, 1), minimum=1 << 12)
        if n % self._n_dev:
            n += self._n_dev - (n % self._n_dev)
        return n

    def _per_device(self, array: np.ndarray) -> dict:
        """``array`` uploaded once to each distinct device of the mesh."""
        host = np.ascontiguousarray(array)
        return {dev: torch.as_tensor(host, device=dev)
                for dev in self.mesh.distinct_devices}

    def _shard_bucket(self, group, id_base: int):
        """A bucket's rows, padded to a multiple of the mesh width and cut
        into one slice a shard on its device: (positions, hierarchy, valid,
        ids) lists, colors, n_real. Cached per (cell ids + generations,
        id_base): a steady orbit reads and uploads no points."""
        key = (tuple((g[2], g[4]) for g in group), id_base)
        hit = self._bucket_cache.get(key)
        if hit is not None:
            return hit
        positions, colors, hier = read_bucket_points(group)
        n_real = len(positions)
        n = self._pad_rows(n_real)
        pos_pad = np.zeros((n, 3), np.float32)
        pos_pad[:n_real] = positions
        hier_pad = np.zeros(n, np.int32)
        hier_pad[:n_real] = hier
        valid = np.zeros(n, bool)
        valid[:n_real] = True
        ids = np.zeros(n, np.int32)
        ids[:n_real] = np.arange(id_base, id_base + n_real, dtype=np.int32)
        ss = n // self._n_dev

        def shards(a):
            return [torch.as_tensor(np.ascontiguousarray(a[s * ss:(s + 1) * ss]),
                                    device=dev)
                    for s, dev in enumerate(self.mesh.devices)]

        entry = ((shards(pos_pad), shards(hier_pad), shards(valid),
                  shards(ids)), colors, n_real)
        _bounded_put(self._bucket_cache, key, entry, 64)
        return entry

    def _constants(self, streamer, camera: Camera, far_distances):
        """Per distinct device: (view, projection, cam_pos, cell_sizes,
        spacings, far_distances, loaded-cells hash); the metadata tables
        and the hash are cached like the single-device renderer's."""
        const_key = (id(self.metadata), int(self.metadata.hierarchies))
        if self._const_cache is None or self._const_cache[0] != const_key:
            sizes, spacings = hierarchy_tables(self.metadata)
            self._const_cache = (const_key, self._per_device(sizes),
                                 self._per_device(spacings))
        table = streamer.loaded_cells_table()
        table_key = table.tobytes()
        if self._hash_cache is None or self._hash_cache[0] != table_key:
            self._hash_cache = (table_key, self._per_device(
                build_loaded_cells_hash(table)))
        _, sizes, spacings = self._const_cache
        hashes = self._hash_cache[1]
        view = self._per_device(np.asarray(camera.view_matrix(), np.float32))
        proj = self._per_device(
            np.asarray(camera.projection_matrix(), np.float32))
        cam = self._per_device(
            np.asarray(camera.transform.translation, np.float32))
        fars = self._per_device(far_distances)
        return {dev: (view[dev], proj[dev], cam[dev], sizes[dev],
                      spacings[dev], fars[dev], hashes[dev])
                for dev in self.mesh.distinct_devices}

    def _color_table(self, keys, all_colors):
        ckey = tuple(keys)
        hit = self._color_cache.get(ckey)
        if hit is None:
            table = np.concatenate(all_colors)
            padded = pad_to_bucket(len(table), minimum=1 << 10)
            table = np.concatenate(
                [table, np.zeros((padded - len(table), 4), np.uint8)])
            hit = torch.as_tensor(table, device=self.device)
            _bounded_put(self._color_cache, ckey, hit, 16)
        return hit

    def render_start(self, streamer, camera: Camera,
                     streaming_frustums=None, paused: bool = False) -> dict:
        """Queue a frame's device chain on every shard without waiting;
        returns a handle for :meth:`render_finish` (the single-device
        renderer's start/finish contract, so Viewer and serve swap
        renderers freely)."""
        s = self.settings
        check_ported(s)
        use_occ = s.occlusion and not paused
        use_pyr = use_occ and s.depth_pyramid
        h, w = s.height, s.width
        cells = self.gather_points(streamer, camera)
        far_distances = np.zeros(MAX_HIERARCHIES, np.float32)
        if streaming_frustums is not None:
            fd = streamer.frustum_far_distances(streaming_frustums,
                                                camera.transform)
            far_distances[: len(fd)] = fd
        consts = self._constants(streamer, camera, far_distances)
        num_h = max(int(self.metadata.hierarchies), 1)

        fbs = [splat.make_framebuffer(h, w, dev) for dev in self.mesh.devices]
        visible = [torch.zeros((), dtype=torch.int32, device=dev)
                   for dev in self.mesh.devices]
        merged_depth = [fb.depth for fb in fbs]
        all_colors = [np.zeros((1, 4), np.uint8)]
        keys = []
        id_base = 1
        total_in = 0
        buckets = []
        i = 0
        while i < len(cells):  # group into buckets, near to far
            bucket = cells[i][0]
            group = []
            while i < len(cells) and cells[i][0] == bucket:
                group.append(cells[i])
                i += 1
            buckets.append(group)

        for b, group in enumerate(buckets):
            arrays, colors, n_real = self._shard_bucket(group, id_base)
            cells_key = tuple((g[2], g[4]) for g in group)
            # the LOD walk is camera-independent: cached per bucket and
            # loaded set, as the single-device renderer caches it
            lkey = (cells_key, self._hash_cache[0])
            hier_bases = self._lod_cache.get(lkey)
            if hier_bases is None:
                hier_bases = self.mesh.map(
                    lambda shard, pos, hier: lod_select(
                        pos, hier, consts[pos.device][3], num_h,
                        consts[pos.device][6]),
                    arrays[0], arrays[1])
                _bounded_put(self._lod_cache, lkey, hier_bases, 64)

            def body(shard, pos, hier_base, valid, ids, fb, depth):
                view, proj, cam, _, spacings, fars, _ = consts[pos.device]
                keep, _, ndc, view_pos, radius = _cull_body(
                    pos, hier_base, valid, view, proj, cam, spacings, fars,
                    s.size_by_distance, s.max_hierarchy,
                    depth.reshape(h, w) if use_occ else None, use_occ,
                    use_pyr)
                splat.rasterize_splats(fb, view_pos, ndc, radius, ids, keep,
                                       proj, h, w, s.footprint, s.voronoi)
                return keep.sum(dtype=torch.int32)

            kept = self.mesh.map(body, arrays[0], hier_bases, *arrays[2:],
                                 fbs, merged_depth)
            visible = [v + k for v, k in zip(visible, kept)]
            if use_occ and b + 1 < len(buckets):
                merged_depth = pmin([fb.depth for fb in fbs])
            all_colors.append(colors)
            keys.append(cells_key)
            total_in += n_real
            id_base += n_real

        merged = merge_framebuffers([fb.depth for fb in fbs],
                                    [fb.point_id for fb in fbs])[0]
        count = psum(visible)[0].reshape(1)
        self.framebuffer = merged
        packed = splat.pack_frame(merged, self._color_table(keys, all_colors),
                                  count, h, w, s.transfer_depth)
        stats = {"cells": len(cells), "points_in": total_in,
                 "buckets": len(buckets)}
        return {"stats": stats, "height": h, "width": w,
                "with_depth": s.transfer_depth, **_start_readback(packed)}

    def render_finish(self, handle: dict):
        """Wait for a frame dispatched by :meth:`render_start`; returns
        (rgb (H,W,3) u8, depth (H,W) f32 or None, stats)."""
        height, width = handle["height"], handle["width"]
        if handle["event"] is not None:
            handle["event"].synchronize()
        buf = handle["host"].numpy()
        hw3 = height * width * 3
        rgb = buf[:hw3].reshape(height, width, 3).copy()
        stats = handle["stats"]
        stats["points_visible"] = int(buf[hw3:hw3 + 4].view(np.int32)[0])
        depth = None
        if handle["with_depth"]:
            off = hw3 + 4 * splat.PACK_COUNTS
            depth = buf[off:].view(np.float32).reshape(height, width).copy()
        return rgb, depth, stats

    def render(self, streamer, camera: Camera, streaming_frustums=None,
               paused: bool = False):
        """Returns (rgb (H,W,3) u8, depth (H,W) f32 or None, stats)."""
        return self.render_finish(
            self.render_start(streamer, camera, streaming_frustums, paused))

    def render_pipelined(self, streamer, camera: Camera,
                         streaming_frustums=None, paused: bool = False):
        """Double-buffered frames, the single-device renderer's contract:
        dispatch this frame, return the PREVIOUS one (None on the first
        call)."""
        handle = self.render_start(streamer, camera, streaming_frustums,
                                   paused)
        prev = getattr(self, "_inflight_frame", None)
        self._inflight_frame = handle
        if prev is None:
            return None
        return self.render_finish(prev)

    def render_flush(self):
        prev = getattr(self, "_inflight_frame", None)
        self._inflight_frame = None
        if prev is None:
            return None
        return self.render_finish(prev)
