"""The headless viewer app: one explicit frame pipeline.

Frame flow parity with the reference's schedule graph (reference:
SURVEY.md section 3.3; src/app.rs:28-53 plugin order):

``update(dt, input)``:
  1. input -> fly camera (src/plugins/camera/fly_cam.rs),
  2. asset completions -> loaded/missing cells
     (cell::receive_cell, src/plugins/cell.rs:256-341),
  3. camera change -> frustum -> per-hierarchy streaming frustums
     (src/plugins/cell/frustums.rs),
  4. visible-set diff + load-queue fill (src/plugins/cell.rs:343-462),
``render()``:
  5. bucket cull+LOD+occlusion + splat rasterization
     (src/plugins/render/point.rs) + debug line overlays
     (src/plugins/debug.rs).

Streaming pauses via ``stream_enabled`` (StreamState, cell.rs:89-99).
Metadata loads through the asset manager; on arrival the camera reframes
the cloud bbox and the view distance becomes ``max_cell_size * 5``
(src/plugins/metadata.rs:299-312, src/plugins/cell.rs:155-162).

Port of the reference's ``viewer/app.py``: the same class and methods,
rendering through the port's ``PointRenderer`` on ``device`` (``"cuda"``
unless the caller asks for the CPU), or with ``mesh_devices`` > 0 through
``MeshPointRenderer`` over ``make_mesh(mesh_devices, device=device)``
(data-parallel frames, images equal to the single-device plain raster
arm). The reference's JAX compile-cache setup has no counterpart.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from ..core.cell import Cell, CellId
from ..core.metadata import Metadata
from ..ops.runtime import resolve_device
from ..render.camera import Camera
from ..render.fly_cam import FlyCam
from ..render.frustums import SCALE_DEFAULT, update_streaming_frustums
from ..render.lines import frustum_lines, line_box, rasterize_lines
from ..render.renderer import PointRenderer, RenderSettings
from ..render.streaming import CellStreamer
from ..utils.assets import AssetManager
from ..utils.source import Directory
from ..utils.thread_pool import ThreadPool
from ..utils.tracing import stage


@dataclass
class ViewerInput:
    """Per-frame input sample (the InputPlugin state, src/plugins/input.rs)."""

    forward: float = 0.0  # W/S axis
    right: float = 0.0  # D/A axis
    ascend: float = 0.0  # Space / ShiftLeft
    cursor_delta: tuple[float, float] = (0.0, 0.0)
    wheel: float = 0.0
    looking: bool = False  # right mouse button held


@dataclass
class DebugSettings:
    """Debug visualization toggles (src/plugins/debug.rs:21-36)."""

    show_bounding_box: bool = False
    show_frustum: bool = False
    show_plane_normals: bool = False  # normal arrows (debug.rs:115-202)
    show_cell_grid: bool = False
    # per-hierarchy streaming-frustum far-plane rectangles (debug.rs:306-342)
    show_streaming_rects: bool = False
    frozen_frustum: object = None  # captured frustum wireframe


class FrameDiagnostics:
    """FPS / frame-time smoothing (bevy FrameTimeDiagnosticsPlugin
    equivalent, read by the UI at src/plugins/render/ui.rs:103-120)."""

    def __init__(self, smoothing: float = 0.9):
        self.smoothing = smoothing
        self.frame_time_ms: float | None = None
        self.frame_count = 0
        self._last = None

    def tick(self) -> None:
        now = time.perf_counter()
        self.frame_count += 1
        if self._last is not None:
            dt_ms = (now - self._last) * 1000.0
            if self.frame_time_ms is None:
                self.frame_time_ms = dt_ms
            else:
                self.frame_time_ms = (
                    self.frame_time_ms * self.smoothing
                    + dt_ms * (1.0 - self.smoothing)
                )
        self._last = now

    @property
    def fps(self) -> float | None:
        if not self.frame_time_ms:
            return None
        return 1000.0 / self.frame_time_ms


class Viewer:
    streaming_scale: float  # property below: changes re-stream immediately

    def __init__(self, settings: RenderSettings | None = None,
                 pool: ThreadPool | None = None, mesh_devices: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        # mesh_devices > 0 renders frames data-parallel over a device mesh
        # (render/parallel.py)
        self.mesh_devices = int(mesh_devices)
        self.settings = settings or RenderSettings()
        self.pool = pool or ThreadPool(2)  # ThreadPoolPlugin size (2)
        self.metadata = Metadata()  # placeholder "Unknown" cloud
        self.working_directory: Directory | None = None
        self.camera = Camera()
        # aspect ratio follows the surface (src/plugins/camera.rs
        # update_aspect_ratio on WindowResized)
        self.camera.projection.aspect_ratio = (
            self.settings.width / self.settings.height
        )
        self.fly_cam = FlyCam.from_transform(self.camera.transform)
        self._streaming_scale = SCALE_DEFAULT
        self.stream_enabled = True
        self.debug = DebugSettings()
        self.diagnostics = FrameDiagnostics()

        self.cell_assets: AssetManager[CellId, Cell] = AssetManager(
            parse=Cell.from_bytes,
            serialize=lambda c: c.to_bytes(),
            pool=self.pool,
        )
        self._cell_handles: dict[CellId, object] = {}
        self.streamer = CellStreamer(self.metadata)
        self.renderer = self._make_renderer(self.metadata)
        self._frustums = []
        self._camera_dirty = True

    def _make_renderer(self, metadata):
        if self.mesh_devices > 0:
            from ..parallel.mesh import make_mesh
            from ..render.parallel import MeshPointRenderer

            return MeshPointRenderer(
                metadata, make_mesh(self.mesh_devices, device=self.device),
                settings=self.settings)
        return PointRenderer(metadata, self.settings, device=self.device)

    # --- metadata loading (src/plugins/metadata.rs) ---------------------------

    def load_metadata(self, source) -> None:
        """Load a store's metadata.json from a path or URL and activate it."""
        if isinstance(source, (str, Path)) and "://" not in str(source):
            path = Path(source)
            data = path.read_bytes()
            self.working_directory = Directory(path.parent)
        else:
            from ..utils.source import UrlSource

            url = str(source)
            data = UrlSource(url).load()
            self.working_directory = Directory(url.rsplit("/", 1)[0])
        self.set_metadata(Metadata.loads(data.decode("utf-8")))

    def set_metadata(self, metadata: Metadata) -> None:
        self.metadata = metadata
        self.streamer.cleanup()
        self.streamer.metadata = metadata
        self._cell_handles.clear()
        self.renderer = self._make_renderer(metadata)
        # reframe + view distance (metadata.rs:299-312, cell.rs:155-162)
        self.camera.projection.far = float(
            metadata.config.max_cell_size * 5.0
        )
        self.camera.look_at_aabb(metadata.bounding_box)
        self.fly_cam = FlyCam.from_transform(self.camera.transform)
        self._camera_dirty = True

    @property
    def streaming_scale(self) -> float:
        return self._streaming_scale

    @streaming_scale.setter
    def streaming_scale(self, value: float) -> None:
        """Load-distance scale slider (frustums.rs:13-25): streaming
        frustums rebuild on change, like the is_changed() reactivity."""
        from ..render.frustums import SCALE_MAX, SCALE_MIN

        self._streaming_scale = float(np.clip(value, SCALE_MIN, SCALE_MAX))
        self._camera_dirty = True

    def resize(self, width: int, height: int) -> None:
        """Resize the render surface (WindowResized handling:
        src/plugins/winit.rs + camera aspect + depth texture recreation —
        the framebuffer here is per-frame, so only settings change)."""
        self.settings.width = max(1, int(width))
        self.settings.height = max(1, int(height))
        self.camera.projection.aspect_ratio = (
            self.settings.width / self.settings.height
        )
        self.renderer = self._make_renderer(self.metadata)
        self._camera_dirty = True

    # --- per-frame update ------------------------------------------------------

    def update(self, dt: float = 1.0 / 60.0,
               inputs: ViewerInput | None = None) -> None:
        self.diagnostics.tick()
        inputs = inputs or ViewerInput()

        # 1. camera control
        self.fly_cam.looking = inputs.looking
        if inputs.looking:
            self.fly_cam.rotate(*inputs.cursor_delta)
            self.fly_cam.adjust_speed(inputs.wheel)
        if inputs.forward or inputs.right or inputs.ascend:
            self.fly_cam.move(dt, inputs.forward, inputs.right, inputs.ascend)
            self._camera_dirty = True
        if inputs.looking and any(inputs.cursor_delta):
            self._camera_dirty = True
        self.camera.transform = self.fly_cam.transform

        # 2. receive loaded cells (cell.rs:256-341)
        if self.streamer.loading and not self.cell_assets.has_completions():
            # a zero-delay update loop would starve the asset pool's
            # worker threads of GIL time; block on the pool's completion
            # event so the frame resumes exactly when a load lands (the
            # timeout only bounds liveness if the load set is stale)
            with stage("update.asset_wait"):
                self.cell_assets.wait_for_completion(timeout=0.05)
        for event in self.cell_assets.poll_events():
            from ..utils.assets import AssetEventKind

            if event.kind == AssetEventKind.LOADED:
                cell = self.cell_assets.get(event.id)
                handle = self.cell_assets.get_handle(event.id)
                self._cell_handles[event.id] = handle
                self.streamer.on_loaded(event.id, cell)
            elif event.kind == AssetEventKind.ERROR:
                if isinstance(event.error, FileNotFoundError):
                    self.streamer.on_missing(event.id)
                else:
                    self.streamer.loading.discard(event.id)
            elif event.kind == AssetEventKind.CREATED:
                # in-app converter feed (cell.rs:268-288)
                cell = self.cell_assets.get(event.id)
                if cell is not None:
                    self.streamer.on_loaded(event.id, cell)

        if not self.stream_enabled:
            return  # StreamState::Paused gates the streaming set

        # 3. streaming frustums (only when the camera moved / metadata changed)
        if self._camera_dirty or not self._frustums:
            frustum = self.camera.frustum()
            self._frustums = update_streaming_frustums(
                self.metadata, self.camera.transform, self.camera.projection,
                frustum, self.streaming_scale,
            )
            # 4. visible-set diff + prioritized load queue
            self.streamer.update(self._frustums, self.camera.transform)
            self._camera_dirty = False
            self._drop_released_handles()

        started = self.streamer.fill_load_slots()
        for cell_id in started:
            if self.working_directory is None:
                self.streamer.on_missing(cell_id)
                continue
            try:
                source = self.working_directory.join(cell_id.path())
            except Exception:
                self.streamer.on_missing(cell_id)
                continue
            self.cell_assets.load(cell_id, source)

    def _drop_released_handles(self) -> None:
        for cell_id in list(self._cell_handles):
            if cell_id not in self.streamer.loaded:
                handle = self._cell_handles.pop(cell_id)
                if handle is not None:
                    handle.release()

    # --- rendering ---------------------------------------------------------------

    def render(self):
        """Render one frame; returns (rgb, depth, stats)."""
        rgb, depth, stats = self.renderer.render(
            self.streamer, self.camera, self._frustums,
            paused=not self.stream_enabled,
        )
        rgb = self._apply_overlays(
            rgb, self.camera.view_projection_matrix(), self._frustums
        )
        return rgb, depth, stats

    def render_pipelined(self):
        """Double-buffered render: dispatch this frame's device chain and
        return the PREVIOUS frame (None on the first call) — frame k+1's
        device work overlaps frame k's readback, the reference's
        AutoVsync swapchain shape (wgpu.rs:107). Debug overlays are drawn
        with the view-projection captured when THEIR frame was
        dispatched, so wireframes stay registered to their image.
        Call :meth:`render_flush` to drain the last in-flight frame."""
        ctx = (self.camera.view_projection_matrix(), list(self._frustums))
        handle = self.renderer.render_start(
            self.streamer, self.camera, self._frustums,
            paused=not self.stream_enabled,
        )
        prev = getattr(self, "_inflight_frame", None)
        self._inflight_frame = (handle, ctx)
        if prev is None:
            return None
        return self._finish_frame(prev)

    def render_flush(self):
        """Drain the in-flight pipelined frame; None if none pending."""
        prev = getattr(self, "_inflight_frame", None)
        self._inflight_frame = None
        if prev is None:
            return None
        return self._finish_frame(prev)

    def _finish_frame(self, prev):
        handle, (vp, frustums) = prev
        rgb, depth, stats = self.renderer.render_finish(handle)
        rgb = self._apply_overlays(rgb, vp, frustums)
        return rgb, depth, stats

    def _apply_overlays(self, rgb, vp, frustums):
        if (
            self.debug.show_bounding_box
            or self.debug.show_frustum
            or self.debug.show_plane_normals
            or self.debug.show_cell_grid
            or self.debug.show_streaming_rects
        ):
            rgb = np.array(rgb)  # writable copy for line overlays
        if self.debug.show_bounding_box:
            segs = line_box(
                self.metadata.bounding_box.min, self.metadata.bounding_box.max
            )
            rasterize_lines(rgb, segs, (1.0, 1.0, 1.0), vp)
        if self.debug.show_frustum and self.debug.frozen_frustum is not None:
            rasterize_lines(
                rgb, frustum_lines(self.debug.frozen_frustum),
                (1.0, 0.2, 0.2), vp,
            )
        if (
            self.debug.show_plane_normals
            and self.debug.frozen_frustum is not None
        ):
            from ..render.lines import frustum_normal_lines

            rasterize_lines(
                rgb, frustum_normal_lines(self.debug.frozen_frustum),
                (0.2, 1.0, 0.2), vp,
            )
        if self.debug.show_streaming_rects:
            from ..render.lines import far_plane_rect

            for h, frustum in enumerate(frustums):
                # hue walk per hierarchy, like the reference's distinct
                # per-hierarchy rectangles (debug.rs:306-342)
                color = (
                    0.3 + 0.7 * ((h * 53) % 97) / 97.0,
                    0.9 - 0.6 * (h % 4) / 3.0 if h % 4 else 0.9,
                    0.35 + 0.65 * ((h * 29) % 89) / 89.0,
                )
                rasterize_lines(rgb, far_plane_rect(frustum), color, vp)
        if self.debug.show_cell_grid:
            for cell_id in self.streamer.loaded:
                size = self.metadata.config.cell_size(cell_id.hierarchy)
                pos = self.metadata.config.cell_pos(
                    np.asarray(cell_id.index, np.int32), size
                )
                half = np.float32(size) / 2
                color = (
                    (1.0, 0.65, 0.0)
                    if sum(cell_id.index) % 2 == 0
                    else (0.85, 0.5, 0.0)
                )  # orange alternating by parity (debug.rs:236-304)
                rasterize_lines(
                    rgb, line_box(pos - half, pos + half), color, vp
                )
        return rgb

    def freeze_frustum(self) -> None:
        """Capture the current frustum wireframe (debug.rs:115-202)."""
        self.debug.frozen_frustum = self.camera.frustum()
        self.debug.show_frustum = True

    def screenshot(self, path) -> dict:
        """Render the current view and save it as a PNG; returns stats."""
        from .offscreen import write_png

        rgb, _, stats = self.render()
        write_png(path, rgb)
        return stats

    # --- stats (the egui side panel's numbers) ------------------------------------

    def stats(self) -> dict:
        s = self.streamer.stats()
        return {
            "fps": self.diagnostics.fps,
            "frame_time_ms": self.diagnostics.frame_time_ms,
            "metadata": {
                "name": self.metadata.name,
                "points": self.metadata.number_of_points,
                "hierarchies": self.metadata.hierarchies,
            },
            "cells": {
                "loaded": s.loaded_cells,
                "missing": s.missing_cells,
                "queued": s.queued_cells,
                "loading": s.loading_cells,
            },
            "points": {
                "loaded": s.loaded_points,
                "bytes": s.loaded_bytes,
            },
        }

    def close(self) -> None:
        self.pool.close()
