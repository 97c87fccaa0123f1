"""Offscreen frame export: PNG writer + camera-path animation.

Copy of the reference's ``viewer/offscreen.py``: ``tests/test_torch_viewer.py``
holds its results equal to the reference's.

The reference presents frames to a winit window / browser canvas
(reference: src/plugins/wgpu.rs begin/end frame, src/plugins/winit.rs
continuous redraw); headless TPU rendering exports frames instead. The PNG
encoder is dependency-free (zlib + struct).
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


def write_png(path, image: np.ndarray) -> None:
    """Write an (H, W, 3) float [0,1] or uint8 image as PNG."""
    if image.dtype != np.uint8:
        image = np.clip(np.asarray(image) * 255.0 + 0.5, 0, 255).astype(
            np.uint8
        )
    height, width = image.shape[:2]
    if image.ndim == 2:
        image = np.repeat(image[:, :, None], 3, axis=2)

    raw = b"".join(
        b"\x00" + image[y].tobytes() for y in range(height)
    )

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    header = struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0)
    payload = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", header)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    if hasattr(path, "write"):  # file-like
        path.write(payload)
    else:
        with open(path, "wb") as f:
            f.write(payload)


def render_orbit(viewer, out_dir, n_frames: int = 24,
                 radius: float | None = None,
                 settle_frames: int = 400) -> list[Path]:
    """Animate the camera around the cloud, streaming + rendering each
    frame; writes frame_<i>.png files and returns their paths.

    The equivalent of flying the reference viewer around a cloud — used by
    the render benchmark and as a smoke test of the full frame loop.
    """
    from ..render.fly_cam import orbit_path

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    bbox = viewer.metadata.bounding_box
    center = bbox.center()
    extent = float(np.linalg.norm(bbox.extends()))
    radius = radius if radius is not None else extent * 1.5

    paths = []
    for i, transform in enumerate(
        orbit_path(center, radius, extent * 0.6, n_frames)
    ):
        viewer.fly_cam.transform = transform
        viewer._camera_dirty = True
        for _ in range(settle_frames):
            viewer.update()
            if (
                not viewer.streamer.loading
                and len(viewer.streamer.should_load) == 0
            ):
                break
        rgb, _, _ = viewer.render()
        path = out_dir / f"frame_{i:04d}.png"
        write_png(path, rgb)
        paths.append(path)
    return paths
