"""Debug line geometry + a simple line overlay rasterizer.

Copy of the reference's ``render/lines.py``: ``tests/test_torch_viewer.py``
holds its results equal to the reference's.

Capability parity with the reference's line renderer and debug plugin
(reference: src/plugins/render/line.rs, src/plugins/render/line/utils.rs:8-112,
src/plugins/debug.rs): generators for line strips, AABB wireframes (12
edges) and spheres (3 rings), used to visualize camera frusta, cloud/cell
bounding boxes and streaming-frustum far planes. Lines can be exported as
geometry or scan-converted onto a rendered frame (the WGSL pipeline's
screen-space quads become sampled scatter writes).
"""

from __future__ import annotations

import numpy as np


def line_strip(points: np.ndarray, color) -> np.ndarray:
    """(N, 3) polyline -> (N-1, 2, 3) segments (line/utils.rs:8-18)."""
    points = np.asarray(points, np.float32)
    return np.stack([points[:-1], points[1:]], axis=1)


def line_box(aabb_min, aabb_max) -> np.ndarray:
    """12 AABB edges, shape (12, 2, 3) (line/utils.rs:20-63)."""
    mn = np.asarray(aabb_min, np.float32)
    mx = np.asarray(aabb_max, np.float32)
    c = np.array(
        [
            [mn[0], mn[1], mn[2]], [mx[0], mn[1], mn[2]],
            [mx[0], mx[1], mn[2]], [mn[0], mx[1], mn[2]],
            [mn[0], mn[1], mx[2]], [mx[0], mn[1], mx[2]],
            [mx[0], mx[1], mx[2]], [mn[0], mx[1], mx[2]],
        ],
        np.float32,
    )
    edges = [
        (0, 1), (1, 2), (2, 3), (3, 0),  # bottom
        (4, 5), (5, 6), (6, 7), (7, 4),  # top
        (0, 4), (1, 5), (2, 6), (3, 7),  # pillars
    ]
    return np.stack([np.stack([c[a], c[b]]) for a, b in edges])


def line_sphere(center, radius: float, segments: int = 32) -> np.ndarray:
    """Three orthogonal great-circle rings (line/utils.rs:65-112)."""
    center = np.asarray(center, np.float32)
    t = np.linspace(0.0, 2 * np.pi, segments + 1, dtype=np.float32)
    cos, sin = np.cos(t) * radius, np.sin(t) * radius
    zeros = np.zeros_like(cos)
    rings = [
        np.stack([cos, sin, zeros], axis=1),  # XY ring
        np.stack([cos, zeros, sin], axis=1),  # XZ ring
        np.stack([zeros, cos, sin], axis=1),  # YZ ring
    ]
    return np.concatenate([line_strip(center + r, None) for r in rings])


def frustum_lines(frustum) -> np.ndarray:
    """Frustum wireframe: near + far quads + connecting edges
    (src/plugins/debug.rs:115-202)."""
    segs = []
    for quad in (frustum.near, frustum.far):
        tl, tr, bl, br = quad
        segs += [[tl, tr], [tr, br], [br, bl], [bl, tl]]
    for a, b in zip(frustum.near, frustum.far):
        segs.append([a, b])
    return np.asarray(segs, np.float32)


def frustum_normal_lines(frustum, length: float | None = None) -> np.ndarray:
    """One segment per frustum plane, from the face center along the
    plane normal (src/plugins/debug.rs:115-202's normal arrows).

    Plane order matches Frustum.planes: near, far, top, bottom, left,
    right; default length scales with the frustum's depth.
    """
    near, far = frustum.near, frustum.far
    tl_n, tr_n, bl_n, br_n = near
    tl_f, tr_f, bl_f, br_f = far
    faces = [
        near,                      # near
        far,                       # far
        (tl_n, tr_n, tl_f, tr_f),  # top
        (bl_n, br_n, bl_f, br_f),  # bottom
        (tl_n, bl_n, tl_f, bl_f),  # left
        (tr_n, br_n, tr_f, br_f),  # right
    ]
    if length is None:
        depth = float(np.linalg.norm(np.mean(far, 0) - np.mean(near, 0)))
        length = max(depth * 0.1, 1.0)
    segs = []
    for face, plane in zip(faces, frustum.planes):
        center = np.mean(np.asarray(face, np.float32), axis=0)
        segs.append([center, center + plane[:3] * np.float32(length)])
    return np.asarray(segs, np.float32)


def far_plane_rect(frustum) -> np.ndarray:
    """The far-plane rectangle of a (streaming) frustum
    (src/plugins/debug.rs:306-342 draws one per hierarchy)."""
    tl, tr, bl, br = frustum.far
    return np.asarray(
        [[tl, tr], [tr, br], [br, bl], [bl, tl]], np.float32
    )


def rasterize_lines(
    image: np.ndarray,
    segments: np.ndarray,
    color,
    view_proj: np.ndarray,
    samples_per_segment: int = 256,
) -> np.ndarray:
    """Scan-convert world-space segments onto an (H, W, 3) image in place.

    ``color`` is float [0,1]; u8 images (the frame pipeline's native
    output since the device-side resolve) get it scaled to 8-bit."""
    if len(segments) == 0:
        return image
    height, width = image.shape[:2]
    color = np.asarray(color, np.float32)
    if image.dtype == np.uint8:
        color = np.clip(color * 255.0 + 0.5, 0, 255).astype(np.uint8)

    a = np.concatenate(
        [segments[:, 0], np.ones((len(segments), 1), np.float32)], axis=1
    )
    b = np.concatenate(
        [segments[:, 1], np.ones((len(segments), 1), np.float32)], axis=1
    )
    t = np.linspace(0.0, 1.0, samples_per_segment, dtype=np.float32)
    pts = a[:, None, :] * (1 - t)[None, :, None] + b[:, None, :] * t[None, :, None]
    clip = pts.reshape(-1, 4) @ view_proj.T
    w = clip[:, 3]
    front = w > 1e-6
    ndc = clip[:, :3] / np.where(front, w, 1.0)[:, None]
    inside = (
        front
        & (np.abs(ndc[:, 0]) <= 1.0)
        & (np.abs(ndc[:, 1]) <= 1.0)
        & (ndc[:, 2] >= 0.0)
        & (ndc[:, 2] <= 1.0)
    )
    px = ((ndc[:, 0] * 0.5 + 0.5) * width).astype(np.int32)
    py = ((ndc[:, 1] * -0.5 + 0.5) * height).astype(np.int32)
    ok = inside & (px >= 0) & (px < width) & (py >= 0) & (py < height)
    image[py[ok], px[ok]] = color
    return image
