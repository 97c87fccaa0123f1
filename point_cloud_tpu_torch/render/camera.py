"""Camera: perspective projection and view frustum (vectorized culling).

Copy of the reference's ``render/camera.py``: ``tests/test_torch_render.py``
holds its results equal to the reference's.

Capability parity with the reference camera stack (reference:
src/plugins/camera.rs, src/plugins/camera/projection.rs:5-31,
src/plugins/camera/frustum.rs:1-219): Z-up world, camera spawned at
(0, -1, 0) looking at the origin; ``Mat4::perspective_rh`` projection
(wgpu depth range [0, 1]); frustum = near/far corner quads + six
Hessian-form planes; AABB culling by the positive-vertex test.

TPU-first redesign: ``cull_aabbs`` culls *batches* of AABBs in one
vectorized pass (the reference tests one box at a time inside a Python-
equivalent loop, src/plugins/cell.rs:370-378); the same math is exposed as
jnp-friendly pure functions for use inside the frame kernel.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.aabb import Aabb
from .transform import Transform


@dataclass
class PerspectiveProjection:
    fov_y: float = float(np.pi / 4.0)
    aspect_ratio: float = 1.0
    near: float = 1.0
    far: float = 1000.0

    def slope(self) -> float:
        return float(np.tan(self.fov_y * 0.5))

    def compute_matrix(self) -> np.ndarray:
        """Right-handed perspective, depth [0, 1] (glam perspective_rh)."""
        f = 1.0 / np.tan(self.fov_y * 0.5)
        n, fa = self.near, self.far
        m = np.zeros((4, 4), np.float32)
        m[0, 0] = f / self.aspect_ratio
        m[1, 1] = f
        m[2, 2] = fa / (n - fa)
        m[2, 3] = -fa * n / (fa - n)
        m[3, 2] = -1.0
        return m

    def copy(self) -> "PerspectiveProjection":
        return PerspectiveProjection(
            self.fov_y, self.aspect_ratio, self.near, self.far
        )


def _corner_quad(transform: Transform, projection: PerspectiveProjection,
                 distance: float) -> np.ndarray:
    """(4, 3) corners at ``distance`` along forward: TL, TR, BL, BR
    (frustum.rs:164-204)."""
    half_h = distance * projection.slope()
    half_w = half_h * projection.aspect_ratio
    up = transform.up() * np.float32(half_h)
    right = transform.right() * np.float32(half_w)
    center = transform.translation + np.float32(distance) * transform.forward()
    return np.stack(
        [center + up - right, center + up + right,
         center - up - right, center - up + right]
    ).astype(np.float32)


def _normalize_or_zero(v: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(v)
    return np.zeros(3, np.float32) if n < 1e-12 else (v / n).astype(np.float32)


@dataclass
class Frustum:
    """Near/far corners + 6 planes (x, y, z = normal, w = distance)."""

    near: np.ndarray = field(default_factory=lambda: np.zeros((4, 3), np.float32))
    far: np.ndarray = field(default_factory=lambda: np.zeros((4, 3), np.float32))
    planes: np.ndarray = field(default_factory=lambda: np.zeros((6, 4), np.float32))
    # plane order: near, far, top, bottom, left, right (frustum.rs:54-65)

    @staticmethod
    def new(transform: Transform, projection: PerspectiveProjection) -> "Frustum":
        near = _corner_quad(transform, projection, projection.near)
        far = _corner_quad(transform, projection, projection.far)

        cam_pos = transform.translation
        fwd = transform.forward()
        center_near = cam_pos + np.float32(projection.near) * fwd
        center_far = cam_pos + np.float32(projection.far) * fwd

        tl, tr, bl, br = near
        n_near = fwd
        n_far = -fwd
        n_top = _normalize_or_zero(np.cross(tl - cam_pos, tr - cam_pos))
        n_bottom = _normalize_or_zero(np.cross(br - cam_pos, bl - cam_pos))
        n_left = _normalize_or_zero(np.cross(bl - cam_pos, tl - cam_pos))
        n_right = _normalize_or_zero(np.cross(tr - cam_pos, br - cam_pos))

        planes = np.array(
            [
                [*n_near, np.dot(center_near, n_near)],
                [*n_far, np.dot(center_far, n_far)],
                [*n_top, np.dot(cam_pos, n_top)],
                [*n_bottom, np.dot(cam_pos, n_bottom)],
                [*n_left, np.dot(cam_pos, n_left)],
                [*n_right, np.dot(cam_pos, n_right)],
            ],
            np.float32,
        )
        return Frustum(near, far, planes)

    def cull_aabbs(self, mins: np.ndarray, maxs: np.ndarray) -> np.ndarray:
        """Vectorized positive-vertex test over (N, 3) AABB batches.

        Returns (N,) bool: True = culled (outside). Mirrors
        frustum.rs:68-98: per plane pick the corner furthest along the
        normal; signed distance <= 0 culls.
        """
        mins = np.asarray(mins, np.float32)
        maxs = np.asarray(maxs, np.float32)
        normals = self.planes[:, :3]  # (6, 3)
        d = self.planes[:, 3]  # (6,)
        # (N, 6, 3): max where normal >= 0 else min
        pick = normals[None, :, :] >= 0.0
        corners = np.where(pick, maxs[:, None, :], mins[:, None, :])
        signed = np.einsum("npk,pk->np", corners, normals) - d[None, :]
        return np.any(signed <= 0.0, axis=1)

    def cull_aabb(self, aabb: Aabb) -> bool:
        return bool(self.cull_aabbs(aabb.min[None], aabb.max[None])[0])

    def aabb(self) -> Aabb:
        corners = np.concatenate([self.near, self.far])
        return Aabb(corners.min(axis=0), corners.max(axis=0))

    def copy(self) -> "Frustum":
        return Frustum(self.near.copy(), self.far.copy(), self.planes.copy())


@dataclass
class Camera:
    """Camera entity: transform + projection (+ cached frustum).

    Default pose mirrors the reference startup camera
    (src/plugins/camera.rs:107-122): at (0, -1, 0) looking at the origin
    with +Z up.
    """

    transform: Transform = field(
        default_factory=lambda: Transform.from_xyz(0.0, -1.0, 0.0).looking_at(
            np.zeros(3, np.float32), np.array([0.0, 0.0, 1.0], np.float32)
        )
    )
    projection: PerspectiveProjection = field(
        default_factory=PerspectiveProjection
    )

    def view_matrix(self) -> np.ndarray:
        return np.linalg.inv(self.transform.compute_matrix()).astype(np.float32)

    def projection_matrix(self) -> np.ndarray:
        return self.projection.compute_matrix()

    def view_projection_matrix(self) -> np.ndarray:
        # projection * view (src/plugins/camera.rs:58-60)
        return (self.projection_matrix() @ self.view_matrix()).astype(np.float32)

    def frustum(self) -> Frustum:
        return Frustum.new(self.transform, self.projection)

    def look_at_aabb(self, aabb: Aabb) -> None:
        """Frame the cloud bbox like the on-load reposition
        (src/plugins/metadata.rs:299-312)."""
        center = aabb.center()
        extends = aabb.extends()
        distance = float(np.linalg.norm(extends)) * 2.0
        self.transform.translation = (
            center + np.array([0.0, -distance, distance * 0.5], np.float32)
        )
        self.transform.look_at(center, np.array([0.0, 0.0, 1.0], np.float32))
