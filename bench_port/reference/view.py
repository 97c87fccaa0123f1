"""Camera, frustums and the set of cells a view streams, in plain NumPy.

A frozen copy of the viewer's camera conventions (Z-up world, glam's
right-handed perspective with depth in [0, 1], ``look_at`` through an
orthonormal basis and a quaternion, per-hierarchy streaming frustums pulled in to ``near + min(cell size *
scale, far)``), kept here so the reference builds its matrices and its
visible set without the program. Every step keeps the f32/f64 types and
the operation order of the conventions it copies.
"""

from __future__ import annotations

import numpy as np

from . import hexgrid

STREAMING_SCALE = 2.0
FOV_Y = float(np.pi / 4.0)
NEAR = 1.0
MAX_CANDIDATES = 1_000_000


def _normalize(v, fallback=None):
    n = np.linalg.norm(v)
    if n < 1e-12:
        return fallback.astype(np.float32)
    return (v / n).astype(np.float32)


def _any_orthonormal(v):
    helper = np.array([1.0, 0.0, 0.0], np.float32)
    if abs(v[0]) > 0.9:
        helper = np.array([0.0, 1.0, 0.0], np.float32)
    return _normalize(np.cross(v, helper))


def quat_from_mat3(m):
    t = np.trace(m)
    if t > 0.0:
        s = np.sqrt(t + 1.0) * 2.0
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2.0
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2.0
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2.0
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    q = np.array([x, y, z, w], np.float32)
    return q / np.linalg.norm(q)


def quat_rotate(q, v):
    xyz = q[:3]
    w = q[3]
    t = 2.0 * np.cross(xyz, v)
    return (v + w * t + np.cross(xyz, t)).astype(np.float32)


def quat_to_mat3(q):
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ], np.float32)


class Pose:
    """Translation and rotation (x, y, z, w), both f32."""

    def __init__(self, translation, rotation):
        self.translation = np.asarray(translation, np.float32).copy()
        self.rotation = np.asarray(rotation, np.float32).copy()

    @staticmethod
    def looking_at(eye, target) -> "Pose":
        eye = np.asarray(eye, np.float32)
        direction = np.asarray(target, np.float32) - eye
        neg_z = np.array([0.0, 0.0, -1.0], np.float32)
        back = -_normalize(np.asarray(direction, np.float32), fallback=neg_z)
        up = _normalize(np.array([0.0, 0.0, 1.0], np.float32),
                        fallback=np.array([0, 1.0, 0], np.float32))
        right = np.cross(up, back)
        n = np.linalg.norm(right)
        right = (_any_orthonormal(up) if n < 1e-12
                 else (right / n).astype(np.float32))
        up = np.cross(back, right).astype(np.float32)
        return Pose(eye, quat_from_mat3(np.stack([right, up, back], axis=1)))

    def forward(self):
        return -quat_rotate(self.rotation, np.array([0, 0, 1.0], np.float32))

    def up(self):
        return quat_rotate(self.rotation, np.array([0, 1.0, 0], np.float32))

    def right(self):
        return quat_rotate(self.rotation, np.array([1.0, 0, 0], np.float32))

    def view_matrix(self):
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = quat_to_mat3(self.rotation) * np.ones(3, np.float32)[
            None, :]
        m[:3, 3] = self.translation
        return np.linalg.inv(m).astype(np.float32)


def projection_matrix(aspect: float, far: float, near: float = NEAR,
                      fov_y: float = FOV_Y):
    f = 1.0 / np.tan(fov_y * 0.5)
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = far / (near - far)
    m[2, 3] = -far * near / (far - near)
    m[3, 2] = -1.0
    return m


# --- streaming frustums and the visible set ---------------------------------


def _corner_quad(pose: Pose, aspect: float, distance: float):
    half_h = distance * float(np.tan(FOV_Y * 0.5))
    half_w = half_h * aspect
    up = pose.up() * np.float32(half_h)
    right = pose.right() * np.float32(half_w)
    center = pose.translation + np.float32(distance) * pose.forward()
    return np.stack([center + up - right, center + up + right,
                     center - up - right, center - up + right]).astype(
                         np.float32)


def _planes(pose: Pose, aspect: float, far: float):
    near_q = _corner_quad(pose, aspect, NEAR)
    cam = pose.translation
    fwd = pose.forward()
    center_near = cam + np.float32(NEAR) * fwd
    center_far = cam + np.float32(far) * fwd
    tl, tr, bl, br = near_q

    def unit(v):
        n = np.linalg.norm(v)
        return (np.zeros(3, np.float32) if n < 1e-12
                else (v / n).astype(np.float32))

    n_top = unit(np.cross(tl - cam, tr - cam))
    n_bottom = unit(np.cross(br - cam, bl - cam))
    n_left = unit(np.cross(bl - cam, tl - cam))
    n_right = unit(np.cross(tr - cam, br - cam))
    planes = np.array([
        [*fwd, np.dot(center_near, fwd)],
        [*(-fwd), np.dot(center_far, -fwd)],
        [*n_top, np.dot(cam, n_top)],
        [*n_bottom, np.dot(cam, n_bottom)],
        [*n_left, np.dot(cam, n_left)],
        [*n_right, np.dot(cam, n_right)],
    ], np.float32)
    return near_q, planes


def visible_cells(meta: dict, pose: Pose, aspect: float, far: float):
    """Per hierarchy, the cells whose boxes meet the streaming frustum:
    a list of (h, (x, y, z)) in hierarchy order."""
    config = meta["config"]
    bmin = np.asarray(meta["bounding_box"]["min"], np.float32)
    bmax = np.asarray(meta["bounding_box"]["max"], np.float32)
    near_q, planes = _planes(pose, aspect, far)
    fwd = pose.forward()
    far_normal = planes[1, :3]
    out = []
    for h in range(int(meta["hierarchies"])):
        size = hexgrid.cell_size(config, h)
        far_h = NEAR + min(float(size) * STREAMING_SCALE, far)
        center_far = pose.translation + np.float32(far_h) * fwd
        far_q = _corner_quad(pose, aspect, far_h)
        pl = planes.copy()
        pl[1] = [*far_normal, np.dot(center_far, far_normal)]
        corners = np.concatenate([near_q, far_q])
        lo = np.maximum(corners.min(axis=0), bmin)
        hi = np.minimum(corners.max(axis=0), bmax)
        lo_i = _np_cell_index(lo, size)
        hi_i = _np_cell_index(hi, size)
        if np.any(hi_i < lo_i):
            continue
        counts = hi_i.astype(np.int64) - lo_i.astype(np.int64) + 1
        if counts.prod() > MAX_CANDIDATES:
            continue
        axes = [np.arange(lo_i[i], hi_i[i] + 1, dtype=np.int64)
                for i in range(3)]
        cand = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(
            -1, 3).astype(np.int32)
        half = np.float32(size) / np.float32(2.0)
        centers = hexgrid.cell_pos(cand, size)
        mins, maxs = centers - half, centers + half
        pick = pl[:, :3][None, :, :] >= 0.0
        corner = np.where(pick, maxs[:, None, :], mins[:, None, :])
        signed = np.einsum("npk,pk->np", corner, pl[:, :3]) - pl[:, 3][None]
        keep = ~np.any(signed <= 0.0, axis=1)
        out += [(h, tuple(int(v) for v in c)) for c in cand[keep]]
    return out


def _np_cell_index(pos, size):
    v = np.floor(np.asarray(pos, np.float32) / np.float32(size))
    nan = np.isnan(v)
    hi = v >= np.float32(2147483648.0)
    lo = v <= np.float32(-2147483904.0)
    safe = np.where(nan | hi | lo, 0.0, v).astype(np.int32)
    safe = np.where(hi, np.int32(2**31 - 1), safe)
    safe = np.where(lo, np.int32(-(2**31)), safe)
    return np.where(nan, np.int32(0), safe)
