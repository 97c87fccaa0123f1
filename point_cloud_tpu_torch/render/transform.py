"""TRS transforms (f32, Z-up world).

Copy of the reference's ``render/transform.py``: ``tests/test_torch_render.py``
holds its results equal to the reference's.

Capability parity with the reference's ``Transform`` component (reference:
src/transform.rs:7-137): translation + quaternion rotation + scale;
``look_at``/``look_to`` build the rotation from an orthonormal basis;
``forward`` is ``-local_z``; ``compute_matrix`` is the scale-rotation-
translation affine. Matrices are column-major 4x4 like glam, so they
compose as ``M @ v``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def _normalize(v: np.ndarray, fallback: np.ndarray | None = None) -> np.ndarray:
    n = np.linalg.norm(v)
    if n < 1e-12:
        if fallback is None:
            raise ValueError("cannot normalize zero vector")
        return fallback.astype(np.float32)
    return (v / n).astype(np.float32)


def _any_orthonormal(v: np.ndarray) -> np.ndarray:
    """An arbitrary unit vector orthogonal to unit ``v``."""
    helper = np.array([1.0, 0.0, 0.0], np.float32)
    if abs(v[0]) > 0.9:
        helper = np.array([0.0, 1.0, 0.0], np.float32)
    return _normalize(np.cross(v, helper))


def quat_from_mat3(m: np.ndarray) -> np.ndarray:
    """Rotation matrix (columns = basis) -> quaternion (x, y, z, w)."""
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


def quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        np.float32,
    )


def quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rotate vector(s) ``v`` (...,3) by quaternion ``q``."""
    xyz = q[:3]
    w = q[3]
    t = 2.0 * np.cross(xyz, v)
    return (v + w * t + np.cross(xyz, t)).astype(np.float32)


def quat_to_mat3(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ],
        np.float32,
    )


def quat_from_axis_angle(axis: np.ndarray, angle: float) -> np.ndarray:
    axis = _normalize(np.asarray(axis, np.float32))
    half = angle * 0.5
    return np.array([*(axis * np.sin(half)), np.cos(half)], np.float32)


def quat_from_euler_zxy(z: float, x: float, y: float) -> np.ndarray:
    """glam EulerRot::ZXY composition (used by the fly cam)."""
    qz = quat_from_axis_angle(np.array([0, 0, 1.0]), z)
    qx = quat_from_axis_angle(np.array([1.0, 0, 0]), x)
    qy = quat_from_axis_angle(np.array([0, 1.0, 0]), y)
    return quat_mul(quat_mul(qz, qx), qy)


_IDENTITY_Q = np.array([0.0, 0.0, 0.0, 1.0], np.float32)


@dataclass
class Transform:
    translation: np.ndarray = field(
        default_factory=lambda: np.zeros(3, np.float32)
    )
    rotation: np.ndarray = field(default_factory=lambda: _IDENTITY_Q.copy())
    scale: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))

    def __post_init__(self):
        self.translation = np.asarray(self.translation, np.float32).copy()
        self.rotation = np.asarray(self.rotation, np.float32).copy()
        self.scale = np.asarray(self.scale, np.float32).copy()

    @staticmethod
    def from_translation(t) -> "Transform":
        return Transform(translation=np.asarray(t, np.float32))

    @staticmethod
    def from_xyz(x: float, y: float, z: float) -> "Transform":
        return Transform.from_translation([x, y, z])

    def looking_at(self, target, up) -> "Transform":
        self.look_at(target, up)
        return self

    def look_at(self, target, up) -> None:
        self.look_to(np.asarray(target, np.float32) - self.translation, up)

    def look_to(self, direction, up) -> None:
        """Build rotation from basis (transform.rs:60-69)."""
        neg_z = np.array([0.0, 0.0, -1.0], np.float32)
        back = -_normalize(np.asarray(direction, np.float32), fallback=neg_z)
        up = _normalize(np.asarray(up, np.float32),
                        fallback=np.array([0, 1.0, 0], np.float32))
        right = np.cross(up, back)
        n = np.linalg.norm(right)
        right = _any_orthonormal(up) if n < 1e-12 else (right / n).astype(np.float32)
        up = np.cross(back, right).astype(np.float32)
        self.rotation = quat_from_mat3(
            np.stack([right, up, back], axis=1)  # columns
        )

    # --- local axes (transform.rs:71-114) -----------------------------------

    def local_x(self) -> np.ndarray:
        return quat_rotate(self.rotation, np.array([1.0, 0, 0], np.float32))

    def local_y(self) -> np.ndarray:
        return quat_rotate(self.rotation, np.array([0, 1.0, 0], np.float32))

    def local_z(self) -> np.ndarray:
        return quat_rotate(self.rotation, np.array([0, 0, 1.0], np.float32))

    def right(self) -> np.ndarray:
        return self.local_x()

    def up(self) -> np.ndarray:
        return self.local_y()

    def forward(self) -> np.ndarray:
        return -self.local_z()

    def back(self) -> np.ndarray:
        return self.local_z()

    # --- composition ----------------------------------------------------------

    def transform_point(self, point) -> np.ndarray:
        point = np.asarray(point, np.float32) * self.scale
        return quat_rotate(self.rotation, point) + self.translation

    def mul_transform(self, other: "Transform") -> "Transform":
        """Compose transforms (transform.rs:116-125): translation through
        self, rotations multiplied, scales componentwise."""
        return Transform(
            translation=self.transform_point(other.translation),
            rotation=quat_mul(self.rotation, other.rotation),
            scale=self.scale * other.scale,
        )

    def __mul__(self, other: "Transform") -> "Transform":
        return self.mul_transform(other)

    def compute_matrix(self) -> np.ndarray:
        """Column-major SRT affine (transform.rs:134-136)."""
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = quat_to_mat3(self.rotation) * self.scale[None, :]
        m[:3, 3] = self.translation
        return m

    def copy(self) -> "Transform":
        return Transform(self.translation, self.rotation, self.scale)
