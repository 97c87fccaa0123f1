"""Fly camera controller (Z-up).

Copy of the reference's ``render/fly_cam.py``: ``tests/test_torch_render.py``
holds its results equal to the reference's.

Capability parity with the reference's ``FlyCamController`` (reference:
src/plugins/camera/fly_cam.rs): WASD planar movement, Space/Shift ascend/
descend along world +Z/-Z, hold-to-look mouse rotation as yaw/pitch ZXY
Euler with the pitch clamped to +/-1.54 rad and an X-axis pre/post rotation
accounting for the Z-up world (fly_cam.rs:111-128), and wheel-while-looking
speed control in [5, 1000] step 5 (fly_cam.rs:139-166).

Event-loop free: callers feed key/cursor state per tick (the FixedUpdate /
Update split collapses into explicit dt arguments).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .transform import Transform, quat_from_axis_angle, quat_mul

SPEED_MIN = 5.0
SPEED_MAX = 1000.0
SPEED_STEP = 5.0
PITCH_LIMIT = 1.54  # fly_cam.rs:121
SENSITIVITY = 0.002


@dataclass
class FlyCam:
    transform: Transform = field(default_factory=Transform)
    speed: float = 50.0
    yaw: float = 0.0
    pitch: float = 0.0
    looking: bool = False  # RMB held

    @staticmethod
    def from_transform(transform: Transform) -> "FlyCam":
        """Adopt an existing pose, recovering yaw/pitch from its rotation."""
        cam = FlyCam(transform=transform.copy())
        fwd = transform.forward()
        # Z-up: yaw around +Z from +Y, pitch toward +Z
        cam.yaw = float(np.arctan2(-fwd[0], fwd[1]))
        cam.pitch = float(np.arcsin(np.clip(fwd[2], -1.0, 1.0)))
        cam._apply_rotation()
        return cam

    def _apply_rotation(self) -> None:
        """yaw/pitch -> rotation with the Z-up correction.

        The reference composes ``Rx(pi/2) * Rz(yaw) * Rx(pitch - pi/2)``
        equivalently: a base X-rotation maps the Y-forward/Z-up frame onto
        the camera's -Z-forward/Y-up local frame (fly_cam.rs:111-128).
        """
        x_axis = np.array([1.0, 0.0, 0.0], np.float32)
        z_axis = np.array([0.0, 0.0, 1.0], np.float32)
        base = quat_from_axis_angle(x_axis, np.pi / 2.0)
        yaw_q = quat_from_axis_angle(z_axis, self.yaw)
        pitch_q = quat_from_axis_angle(x_axis, self.pitch)
        self.transform.rotation = quat_mul(quat_mul(yaw_q, base), pitch_q)

    # --- input ------------------------------------------------------------------

    def rotate(self, cursor_delta_x: float, cursor_delta_y: float) -> None:
        """Mouse-look while the look button is held (fly_cam.rs:99-137)."""
        if not self.looking:
            return
        self.yaw -= cursor_delta_x * SENSITIVITY
        self.pitch = float(
            np.clip(
                self.pitch - cursor_delta_y * SENSITIVITY,
                -PITCH_LIMIT,
                PITCH_LIMIT,
            )
        )
        self._apply_rotation()

    def adjust_speed(self, wheel_steps: float) -> None:
        """Wheel adjusts speed only while looking (fly_cam.rs:139-166)."""
        if not self.looking:
            return
        self.speed = float(
            np.clip(self.speed + wheel_steps * SPEED_STEP, SPEED_MIN, SPEED_MAX)
        )

    def move(self, dt: float, forward: float = 0.0, right: float = 0.0,
             ascend: float = 0.0) -> None:
        """Planar WASD + world-Z ascend/descend (fly_cam.rs:69-97).

        ``forward``/``right``/``ascend`` in [-1, 1] (key axes).
        """
        fwd = self.transform.forward()
        rgt = self.transform.right()
        # planar: project onto XY so looking down doesn't dive (Z-up world)
        fwd_plane = np.array([fwd[0], fwd[1], 0.0], np.float32)
        n = np.linalg.norm(fwd_plane)
        if n > 1e-6:
            fwd_plane /= n
        rgt_plane = np.array([rgt[0], rgt[1], 0.0], np.float32)
        n = np.linalg.norm(rgt_plane)
        if n > 1e-6:
            rgt_plane /= n
        direction = (
            fwd_plane * forward
            + rgt_plane * right
            + np.array([0.0, 0.0, 1.0], np.float32) * ascend
        )
        n = np.linalg.norm(direction)
        if n > 1e-6:
            direction = direction / n
        self.transform.translation = (
            self.transform.translation
            + direction * np.float32(self.speed * dt)
        ).astype(np.float32)


def orbit_path(center, radius: float, height: float, n_frames: int):
    """Camera transforms orbiting a point (bench/test camera animation)."""
    center = np.asarray(center, np.float32)
    for i in range(n_frames):
        angle = 2.0 * np.pi * i / n_frames
        pos = center + np.array(
            [radius * np.cos(angle), radius * np.sin(angle), height],
            np.float32,
        )
        t = Transform.from_translation(pos)
        t.look_at(center, np.array([0.0, 0.0, 1.0], np.float32))
        yield t
