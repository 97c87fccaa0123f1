"""The store's geometry in plain torch: cell indices, hexagonal-prism slots
and the squared distance to a slot's centre.

Written from the store format's definition (cell index = floor(position /
cell size) with Rust's saturating cast; slots quantized by the
Charles-Chambers hex rounding in f32 with the published operation order;
the z layer truncated toward zero). Each operation is its own eager op
and every divisor a tensor on the data's device, so nothing fuses into an
fma and CUDA's division stays the IEEE quotient. ``dtype`` lets the
control run the same arithmetic in a lower precision.
"""

from __future__ import annotations

import numpy as np
import torch

SQRT_3 = np.float32(1.73205080757)


def scalar(value, device, dtype=torch.float32) -> torch.Tensor:
    """A 0-d tensor on ``device``: ``value`` rounded to f32, then ``dtype``."""
    return torch.tensor(np.float32(value), dtype=torch.float32,
                        device=device).to(dtype)


def cell_size(config: dict, hierarchy: int) -> np.float32:
    return np.float32(config["max_cell_size"]) / np.float32(
        np.uint32(2) ** np.uint32(hierarchy))


def sub_cell_size(config: dict, size) -> np.float32:
    return np.float32(size) / np.float32(config["sub_grid_dimension"])


def cell_pos(index: np.ndarray, size) -> np.ndarray:
    """Cell centre: index * size + size / 2 in f32."""
    size = np.float32(size)
    return np.asarray(index, np.float32) * size + size / np.float32(2.0)


def saturating_i32(v: torch.Tensor) -> torch.Tensor:
    """Rust ``as i32`` of an integral float: saturate, NaN to 0."""
    v = v.to(torch.float32)
    nan = torch.isnan(v)
    hi = v >= 2147483648.0
    lo = v <= -2147483904.0
    safe = torch.where(nan | hi | lo, torch.zeros_like(v), v).to(torch.int32)
    safe = torch.where(hi, torch.full_like(safe, 2**31 - 1), safe)
    safe = torch.where(lo, torch.full_like(safe, -(2**31)), safe)
    return torch.where(nan, torch.zeros_like(safe), safe)


def cell_index(pos: torch.Tensor, size, dtype=torch.float32) -> torch.Tensor:
    """(N, 3) i32 index of the cell of side ``size`` holding each point."""
    return saturating_i32(
        torch.floor(pos.to(dtype) / scalar(size, pos.device, dtype)))


def slot_index(pos: torch.Tensor, radius, dtype=torch.float32):
    """(N, 3) i32 offset hex index (x, y, z) of each point's slot."""
    dev = pos.device
    r = scalar(radius, dev, dtype)
    s3 = scalar(SQRT_3, dev, dtype)
    three = scalar(3.0, dev, dtype)
    p = pos.to(dtype)
    x = p[:, 0] / (r * s3)
    y = p[:, 1] / (-r * s3)
    sy = s3 * y
    t = sy + 1.0
    temp1 = torch.floor(t + x)
    temp2 = t - x
    temp3 = 2.0 * x + 1.0
    q = saturating_i32(torch.floor((temp1 + temp3) / three))
    rr = -saturating_i32(torch.floor((temp1 + temp2) / three))
    h = saturating_i32(torch.trunc(p[:, 2] / r))
    # axial (q, r) -> offset x = q + (r - (r & 1)) / 2
    ox = q + torch.div(rr - (rr & 1), 2, rounding_mode="floor")
    return torch.stack([ox, rr, h], dim=1)


def slot_center(slot: torch.Tensor, radius, dtype=torch.float32):
    """World centre of offset hex slots."""
    dev = slot.device
    r = scalar(radius, dev, dtype)
    s3 = scalar(SQRT_3, dev, dtype)
    y = slot[:, 1]
    q = slot[:, 0] - torch.div(y - (y & 1), 2, rounding_mode="floor")
    qf, rf, hf = q.to(dtype), y.to(dtype), slot[:, 2].to(dtype)
    t1 = s3 * qf
    t2 = (s3 / 2.0) * rf
    cx = r * (t1 + t2)
    cy = (r * 1.5) * rf
    cz = hf * r
    return torch.stack([cx, cy, cz], dim=1)


def dist_sq(pos: torch.Tensor, center: torch.Tensor, dtype=torch.float32):
    """(dx*dx + dy*dy) + dz*dz, in that order."""
    d = pos.to(dtype) - center
    return (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]


def slots_and_dist(pos: torch.Tensor, radius, dtype=torch.float32):
    slot = slot_index(pos, radius, dtype)
    return slot, dist_sq(pos, slot_center(slot, radius, dtype), dtype)
