"""Torch twins of the reference's device hex functions.

Mirrors ``point_cloud_tpu/core/hex.py:136-238`` (``_jax_saturating_i32``,
``jax_cell_index``, ``jax_axial_from_world``, ``jax_axial_to_offset``,
``jax_offset_to_axial``, ``jax_axial_to_world``) with the same f32
operation order, so every quantization boundary lands on the same point
as the NumPy oracle in that module (CLAUDE.md invariant 2).

Rules that keep the results bit-identical to NumPy:

- Division is plain torch ``/``. The reference reconstructs division
  with ``ops/exact.py`` because the TPU's divide is approximate; torch's
  division is IEEE on the CPU and, without fast-math, on CUDA, so that
  module is not ported. The divisor is always a tensor on the operand's
  device: PyTorch's CUDA division by a CPU scalar multiplies by its
  reciprocal instead, which is not the IEEE quotient.
- Every multiply and add is its own eager op, so nothing fuses into an
  fma (``sqrt3 * y`` then ``+ 1.0``); no ``torch.compile`` here.
- Float -> i32 casts mask NaN and out-of-range values before the cast:
  torch's cast of those is undefined (NaN and 3e9 both come out as
  -2^31 on the CPU).

Positions are ``(..., 3)`` float32, indices ``(..., 3)`` int32 (offset:
x, y, z / axial: q, r, h). Scalar parameters (cell size, radius) are
0-d float32 tensors or numbers; either way they are rounded to f32 and
placed on the positions' device first.
"""

from __future__ import annotations

import numpy as np
import torch

from point_cloud_tpu.core.hex import SQRT_3

_I32_MIN = -(2**31)
_I32_MAX = 2**31 - 1


def f32_scalar(value, device) -> torch.Tensor:
    """A 0-d float32 tensor on ``device`` holding ``value`` rounded to f32."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.float32)
    return torch.tensor(np.float32(value), dtype=torch.float32, device=device)


def saturating_i32(v: torch.Tensor) -> torch.Tensor:
    """Rust ``as i32`` on an integral f32 tensor: saturate, NaN -> 0
    (``_jax_saturating_i32``, hex.py:136-146)."""
    nan = torch.isnan(v)
    hi = v >= 2147483648.0
    lo = v <= -2147483904.0  # first f32 below i32::MIN
    safe = torch.where(nan | hi | lo, torch.zeros_like(v), v).to(torch.int32)
    out = torch.where(hi, torch.full_like(safe, _I32_MAX), safe)
    out = torch.where(lo, torch.full_like(safe, _I32_MIN), out)
    return torch.where(nan, torch.zeros_like(safe), out)


def cell_index(pos: torch.Tensor, cell_size) -> torch.Tensor:
    """``floor(pos / cell_size)`` with Rust cast semantics
    (``jax_cell_index``, hex.py:182-193)."""
    cs = f32_scalar(cell_size, pos.device)
    return saturating_i32(torch.floor(pos.to(torch.float32) / cs))


def axial_from_world(pos: torch.Tensor, cell_radius) -> torch.Tensor:
    """World positions -> axial (q, r, h) (``jax_axial_from_world``,
    hex.py:149-179; NumPy ``axial_from_world`` :85-111)."""
    dev = pos.device
    radius = f32_scalar(cell_radius, dev)
    sqrt3 = f32_scalar(SQRT_3, dev)
    three = f32_scalar(3.0, dev)
    pos = pos.to(torch.float32)
    x = pos[..., 0] / (radius * sqrt3)
    y = pos[..., 1] / (-radius * sqrt3)
    sy = sqrt3 * y  # two roundings, as the reference: no fma
    t = sy + 1.0
    temp1 = torch.floor(t + x)
    temp2 = t - x
    temp3 = 2.0 * x + 1.0
    qf = (temp1 + temp3) / three
    rf = (temp1 + temp2) / three
    q = saturating_i32(torch.floor(qf))
    r = -saturating_i32(torch.floor(rf))
    h = saturating_i32(torch.trunc(pos[..., 2] / radius))
    return torch.stack([q, r, h], dim=-1)


def axial_to_offset(axial: torch.Tensor) -> torch.Tensor:
    """(``jax_axial_to_offset``, hex.py:196-201); i32 wraparound."""
    q = axial[..., 0]
    r = axial[..., 1]
    x = q + torch.div(r - (r & 1), 2, rounding_mode="floor")
    return torch.stack([x, r, axial[..., 2]], dim=-1)


def offset_to_axial(offset: torch.Tensor) -> torch.Tensor:
    """(``jax_offset_to_axial``, hex.py:204-209); i32 wraparound."""
    x = offset[..., 0]
    y = offset[..., 1]
    q = x - torch.div(y - (y & 1), 2, rounding_mode="floor")
    return torch.stack([q, y, offset[..., 2]], dim=-1)


def axial_to_world(axial: torch.Tensor, cell_radius) -> torch.Tensor:
    """Hex centre of axial indices (``jax_axial_to_world``,
    hex.py:212-230)."""
    dev = axial.device
    radius = f32_scalar(cell_radius, dev)
    sqrt3 = f32_scalar(SQRT_3, dev)
    q = axial[..., 0].to(torch.float32)
    r = axial[..., 1].to(torch.float32)
    h = axial[..., 2].to(torch.float32)
    t1 = sqrt3 * q
    t2 = (sqrt3 / 2.0) * r
    x = radius * (t1 + t2)
    y = (radius * 1.5) * r
    z = h * radius
    return torch.stack([x, y, z], dim=-1)


def offset_from_world(pos: torch.Tensor, cell_radius) -> torch.Tensor:
    return axial_to_offset(axial_from_world(pos, cell_radius))


def offset_to_world(offset: torch.Tensor, cell_radius) -> torch.Tensor:
    return axial_to_world(offset_to_axial(offset), cell_radius)
