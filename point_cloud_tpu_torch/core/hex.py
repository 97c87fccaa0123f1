"""Hexagonal-prism sub-grid quantization: NumPy, and its torch twins.

The NumPy half (``SQRT_3``, ``_np_saturating_i32``, ``offset_to_axial``,
``axial_to_offset``, ``axial_to_world``, ``axial_from_world``,
``offset_from_world``, ``offset_to_world``) is a copy of the reference's
``core/hex.py:1-121``: the host store code, the C++ engine's lockstep
check and the dedup pass's host half use it, and tests hold it
bit-identical to the reference's.

The torch twins take a ``torch_`` prefix, as the reference's device
versions take ``jax_``. They mirror ``core/hex.py:136-238``
(``_jax_saturating_i32``, ``jax_cell_index``, ``jax_axial_from_world``,
``jax_axial_to_offset``, ``jax_offset_to_axial``, ``jax_axial_to_world``)
with the same f32 operation order, so every quantization boundary lands
on the same point as the NumPy half (CLAUDE.md invariant 2).

Rules that keep the twins bit-identical to NumPy:

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
x, y, z / axial: q, r, h). The twins' scalar parameters (cell size,
radius) are 0-d float32 tensors or numbers; either way they are rounded
to f32 and placed on the positions' device first.

Casting semantics replicated from Rust:
- ``f.floor() as i32`` — floor, then saturating cast (NaN -> 0),
- ``f as i32`` (used for the z layer) — truncation toward zero, saturating.
"""

from __future__ import annotations

import numpy as np
import torch

SQRT_3 = np.float32(1.73205080757)  # same literal as hex.rs:3

_I32_MIN = -(2**31)
_I32_MAX = 2**31 - 1


def _np_saturating_i32(v: np.ndarray) -> np.ndarray:
    """Rust `as i32` on an already-integral float: saturate, NaN -> 0.

    Explicit bounds comparisons (not clip+cast): 2^31-1 is not
    representable in f32, so a clipped value of 2^31 would wrap in the
    cast. The in-range cast is exact because callers pass floor/trunc
    results. The C++ (native/pc_native.cpp sat_i32) and jnp versions
    implement the identical rule.
    """
    v = np.asarray(v, dtype=np.float32)
    nan = np.isnan(v)
    hi = v >= np.float32(2147483648.0)
    lo = v <= np.float32(-2147483904.0)  # first f32 below i32::MIN
    safe = np.where(nan | hi | lo, 0.0, v).astype(np.int32)
    out = np.where(hi, np.int32(_I32_MAX), safe)
    out = np.where(lo, np.int32(_I32_MIN), out)
    return np.where(nan, np.int32(0), out)


def offset_to_axial(offset: np.ndarray) -> np.ndarray:
    """Offset (x, y, z) -> axial (q, r, h). Mirrors hex.rs:18-24."""
    x = offset[..., 0].astype(np.int64)
    y = offset[..., 1].astype(np.int64)
    q = x - (y - (y & 1)) // 2
    return np.stack(
        [q.astype(np.int32), offset[..., 1], offset[..., 2]], axis=-1
    )


def axial_to_offset(axial: np.ndarray) -> np.ndarray:
    """Axial (q, r, h) -> offset (x, y, z). Mirrors hex.rs:45-51."""
    q = axial[..., 0].astype(np.int64)
    r = axial[..., 1].astype(np.int64)
    x = q + (r - (r & 1)) // 2
    return np.stack(
        [x.astype(np.int32), axial[..., 1], axial[..., 2]], axis=-1
    )


def axial_to_world(axial: np.ndarray, cell_radius: float) -> np.ndarray:
    """Hex center world position for axial indices. Mirrors hex.rs:55-65."""
    radius = np.float32(cell_radius)
    q = axial[..., 0].astype(np.float32)
    r = axial[..., 1].astype(np.float32)
    h = axial[..., 2].astype(np.float32)
    x = radius * (SQRT_3 * q + np.float32(SQRT_3 / np.float32(2.0)) * r)
    y = radius * np.float32(3.0) / np.float32(2.0) * r
    z = h * radius
    return np.stack([x, y, z], axis=-1)


def axial_from_world(pos: np.ndarray, cell_radius: float) -> np.ndarray:
    """Quantize world positions to axial hex indices. Mirrors hex.rs:67-85.

    Every intermediate is computed in float32 in the same operation order as
    the reference so quantization boundaries land on identical points.
    """
    radius = np.float32(cell_radius)
    pos = np.asarray(pos, dtype=np.float32)
    # extreme coordinates overflow to +/-inf here (and inf - inf makes
    # NaN, which _np_saturating_i32 casts deterministically) — the
    # IEEE-defined results the Rust reference, the C++ kernel, and jnp
    # all produce, lockstep-tested; silence only the warnings
    with np.errstate(over="ignore", invalid="ignore"):
        x = pos[..., 0] / (radius * SQRT_3)
        y = pos[..., 1] / (-radius * SQRT_3)
        # Charles-Chambers hex quantization (hex.rs:71-82)
        t = SQRT_3 * y + np.float32(1.0)
        temp1 = np.floor(t + x).astype(np.float32)
        temp2 = t - x
        temp3 = np.float32(2.0) * x + np.float32(1.0)
        qf = (temp1 + temp3) / np.float32(3.0)
        rf = (temp1 + temp2) / np.float32(3.0)
        q = _np_saturating_i32(np.floor(qf))
        r = -_np_saturating_i32(np.floor(rf))
        # `(pos.z / cell_radius) as i32` truncates toward zero (hex.rs:83)
        h = _np_saturating_i32(np.trunc(pos[..., 2] / radius))
    return np.stack([q, r, h], axis=-1)


def offset_from_world(pos: np.ndarray, cell_radius: float) -> np.ndarray:
    """World positions -> offset hex indices (the stored sub-grid index)."""
    return axial_to_offset(axial_from_world(pos, cell_radius))


def offset_to_world(offset: np.ndarray, cell_radius: float) -> np.ndarray:
    """Offset hex index -> hex center world position."""
    return axial_to_world(offset_to_axial(offset), cell_radius)

# ---------------------------------------------------------------------------
# torch twins — identical math, on any device
# ---------------------------------------------------------------------------


def f32_scalar(value, device) -> torch.Tensor:
    """A 0-d float32 tensor on ``device`` holding ``value`` rounded to f32."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.float32)
    return torch.tensor(np.float32(value), dtype=torch.float32, device=device)


def torch_saturating_i32(v: torch.Tensor) -> torch.Tensor:
    """Rust ``as i32`` on an integral f32 tensor: saturate, NaN -> 0
    (``_jax_saturating_i32``, hex.py:136-146)."""
    nan = torch.isnan(v)
    hi = v >= 2147483648.0
    lo = v <= -2147483904.0  # first f32 below i32::MIN
    safe = torch.where(nan | hi | lo, torch.zeros_like(v), v).to(torch.int32)
    out = torch.where(hi, torch.full_like(safe, _I32_MAX), safe)
    out = torch.where(lo, torch.full_like(safe, _I32_MIN), out)
    return torch.where(nan, torch.zeros_like(safe), out)


def torch_cell_index(pos: torch.Tensor, cell_size) -> torch.Tensor:
    """``floor(pos / cell_size)`` with Rust cast semantics
    (``jax_cell_index``, hex.py:182-193)."""
    cs = f32_scalar(cell_size, pos.device)
    return torch_saturating_i32(torch.floor(pos.to(torch.float32) / cs))


def torch_axial_from_world(pos: torch.Tensor, cell_radius) -> torch.Tensor:
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
    q = torch_saturating_i32(torch.floor(qf))
    r = -torch_saturating_i32(torch.floor(rf))
    h = torch_saturating_i32(torch.trunc(pos[..., 2] / radius))
    return torch.stack([q, r, h], dim=-1)


def torch_axial_to_offset(axial: torch.Tensor) -> torch.Tensor:
    """(``jax_axial_to_offset``, hex.py:196-201); i32 wraparound."""
    q = axial[..., 0]
    r = axial[..., 1]
    x = q + torch.div(r - (r & 1), 2, rounding_mode="floor")
    return torch.stack([x, r, axial[..., 2]], dim=-1)


def torch_offset_to_axial(offset: torch.Tensor) -> torch.Tensor:
    """(``jax_offset_to_axial``, hex.py:204-209); i32 wraparound."""
    x = offset[..., 0]
    y = offset[..., 1]
    q = x - torch.div(y - (y & 1), 2, rounding_mode="floor")
    return torch.stack([q, y, offset[..., 2]], dim=-1)


def torch_axial_to_world(axial: torch.Tensor, cell_radius) -> torch.Tensor:
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


def torch_offset_from_world(pos: torch.Tensor, cell_radius) -> torch.Tensor:
    return torch_axial_to_offset(torch_axial_from_world(pos, cell_radius))


def torch_offset_to_world(offset: torch.Tensor, cell_radius) -> torch.Tensor:
    return torch_axial_to_world(torch_offset_to_axial(offset), cell_radius)
