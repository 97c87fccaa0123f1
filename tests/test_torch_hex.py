"""Port hex math (point_cloud_tpu_torch/core/hex.py) against the reference.

The ``torch_*`` twins are bit-exact against the NumPy oracle
(point_cloud_tpu.core.hex) and the ``jax_*`` twins on the same numpy
inputs, and the port's copy of the NumPy half against the reference's:
the tests/test_hex.py cases plus the shapes that broke the TPU build —
hex-edge x == 0.0, cell-boundary planes, |p| ~ 500 with tiny offsets,
NaN/inf, and values beyond the i32 range.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from point_cloud_tpu.core import hex as hexgrid
from point_cloud_tpu.core.metadata import MetadataConfig
from point_cloud_tpu_torch.core import hex as thex


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's torch work: the test workers
    share the machine's cores, and torch's parallel regions wait at a
    barrier for every thread, so a descheduled thread stalls each small
    op (three 64x64 CPU frames took 90 s at 8 threads beside six busy
    processes on 8 cores, 0.4 s at one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

RADII = [0.0520833333, 0.5, 5.2083335, 96.0, 10.416667]


def adversarial_positions(seed=0):
    rng = np.random.default_rng(seed)
    parts = [
        rng.uniform(-500, 500, (4000, 3)),
        # |p| ~ 500 with tiny offsets (cancellation-heavy distances)
        500.0 + rng.uniform(-1e-3, 1e-3, (500, 3)),
        -500.0 + rng.uniform(-1e-3, 1e-3, (500, 3)),
        # cell-boundary planes: exact multiples of the cell sizes
        rng.integers(-8, 8, (500, 3)) * np.float32(125.0),
        # far beyond the i32 range after division
        rng.normal(0, 1e12, (200, 3)),
        rng.uniform(-1e-30, 1e-30, (100, 3)),
    ]
    pos = np.concatenate(parts).astype(np.float32)
    pos[:300, 0] = 0.0  # hex edge x == 0.0
    pos[300:310] = [[np.nan, 0, 0], [0, np.nan, 1], [1, 2, np.nan],
                    [np.inf, 0, 0], [-np.inf, 1, 1], [0, np.inf, 0],
                    [0, -np.inf, 0], [0, 0, np.inf], [0, 0, -np.inf],
                    [3.4e38, -3.4e38, 3.4e38]]
    return pos


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def same_bits(a, b):
    a = np.asarray(a)
    b = np.asarray(b)
    return a.dtype == b.dtype and np.array_equal(
        a.view(np.uint8), b.view(np.uint8)
    )


@pytest.mark.parametrize("radius", RADII)
def test_offset_from_world_matches_numpy_and_jax(radius):
    pos = adversarial_positions()
    got = thex.torch_offset_from_world(t(pos), radius).numpy()
    with np.errstate(all="ignore"):
        ref = hexgrid.offset_from_world(pos, radius)
    jref = np.asarray(hexgrid.jax_offset_from_world(jnp.asarray(pos), radius))
    assert same_bits(got, ref)
    assert same_bits(got, jref)


@pytest.mark.parametrize("radius", RADII)
def test_axial_from_world_matches_numpy(radius):
    pos = adversarial_positions(seed=1)
    with np.errstate(all="ignore"):
        ref = hexgrid.axial_from_world(pos, radius)
    assert same_bits(thex.torch_axial_from_world(t(pos), radius).numpy(), ref)


@pytest.mark.parametrize("cell_size", [1000.0, 125.0, 0.9765625, 3.0])
def test_cell_index_matches_numpy_and_jax(cell_size):
    pos = adversarial_positions(seed=2)
    with np.errstate(all="ignore"):
        ref = MetadataConfig().cell_index(pos, np.float32(cell_size))
    jref = np.asarray(hexgrid.jax_cell_index(jnp.asarray(pos), cell_size))
    got = thex.torch_cell_index(t(pos), cell_size).numpy()
    assert same_bits(got, ref)
    assert same_bits(got, jref)


def test_saturating_cast_masks_before_cast():
    v = np.array([np.nan, 3e9, -3e9, 2147483648.0, -2147483904.0,
                  -2147483648.0, 2147483520.0, -0.0, 7.0, -7.0, np.inf,
                  -np.inf], np.float32)
    got = thex.torch_saturating_i32(t(v)).numpy()
    assert same_bits(got, hexgrid._np_saturating_i32(v))
    assert list(got[:3]) == [0, 2**31 - 1, -(2**31)]


@pytest.mark.parametrize("radius", [0.5, 2.5, 5.2083335])
def test_to_world_matches_numpy_and_jax(radius):
    rng = np.random.default_rng(11)
    idx = rng.integers(-1000, 1000, size=(4096, 3)).astype(np.int32)
    got = thex.torch_offset_to_world(t(idx), radius).numpy()
    assert same_bits(got, hexgrid.offset_to_world(idx, radius))
    jref = np.asarray(hexgrid.jax_offset_to_world(jnp.asarray(idx), radius))
    assert same_bits(got, jref)


def test_offset_axial_round_trip_and_wraparound():
    rng = np.random.default_rng(0)
    idx = rng.integers(-10_000, 10_000, size=(10_000, 3)).astype(np.int32)
    idx[:4] = [[2**31 - 1, -(2**31), 0], [-(2**31), 2**31 - 1, 5],
               [0, -3, 0], [-7, 7, -1]]
    for fn_t, fn_np in [
        (thex.torch_offset_to_axial, hexgrid.offset_to_axial),
        (thex.torch_axial_to_offset, hexgrid.axial_to_offset),
    ]:
        assert same_bits(fn_t(t(idx)).numpy(), fn_np(idx))
    back = thex.torch_axial_to_offset(thex.torch_offset_to_axial(t(idx[4:])))
    assert np.array_equal(back.numpy(), idx[4:])


def test_z_truncation_not_floor():
    pos = np.array([[0.0, 0.0, -0.5], [0.0, 0.0, -1.5]], np.float32)
    got = thex.torch_axial_from_world(t(pos), 1.0).numpy()
    assert list(got[:, 2]) == [0, -1]


@pytest.mark.parametrize("radius", RADII)
@pytest.mark.parametrize("name", ["axial_from_world", "offset_from_world"])
def test_numpy_half_from_world_matches_reference(name, radius):
    pos = adversarial_positions(seed=3)
    with np.errstate(all="ignore"):
        got = getattr(thex, name)(pos, radius)
        ref = getattr(hexgrid, name)(pos, radius)
    assert same_bits(got, ref)


@pytest.mark.parametrize("name", ["offset_to_world", "axial_to_world",
                                  "offset_to_axial", "axial_to_offset"])
def test_numpy_half_index_maps_match_reference(name):
    rng = np.random.default_rng(12)
    idx = rng.integers(-10_000, 10_000, size=(8192, 3)).astype(np.int32)
    idx[:2] = [[2**31 - 1, -(2**31), 0], [-(2**31), 2**31 - 1, 5]]
    fn, ref_fn = getattr(thex, name), getattr(hexgrid, name)
    args = (idx, 5.2083335) if name.endswith("world") else (idx,)
    with np.errstate(all="ignore"):
        assert same_bits(fn(*args), ref_fn(*args))


def test_numpy_saturating_cast_matches_reference():
    v = np.array([np.nan, 3e9, -3e9, 2147483648.0, -2147483904.0,
                  -2147483648.0, 2147483520.0, -0.0, 7.0, -7.0, np.inf,
                  -np.inf], np.float32)
    assert same_bits(thex._np_saturating_i32(v), hexgrid._np_saturating_i32(v))
    assert thex.SQRT_3 == hexgrid.SQRT_3
