"""Synthetic input clouds, made from a seed.

:func:`synth_cloud` is a copy of ``bench.py``'s (the reference's bench
cloud), for ``chip_smoke.py`` and the tests; a test holds it equal to
the original. :func:`pass_case` and :func:`resident_case` are the
dedup pass's inputs on the shapes its kernels must meet, shared by
``tests/test_torch_pass_kernels.py`` and ``chip_smoke.py`` phase 3.
:func:`lod_case` is one bucket's LOD walk (``render/kernel.py``
``lod_select``, K6) on its edge cases, shared by
``tests/test_torch_render.py`` and ``chip_smoke.py``'s phase ``lod``.
"""

from __future__ import annotations

import numpy as np


def synth_cloud(n: int, seed: int = 0) -> np.ndarray:
    """LiDAR-like mix: a ground plane sheet + building clusters + scatter."""
    rng = np.random.default_rng(seed)
    n_ground = n // 2
    n_clusters = n // 4
    n_scatter = n - n_ground - n_clusters

    ground = np.empty((n_ground, 3), np.float32)
    ground[:, :2] = rng.uniform(-400, 400, (n_ground, 2))
    ground[:, 2] = rng.normal(0.0, 0.3, n_ground)

    centers = rng.uniform(-350, 350, (64, 3)).astype(np.float32)
    centers[:, 2] = rng.uniform(5, 40, 64)
    which = rng.integers(0, 64, n_clusters)
    clusters = centers[which] + rng.normal(0, 8.0, (n_clusters, 3))

    scatter = rng.uniform(-500, 500, (n_scatter, 3))
    return np.concatenate(
        [ground, clusters.astype(np.float32), scatter.astype(np.float32)]
    ).astype(np.float32)



# the shapes of :func:`pass_case`; every one but "nonfinite" is finite
PASS_SHAPES = ("synth", "uniform", "all_equal", "lattice", "far",
               "saturate", "nonfinite")
_I32_MAX = 2**31 - 1


def pass_case(kind: str, n: int, seed: int = 0):
    """``(positions (n, 3) f32, valid (n,) bool)`` of one pass: real rows,
    then an eighth of zero padding rows as a bucket has. ``kind``:
    ``synth`` the LiDAR-like cloud; ``uniform`` points; ``all_equal`` one
    point in every row and no padding, so all n rows are one run;
    ``lattice`` a 1/8 grid (exact duplicates: tied distances, near-tie
    flags); ``far`` |p| ~ 500 with hex-edge x == 0.0 rows (cancellation
    near-ties); ``saturate`` coordinates past 2^31 cells and slots up to
    f32's top (the saturating casts); ``nonfinite`` NaN and infinite
    coordinates."""
    rng = np.random.default_rng(seed)
    m = n if kind == "all_equal" else n - n // 8
    if kind == "synth":
        pos = synth_cloud(m, seed=seed)
    elif kind == "uniform":
        pos = rng.uniform(-300, 300, (m, 3))
    elif kind == "all_equal":
        pos = np.tile(np.float32([1.25, -3.5, 7.0]), (m, 1))
    elif kind == "lattice":
        pos = rng.integers(-24, 24, (m, 3)) / 8.0
    elif kind == "far":
        pos = 500.0 + rng.uniform(-0.05, 0.05, (m, 3))
        pos[::7, 0] = 0.0
    elif kind == "saturate":
        big = np.array([2.2e12, -2.2e12, 1e13, -1e13, 3e38, -3e38, 1e20,
                        2147483648.0, -2147483904.0, 0.5])
        pos = rng.uniform(-300, 300, (m, 3))
        pick = rng.random((m, 3)) < 0.4
        pos[pick] = rng.choice(big, int(pick.sum()))
    elif kind == "nonfinite":
        pos = rng.uniform(-300, 300, (m, 3))
        pick = rng.random((m, 3)) < 0.2
        pos[pick] = rng.choice(np.array([np.nan, np.inf, -np.inf]),
                               int(pick.sum()))
    else:
        raise ValueError(f"unknown pass shape {kind!r}")
    out = np.zeros((n, 3), np.float32)
    out[:m] = pos
    valid = np.zeros(n, bool)
    valid[:m] = True
    return out, valid


def resident_case(n: int, seed: int = 0):
    """``(resident, src_packed, extras)`` of a resident cascade level as
    ``dispatch_dedup_resident`` packs it: half the bucket indexes the
    ``(n, 3)`` resident rows, a third is ``~index`` into the extras, the
    rest padding (``i32::MAX``)."""
    rng = np.random.default_rng(seed)
    resident = synth_cloud(n, seed=seed)
    extras = rng.uniform(-400, 400, (n // 3, 3)).astype(np.float32)
    rows = rng.choice(n, n // 2, replace=False).astype(np.int32)
    src = np.concatenate([rows, ~np.arange(len(extras), dtype=np.int32)])
    src_packed = np.full(n, _I32_MAX, np.int32)
    src_packed[: len(src)] = src[rng.permutation(len(src))]
    return resident, src_packed, extras


# the LOD walk's cases: an indoor-deep walk, own hierarchies at and past
# the last (and below 0), a coarse cell missing under loaded finer ones,
# no loaded cell at all, the renderer's padding rows; "extreme" (rows at
# +-3e9, 1e30, inf and NaN) is for the card alone: a CPU's float to int
# cast of them is not defined
LOD_CASES = ("deep", "own_out_of_range", "gap", "empty_table", "padding")
LOD_LEVELS = 12  # the indoor store's hierarchies


def lod_case(case: str, n: int = 1 << 12, num_h: int = LOD_LEVELS,
             seed: int = 3):
    """``(positions, point_h, sizes, table rows, gap rows)`` of one LOD
    walk case: points over a 50 x 20 x 3 m area, own hierarchies 0-7 as
    in the indoor orbit's frames, the default config's cell sizes (1000 m
    down to 0.49 m at 12 levels), and half the points' cells loaded from
    hierarchy 0 down to a depth drawn per point, as streaming leaves
    them. ``gap`` holds the rows whose next finer cell was taken out of
    the table (their finer cells stay)."""
    from ..core.metadata import MetadataConfig
    from ..render.kernel import MAX_HIERARCHIES

    if case not in LOD_CASES + ("extreme",):
        raise ValueError(f"unknown LOD case {case!r}")
    rng = np.random.default_rng(seed)
    config = MetadataConfig()
    sizes = np.zeros(MAX_HIERARCHIES, np.float32)
    for h in range(num_h):
        sizes[h] = config.cell_size(h)
    positions = (rng.uniform(0.0, 1.0, (n, 3)) * [50.0, 20.0, 3.0]
                 + [-25.0, -10.0, 0.0]).astype(np.float32)
    point_h = rng.integers(0, 8, n).astype(np.int32)
    if case == "padding":  # the renderer pads a bucket with zero rows
        positions[n - n // 4:] = 0.0
        point_h[n - n // 4:] = 0
    if case == "own_out_of_range":
        point_h[::4] = num_h - 1
        point_h[1::4] = num_h + 5
        point_h[2::8] = -1
        # unloaded rows (odd rows are never sampled) far off the area:
        # their first probe misses, so they keep -1
        point_h[3::16] = -1
        positions[3::16] = [600.0, 0.0, 0.0]

    def cells(p, h):
        idx = np.floor(p / sizes[h]).astype(np.int32)
        return np.concatenate([np.full((len(p), 1), h, np.int32), idx], 1)

    sampled = positions[::2]
    depth = rng.integers(0, num_h + 1, len(sampled))
    rows = [cells(sampled[depth > h], h) for h in range(num_h)]
    table = np.concatenate(rows) if case != "empty_table" else \
        np.zeros((0, 4), np.int32)
    gap = np.zeros(n, bool)
    if case == "gap":
        # every fourth sampled row loses its next finer cell, which rows
        # sharing that cell lose too
        cut = np.arange(0, n, 8)
        cut = cut[point_h[cut] + 2 < num_h]
        drop = {tuple(cells(positions[[i]], point_h[i] + 1)[0]) for i in cut}
        table = np.array([r for r in table if tuple(r) not in drop],
                         np.int32).reshape(-1, 4)
        gap[cut] = True
    if case == "extreme":  # after the table: these rows' cells stay out
        positions[::7] = [3e9, -3e9, 1e30]
        positions[1::7] = [np.inf, -np.inf, np.nan]
    return positions, point_h, sizes, table, gap
