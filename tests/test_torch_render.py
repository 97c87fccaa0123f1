"""The port's frame path (point_cloud_tpu_torch/render/) against the reference.

- The copied host modules (caches, transform, camera, frustums, fly cam,
  streamer, the NumPy half of the hash) give the reference's results on
  the same inputs.
- ``hash_member`` and ``lod_select`` equal JAX's exactly; on a CPU
  tensor ``lod_select`` runs its plain version (no K6 launch), which
  equals JAX's walk and a row-at-a-time NumPy walk on twelve hierarchies:
  own hierarchies past the last and below 0, a missing coarse cell under
  loaded finer ones (the walk stops there), no loaded cell, padding rows.
- K1's plain version (``cull_classify_reference``, what the cull runs on
  a CPU tensor) gives JAX's ``_cull_body`` view_pos and ndc bit for bit:
  the pairwise dot reproduces XLA:CPU's (N,4)x(4,4) product. keep,
  hierarchy and radius are equal too, except on rows the test shows to
  lie within the fma drift of a decision boundary: XLA:CPU fuses the
  camera distance's multiply-adds.
- K2's plain version (``splat_raster_reference``) is bit-exact against a
  NumPy oracle rasterizer (NumPy never fuses) in flat and voronoi mode,
  on odd and even windows, on half-pixel centres (odd windows centre on
  rint, half to even) and on the -0.0 and tie cases. The bucket raster
  (every segment in one call, what K2's one launch computes) equals the
  segment-by-segment loop and the oracle word for word: every rung
  filled, overflow rungs past their caps with tails, no row at all, a
  65-px splat on the frame's corner, segments in any order.
- Whole frames of the port's ``PointRenderer`` on the CPU against the JAX
  ``PointRenderer`` on the same store and camera: at least 99.9% of the
  pixels equal and depth within 1e-6 where the pixels agree. The
  difference is XLA:CPU's fma contraction of the fragment distance and
  the voronoi depth; measured on both test scenes: 0 of 19,200 rgb pixels
  differ, and the depth of 2,111 (cube) and 4,696 (corridor) pixels
  differs by at most 1.2e-7.
- The gather reads no point: a frame whose buckets hit the device cache
  reads no cell (single-device and mesh renderers), and each frame of a
  renderer with warm caches, down a flight and after a cell changes in
  place, equals a fresh renderer's.
- The reference's image identities hold exactly in the port. (Its other
  render arms: tests/test_torch_arms.py, tests/test_torch_fusion_sorted.py.)
- Footprint 1: every bucket of the port's frame (the reference's arm)
  equals the NumPy oracle at k = 1 over the kept rows the budget keeps,
  and the frame meets the JAX renderer's (first and steady frames) with
  the same landed counts. A footprint of 129 gives JAX's raster and the
  oracle's; 129- and 300-px windows that cover the frame light the same
  pixels.

The kernels themselves (``cuda`` marker) are held against their plain
versions only where a card exists; here they skip. On the card, without
JAX: ``PCT_TEST_PLATFORM=gpu python -m pytest tests/test_torch_render.py
-m cuda``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from point_cloud_tpu.core.cell import Cell as RCell
from point_cloud_tpu.core.metadata import Metadata as RMetadata
from point_cloud_tpu.core.point import PointBatch as RPointBatch
from point_cloud_tpu.render import camera as rcamera
from point_cloud_tpu_torch.core.cell import Cell as TCell
from point_cloud_tpu_torch.core.metadata import Metadata as TMetadata
from point_cloud_tpu_torch.models.synth import LOD_CASES, LOD_LEVELS, lod_case
from point_cloud_tpu_torch.render import camera as tcamera
from point_cloud_tpu_torch.render import kernel as tkernel
from point_cloud_tpu_torch.render import splat as tsplat
from point_cloud_tpu_torch.render import transform as ttransform
from point_cloud_tpu_torch.render.renderer import PointRenderer as TRenderer
from point_cloud_tpu_torch.render.renderer import RenderSettings as TSettings


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

NO_ID = int(tsplat._NO_ID)


def jax_render():
    """The reference's kernel and splat modules, which import JAX: imported
    by the tests that compare against them, so the ``cuda`` tests collect
    on a machine without JAX."""
    from point_cloud_tpu.render import kernel, splat

    return kernel, splat


# --- carrying the reference's objects across -----------------------------


def port_transform(ref):
    return ttransform.Transform(ref.translation, ref.rotation, ref.scale)


def port_camera(ref):
    cam = tcamera.Camera()
    cam.transform = port_transform(ref.transform)
    p = ref.projection
    cam.projection = tcamera.PerspectiveProjection(
        fov_y=p.fov_y, aspect_ratio=p.aspect_ratio, near=p.near, far=p.far)
    return cam


def port_settings(ref):
    return TSettings(**dataclasses.asdict(ref))


def port_metadata(ref):
    return TMetadata.loads(ref.dumps())


def as_t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.float32:
        return np.array_equal(a.view(np.int32), b.view(np.int32))
    return np.array_equal(a, b)


# --- copied host modules --------------------------------------------------


@pytest.mark.parametrize("case", ["empty", "random", "clustered", "dups"])
def test_build_loaded_cells_hash_byte_equal(case):
    rkernel, _ = jax_render()
    rng = np.random.default_rng(3)
    if case == "empty":
        table = np.empty((0, 4), np.int32)
    elif case == "random":
        table = rng.integers(-2**31, 2**31, (700, 4), dtype=np.int64)
    elif case == "clustered":  # one hierarchy, a dense block: forces growth
        idx = np.stack(np.meshgrid(*[np.arange(-6, 6)] * 3), -1).reshape(-1, 3)
        table = np.concatenate([np.full((len(idx), 1), 2), idx], 1)
    else:
        table = np.repeat(rng.integers(-5, 5, (50, 4)), 3, axis=0)
    table = np.asarray(table, np.int32)
    got = tkernel.build_loaded_cells_hash(table)
    ref = rkernel.build_loaded_cells_hash(table)
    assert got.dtype == ref.dtype and got.tobytes() == ref.tobytes()
    assert np.array_equal(tkernel._hash_rows_np(table),
                          rkernel._hash_rows_np(table))


def test_hash_rows_torch_matches_uint32_numpy():
    """The int64 form of the uint32 hash (logical shifts, wraparound)."""
    rkernel, _ = jax_render()
    rng = np.random.default_rng(4)
    rows = rng.integers(-2**31, 2**31, (5000, 4), dtype=np.int64)
    rows[:4] = [[-2**31] * 4, [2**31 - 1] * 4, [-1] * 4, [0] * 4]
    rows = rows.astype(np.int32)
    got = tkernel._hash_rows_torch(as_t(rows)).numpy()
    assert np.array_equal(got, rkernel._hash_rows_np(rows).astype(np.int64))


def test_lru_and_sorted_hash_match_reference():
    from point_cloud_tpu.utils.lru import LruCache as RLru
    from point_cloud_tpu.utils.sorted_hash import SortedHashMap as RMap
    from point_cloud_tpu_torch.utils.lru import LruCache as TLru
    from point_cloud_tpu_torch.utils.sorted_hash import SortedHashMap as TMap

    def entry(e):
        return None if e is None else (e.hash_key, e.sort_key, e.value)

    logs = []
    for lru_cls, map_cls in ((RLru, RMap), (TLru, TMap)):
        rng = np.random.default_rng(6)
        lru, smap, log = lru_cls(16), map_cls(), []
        for _ in range(400):
            key = int(rng.integers(0, 40))
            op = int(rng.integers(0, 5))
            if op == 0:
                log.append(("put", lru.put(key, key * 2)))
            elif op == 1:
                log.append(("get", lru.get(key), key in lru, len(lru)))
            elif op == 2:
                smap.insert(key, (int(rng.integers(0, 4)), key % 7), key)
            elif op == 3:
                log.append(("rm", entry(smap.remove(key))))
            else:
                log.append(("pop", entry(smap.pop_first()), len(smap)))
        log.append(list(lru.keys()))
        logs.append(log)
    assert logs[0] == logs[1]


def world(n_hier=3):
    md = RMetadata(hierarchies=n_hier)
    md.bounding_box.min = np.array([-500, -500, -500], np.float32)
    md.bounding_box.max = np.array([500, 500, 500], np.float32)
    cam = rcamera.Camera()
    cam.projection.far = md.config.max_cell_size * 5.0
    cam.transform.translation = np.array([30.0, -700.0, 120.0], np.float32)
    cam.transform.look_at(np.array([0.0, 0.0, 0.0], np.float32),
                          np.array([0.0, 0.0, 1.0], np.float32))
    return md, cam


@pytest.mark.parametrize("scale", [1.0, 2.0])
def test_frustums_and_streamer_load_order_match(scale):
    """update_streaming_frustums, the streamer's visible-set diff, load
    order, loaded-cells table and far distances: the reference's."""
    from point_cloud_tpu.render.frustums import update_streaming_frustums as rf
    from point_cloud_tpu.render.streaming import CellStreamer as RStreamer
    from point_cloud_tpu_torch.render.frustums import (
        update_streaming_frustums as tf,
    )
    from point_cloud_tpu_torch.render.streaming import CellStreamer as TStreamer

    md, cam = world()
    tmd, tcam = port_metadata(md), port_camera(cam)
    assert np.array_equal(tcam.view_matrix(), cam.view_matrix())
    assert np.array_equal(tcam.projection_matrix(), cam.projection_matrix())
    rfr = rf(md, cam.transform, cam.projection, cam.frustum(), scale)
    tfr = tf(tmd, tcam.transform, tcam.projection, tcam.frustum(), scale)
    assert len(rfr) == len(tfr) == 3
    for a, b in zip(rfr, tfr):
        for attr in ("near", "far", "planes"):
            assert np.array_equal(getattr(a, attr), getattr(b, attr))
    orders, tables, fars = [], [], []
    for streamer_cls, frustums, camera, meta, cell_cls in (
            (RStreamer, rfr, cam, md, RCell), (TStreamer, tfr, tcam, tmd, TCell)):
        streamer = streamer_cls(meta, max_loading=7)
        streamer.update(frustums, camera.transform)
        order = []
        while True:
            started = streamer.fill_load_slots()
            if not started:
                break
            order += started
            for i, cid in enumerate(started):
                if i % 3 == 2:
                    streamer.on_missing(cid)
                else:
                    size = meta.config.cell_size(cid.hierarchy)
                    streamer.on_loaded(cid, cell_cls(
                        cid, meta.config.sub_cell_size(size), size,
                        meta.config.cell_pos(np.asarray(cid.index, np.int32),
                                             size)))
        orders.append([(c.hierarchy, tuple(c.index)) for c in order])
        tables.append(streamer.loaded_cells_table())
        fars.append(streamer.frustum_far_distances(frustums, camera.transform))
    assert orders[0] == orders[1] and len(orders[0]) > 10
    assert np.array_equal(tables[0], tables[1])
    assert np.array_equal(fars[0], fars[1])


def test_fly_cam_and_orbit_path_match():
    from point_cloud_tpu.render.fly_cam import FlyCam as RFly
    from point_cloud_tpu.render.fly_cam import orbit_path as rorbit
    from point_cloud_tpu_torch.render.fly_cam import FlyCam as TFly
    from point_cloud_tpu_torch.render.fly_cam import orbit_path as torbit

    center = np.array([3.0, -4.0, 12.5], np.float32)
    for a, b in zip(rorbit(center, 250.0, 90.0, 7), torbit(center, 250.0, 90.0, 7)):
        assert np.array_equal(a.compute_matrix(), b.compute_matrix())
    _, cam = world()
    r, t = RFly.from_transform(cam.transform), TFly.from_transform(
        port_transform(cam.transform))
    for fly in (r, t):
        fly.rotate(12.0, -7.0)
        fly.adjust_speed(2.0)
        fly.move(0.25, 1.0, -0.5, 0.3)
    assert np.array_equal(r.transform.compute_matrix(),
                          t.transform.compute_matrix())


# --- the LOD walk ---------------------------------------------------------


def lod_inputs(seed=12, n=3000, num_h=5):
    from point_cloud_tpu.core.metadata import MetadataConfig

    rng = np.random.default_rng(seed)
    config = MetadataConfig()
    sizes = np.zeros(tkernel.MAX_HIERARCHIES, np.float32)
    for h in range(num_h):
        sizes[h] = config.cell_size(h)
    positions = rng.uniform(-800, 800, (n, 3)).astype(np.float32)
    point_h = rng.integers(0, num_h, n).astype(np.int32)
    entries = set()
    for p in positions[::3]:
        for h in range(num_h):
            if rng.random() < 0.6:
                entries.add((h, *np.floor(p / sizes[h]).astype(np.int32)))
    table = np.array(sorted(entries), np.int32).reshape(-1, 4)
    return positions, point_h, sizes, table, num_h


def test_hash_member_matches_jax():
    rkernel, _ = jax_render()
    import jax.numpy as jnp

    positions, _, sizes, table, num_h = lod_inputs()
    hash_table = rkernel.build_loaded_cells_hash(table)
    found = 0
    for h in range(num_h):
        idx = np.floor(positions / sizes[h]).astype(np.int32)
        targets = np.concatenate([np.full((len(idx), 1), h, np.int32), idx], 1)
        ref = np.asarray(rkernel.hash_member(jnp.asarray(hash_table),
                                             jnp.asarray(targets)))
        got = tkernel.hash_member(as_t(hash_table), as_t(targets)).numpy()
        assert np.array_equal(got, ref)
        found += got.sum()
    assert 0 < found < num_h * len(positions)


def test_lod_select_matches_jax():
    rkernel, _ = jax_render()
    import jax.numpy as jnp

    positions, point_h, sizes, table, num_h = lod_inputs()
    hash_table = rkernel.build_loaded_cells_hash(table)
    ref = np.asarray(rkernel.lod_select(
        jnp.asarray(positions), jnp.asarray(point_h), jnp.asarray(sizes),
        num_h, jnp.asarray(hash_table)))
    got = tkernel.lod_select(as_t(positions), as_t(point_h), as_t(sizes),
                             num_h, as_t(hash_table)).numpy()
    assert np.array_equal(got, ref)
    assert (got > point_h).sum() > 100  # the walk really moved points


def lod_walk_reference_np(positions, point_h, sizes, num_h, table):
    """The walk one row at a time over a set of loaded rows: the NumPy
    statement of kernel.py:172-196 the cases are held to."""
    loaded = {tuple(r) for r in table}
    last = num_h - 1
    out = np.minimum(point_h, last)
    for i in range(len(positions)):
        for h in range(max(int(out[i]) + 1, 1), last + 1):
            cell = (h, *np.floor(positions[i] / sizes[h]).astype(np.int32))
            if tuple(int(c) for c in cell) not in loaded:
                break
            out[i] = h
    return out


@pytest.mark.parametrize("case", LOD_CASES)
def test_lod_select_cases_match_jax(case):
    """The wrapper on a CPU tensor runs the plain version (no K6 launch)
    and gives JAX's walk and the row-at-a-time walk on every case."""
    rkernel, _ = jax_render()
    import jax.numpy as jnp

    positions, point_h, sizes, table, gap = lod_case(case)
    hash_table = rkernel.build_loaded_cells_hash(table)
    assert np.array_equal(hash_table, tkernel.build_loaded_cells_hash(table))
    ref = np.asarray(rkernel.lod_select(
        jnp.asarray(positions), jnp.asarray(point_h), jnp.asarray(sizes),
        LOD_LEVELS, jnp.asarray(hash_table)))
    before = tkernel.lod_launches
    got = tkernel.lod_select(as_t(positions), as_t(point_h), as_t(sizes),
                             LOD_LEVELS, as_t(hash_table))
    assert tkernel.lod_launches == before
    assert got.dtype == torch.int32 and got.shape == (len(positions),)
    got = got.numpy()
    assert np.array_equal(got, ref)
    assert np.array_equal(got, lod_walk_reference_np(
        positions, point_h, sizes, LOD_LEVELS, table))
    own = np.minimum(point_h, LOD_LEVELS - 1)
    if case == "empty_table":
        assert np.array_equal(got, own)
    else:  # the walk moved rows
        assert (got > own).sum() > (100 if case == "gap" else len(got) // 8)
    if case == "gap":  # the walk stops at the missing cell
        assert gap.sum() > 100 and np.array_equal(got[gap], own[gap])
        loaded = {tuple(r) for r in table}
        finer = [(int(own[i]) + 2, *np.floor(
            positions[i] / sizes[own[i] + 2]).astype(np.int32))
            for i in np.flatnonzero(gap)]
        assert sum(tuple(int(c) for c in f) in loaded for f in finer) > 10
    if case == "own_out_of_range":
        past = point_h >= LOD_LEVELS - 1
        assert np.array_equal(got[past], np.full(past.sum(), LOD_LEVELS - 1))
        assert (got[point_h < 0] >= 0).any()
        assert np.array_equal(got[3::16], np.full(len(got[3::16]), -1))


def test_lod_select_routes_by_device():
    """CPU tensors run the plain version; a device that is neither the
    card nor the CPU raises (no fallback)."""
    positions, point_h, sizes, table, _ = lod_case("deep", n=256)
    args = [as_t(positions), as_t(point_h), as_t(sizes), LOD_LEVELS,
            as_t(tkernel.build_loaded_cells_hash(table))]
    assert torch.equal(tkernel.lod_select(*args),
                       tkernel.lod_select_reference(*args))
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(ValueError, match="cuda or cpu"):
        tkernel.lod_select(*meta)


@pytest.mark.parametrize("broken", ["hier_i64", "pos_strided", "sizes_short",
                                    "table_not_pow2", "table_width",
                                    "table_1d", "table_offset"])
def test_lod_select_checks_kernel_arguments(broken):
    """What K6 does not take raises before a launch."""
    positions, point_h, sizes, table, _ = lod_case("deep", n=256)
    args = {"positions": as_t(positions), "point_hierarchy": as_t(point_h),
            "cell_sizes": as_t(sizes), "num_hierarchies": LOD_LEVELS,
            "loaded_cells": as_t(tkernel.build_loaded_cells_hash(table))}
    tkernel._check_lod_args(**args)
    if broken == "hier_i64":
        args["point_hierarchy"] = args["point_hierarchy"].long()
    elif broken == "pos_strided":
        args["positions"] = torch.zeros(256, 6)[:, ::2]
    elif broken == "sizes_short":
        args["cell_sizes"] = args["cell_sizes"][: LOD_LEVELS - 1].clone()
    elif broken == "table_not_pow2":
        args["loaded_cells"] = args["loaded_cells"][:48].clone()
    elif broken == "table_width":
        args["loaded_cells"] = args["loaded_cells"][:, :12].clone()
    elif broken == "table_1d":
        args["loaded_cells"] = args["loaded_cells"].reshape(-1)
    else:  # a view 4 bytes past an aligned start
        args["loaded_cells"] = torch.zeros(
            64 * 16 + 1, dtype=torch.int32)[1:].reshape(64, 16)
    with pytest.raises(ValueError, match="lod_select"):
        tkernel._check_lod_args(**args)


# --- K1: the cull and classify pass ---------------------------------------

LADDER = (1, 2, 3, 4, 5, 6, 7, 8, 9, 17, 33, 65)


def cull_scene(seed, n=1 << 14, w=160, h=120):
    """Random points around the default camera, four hierarchies, and a
    depth plane from a near wall so occlusion and the pyramid both act."""
    rng = np.random.default_rng(seed)
    cam = rcamera.Camera()
    cam.projection.far = 3000.0
    cam.projection.aspect_ratio = w / h
    pos = rng.uniform(-150, 150, (n, 3)).astype(np.float32)
    pos[:, 1] = rng.uniform(-1, 400, n).astype(np.float32)
    hb = rng.integers(0, 4, n).astype(np.int32)
    valid = rng.random(n) < 0.95
    spacings = np.zeros(tkernel.MAX_HIERARCHIES, np.float32)
    spacings[:4] = [6.0, 3.0, 1.5, 0.75]
    far = np.zeros(tkernel.MAX_HIERARCHIES, np.float32)
    far[:4] = [3000.0, 250.0, 120.0, 60.0]
    # a depth plane: near in the left half, clear elsewhere, plus noise
    depth = np.ones((h, w), np.float32)
    depth[:, : w // 2] = rng.uniform(0.985, 0.995, (h, w // 2))
    return dict(
        positions=pos, hier_base=hb, valid=valid,
        view=cam.view_matrix().astype(np.float32),
        projection=cam.projection_matrix().astype(np.float32),
        cam_pos=np.asarray(cam.transform.translation, np.float32),
        spacings=spacings, far_distances=far), depth, (w, h)


@pytest.mark.parametrize("occ,pyr,sbd", [
    (False, False, False), (True, False, False), (True, True, False),
    (True, True, True),
])
def test_cull_plain_matches_jax_cull_body(occ, pyr, sbd):
    rkernel, _ = jax_render()
    import jax.numpy as jnp

    arrays, depth, _ = cull_scene(21)
    ref = rkernel._cull_body(
        *(jnp.asarray(arrays[k]) for k in (
            "positions", "hier_base", "valid", "view", "projection",
            "cam_pos", "spacings", "far_distances")),
        jnp.bool_(sbd), jnp.int32(3), jnp.asarray(depth) if occ else None,
        occ, pyr)
    ref = [np.asarray(r) for r in ref]  # keep, hierarchy, ndc, view_pos, radius
    t = {k: as_t(v) for k, v in arrays.items()}
    got = tkernel._cull_body(
        t["positions"], t["hier_base"], t["valid"], t["view"],
        t["projection"], t["cam_pos"], t["spacings"], t["far_distances"],
        sbd, 3, as_t(depth) if occ else None, occ, pyr)
    got = [g.numpy() for g in got]
    assert bits_equal(got[2], ref[2])  # ndc
    assert bits_equal(got[3], ref[3])  # view_pos
    # the distance override compares an fma-fused distance in XLA:CPU:
    # a differing row must sit within a few ulps of a far distance
    pos = arrays["positions"].astype(np.float64)
    dist = np.linalg.norm(pos - arrays["cam_pos"], axis=1)
    near_edge = (np.abs(dist[:, None] - arrays["far_distances"][None, :4])
                 <= 1e-5 * dist[:, None]).any(axis=1)
    for i in (0, 1, 4):  # keep, hierarchy, radius
        differ = ~(got[i] == ref[i])
        assert not (differ & ~near_edge).any(), i
    assert got[0].sum() > 500
    if sbd:
        assert (got[1] != arrays["hier_base"]).sum() > 100
    if occ:  # occlusion really culled something the plain cull keeps
        plain = tkernel._cull_body(
            t["positions"], t["hier_base"], t["valid"], t["view"],
            t["projection"], t["cam_pos"], t["spacings"],
            t["far_distances"], sbd, 3, None, False, False)[0].numpy()
        assert (plain & ~got[0]).sum() > 50


def test_cull_rung_is_the_reference_exclusive_band():
    """rmax and the exclusive rung from K1's plain version against the
    reference's splat_pixel_radii and its nested fit masks
    (splat.py:729-750), with the pyramid gate on."""
    _, rsplat = jax_render()
    import jax.numpy as jnp

    arrays, depth, (w, h) = cull_scene(22)
    t = {k: as_t(v) for k, v in arrays.items()}
    dt = as_t(depth)
    keep, _, view_pos, _, radius, rmax, rung = tkernel.cull_classify(
        t["positions"], t["hier_base"], t["valid"], t["view"],
        t["projection"], t["cam_pos"], t["spacings"], t["far_distances"],
        False, 0, as_t(np.array([k / 2 for k in LADDER], np.float32)), w, h,
        depth=dt, coarse=tkernel.coarse_depth_grid(dt))
    rx, ry = rsplat.splat_pixel_radii(
        jnp.asarray(view_pos.numpy()), jnp.asarray(radius.numpy()),
        jnp.asarray(arrays["projection"]), w, h)
    assert bits_equal(rmax.numpy(), np.maximum(np.asarray(rx), np.asarray(ry)))
    keep, rmax, rung = keep.numpy(), rmax.numpy(), rung.numpy()
    covered = np.zeros_like(keep)
    want = np.full(len(keep), -1, np.int32)
    for j, k in enumerate(LADDER):
        fits = keep & (rmax < np.float32(k / 2)) if j < len(LADDER) - 1 else keep
        want[fits & ~covered] = j
        covered |= fits
    assert np.array_equal(rung, want)
    assert len(np.unique(rung[keep])) >= 4


def test_cull_classify_pass_matches_jax():
    """The camera pass with the cumulative ladder counts (kernel.py:
    398-437): every output bit-equal to JAX's on a scene without the
    fma-sensitive distance override."""
    import jax.numpy as jnp

    rkernel, _ = jax_render()
    arrays, depth, (w, h) = cull_scene(24)
    thr = np.array([k / 2 for k in LADDER], np.float32)
    names = ("positions", "hier_base", "valid", "view", "projection",
             "cam_pos", "spacings", "far_distances")
    ref = rkernel.cull_classify_pass(
        *(jnp.asarray(arrays[k]) for k in names), jnp.bool_(False),
        jnp.int32(0), jnp.asarray(thr), w, h, depth=jnp.asarray(depth),
        use_occlusion=True, use_pyramid=True)
    got = tkernel.cull_classify_pass(
        *(as_t(arrays[k]) for k in names), False, 0, as_t(thr), w, h,
        depth=as_t(depth), use_occlusion=True, use_pyramid=True)
    assert len(got) == len(ref) == 7
    for g, r in zip(got, ref):
        assert bits_equal(g.numpy(), np.asarray(r))
    counts = got[6].numpy()
    assert counts[0] > 500 and len(np.unique(counts[1:])) >= 4


def test_coarse_grid_wraps_like_jnp_roll():
    import jax.numpy as jnp

    rng = np.random.default_rng(8)
    depth = rng.uniform(0, 1, (37, 50)).astype(np.float32)
    t = tkernel.PYRAMID_TILE
    dpad = jnp.pad(jnp.asarray(depth), ((0, 3), (0, 6)), constant_values=1.0)
    coarse = dpad.reshape(40 // t, t, 56 // t, t).max(axis=(1, 3))
    for ax in (0, 1):
        coarse = jnp.maximum(coarse, jnp.maximum(jnp.roll(coarse, 1, ax),
                                                 jnp.roll(coarse, -1, ax)))
    got = tkernel.coarse_depth_grid(as_t(depth)).numpy()
    assert bits_equal(got, np.asarray(coarse))


def test_trunc_index_casts_like_the_kernel():
    """Truncation toward zero, then the clamp; NaN and infinities land in
    range (the kernel's saturating __float2int_rz)."""
    u = torch.tensor([-5.0, -0.5, 0.0, 0.99, 3.7, 9.0, 1e30, -1e30,
                      float("nan"), float("inf"), float("-inf")])
    assert tkernel._trunc_index(u, 10).tolist() == [0, 0, 0, 0, 3, 9, 9, 0,
                                                    0, 9, 0]


# --- compact_classes ------------------------------------------------------


def test_compact_classes_matches_numpy_oracle():
    rng = np.random.default_rng(77)
    for trial in range(12):
        c, n = int(rng.integers(1, 14)), int(rng.integers(8, 300))
        owner = rng.integers(-1, c, n).astype(np.int32)
        if trial == 0:
            owner[:] = c - 1  # one full class, the others empty
        perm, counts, offsets = (
            x.numpy() for x in tsplat.compact_classes(as_t(owner), c))
        masks = np.stack([owner == i for i in range(c)])
        assert perm.shape == (2 * n,)
        assert np.array_equal(counts, masks.sum(axis=1))
        assert np.array_equal(offsets,
                              np.concatenate([[0], np.cumsum(counts)[:-1]]))
        for i in range(c):
            assert np.array_equal(perm[offsets[i] : offsets[i] + counts[i]],
                                  np.flatnonzero(masks[i]))


# --- K2: the splat raster against a NumPy oracle --------------------------


def oracle_fragments(view_pos, ndc, radius, ids, proj, h, w, k, voronoi):
    """The reference's fragment math (splat.py:187-259) in NumPy f32, one
    operation at a time: (pixel, depth, id) of every lit fragment."""
    f32 = np.float32
    px = (ndc[:, 0] * f32(0.5) + f32(0.5)) * f32(w)
    py = (ndc[:, 1] * f32(-0.5) + f32(0.5)) * f32(h)
    w_clip = np.maximum(-view_pos[:, 2], f32(1e-6))
    rx = np.maximum(radius * proj[0, 0] / w_clip * f32(0.5 * w), f32(1e-6))
    ry = np.maximum(radius * proj[1, 1] / w_clip * f32(0.5 * h), f32(1e-6))
    if k % 2:
        half = (k - 1) // 2
        bx, by = np.round(px), np.round(py)  # half to even
    else:
        half = k // 2 - 1
        bx, by = np.floor(px), np.floor(py)
    pix, dep, pid = [], [], []
    for iy in range(k):
        for ix in range(k):
            fx = bx + f32(ix - half)
            fy = by + f32(iy - half)
            nx = (fx - px) / rx
            ny = (fy - py) / ry
            d2 = nx * nx + ny * ny
            if voronoi:
                mz = view_pos[:, 2] + radius * (f32(1.0) - d2)
                depth = (proj[2, 2] * mz + proj[2, 3]) / -mz
            else:
                depth = ndc[:, 2].copy()
            ok = ((d2 <= 1) & (fx >= 0) & (fx < w) & (fy >= 0) & (fy < h)
                  & (depth >= 0) & (depth <= 1))
            pix.append((fy[ok].astype(np.int64) * w + fx[ok].astype(np.int64)))
            dep.append(depth[ok])
            pid.append(ids[ok])
    return np.concatenate(pix), np.concatenate(dep), np.concatenate(pid)


def oracle_raster(depth_plane, id_plane, pix, dep, pid):
    """Per pixel the nearest fragment, ties to the smallest id (LessEqual
    against the old pixel too); -0.0 ranks equal to +0.0."""
    depth_plane, id_plane = depth_plane.copy(), id_plane.copy()
    order = np.lexsort((pid, dep, pix))  # -0.0 == +0.0 in the sort too
    pix, dep, pid = pix[order], dep[order], pid[order]
    first = np.ones(len(pix), bool)
    first[1:] = pix[1:] != pix[:-1]
    for p, d, i in zip(pix[first], dep[first], pid[first]):
        if d < depth_plane[p] or (d == depth_plane[p] and i < id_plane[p]):
            depth_plane[p], id_plane[p] = d, i
    return depth_plane, id_plane


def splat_rows(seed, n, w, h, spread_px):
    """n splats seen by the default camera at half-extents up to
    ``spread_px`` pixels, many overlapping."""
    rng = np.random.default_rng(seed)
    cam = rcamera.Camera()
    cam.projection.aspect_ratio = w / h
    view = cam.view_matrix().astype(np.float32)
    proj = cam.projection_matrix().astype(np.float32)
    pos = np.stack([rng.uniform(-4, 4, n), rng.uniform(10, 14, n),
                    rng.uniform(-3, 3, n)], 1).astype(np.float32)
    hpos = np.concatenate([pos, np.ones((n, 1), np.float32)], 1)
    view_pos = (hpos @ view.T).astype(np.float32)
    clip = view_pos @ proj.T
    ndc = (clip[:, :3] / clip[:, 3:4]).astype(np.float32)
    w_clip = -view_pos[:, 2]
    radius = (rng.uniform(0.2, 1.0, n) * spread_px * w_clip
              / (proj[1, 1] * 0.5 * h)).astype(np.float32)
    ids = rng.permutation(n).astype(np.int32) + 1
    return view_pos, ndc, radius, ids, proj


@pytest.mark.parametrize("voronoi", [True, False])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 8, 9, 17])
def test_raster_plain_matches_numpy_oracle(k, voronoi):
    w, h, n = 64, 48, 300
    view_pos, ndc, radius, ids, proj = splat_rows(k, n, w, h, k / 2)
    # a prior frame in the plane: some pixels already near, some tied
    rng = np.random.default_rng(k)
    depth0 = np.ones(h * w, np.float32)
    id0 = np.full(h * w, NO_ID, np.int64)
    hit = rng.random(h * w) < 0.2
    depth0[hit] = rng.uniform(0.9, 1.0, hit.sum()).astype(np.float32)
    id0[hit] = rng.integers(1, 500, hit.sum())
    fb = torch.as_tensor((depth0.view(np.int32).astype(np.int64) << 32) | id0)
    perm = np.concatenate([np.arange(n), np.zeros(n)]).astype(np.int32)
    start, count = torch.tensor([0], dtype=torch.int32), torch.tensor(
        [n], dtype=torch.int32)
    tsplat.splat_raster(fb, as_t(view_pos), as_t(ndc), as_t(radius),
                        as_t(ids), as_t(perm), start, count, as_t(proj), h, w,
                        k, voronoi, chunk_rows=37)
    want_d, want_i = oracle_raster(depth0, id0, *oracle_fragments(
        view_pos, ndc, radius, ids, proj, h, w, k, voronoi))
    got = tsplat.Framebuffer(fb)
    assert np.array_equal(got.point_id.numpy(), want_i)
    assert bits_equal(got.depth.numpy(), np.where(want_d == 0, 0, want_d)
                      .astype(np.float32))
    assert (got.point_id.numpy() != id0).sum() > 50


def half_pixel_splats(device="cpu"):
    """Flat splats whose centres sit exactly on half pixels (px = 2.5 and
    5.5, py = 0 in an 8x1 frame) with half-extents of 0.6 px: an odd
    window centres on rint (half to even: pixels 2 and 6, where roundf
    would pick 3 and 6), an even window bases on floor (2 and 5)."""
    w, h = 8, 1
    cam = rcamera.Camera()
    cam.projection.aspect_ratio = w / h  # rx == ry
    proj = cam.projection_matrix().astype(np.float32)
    ndc = np.array([[2.5 / 4 - 1, 1.0, 0.5], [5.5 / 4 - 1, 1.0, 0.25]],
                   np.float32)
    view_pos = np.tile(np.array([[0, 0, -5.0, 1.0]], np.float32), (2, 1))
    radius = np.full(2, 0.6 * 5.0 / (proj[1, 1] * 0.5 * h), np.float32)
    ids = np.array([11, 12], np.int32)
    perm = np.concatenate([np.arange(2), np.zeros(2)]).astype(np.int32)
    return [as_t(a).to(device) for a in (view_pos, ndc, radius, ids, perm,
                                         proj)], (h, w)


@pytest.mark.parametrize("k,lit", [(1, [2, 6]), (2, [2, 3, 5, 6]),
                                   (3, [2, 3, 5, 6])])
def test_raster_rounds_half_to_even(k, lit):
    (view_pos, ndc, radius, ids, perm, proj), (h, w) = half_pixel_splats()
    fb = tsplat.make_framebuffer(h, w).packed
    one = torch.tensor([0], dtype=torch.int32)
    tsplat.splat_raster(fb, view_pos, ndc, radius, ids, perm, one,
                        torch.tensor([2], dtype=torch.int32), proj, h, w, k,
                        False, chunk_rows=2)
    got = tsplat.Framebuffer(fb).point_id.numpy()
    assert np.flatnonzero(got != NO_ID).tolist() == lit


@pytest.mark.parametrize("n_counts", [5, 130])
def test_pack_frame_layout(n_counts):
    """[rgb | PACK_COUNTS i32 counts, padded or cut | f32 depth], against
    resolve_framebuffer (splat.py:940-966)."""
    h, w = 3, 5
    rng = np.random.default_rng(n_counts)
    depth = rng.uniform(0, 1, h * w).astype(np.float32)
    ids = rng.integers(1, 9, h * w)
    ids[::4] = NO_ID
    fb = tsplat.Framebuffer(as_t((depth.view(np.int32).astype(np.int64) << 32)
                                 | ids))
    colors = as_t(rng.integers(0, 256, (16, 4), dtype=np.uint8))
    counts = as_t(rng.integers(0, 1000, n_counts).astype(np.int32))
    rgb, dplane = tsplat.resolve_framebuffer(fb, colors, h, w)
    buf = tsplat.pack_frame(fb, colors, counts, h, w, True).numpy()
    pc = tsplat.PACK_COUNTS
    assert buf.shape == (h * w * 3 + 4 * pc + 4 * h * w,)
    assert np.array_equal(buf[: h * w * 3], rgb.numpy().reshape(-1))
    got = buf[h * w * 3 : h * w * 3 + 4 * pc].view(np.int32)
    want = np.zeros(pc, np.int32)
    want[: min(n_counts, pc)] = counts.numpy()[:pc]
    assert np.array_equal(got, want)
    assert bits_equal(buf[h * w * 3 + 4 * pc :].view(np.float32), depth)
    assert (rgb.numpy().reshape(-1, 3)[::4] == tsplat.CLEAR_COLOR_U8).all()
    assert bits_equal(dplane.numpy().reshape(-1), depth)


def test_raster_negative_zero_and_ties():
    """-0.0 ties +0.0 and the smaller id wins; a fragment at exactly the
    clear depth 1.0 beats _NO_ID; an equal depth already in the plane (an
    earlier bucket's) keeps the smaller id, whichever side has it."""
    w, h = 4, 1
    proj = rcamera.Camera().projection_matrix().astype(np.float32)
    # flat splats centred on pixels 0, 0, 1 and 3 (px = 0, 1, 3; py = 0)
    ndc = np.array([[-1.0, 1.0, -0.0], [-1.0, 1.0, 0.0],
                    [-0.5, 1.0, 1.0], [0.5, 1.0, 0.5]], np.float32)
    view_pos = np.tile(np.array([[0, 0, -5.0, 1.0]], np.float32), (4, 1))
    radius = np.full(4, 1e-3, np.float32)
    ids = np.array([7, 3, 5, 9], np.int32)

    def word(depth, i):
        return (int(np.float32(depth).view(np.int32)) << 32) | i

    perm = as_t(np.concatenate([np.arange(4), np.zeros(4)]).astype(np.int32))
    planes = []
    for prior in (4, 12):
        fb = torch.tensor([tsplat._CLEAR_WORD] * 3 + [word(0.5, prior)])
        tsplat.splat_raster(fb, as_t(view_pos), as_t(ndc), as_t(radius),
                            as_t(ids), perm,
                            torch.tensor([0], dtype=torch.int32),
                            torch.tensor([4], dtype=torch.int32), as_t(proj),
                            h, w, 1, False, chunk_rows=4)
        planes.append(tsplat.Framebuffer(fb))
    assert planes[0].point_id.tolist() == [3, 5, NO_ID, 4]
    assert planes[1].point_id.tolist()[3] == 9
    assert planes[0].depth.tolist() == [0.0, 1.0, 1.0, 0.5]
    assert np.float32(planes[0].depth[0]).view(np.int32) == 0  # +0.0 kept


# --- K2 on a bucket: all segments in one call ------------------------------

BUCKET_RUNGS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 17, 33, 65)
BUCKET_FOOTPRINT = 5


def raster_bucket(case, seed=5, n=400, w=96, h=64):
    """Seeded splats with a rung drawn for every row (the raster clips a
    splat to whatever window its rung gives it), ranked by
    compact_classes. ``empty``: no row in any rung; ``corner``: one row,
    in the 65 rung, centred on the frame's first pixel."""
    view_pos, ndc, radius, ids, proj = splat_rows(seed, n, w, h, 6.0)
    rng = np.random.default_rng(seed + 1000)
    rung = rng.integers(-1, len(BUCKET_RUNGS), n).astype(np.int32)
    if case == "empty":
        rung[:] = -1
    elif case == "corner":
        rung[:] = -1
        rung[7] = BUCKET_RUNGS.index(65)
        ndc[7, :2] = (-1.0, 1.0)
        radius[7] *= 6.0
    perm, counts, offsets = tsplat.compact_classes(as_t(rung),
                                                   len(BUCKET_RUNGS))
    arrays = dict(view_pos=view_pos, ndc=ndc, radius=radius, ids=ids,
                  proj=proj, rung=rung)
    return arrays, perm, counts, offsets, (h, w)


def bucket_parts(rung, n):
    """(window, rows) of every segment by the cap's definition: a rung's
    rows in row order through its own window, an overflow rung's beyond
    its cap through the footprint window."""
    parts = []
    for j, k in enumerate(BUCKET_RUNGS):
        rows = np.flatnonzero(rung == j)
        cap = (tsplat.rung_chunk_rows(k, n) * tsplat.RUNG_CAP_CHUNKS
               if k > BUCKET_FOOTPRINT else len(rows))
        parts += [(k, rows[:cap]), (BUCKET_FOOTPRINT, rows[cap:])]
    return parts


def run_bucket(a, perm, counts, offsets, h, w, voronoi, fb, **kw):
    return tsplat.raster_rungs(
        fb, as_t(a["view_pos"]), as_t(a["ndc"]), as_t(a["radius"]),
        as_t(a["ids"]), perm, counts, offsets, as_t(a["proj"]), height=h,
        width=w, rungs=BUCKET_RUNGS, footprint=BUCKET_FOOTPRINT,
        voronoi=voronoi, **kw)


@pytest.mark.parametrize("voronoi", [True, False])
@pytest.mark.parametrize("case", ["filled", "overflow", "empty", "corner"])
def test_bucket_raster_matches_segment_loop_and_oracle(case, voronoi,
                                                       monkeypatch):
    """The one-call bucket raster (what K2 runs on a CPU tensor) equals,
    word for word, the segment-by-segment loop on splat_raster_reference
    composed by hand from the cap's definition, and the NumPy oracle over
    the same segments: every rung of the even and odd ladder filled;
    overflow rungs past their caps, with tails; no row at all; and one
    65-px splat clipped by the frame's corner."""
    if case == "overflow":  # every overflow rung's cap falls to 8 rows
        monkeypatch.setattr(tsplat, "RUNG_CHUNK_FRAGS", 256)
        monkeypatch.setattr(tsplat, "RUNG_CAP_CHUNKS", 1)
    a, perm, counts, offsets, (h, w) = raster_bucket(case)
    n = len(a["rung"])
    if case == "filled":
        assert (counts > 0).all()
    if case == "overflow":
        over = [j for j, k in enumerate(BUCKET_RUNGS) if k > BUCKET_FOOTPRINT]
        assert (counts[over] > 8).all()
    fb0 = tsplat.make_framebuffer(h, w).packed
    got = run_bucket(a, perm, counts, offsets, h, w, voronoi, fb0.clone())

    parts = bucket_parts(a["rung"], n)
    manual = fb0.clone()
    frags = []
    for k, rows in parts:
        seg_perm = np.concatenate([rows, np.zeros(n)]).astype(np.int32)
        tsplat.splat_raster_reference(
            manual, as_t(a["view_pos"]), as_t(a["ndc"]), as_t(a["radius"]),
            as_t(a["ids"]), as_t(seg_perm),
            torch.tensor([0], dtype=torch.int32),
            torch.tensor([len(rows)], dtype=torch.int32), as_t(a["proj"]),
            h, w, k, voronoi, 64)
        frags.append(oracle_fragments(
            a["view_pos"][rows], a["ndc"][rows], a["radius"][rows],
            a["ids"][rows], a["proj"], h, w, k, voronoi))
    assert torch.equal(got, manual)

    want_d, want_i = oracle_raster(
        np.ones(h * w, np.float32), np.full(h * w, NO_ID, np.int64),
        *(np.concatenate(col) for col in zip(*frags)))
    plane = tsplat.Framebuffer(got)
    assert np.array_equal(plane.point_id.numpy(), want_i)
    assert bits_equal(plane.depth.numpy(),
                      np.where(want_d == 0, 0, want_d).astype(np.float32))
    lit = int((plane.point_id.numpy() != NO_ID).sum())
    if case == "empty":
        assert lit == 0 and torch.equal(got, fb0)
    elif case == "corner":  # clipped to the quadrant inside the frame
        ys, xs = np.divmod(np.flatnonzero(plane.point_id.numpy() != NO_ID), w)
        assert lit > 50 and ys.max() <= 32 and xs.max() <= 32
        assert plane.point_id.numpy()[0] == a["ids"][7]
    else:
        assert lit > 500


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bucket_raster_ignores_segment_order(seed, monkeypatch):
    """The plane is a minimum: segments in any order give the same words."""
    monkeypatch.setattr(tsplat, "RUNG_CHUNK_FRAGS", 256)
    monkeypatch.setattr(tsplat, "RUNG_CAP_CHUNKS", 1)
    a, perm, counts, offsets, (h, w) = raster_bucket("overflow", seed=seed + 9)
    segments = tsplat.bucket_segments(BUCKET_RUNGS, BUCKET_FOOTPRINT,
                                      len(a["rung"]))
    order = np.random.default_rng(seed).permutation(len(segments))
    planes = []
    for segs in (segments, tuple(segments[i] for i in order)):
        fb = tsplat.make_framebuffer(h, w).packed
        tsplat.splat_raster_segments(
            fb, as_t(a["view_pos"]), as_t(a["ndc"]), as_t(a["radius"]),
            as_t(a["ids"]), perm, offsets, counts, as_t(a["proj"]), h, w,
            segs, True)
        planes.append(fb)
    assert torch.equal(planes[0], planes[1])
    assert (planes[0] != tsplat._CLEAR_WORD).sum() > 500


def test_bucket_segments_table():
    """One segment a rung, footprint first, overflow rungs capped at
    rung_chunk_rows * RUNG_CAP_CHUNKS, then one footprint-window tail an
    overflow rung; the bounds follow counts and offsets on the device."""
    S = tsplat.Segment
    n = 1 << 14
    cap = {k: tsplat.rung_chunk_rows(k, n) * tsplat.RUNG_CAP_CHUNKS
           for k in (9, 17)}
    assert cap == {9: 512 * 64, 17: 128 * 64}
    assert tsplat.bucket_segments((3, 5, 9, 17), 5, n) == (
        S(5, 1, tsplat.NO_CAP, False), S(3, 0, tsplat.NO_CAP, False),
        S(9, 2, cap[9], False), S(17, 3, cap[17], False),
        S(5, 2, cap[9], True), S(5, 3, cap[17], True))
    assert len(tsplat.bucket_segments(BUCKET_RUNGS, 5, n)) == 19
    counts = torch.tensor([4, 0, 40000, 10], dtype=torch.int32)
    offsets = torch.tensor([0, 4, 4, 40004], dtype=torch.int32)
    bounds = [tuple(int(t) for t in tsplat.segment_bounds(s, offsets, counts))
              for s in tsplat.bucket_segments((3, 5, 9, 17), 5, n)]
    assert bounds == [(4, 0), (0, 4), (4, 32768), (40004, 10),
                      (4 + 32768, 40000 - 32768), (40004 + 8192, 0)]


def test_raster_rungs_hands_each_segment_to_a_given_raster():
    """With ``raster=``, raster_rungs is the plain twin's loop: that
    function once a segment, with the segment's window, the reference's
    chunk size and one-element device bounds."""
    a, perm, counts, offsets, (h, w) = raster_bucket("filled")
    n = len(a["rung"])
    calls = []

    def spy(fb, *args):
        start, count = args[5], args[6]
        calls.append((args[-3], args[-1], int(start), int(count)))
        return fb

    fb = tsplat.make_framebuffer(h, w).packed
    run_bucket(a, perm, counts, offsets, h, w, True, fb, raster=spy)
    segments = tsplat.bucket_segments(BUCKET_RUNGS, BUCKET_FOOTPRINT, n)
    assert [c[0] for c in calls] == [s.k for s in segments]
    assert [c[1] for c in calls] == [tsplat.rung_chunk_rows(s.k, n)
                                     for s in segments]
    assert sum(c[3] for c in calls) == int(counts.sum())
    assert all(c[3] == 0 for c, s in zip(calls, segments) if s.tail)
    assert torch.equal(fb, tsplat.make_framebuffer(h, w).packed)


# --- whole frames ---------------------------------------------------------


def make_store(tmp_path, pos, seed=0):
    from point_cloud_tpu.convert.converter import Converter

    rng = np.random.default_rng(seed)
    col = rng.integers(0, 256, (len(pos), 4), dtype=np.uint8)
    with Converter(RMetadata(), tmp_path) as conv:
        conv.add_points_batch(RPointBatch(pos.astype(np.float32), col))
    return RMetadata.from_path(tmp_path / "metadata.json")


def streamed(meta, store, cam, port: bool):
    """A streamer with every visible cell of ``store`` loaded, and the
    frustums, for the reference's or the port's modules."""
    if port:
        from point_cloud_tpu_torch.render.frustums import (
            update_streaming_frustums,
        )
        from point_cloud_tpu_torch.render.streaming import CellStreamer
        cell_cls = TCell
    else:
        from point_cloud_tpu.render.frustums import update_streaming_frustums
        from point_cloud_tpu.render.streaming import CellStreamer
        cell_cls = RCell

    def loader(cell_id):
        path = store / cell_id.path()
        return cell_cls.from_path(path) if path.exists() else None

    streamer = CellStreamer(meta, loader=loader)
    frustums = update_streaming_frustums(meta, cam.transform, cam.projection,
                                         cam.frustum())
    streamer.update(frustums, cam.transform)
    for _ in range(400):
        if not streamer.fill_load_slots():
            break
    return streamer, frustums


def corridor(n=25_000, seed=31):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-1600, 1600, n), rng.uniform(-200, 200, n),
                     rng.uniform(-200, 200, n)], axis=1)


def corridor_camera(meta):
    cam = rcamera.Camera()
    cam.projection.far = meta.config.max_cell_size * 5.0
    cam.transform.translation = np.array([-1400.0, 60.0, 90.0], np.float32)
    cam.transform.look_at(np.array([1500.0, 0.0, 0.0], np.float32),
                          np.array([0.0, 0.0, 1.0], np.float32))
    return cam


def render_port(meta, store, cam, settings, frames=1, **kw):
    tmeta, tcam = port_metadata(meta), port_camera(cam)
    streamer, frustums = streamed(tmeta, store, tcam, port=True)
    renderer = TRenderer(tmeta, port_settings(settings), device="cpu")
    out = None
    for _ in range(frames):
        out = renderer.render(streamer, tcam, frustums, **kw)
    return out, renderer


@pytest.mark.parametrize("scene", ["cube", "corridor"])
def test_frame_matches_jax_renderer(tmp_path, scene):
    """The port's frame against the JAX renderer's on one store and camera.
    Tolerance: XLA:CPU contracts the fragment distance and the voronoi
    depth into fma, so a fragment near a circle edge or a depth tie can
    differ; at least 99.9% of the pixels must be equal and depth within
    1e-6 where they are."""
    from point_cloud_tpu.render.renderer import PointRenderer, RenderSettings

    if scene == "cube":
        rng = np.random.default_rng(17)
        meta = make_store(tmp_path, rng.uniform(-50, 50, (20_000, 3)))
        cam = rcamera.Camera()
        cam.projection.far = meta.config.max_cell_size * 5.0
        cam.look_at_aabb(meta.bounding_box)
    else:
        meta = make_store(tmp_path, corridor())
        cam = corridor_camera(meta)
    settings = RenderSettings(width=160, height=120)
    streamer, frustums = streamed(meta, tmp_path, cam, port=False)
    rgb_r, depth_r, stats_r = PointRenderer(meta, settings).render(
        streamer, cam, frustums)
    (rgb_t, depth_t, stats_t), renderer = render_port(
        meta, tmp_path, cam, settings)
    same = (rgb_r == rgb_t).all(axis=2)
    assert same.mean() >= 0.999, same.mean()
    assert np.abs(depth_r - depth_t)[same].max() <= 1e-6
    assert stats_t["points_visible"] == stats_r["points_visible"] > 0
    lit = (renderer.framebuffer.point_id != NO_ID).sum()
    assert lit > 1000
    if scene == "corridor":
        assert stats_t["buckets"] > 1


IDENTITIES = {
    "depth_pyramid": (dict(depth_pyramid=True), dict(depth_pyramid=False)),
    "even_sub_rungs": (dict(even_sub_rungs=True), dict(even_sub_rungs=False)),
    "even_overflow_rungs": (dict(even_overflow_rungs=True),
                            dict(even_overflow_rungs=False)),
    "sub_rungs": (dict(sub_rungs=True), dict(sub_rungs=False)),
}


@pytest.mark.parametrize("knob", sorted(IDENTITIES))
def test_image_identities_hold_in_the_port(tmp_path, knob):
    """Rung assignment and the pyramid gate change fragment counts, never
    the image (tests/test_render_kernel.py's identities): byte-identical
    rgb, depth and ids, on a multi-bucket scene."""
    from point_cloud_tpu.render.renderer import RenderSettings

    meta = make_store(tmp_path, corridor(18_000, seed=41))
    cam = corridor_camera(meta)
    outs = []
    for kw in IDENTITIES[knob]:
        (rgb, depth, stats), renderer = render_port(
            meta, tmp_path, cam, RenderSettings(width=128, height=96, **kw))
        outs.append((rgb, depth, renderer.framebuffer.packed.clone(),
                     stats, dict(renderer._survivor_counts)))
    (rgb_a, d_a, fb_a, s_a, counts_a), (rgb_b, d_b, fb_b, s_b, _) = outs
    assert np.array_equal(rgb_a, rgb_b) and np.array_equal(d_a, d_b)
    assert torch.equal(fb_a, fb_b)
    if knob == "depth_pyramid":
        assert s_a["points_visible"] <= s_b["points_visible"]
    else:
        assert s_a["points_visible"] == s_b["points_visible"] > 0
    rungs = {"even_sub_rungs": (2, 4), "even_overflow_rungs": (6, 7, 8),
             "sub_rungs": (1, 2, 3, 4), "depth_pyramid": ()}[knob]
    if rungs:  # the knob's rungs really took rows, or this proves nothing
        assert any(k[1] in rungs and v > 0 for k, v in counts_a.items())


def test_pipelined_frames_match_sync(tmp_path):
    from point_cloud_tpu.render.renderer import RenderSettings

    rng = np.random.default_rng(15)
    meta = make_store(tmp_path, rng.uniform(-50, 50, (15_000, 3)))
    tmeta = port_metadata(meta)
    cams = []
    for dy in (0.0, 5.0, 10.0):
        cam = rcamera.Camera()
        cam.projection.far = meta.config.max_cell_size * 5.0
        cam.look_at_aabb(meta.bounding_box)
        cam.transform.translation = (cam.transform.translation
                                     + np.array([0, dy, 0], np.float32))
        cams.append(port_camera(cam))

    def run(pipelined):
        renderer = TRenderer(tmeta, TSettings(width=96, height=72),
                             device="cpu")
        frames = []
        for cam in cams:
            streamer, frustums = streamed(tmeta, tmp_path, cam, port=True)
            if pipelined:
                out = renderer.render_pipelined(streamer, cam, frustums)
                if out is not None:
                    frames.append(out)
            else:
                frames.append(renderer.render(streamer, cam, frustums))
        if pipelined:
            frames.append(renderer.render_flush())
            assert renderer.render_flush() is None
        return frames

    sync, piped = run(False), run(True)
    assert len(sync) == len(piped) == 3
    for (rgb_a, d_a, s_a), (rgb_b, d_b, s_b) in zip(sync, piped):
        assert np.array_equal(rgb_a, rgb_b) and np.array_equal(d_a, d_b)
        assert s_a == s_b


def test_pack_overflow_falls_back_to_sync_readback(tmp_path, monkeypatch):
    """More counts than the packed tail holds: the same frame through the
    synchronous readback (renderer.py:989-1005)."""
    from point_cloud_tpu.render.renderer import RenderSettings

    meta = make_store(tmp_path, corridor(8_000, seed=43))
    cam = corridor_camera(meta)
    base, _ = render_port(meta, tmp_path, cam, RenderSettings(width=64, height=48))
    monkeypatch.setattr(tsplat, "PACK_COUNTS", 3)
    fallback, _ = render_port(meta, tmp_path, cam,
                              RenderSettings(width=64, height=48))
    assert np.array_equal(base[0], fallback[0])
    assert np.array_equal(base[1], fallback[1])
    assert base[2] == fallback[2]


# --- the gather reads a cell's points only on a bucket-cache miss --------


def count_reads(monkeypatch) -> list:
    """The ids of the cells whose points are read from now on (each call
    of ``Cell._materialize`` or ``Cell.point_columns``)."""
    calls = []

    def counting(read):
        def counted(self):
            calls.append(self.id)
            return read(self)
        return counted

    for name in ("_materialize", "point_columns"):
        monkeypatch.setattr(TCell, name, counting(getattr(TCell, name)))
    return calls


def make_renderer(kind, tmeta):
    """A CPU renderer at 96x72: the single-device default arms, or a
    two-shard mesh with the plain raster arm it mirrors."""
    if kind == "mesh":
        from point_cloud_tpu_torch.parallel.mesh import make_mesh
        from point_cloud_tpu_torch.render.parallel import MeshPointRenderer

        return MeshPointRenderer(tmeta, make_mesh(2, device="cpu"),
                                 settings=TSettings(
                                     width=96, height=72, compact_raster=False,
                                     megakernel=False, classing=False))
    return TRenderer(tmeta, TSettings(width=96, height=72), device="cpu")


def traced_render(renderer, streamer, cam, frustums):
    """(rgb, depth, stats) and the frame's ``render.cells_read``."""
    from point_cloud_tpu_torch.utils.tracing import StageTimer

    with StageTimer() as timer:
        out = renderer.render(streamer, cam, frustums)
    return out, timer.counters["render.cells_read"]


@pytest.mark.parametrize("kind", ["single", "mesh"])
def test_steady_frames_read_no_points(tmp_path, monkeypatch, kind):
    """A camera that moves within one bucket composition hits the bucket
    cache: after the first frame, which reads each cell once, no cell's
    points are read (no ``Cell._materialize`` or ``Cell.point_columns``,
    no ``render.cells_read``)."""
    meta = make_store(tmp_path, corridor(8_000, seed=53))
    tmeta = port_metadata(meta)
    cam = port_camera(corridor_camera(meta))
    streamer, frustums = streamed(tmeta, tmp_path, cam, port=True)
    renderer = make_renderer(kind, tmeta)

    def composition():
        return [(c[0], c[2]) for c in renderer.gather_points(streamer, cam)]

    first = composition()
    assert len({bucket for bucket, _ in first}) > 1
    reads = count_reads(monkeypatch)
    per_frame = []
    for _ in range(4):
        assert composition() == first
        (_, _, stats), cells_read = traced_render(renderer, streamer, cam,
                                                  frustums)
        assert stats["points_visible"] > 0
        per_frame.append((len(reads), cells_read))
        reads.clear()
        cam.transform.translation = (cam.transform.translation
                                     + np.float32([0.0, 0.5, 0.25]))
    assert per_frame == [(len(first), len(first))] + [(0, 0)] * 3


def test_lazy_gather_draws_what_a_fresh_renderer_draws(tmp_path):
    """Down a flight in which cells land and leave, each frame of one
    renderer (warm caches: a hit reads no point) equals a fresh renderer's,
    which reads every cell."""
    from point_cloud_tpu_torch.render.frustums import (
        update_streaming_frustums,
    )
    from point_cloud_tpu_torch.render.streaming import CellStreamer

    meta = make_store(tmp_path, corridor(12_000, seed=59))
    tmeta = port_metadata(meta)
    cam = port_camera(corridor_camera(meta))
    streamer = CellStreamer(
        tmeta, loader=lambda cid: (TCell.from_path(tmp_path / cid.path())
                                   if (tmp_path / cid.path()).exists()
                                   else None))
    renderer = make_renderer("single", tmeta)
    held, reads = [], []
    for _ in range(6):
        frustums = update_streaming_frustums(tmeta, cam.transform,
                                             cam.projection, cam.frustum())
        streamer.update(frustums, cam.transform)
        while streamer.fill_load_slots():
            pass
        held.append(set(streamer.loaded))
        (rgb, depth, stats), cells_read = traced_render(renderer, streamer,
                                                        cam, frustums)
        fresh = make_renderer("single", tmeta).render(streamer, cam, frustums)
        assert np.array_equal(rgb, fresh[0])
        assert np.array_equal(depth, fresh[1])
        assert stats == fresh[2] and stats["points_visible"] > 0
        reads.append(cells_read)
        cam.transform.translation = (cam.transform.translation
                                     + np.float32([450.0, 0.0, 0.0]))
    steps = list(zip(held, held[1:]))
    assert any(b - a for a, b in steps) and any(a - b for a, b in steps)
    assert sum(reads[1:]) < sum(len(h) for h in held[1:])


def test_mutated_cell_is_read_again(tmp_path, monkeypatch):
    """A loaded cell changed in place by ``add_points`` (a new generation)
    is read again on the next frame, with the rest of its bucket only, and
    the frame shows the change as a fresh renderer draws it."""
    from point_cloud_tpu_torch.core import hex as thex
    from point_cloud_tpu_torch.core.point import PointBatch as TPointBatch

    meta = make_store(tmp_path, corridor(8_000, seed=61))
    tmeta = port_metadata(meta)
    cam = port_camera(corridor_camera(meta))
    streamer, frustums = streamed(tmeta, tmp_path, cam, port=True)
    renderer = make_renderer("single", tmeta)
    before, _ = traced_render(renderer, streamer, cam, frustums)
    # the cell that lights the most pixels: its rows' ids follow the
    # gather's order from 1
    cells = renderer.gather_points(streamer, cam)
    sizes = [c[3].number_of_points + c[3].number_of_overflow_points
             for c in cells]
    starts = 1 + np.cumsum([0] + sizes[:-1])
    ids = renderer.framebuffer.point_id.numpy()
    lit = [int(((ids >= a) & (ids < a + n)).sum())
           for a, n in zip(starts, sizes)]
    bucket, _, target_id, target, _ = cells[int(np.argmax(lit))]
    assert max(lit) > 0
    # each stored point displaced by one at its slot's centre, in magenta
    centres = thex.offset_to_world(target.sub_indices,
                                   target.sub_cell_size / np.float32(2.0))
    magenta = np.broadcast_to(np.uint8([255, 0, 255, 255]),
                              (len(centres), 4))
    displaced = target.add_points(TPointBatch(centres, magenta))
    assert len(displaced) > 0
    reads = count_reads(monkeypatch)
    after, cells_read = traced_render(renderer, streamer, cam, frustums)
    in_bucket = [c[2] for c in cells if c[0] == bucket]
    assert sorted(reads, key=str) == sorted(in_bucket, key=str)
    assert target_id in reads and cells_read == len(in_bucket)
    assert not np.array_equal(after[0], before[0])
    fresh = make_renderer("single", tmeta).render(streamer, cam, frustums)
    assert np.array_equal(after[0], fresh[0])
    assert np.array_equal(after[1], fresh[1])
    assert after[2] == fresh[2]


def chunk_bucket(n=1024, w=52, h=60):
    """The reference's synthetic bucket (test_render_kernel.py:1674-1707):
    every splat in the 9-px overflow rung at footprint 5."""
    cam = rcamera.Camera()
    rng = np.random.default_rng(77)
    pos = np.stack([rng.uniform(-4, 4, n), rng.uniform(28, 33, n),
                    rng.uniform(-4, 4, n)], axis=1).astype(np.float32)
    spacings = np.zeros(tkernel.MAX_HIERARCHIES, np.float32)
    spacings[0] = 1.45
    return dict(
        positions=pos, hier_base=np.zeros(n, np.int32),
        valid=np.ones(n, bool), point_id=np.arange(1, n + 1, dtype=np.int32),
        view=cam.view_matrix().astype(np.float32),
        projection=cam.projection_matrix().astype(np.float32),
        cam_pos=np.asarray(cam.transform.translation, np.float32),
        spacings=spacings,
        far_distances=np.zeros(tkernel.MAX_HIERARCHIES, np.float32)), (h, w)


def test_cap_tail_spills_through_footprint(monkeypatch):
    """Rows beyond an overflow rung's cap render through the footprint
    window: the port's bucket pass equals the cap's definition composed by
    hand (first ``cap`` rows of the rung at k=9, the rest at k=5), and
    matches JAX's chunked bucket pass at the same cap within the fma
    tolerance."""
    _, rsplat = jax_render()
    import jax.numpy as jnp

    monkeypatch.setattr(tsplat, "RUNG_CAP_CHUNKS", 1)
    monkeypatch.setattr(rsplat, "RUNG_CAP_CHUNKS", 1)
    arrays, (h, w) = chunk_bucket(w=68, h=44)
    n = len(arrays["positions"])
    overs, subs = (9, 17, 33, 65), ()
    rungs = subs + (5,) + overs
    thr = as_t(np.array([k / 2 for k in rungs], np.float32))
    t = {k: as_t(v) for k, v in arrays.items()}
    args = (t["positions"], t["hier_base"], t["valid"], t["point_id"],
            t["view"], t["projection"], t["cam_pos"], t["spacings"],
            t["far_distances"], False, 0, thr)
    kw = dict(height=h, width=w, footprint=5, voronoi=True,
              use_occlusion=False, overflow_ks=overs, sub_ks=subs)
    fb, vec = tsplat.render_bucket_pass(tsplat.make_framebuffer(h, w), *args,
                                        **kw)
    cap = tsplat.rung_chunk_rows(9, n)
    assert int(vec[2]) > cap  # more k=9 rows than the cap: the tail runs

    keep, _, vp, ndc, radius, _, rung = tkernel.cull_classify(
        *args[:3], *args[4:11], thr, w, h)
    parts = []  # (window, rows): each rung's rows, an overflow rung's
    for j, k in enumerate(rungs):  # beyond its cap through the footprint
        rows = np.flatnonzero(rung.numpy() == j)
        cap_k = tsplat.rung_chunk_rows(k, n) if k > 5 else len(rows)
        parts += [(k, rows[:cap_k]), (5, rows[cap_k:])]
    manual = tsplat.make_framebuffer(h, w).packed
    for k, rows in parts:
        perm = np.concatenate([rows, np.zeros(n)]).astype(np.int32)
        tsplat.splat_raster_reference(
            manual, vp, ndc, radius, t["point_id"], as_t(perm),
            torch.tensor([0], dtype=torch.int32),
            torch.tensor([len(rows)], dtype=torch.int32), t["projection"],
            h, w, k, True, 64)
    assert torch.equal(fb.packed, manual)

    ref_fb, ref_vec = rsplat.render_bucket_pass(
        rsplat.make_framebuffer(h, w),
        *(jnp.asarray(arrays[k]) for k in (
            "positions", "hier_base", "valid", "point_id", "view",
            "projection", "cam_pos", "spacings", "far_distances")),
        jnp.bool_(False), jnp.int32(0), depth=None, height=h, width=w,
        footprint=5, voronoi=True, use_occlusion=False, out_size=0,
        overflow_rows=(), overflow_ks=overs, sub_rows=(), sub_ks=subs,
        chunked=True)
    assert np.array_equal(vec.numpy(), np.asarray(ref_vec))
    same = fb.point_id.numpy() == np.asarray(ref_fb.point_id)
    assert same.mean() >= 0.999


def test_footprint_above_128_covers_the_frame():
    """Windows past the old 128-px limit: on a 64x48 frame a 129-px window
    (odd, centred on rint) and a 300-px window (even, based on floor) both
    cover the frame from any on-screen centre, so they light the same
    pixels; the 129-px plane equals the NumPy oracle's bit for bit. The
    renderer takes both footprints (129 raised before)."""
    from point_cloud_tpu_torch.render.streaming import CellStreamer

    w, h = 64, 48
    view_pos, ndc, radius, ids, proj = splat_rows(3, 12, w, h, 120.0)
    on = (np.abs(ndc[:, 0]) <= 1) & (np.abs(ndc[:, 1]) <= 1)
    assert on.sum() >= 4
    planes = {}
    for k in (129, 300):
        fb = tsplat.rasterize_splats(
            tsplat.make_framebuffer(h, w), as_t(view_pos), as_t(ndc),
            as_t(radius), as_t(ids), as_t(on), as_t(proj), height=h, width=w,
            footprint=k, voronoi=True)
        planes[k] = fb
    want_d, want_i = oracle_raster(
        np.ones(h * w, np.float32), np.full(h * w, NO_ID, np.int64),
        *oracle_fragments(view_pos[on], ndc[on], radius[on], ids[on], proj,
                          h, w, 129, True))
    assert np.array_equal(planes[129].point_id.numpy(), want_i)
    assert bits_equal(planes[129].depth.numpy(),
                      np.where(want_d == 0, 0, want_d).astype(np.float32))
    assert torch.equal(planes[129].packed, planes[300].packed)
    assert (planes[129].point_id != NO_ID).sum() > 0.9 * w * h
    meta = TMetadata()
    for footprint in (129, 300):
        renderer = TRenderer(meta, TSettings(width=32, height=24,
                                             footprint=footprint),
                             device="cpu")
        rgb, _, _ = renderer.render(CellStreamer(meta), tcamera.Camera())
        assert (rgb == tsplat.CLEAR_COLOR_U8[0]).all()


def test_footprint_129_matches_reference():
    """A footprint the port refused before: the JAX raster draws a 129-px
    window (a splat lights more pixels than the ladder's widest rung,
    65 x 65, could), and the port's raster gives JAX's plane (the Frames
    contract) and the NumPy oracle's (bit for bit); the port's renderer
    takes the reference's settings at 129."""
    from point_cloud_tpu.render.renderer import RenderSettings
    from point_cloud_tpu_torch.render.streaming import CellStreamer

    _, rsplat = jax_render()
    w, h = 320, 240
    view_pos, ndc, radius, ids, proj = splat_rows(3, 4, w, h, 120.0)
    fb = rsplat.rasterize_splats(
        rsplat.make_framebuffer(h, w), view_pos, ndc, radius, ids,
        np.ones(4, bool), proj, height=h, width=w, footprint=129,
        voronoi=True)
    ref_ids = np.asarray(fb.point_id)
    lit = np.bincount(ref_ids[ref_ids != NO_ID])
    assert lit.max() > 65 * 65
    got = tsplat.rasterize_splats(
        tsplat.make_framebuffer(h, w), as_t(view_pos), as_t(ndc),
        as_t(radius), as_t(ids), torch.ones(4, dtype=torch.bool),
        as_t(proj), height=h, width=w, footprint=129, voronoi=True)
    same = got.point_id.numpy() == ref_ids
    assert same.mean() >= 0.999
    assert np.abs(got.depth.numpy() - np.asarray(fb.depth))[same].max() <= 1e-6
    want_d, want_i = oracle_raster(
        np.ones(h * w, np.float32), np.full(h * w, NO_ID, np.int64),
        *oracle_fragments(view_pos, ndc, radius, ids, proj, h, w, 129, True))
    assert np.array_equal(got.point_id.numpy(), want_i)
    meta = TMetadata()
    renderer = TRenderer(meta, port_settings(RenderSettings(
        width=w, height=h, footprint=129)), device="cpu")
    rgb, _, _ = renderer.render(CellStreamer(meta), tcamera.Camera())
    assert rgb.shape == (h, w, 3)


# --- footprint 1 ------------------------------------------------------------


def footprint_one_buckets(tmp_path, monkeypatch, n=25_000):
    """The port's footprint-1 frames of the corridor at 128x96 on the CPU,
    a first and a steady one: for each bucket, the arguments of its cull
    (``kernel.cull_classify``) and (input plane, arguments, output plane)
    of its raster (the multi-dispatch arm's ``raster_compacted``)."""
    from point_cloud_tpu.render.renderer import RenderSettings

    meta = make_store(tmp_path, corridor(n, seed=61))
    culls, captured = [], []
    cull, raster = tkernel.cull_classify, tsplat.raster_compacted

    def capture_cull(*args, **kw):
        culls.append((args, kw))
        return cull(*args, **kw)

    def capture(framebuffer, *args):
        fb_in = framebuffer.packed.clone()
        out = raster(framebuffer, *args)
        captured.append((fb_in, args, out.packed.clone()))
        return out

    monkeypatch.setattr(tkernel, "cull_classify", capture_cull)
    monkeypatch.setattr(tsplat, "raster_compacted", capture)
    render_port(meta, tmp_path, corridor_camera(meta),
                RenderSettings(width=128, height=96, footprint=1), frames=2)
    assert len(culls) == len(captured)
    return [(c, *r) for c, r in zip(culls, captured)]


def test_footprint_one_frame_matches_numpy_oracle(tmp_path, monkeypatch):
    """Every bucket of two footprint-1 frames, through the plain versions
    (the reference's arm: K1, then one k = 1 segment of K2 over the
    bucket's first ``out_size`` kept rows in row order), equals the NumPy
    oracle rasterizer at k = 1 over those rows, from the bucket's input
    plane, bit for bit. The rows it keeps are the plain cull's on the
    bucket's own inputs and its input plane's depth, bit for bit."""
    captured = footprint_one_buckets(tmp_path, monkeypatch)
    assert len(captured) > 2
    for (cargs, ckw), fb_in, args, fb_out in captured:
        (view_pos, ndc, radius, ids, keep, proj, h, w, footprint, voronoi,
         out_size) = args
        assert footprint == 1
        assert ckw["depth"] is not None and ckw["coarse"] is not None
        plane_in = tsplat.Framebuffer(fb_in)
        depth = tsplat.framebuffer_depth(plane_in, h, w)
        want_keep, _, want_vp, want_ndc, want_radius, _, _ = (
            tkernel.cull_classify_reference(
                *cargs, depth=depth, coarse=tkernel.coarse_depth_grid(depth)))
        assert torch.equal(keep, want_keep)
        for got_t, want_t in ((view_pos, want_vp), (ndc, want_ndc),
                              (radius, want_radius)):
            assert bits_equal(got_t.numpy(), want_t.numpy())
        rows = np.flatnonzero(want_keep.numpy())[:out_size]
        want_d, want_i = oracle_raster(
            plane_in.depth.numpy(), plane_in.point_id.numpy().astype(np.int64),
            *oracle_fragments(want_vp.numpy()[rows], want_ndc.numpy()[rows],
                              want_radius.numpy()[rows], ids.numpy()[rows],
                              proj.numpy(), h, w, 1, voronoi))
        got = tsplat.Framebuffer(fb_out)
        assert np.array_equal(got.point_id.numpy(), want_i)
        assert bits_equal(got.depth.numpy(),
                          np.where(want_d == 0, 0, want_d).astype(np.float32))
    lit = (tsplat.Framebuffer(captured[-1][3]).point_id != NO_ID).sum()
    assert lit > 1000


@pytest.mark.parametrize("scene", ["cube", "corridor"])
def test_footprint_one_frame_matches_jax_renderer(tmp_path, scene):
    """The port's footprint-1 frame against the JAX renderer's, the first
    frame (no compaction budget yet in the reference) and a steady second
    one: the Frames contract (>= 99.9% equal pixels, depth within 1e-6
    where they agree), the same visible count and the same landed
    per-rung counts (the reference's cumulative fit counts)."""
    from point_cloud_tpu.render.renderer import PointRenderer, RenderSettings

    if scene == "cube":
        rng = np.random.default_rng(18)
        meta = make_store(tmp_path, rng.uniform(-50, 50, (20_000, 3)))
        cam = rcamera.Camera()
        cam.projection.far = meta.config.max_cell_size * 5.0
        cam.look_at_aabb(meta.bounding_box)
    else:
        meta = make_store(tmp_path, corridor(seed=32))
        cam = corridor_camera(meta)
    settings = RenderSettings(width=160, height=120, footprint=1)
    streamer, frustums = streamed(meta, tmp_path, cam, port=False)
    ref = PointRenderer(meta, settings)
    tmeta, tcam = port_metadata(meta), port_camera(cam)
    tstreamer, tfrustums = streamed(tmeta, tmp_path, tcam, port=True)
    port = TRenderer(tmeta, port_settings(settings), device="cpu")
    for _ in range(2):
        rgb_r, depth_r, stats_r = ref.render(streamer, cam, frustums)
        rgb_t, depth_t, stats_t = port.render(tstreamer, tcam, tfrustums)
        same = (rgb_r == rgb_t).all(axis=2)
        assert same.mean() >= 0.999, same.mean()
        assert np.abs(depth_r - depth_t)[same].max() <= 1e-6
        assert stats_t["points_visible"] == stats_r["points_visible"] > 0
        assert port._survivor_counts == ref._survivor_counts
        assert (port.framebuffer.point_id != NO_ID).sum() > 1000


def test_frame_without_cells_is_clear():
    """No loaded cell: no bucket runs, and the frame is the clear grey at
    the clear depth, through the packed readback."""
    from point_cloud_tpu_torch.render.streaming import CellStreamer

    meta = TMetadata()
    renderer = TRenderer(meta, TSettings(width=32, height=24), device="cpu")
    rgb, depth, stats = renderer.render(CellStreamer(meta), tcamera.Camera())
    assert rgb.shape == (24, 32, 3) and (rgb == tsplat.CLEAR_COLOR_U8[0]).all()
    assert (depth == 1.0).all()
    assert stats == {"cells": 0, "points_in": 0, "buckets": 0,
                     "points_visible": 0}


def test_settings_defaults_match_reference():
    from point_cloud_tpu.render.renderer import RenderSettings

    ref = dataclasses.asdict(RenderSettings())
    assert dataclasses.asdict(TSettings()) == ref
    assert [f.name for f in dataclasses.fields(TSettings)] == list(ref)


def test_renderer_needs_a_card_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the CPU-only refusal")
    with pytest.raises(RuntimeError, match="cuda"):
        TRenderer(TMetadata())


# --- the kernels on the card ----------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cull, LOD and raster kernels have no "
                    "CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
class TestKernelsOnCard:
    @pytest.mark.parametrize("occ,pyr,sbd", [(False, False, False),
                                             (True, True, True)])
    def test_cull_kernel_matches_plain(self, cuda_device, occ, pyr, sbd):
        arrays, depth, (w, h) = cull_scene(23, n=1 << 16)
        t = {k: as_t(v).to(cuda_device) for k, v in arrays.items()}
        thr = as_t(np.array([k / 2 for k in LADDER], np.float32)).to(cuda_device)
        d = as_t(depth).to(cuda_device) if occ else None
        c = tkernel.coarse_depth_grid(d) if pyr else None
        args = (t["positions"], t["hier_base"], t["valid"], t["view"],
                t["projection"], t["cam_pos"], t["spacings"],
                t["far_distances"], sbd, 3, thr, w, h)
        before = tkernel.launches
        got = tkernel.cull_classify(*args, depth=d, coarse=c)
        ref = tkernel.cull_classify_reference(*args, depth=d, coarse=c)
        torch.cuda.synchronize()
        assert tkernel.launches == before + 1
        for g, r in zip(got, ref):
            assert bits_equal(g.cpu().numpy(), r.cpu().numpy())

    @pytest.mark.parametrize("case,log_n", (
        [("deep", log_n) for log_n in range(12, 19)]
        + [(case, 14) for case in LOD_CASES[1:]] + [("extreme", 14)]))
    def test_lod_kernel_matches_plain(self, cuda_device, case, log_n):
        """K6 bit-equal to its plain version at the orbit's bucket sizes
        (2^12-2^18 rows) on twelve hierarchies and on every edge case;
        ``extreme`` adds rows at +-3e9, 1e30, inf and NaN, whose cell
        indices saturate (NaN to 0) on either side. One launch a call."""
        positions, point_h, sizes, table, gap = lod_case(
            case, n=1 << log_n, seed=log_n)
        dev = lambda a: as_t(a).to(cuda_device)
        args = (dev(positions), dev(point_h), dev(sizes), LOD_LEVELS,
                dev(tkernel.build_loaded_cells_hash(table)))
        before = tkernel.lod_launches
        got = tkernel.lod_select(*args)
        assert tkernel.lod_launches == before + 1
        ref = tkernel.lod_select_reference(*args)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and torch.equal(got, ref)
        own = np.minimum(point_h, LOD_LEVELS - 1)
        got = got.cpu().numpy()
        if case == "gap":
            assert np.array_equal(got[gap], own[gap])
        if case != "empty_table":
            assert (got > own).sum() > 100

    @pytest.mark.parametrize("k", [1, 2, 3])
    def test_raster_kernel_rounds_like_plain(self, cuda_device, k):
        (view_pos, ndc, radius, ids, perm, proj), (h, w) = (
            half_pixel_splats(cuda_device))
        start = torch.tensor([0], dtype=torch.int32, device=cuda_device)
        count = torch.tensor([2], dtype=torch.int32, device=cuda_device)
        fb_k = tsplat.make_framebuffer(h, w, cuda_device).packed
        fb_p = fb_k.clone()
        tsplat.splat_raster(fb_k, view_pos, ndc, radius, ids, perm, start,
                            count, proj, h, w, k, False, 2)
        tsplat.splat_raster_reference(fb_p, view_pos, ndc, radius, ids, perm,
                                      start, count, proj, h, w, k, False, 2)
        torch.cuda.synchronize()
        assert torch.equal(fb_k, fb_p)

    @pytest.mark.parametrize("voronoi", [True, False])
    @pytest.mark.parametrize("k", [1, 4, 5, 9, 65])
    def test_raster_kernel_matches_plain(self, cuda_device, k, voronoi):
        w, h, n = 640, 360, 2000
        view_pos, ndc, radius, ids, proj = splat_rows(k, n, w, h, k / 2)
        perm = np.concatenate([np.random.default_rng(k).permutation(n),
                               np.zeros(n)]).astype(np.int32)
        args = [as_t(a).to(cuda_device) for a in (view_pos, ndc, radius, ids,
                                                  perm)]
        start = torch.tensor([5], dtype=torch.int32, device=cuda_device)
        count = torch.tensor([n - 5], dtype=torch.int32, device=cuda_device)
        fb_k = tsplat.make_framebuffer(h, w, cuda_device).packed
        fb_p = fb_k.clone()
        before = tsplat.launches
        tsplat.splat_raster(fb_k, *args, start, count,
                            as_t(proj).to(cuda_device), h, w, k, voronoi, 64)
        tsplat.splat_raster_reference(fb_p, *args, start, count,
                                      as_t(proj).to(cuda_device), h, w, k,
                                      voronoi, 64)
        torch.cuda.synchronize()
        assert tsplat.launches == before + 1
        assert torch.equal(fb_k, fb_p)

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_bucket_kernel_matches_plain_on_random_tables(self, cuda_device,
                                                          seed):
        """One launch over a random table of segments (windows of 1 to 257
        px, caps that bite and caps that do not, tails, empty segments,
        shuffled) against the plain loop."""
        w, h, n = 640, 360, 6000
        rng = np.random.default_rng(seed)
        ks = [int(k) for k in rng.choice(
            [1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 31, 32, 33, 64, 65, 100,
             128, 129, 257], 12, replace=False)]
        view_pos, ndc, radius, ids, proj = splat_rows(seed, n, w, h, 12.0)
        rung = rng.integers(-1, len(ks), n).astype(np.int32)
        rung[rung == 3] = -1  # an empty rung
        dev = lambda x: as_t(x).to(cuda_device)
        perm, counts, offsets = tsplat.compact_classes(dev(rung), len(ks))
        segments = []
        for j, k in enumerate(ks):
            cap = int(rng.choice([0, 5, 100, tsplat.NO_CAP]))
            segments += [tsplat.Segment(k, j, cap, False),
                         tsplat.Segment(int(rng.choice(ks)), j, cap, True)]
        segments = tuple(segments[i] for i in rng.permutation(len(segments)))
        args = [dev(x) for x in (view_pos, ndc, radius, ids)]
        fb_k = tsplat.make_framebuffer(h, w, cuda_device).packed
        fb_p = fb_k.clone()
        before = tsplat.launches
        tsplat.splat_raster_segments(fb_k, *args, perm, offsets, counts,
                                     dev(proj), h, w, segments, True)
        tsplat.splat_raster_segments_reference(
            fb_p, *args, perm, offsets, counts, dev(proj), h, w, segments,
            True)
        torch.cuda.synchronize()
        assert tsplat.launches == before + 1
        assert torch.equal(fb_k, fb_p)
        assert (fb_k != tsplat._CLEAR_WORD).sum() > 10_000

    def test_one_raster_launch_a_bucket_pass(self, cuda_device):
        """render_bucket_pass launches K1 once and K2 once, whatever the
        ladder holds, and equals its plain twin."""
        arrays, (h, w) = chunk_bucket(n=4096, w=320, h=240)
        overs, subs = (6, 7, 8, 9, 17, 33, 65), (1, 2, 3, 4)
        rungs = subs + (5,) + overs
        thr = as_t(np.array([k / 2 for k in rungs], np.float32)).to(cuda_device)
        t = {k: as_t(v).to(cuda_device) for k, v in arrays.items()}
        args = (t["positions"], t["hier_base"], t["valid"], t["point_id"],
                t["view"], t["projection"], t["cam_pos"], t["spacings"],
                t["far_distances"], False, 0, thr)
        kw = dict(height=h, width=w, footprint=5, voronoi=True,
                  use_occlusion=False, overflow_ks=overs, sub_ks=subs)
        k1, k2 = tkernel.launches, tsplat.launches
        fb_k, vec_k = tsplat.render_bucket_pass(
            tsplat.make_framebuffer(h, w, cuda_device), *args, **kw)
        torch.cuda.synchronize()
        assert (tkernel.launches, tsplat.launches) == (k1 + 1, k2 + 1)
        fb_p, vec_p = tsplat.render_bucket_pass(
            tsplat.make_framebuffer(h, w, cuda_device), *args, **kw,
            cull=tkernel.cull_classify_reference,
            raster=tsplat.splat_raster_reference)
        assert torch.equal(vec_k, vec_p) and int(vec_k[0]) > 0
        assert torch.equal(fb_k.packed, fb_p.packed)

    def test_footprint_one_bucket_pass_matches_plain(self, cuda_device):
        """The reference's bucket megakernel at footprint 1 (which the
        renderer leaves to the multi-dispatch arm there, as the
        reference's does): one K1 and one K2 launch (the 1-px rung, the
        capped overflow rungs and their 1-px tails) equal to its plain
        twin, splats of every rung of the ladder included."""
        arrays, depth, (w, h) = cull_scene(29, n=1 << 15)
        overs = (2, 3, 4, 5, 6, 7, 8, 9, 17, 33, 65)
        thr = as_t(np.array([k / 2 for k in (1,) + overs],
                            np.float32)).to(cuda_device)
        t = {k: as_t(v).to(cuda_device) for k, v in arrays.items()}
        ids = torch.arange(1, (1 << 15) + 1, dtype=torch.int32,
                           device=cuda_device)
        args = (t["positions"], t["hier_base"], t["valid"], ids, t["view"],
                t["projection"], t["cam_pos"], t["spacings"],
                t["far_distances"], True, 3, thr)
        kw = dict(height=h, width=w, footprint=1, voronoi=True,
                  use_occlusion=True, use_pyramid=True, overflow_ks=overs)
        fb0 = tsplat.make_framebuffer(h, w, cuda_device)
        fb0.packed.view(-1)[: h * w // 2] = int(tsplat._CLEAR_WORD) - (1 << 40)
        k1, k2 = tkernel.launches, tsplat.launches
        fb_k, vec_k = tsplat.render_bucket_pass(
            tsplat.Framebuffer(fb0.packed.clone()), *args, **kw)
        torch.cuda.synchronize()
        assert (tkernel.launches, tsplat.launches) == (k1 + 1, k2 + 1)
        fb_p, vec_p = tsplat.render_bucket_pass(
            tsplat.Framebuffer(fb0.packed.clone()), *args, **kw,
            cull=tkernel.cull_classify_reference,
            raster=tsplat.splat_raster_reference)
        assert torch.equal(vec_k, vec_p) and int(vec_k[0]) > 0
        assert (vec_k[2:] > 0).sum() > 3  # kept rows in several rungs
        assert torch.equal(fb_k.packed, fb_p.packed)
        assert (fb_k.packed != fb0.packed).sum() > 1000

    def test_frame_on_card_matches_cpu(self, cuda_device, tmp_path):
        meta = make_store(tmp_path, corridor(20_000, seed=51))
        cam = corridor_camera(meta)
        tmeta, tcam = port_metadata(meta), port_camera(cam)
        streamer, frustums = streamed(tmeta, tmp_path, tcam, port=True)
        settings = TSettings(width=320, height=240)
        outs = []
        for device in ("cuda", "cpu"):
            renderer = TRenderer(tmeta, settings, device=device)
            rgb, depth, stats = renderer.render(streamer, tcam, frustums)
            outs.append((rgb, depth, stats,
                         renderer.framebuffer.point_id.cpu()))
        (rgb_g, d_g, s_g, id_g), (rgb_c, d_c, s_c, id_c) = outs
        assert np.array_equal(rgb_g, rgb_c) and np.array_equal(d_g, d_c)
        assert torch.equal(id_g, id_c) and s_g == s_c
