"""The port's multi-dispatch and sorted-raster primitives
(point_cloud_tpu_torch/render/splat.py, kernel.py) against the reference's
functions on identical inputs.

- ``compact_rows`` equals JAX's exactly, with a budget that drops rows and
  one past the kept count; ``compact_visible`` and ``loaded_cells_member``
  equal JAX's.
- ``rasterize_class_slice`` and ``rasterize_splats`` (one K2 segment whose
  cap is the budget) draw exactly the rows the reference's slice keeps:
  word for word the plain raster of those rows, and JAX's frame within
  the Frames contract (XLA:CPU contracts the fragment math into fma).
- ``emit_fragments``: pixels and ids equal JAX's; valid depths bit-exact
  against a NumPy IEEE oracle and within 2 ulp of JAX (XLA:CPU's fma).
- K3's plain twin (``emit_fragment_columns_reference``) lays a bucket's
  classes out as ``emit_fragments`` and the reference's padding do.
- ``_sort4_frags`` equals ``np.lexsort``; ``sorted_raster_merge`` (sort,
  then K4's one-pass merge) and its step-by-step twin equal JAX's
  ``sorted_raster_merge`` bit for bit; K4's plain twin on the cases where
  it could differ from the reference's steps: an id that sign-extends, a
  -0.0 depth, the padding tail, a pixel run across a thread block.

The ``cuda`` cases hold K3, K4 and ``sort4`` at 2^21..2^26 against their
plain versions on the card; here they skip. On the card, without JAX:
``PCT_TEST_PLATFORM=gpu python -m pytest tests/test_torch_fragments.py
-m cuda``.
"""

import numpy as np
import pytest
import torch

from point_cloud_tpu.render import camera as rcamera
from point_cloud_tpu_torch.ops import sort as tsort
from point_cloud_tpu_torch.render import kernel as tkernel
from point_cloud_tpu_torch.render import splat as tsplat


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's torch work (the workers
    share the machine's cores; see tests/test_torch_render.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


NO_ID = int(tsplat._NO_ID)


def jax_render():
    from point_cloud_tpu.render import kernel, splat

    return kernel, splat


def as_t(a, device="cpu"):
    return torch.as_tensor(np.ascontiguousarray(a), device=device)


def splat_rows(seed, n, w, h, spread_px):
    """n splats seen by the default camera at half-extents up to
    ``spread_px`` pixels, many overlapping (tests/test_torch_render.py)."""
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
    radius = (rng.uniform(0.2, 1.0, n) * spread_px * -view_pos[:, 2]
              / (proj[1, 1] * 0.5 * h)).astype(np.float32)
    ids = rng.permutation(n).astype(np.int32) + 1
    return view_pos, ndc, radius, ids, proj


def oracle_fragments(view_pos, ndc, radius, proj, h, w, k, voronoi):
    """The reference's fragment math (splat.py:187-259) in NumPy f32, one
    operation at a time: (rows, k*k) pixel x, pixel y, depth, valid."""
    f32 = np.float32
    px = (ndc[:, 0] * f32(0.5) + f32(0.5)) * f32(w)
    py = (ndc[:, 1] * f32(-0.5) + f32(0.5)) * f32(h)
    w_clip = np.maximum(-view_pos[:, 2], f32(1e-6))
    rx = np.maximum(radius * proj[0, 0] / w_clip * f32(0.5 * w), f32(1e-6))
    ry = np.maximum(radius * proj[1, 1] / w_clip * f32(0.5 * h), f32(1e-6))
    if k % 2:
        half = (k - 1) // 2
        bx, by = np.round(px), np.round(py)
    else:
        half = k // 2 - 1
        bx, by = np.floor(px), np.floor(py)
    offs = np.arange(-half, k - half, dtype=np.float32)
    fx = bx[:, None] + np.tile(offs, k)[None, :]
    fy = by[:, None] + np.repeat(offs, k)[None, :]
    nx = (fx - px[:, None]) / rx[:, None]
    ny = (fy - py[:, None]) / ry[:, None]
    d2 = nx * nx + ny * ny
    if voronoi:
        mz = view_pos[:, 2:3] + radius[:, None] * (f32(1.0) - d2)
        depth = (proj[2, 2] * mz + proj[2, 3]) / -mz
    else:
        depth = np.broadcast_to(ndc[:, 2:3], d2.shape)
    ok = ((d2 <= 1) & (fx >= 0) & (fx < w) & (fy >= 0) & (fy < h)
          & (depth >= 0) & (depth <= 1))
    return fx, fy, depth.astype(np.float32), ok


def ulp_distance(a, b):
    """|a - b| in units in the last place, for finite f32 of one sign."""
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


# --- compaction -------------------------------------------------------------


@pytest.mark.parametrize("out_size", [64, 150, 700])
def test_compact_rows_matches_jax(out_size):
    """A stable compaction to out_size rows: the kept rows in row order,
    row 0 in the unfilled slots, rows past out_size dropped (64 and 150
    are under the kept count, 700 over the row count)."""
    _, rsplat = jax_render()
    view_pos, ndc, radius, ids, _ = splat_rows(3, 500, 64, 48, 3.0)
    keep = np.random.default_rng(4).random(500) < 0.4
    got = tsplat.compact_rows(as_t(keep), as_t(view_pos), as_t(ndc),
                              as_t(radius), as_t(ids), out_size)
    want = rsplat.compact_rows(keep, view_pos, ndc, radius, ids,
                               out_size=out_size)
    for g, r in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(r))
    perm, count = tsplat.compact_perm(as_t(keep), out_size)
    assert int(count) == keep.sum()
    m = min(out_size, keep.sum())
    assert np.array_equal(perm.numpy()[:m], np.flatnonzero(keep)[:m])


def test_compact_visible_matches_jax():
    rkernel, _ = jax_render()
    rng = np.random.default_rng(8)
    mask = rng.random(300) < 0.3
    a, b = rng.random((300, 3)).astype(np.float32), np.arange(300)
    count, (ga, gb) = tkernel.compact_visible(as_t(mask), as_t(a), as_t(b))
    rcount, (ra, rb) = rkernel.compact_visible(mask, a, b)
    assert int(count) == int(rcount)
    assert np.array_equal(ga.numpy(), np.asarray(ra))
    assert np.array_equal(gb.numpy(), np.asarray(rb))


@pytest.mark.parametrize("m", [0, 1, 37, 500])
def test_loaded_cells_member_matches_jax(m):
    rkernel, _ = jax_render()
    rng = np.random.default_rng(m)
    table = np.unique(rng.integers(-4, 5, (m, 4)).astype(np.int32), axis=0)
    table = table.reshape(-1, 4)
    targets = rng.integers(-4, 5, (400, 4)).astype(np.int32)
    if len(table):
        targets[:50] = table[rng.integers(0, len(table), 50)]
    got = tkernel.loaded_cells_member(as_t(table), as_t(targets)).numpy()
    want = np.asarray(rkernel.loaded_cells_member(table, targets))
    assert np.array_equal(got, want)
    assert got.sum() == sum(tuple(t) in set(map(tuple, table))
                            for t in targets)


# --- the class slice and the uncompacted raster ----------------------------


def slice_inputs(seed=9, n=600, w=96, h=72):
    view_pos, ndc, radius, ids, proj = splat_rows(seed, n, w, h, 4.0)
    rung = np.random.default_rng(seed).integers(-1, 3, n).astype(np.int32)
    return view_pos, ndc, radius, ids, proj, rung


@pytest.mark.parametrize("ci,out_size", [(1, 64), (2, 512), (0, 128)])
def test_rasterize_class_slice_draws_the_kept_rows(ci, out_size):
    """One class of compact_classes through its slice: word for word the
    plain raster of the class's first out_size rows (64 and 128 drop rows),
    and JAX's slice raster on the same perm within the Frames contract.
    A budget stays under the bucket's rows, as the renderer keeps it (a
    budget at or past them rasters the class uncompacted)."""
    _, rsplat = jax_render()
    view_pos, ndc, radius, ids, proj, rung = slice_inputs()
    w, h, k = 96, 72, 5
    perm, counts, offsets = tsplat.compact_classes(as_t(rung), 3)
    fb = tsplat.make_framebuffer(h, w)
    tsplat.rasterize_class_slice(
        fb, as_t(view_pos), as_t(ndc), as_t(radius), as_t(ids), perm,
        offsets[ci], counts[ci], as_t(proj), h, w, k, True, out_size)
    rows = np.flatnonzero(rung == ci)[:out_size]
    if out_size < 512:
        assert len(rows) < (rung == ci).sum()  # the budget drops rows
    manual = tsplat.make_framebuffer(h, w).packed
    tsplat.splat_raster_reference(
        manual, as_t(view_pos), as_t(ndc), as_t(radius), as_t(ids),
        as_t(np.concatenate([rows, np.zeros(len(rows))]).astype(np.int32)),
        torch.tensor([0], dtype=torch.int32),
        torch.tensor([len(rows)], dtype=torch.int32), as_t(proj), h, w, k,
        True, 64)
    assert torch.equal(fb.packed, manual)
    drawn = set(fb.point_id.numpy().tolist()) - {NO_ID}
    assert drawn <= set(ids[rows].tolist()) and len(drawn) > 10
    ref = rsplat.rasterize_class_slice(
        rsplat.make_framebuffer(h, w), view_pos, ndc, radius, ids,
        perm.numpy(), np.int32(offsets[ci]), np.int32(counts[ci]), proj,
        height=h, width=w, footprint=k, voronoi=True, out_size=out_size)
    same = fb.point_id.numpy() == np.asarray(ref.point_id)
    assert same.mean() >= 0.999
    assert np.abs(fb.depth.numpy() - np.asarray(ref.depth))[same].max() <= 1e-6


def test_rasterize_splats_and_raster_compacted():
    """rasterize_splats draws every valid row (JAX's within the Frames
    contract); raster_compacted at a budget under the kept count draws
    exactly the first rows of the compaction."""
    _, rsplat = jax_render()
    view_pos, ndc, radius, ids, proj, rung = slice_inputs(seed=10)
    w, h = 96, 72
    valid = rung >= 0
    args = (as_t(view_pos), as_t(ndc), as_t(radius), as_t(ids))
    fb = tsplat.rasterize_splats(tsplat.make_framebuffer(h, w), *args,
                                 as_t(valid), as_t(proj), h, w, 3, True)
    ref = rsplat.rasterize_splats(rsplat.make_framebuffer(h, w), view_pos,
                                  ndc, radius, ids, valid, proj, height=h,
                                  width=w, footprint=3, voronoi=True)
    same = fb.point_id.numpy() == np.asarray(ref.point_id)
    assert same.mean() >= 0.999 and (fb.point_id != NO_ID).sum() > 500
    budget = tsplat.raster_compacted(
        tsplat.make_framebuffer(h, w), *args, as_t(valid), as_t(proj), h, w,
        3, True, 100)
    first = np.zeros(len(valid), bool)
    first[np.flatnonzero(valid)[:100]] = True
    whole = tsplat.rasterize_splats(tsplat.make_framebuffer(h, w), *args,
                                    as_t(first), as_t(proj), h, w, 3, True)
    assert torch.equal(budget.packed, whole.packed)


# --- fragments ----------------------------------------------------------------


@pytest.mark.parametrize("voronoi", [True, False])
@pytest.mark.parametrize("k", [1, 4, 5, 9])
def test_emit_fragments_matches_jax_and_oracle(k, voronoi):
    """Pixels and ids equal JAX's (the budget of 200 drops kept rows);
    valid depths bit-exact against the NumPy oracle and within 2 ulp of
    JAX: its CPU compiler contracts the voronoi depth's two multiply-adds
    (the moved z and the clip z) into fma, and each rounds once less
    (measured: at most 2 ulp on these rows, most depths equal)."""
    _, rsplat = jax_render()
    w, h = 64, 48
    view_pos, ndc, radius, ids, proj = splat_rows(k, 400, w, h, k / 2)
    keep = np.random.default_rng(k).random(400) < 0.7
    out_size = 200
    pix, depth, fid = tsplat.emit_fragments(
        as_t(keep), as_t(view_pos), as_t(ndc), as_t(radius), as_t(ids),
        as_t(proj), h, w, k, voronoi, out_size)
    rpix, rdepth, rfid = (np.asarray(a) for a in rsplat.emit_fragments(
        keep, view_pos, ndc, radius, ids, proj, height=h, width=w,
        footprint=k, voronoi=voronoi, out_size=out_size))
    assert np.array_equal(pix.numpy(), rpix)
    assert np.array_equal(fid.numpy(), rfid)
    rows = np.flatnonzero(keep)[:out_size]
    fx, fy, odepth, ok = oracle_fragments(view_pos[rows], ndc[rows],
                                          radius[rows], proj, h, w, k,
                                          voronoi)
    valid = pix.numpy() != NO_ID
    assert valid.sum() == ok.sum() > 50
    want = (fy.astype(np.int64) * w + fx.astype(np.int64))[ok]
    assert np.array_equal(pix.numpy()[valid], want)
    got_d = depth.numpy()[valid]
    assert np.array_equal(got_d.view(np.int32), odepth[ok].view(np.int32))
    assert ulp_distance(got_d, rdepth[valid]).max() <= 2


def test_fragment_columns_lay_out_classes_and_padding():
    """K3's plain twin: class after class as emit_fragments lays each out
    (a class of more slots than rows, one of fewer), then the padding rows
    (_NO_ID, _NO_ID, 0); the depth bits with -0.0 as +0.0."""
    w, h = 64, 48
    view_pos, ndc, radius, ids, proj = splat_rows(21, 300, w, h, 3.0)
    ndc[::7, 2] = -0.0  # flat depth -0.0 on every 7th row
    rung = np.random.default_rng(21).integers(-1, 3, 300).astype(np.int32)
    args = [as_t(a) for a in (view_pos, ndc, radius, ids)]
    perm, counts, offsets = tsplat.compact_classes(as_t(rung), 3)
    classes = (tsplat.FragmentClass(3, 2, 1024),
               tsplat.FragmentClass(2, 0, 40))
    total = tsplat.fragment_total(classes)
    length = 16384
    cols = tsplat.emit_fragment_columns(*args, perm, offsets, counts,
                                        as_t(proj), h, w, classes, False,
                                        length)
    parts = [tsplat.emit_fragments(as_t(rung == c.cls), *args, as_t(proj),
                                   h, w, c.k, False, c.rows)
             for c in classes]
    pad = length - total
    want = tsplat.fragment_columns(
        torch.cat([p for p, _, _ in parts]
                  + [torch.full((pad,), NO_ID, dtype=torch.int32)]),
        torch.cat([d for _, d, _ in parts] + [torch.zeros(pad)]),
        torch.cat([i for _, _, i in parts]
                  + [torch.zeros(pad, dtype=torch.int32)]))
    for g, r in zip(cols, want):
        assert torch.equal(g, r)
    pix, bits, fid, arrival = (c.numpy() for c in cols)
    assert (pix[total:] == NO_ID).all() and (bits[total:] == NO_ID).all()
    assert (fid[total:] == 0).all()
    assert np.array_equal(arrival, np.arange(length))
    valid = pix != NO_ID
    assert ((bits[valid] == 0).sum() > 0) and (bits[valid] >= 0).all()


def test_sort4_frags_matches_lexsort():
    rng = np.random.default_rng(5)
    n = 4096
    pix = rng.integers(0, 300, n).astype(np.int32)
    pix[rng.random(n) < 0.3] = NO_ID
    bits = rng.integers(0, 1 << 30, n).astype(np.int32)
    bits[1::5] = bits[::5][: len(bits[1::5])]  # ties on depth
    fid = rng.integers(-5, 5000, n).astype(np.int32)
    got = tsplat._sort4_frags(as_t(pix), as_t(bits), as_t(fid))
    order = np.lexsort((np.arange(n), fid, bits, pix))
    for g, col in zip(got, (pix, bits, fid, np.arange(n, dtype=np.int32))):
        assert np.array_equal(g.numpy(), col[order])


def fragment_list(seed, n=2048, w=32, h=24):
    """A fragment list with repeated pixels, depth ties, -0.0 depths and
    invalid rows, and a prior plane half covered."""
    rng = np.random.default_rng(seed)
    pix = rng.integers(0, w * h, n).astype(np.int32)
    pix[rng.random(n) < 0.2] = NO_ID
    depth = rng.choice(np.linspace(0, 1, 40).astype(np.float32), n)
    depth[rng.random(n) < 0.05] = np.float32(-0.0)
    fid = rng.integers(1, 400, n).astype(np.int32)
    prior = tsplat.make_framebuffer(h, w).packed
    half = torch.arange(w * h) % 2 == 0
    d0 = torch.as_tensor(rng.choice(np.linspace(0, 1, 40).astype(np.float32),
                                    w * h))
    w0 = (d0.view(torch.int32).long() << 32) | torch.as_tensor(
        rng.integers(1, 400, w * h))
    prior[half] = w0[half]
    return pix, depth, fid, prior, (h, w)


@pytest.mark.parametrize("seed", [0, 1])
def test_sorted_raster_merge_matches_jax(seed):
    """One merge of a fragment list into a covered plane: the port's
    (sort, then K4's one-pass minimum of the packed word) and its
    step-by-step twin equal JAX's sorted_raster_merge, depth bits and ids."""
    _, rsplat = jax_render()
    pix, depth, fid, prior, (h, w) = fragment_list(seed)
    fb = tsplat.Framebuffer(prior.clone())
    tsplat.sorted_raster_merge(fb, as_t(pix), as_t(depth), as_t(fid))
    steps = tsplat.sorted_raster_merge_reference(
        tsplat.Framebuffer(prior.clone()), as_t(pix), as_t(depth), as_t(fid))
    p = tsplat.Framebuffer(prior)
    ref = rsplat.sorted_raster_merge(
        rsplat.Framebuffer(depth=p.depth.numpy(), point_id=p.point_id.numpy()),
        pix, depth, fid)
    want_d = np.asarray(ref.depth).view(np.int32)
    want_i = np.asarray(ref.point_id)
    for got in (fb, steps):
        assert np.array_equal(got.depth.numpy().view(np.int32), want_d)
        assert np.array_equal(got.point_id.numpy(), want_i)
    assert (fb.packed != prior).sum() > 100


def test_sorted_merge_twin_edge_cases():
    """K4's plain twin where a one-pass merge of packed words could part
    from the reference's steps: an id with the sign bit set is masked to
    its 32 bits and never reaches the depth word; the padding rows (pixel
    _NO_ID) merge nothing; a pixel run that crosses a 256-row thread block
    has one winner, its first row."""
    n, n_pix = 1024, 64
    pix = np.full(n, NO_ID, np.int32)
    bits = np.full(n, NO_ID, np.int32)
    fid = np.zeros(n, np.int32)
    pix[250:262] = 7  # one run across rows 255 / 256
    bits[250:262] = np.arange(12) + 100
    fid[250:262] = 5
    pix[300], bits[300], fid[300] = 8, 100, -3  # an id that sign-extends
    fb = tsplat.make_framebuffer(1, n_pix).packed
    tsplat.sorted_merge_reference(fb, as_t(pix), as_t(bits), as_t(fid))
    out = tsplat.Framebuffer(fb)
    assert int(fb[7]) == (100 << 32) | 5
    assert int(fb[8]) == (100 << 32) | (2**32 - 3)
    assert out.depth.numpy().view(np.int32)[8] == 100
    assert (fb[[i for i in range(n_pix) if i not in (7, 8)]]
            == tsplat._CLEAR_WORD).all()
    # a word of higher bits loses to one of lower, unsigned, either order
    for ids in ([1, -1], [-1, 1]):
        fb = torch.full((1,), tsplat._CLEAR_WORD)
        for i in ids:
            tsplat.sorted_merge_reference(
                fb, torch.tensor([0], dtype=torch.int32),
                torch.tensor([100], dtype=torch.int32),
                torch.tensor([i], dtype=torch.int32))
        assert int(fb[0]) == (100 << 32) | 1


def sorted_rows(pix, bits, fid):
    """The columns as ``sort4`` orders them (its plain version), on the
    CPU: pixel, depth bits, id, arrival."""
    arrival = np.arange(len(pix), dtype=np.int32)
    return tsort.sort4_reference(*(as_t(c) for c in (pix, bits, fid,
                                                     arrival)))


def tail_list(case):
    """A fragment list of 4096 rows with a ``_NO_ID`` tail: ``fragments``
    as K3 lays a bucket out (``fragment_list``'s rows, a fifth invalid);
    ``off_plane`` adds negative pixels and pixels past the plane."""
    pix, depth, fid, prior, (h, w) = fragment_list(7, n=4096)
    if case == "off_plane":
        rng = np.random.default_rng(8)
        pix[rng.random(len(pix)) < 0.1] = -rng.integers(1, 50)
        pix[rng.random(len(pix)) < 0.1] = h * w + rng.integers(0, 50)
    cols = tsplat.fragment_columns(as_t(pix), as_t(depth), as_t(fid))
    return tuple(c.numpy() for c in cols[:3]), prior


@pytest.mark.parametrize("case", ["fragments", "off_plane"])
def test_sorted_merge_needs_no_row_of_the_tail(case):
    """The precondition K4's stop rests on: on sort4's output every
    _NO_ID row lies in one tail at the end, and merging the rows up to
    the first of them leaves the plane that merging every row does."""
    (pix, bits, fid), prior = tail_list(case)
    cols = sorted_rows(pix, bits, fid)[:3]
    spix = cols[0].numpy()
    first = int(np.argmax(spix == NO_ID))
    assert 0 < first < len(spix) and (spix[first:] == NO_ID).all()
    assert (spix[:first] != NO_ID).all()
    if case == "off_plane":
        assert (spix[:first] < 0).any() and (spix[:first] >= len(prior)).any()
    fb_all, fb_prefix = prior.clone(), prior.clone()
    tsplat.sorted_merge_reference(fb_all, *cols)
    tsplat.sorted_merge_reference(fb_prefix, *(c[:first] for c in cols))
    assert torch.equal(fb_all, fb_prefix)
    assert (fb_all != prior).sum() > 50


# --- the kernels on the card ----------------------------------------------

N_PIX = 1280 * 720
CHUNK_LCM = 1536  # a multiple of every warp chunk K4 may take (128 x 2..4)


def merge_case(case):
    """K4's inputs for one case: (pix, bits, ids) before the sort, the
    plane's length, whether the plane already holds words, and the rows
    sliced off the sorted columns' front."""
    rng = np.random.default_rng(MERGE_CASES.index(case))
    n, offset, prior = 1 << 20, 0, True
    if case.startswith("n="):
        n = {"n=1": 1, "n=3": 3, "n=2^20+3": (1 << 20) + 3}[case]
    elif case == "runs":
        n = (1 << 21) + 5
    pix = rng.integers(0, N_PIX, n).astype(np.int32)
    if case == "all_no_id":
        pix[:] = NO_ID
    elif case == "runs":
        # short runs across vector (4-row) bounds in the first half; runs
        # of 128 rows from row 64 on, so each crosses a lane, and so every
        # warp chunk and block stride, bound; one run of 5000 rows
        half = n // 2
        pix[:half] = np.arange(half) // 3
        pix[half:] = pix[half - 1] + 1 + (np.arange(n - half) + 64) // 128
        pix[half + 9000:half + 14000] = pix[half + 9000]
    elif case in ("tail_at_chunk", "tail_after_chunk"):
        pix = np.sort(pix)
        start = 3 * (1 << 18) + (case == "tail_after_chunk")
        assert start % CHUNK_LCM == (case == "tail_after_chunk")
        pix[start:] = NO_ID
    elif case == "off_plane":
        for share, low, high in ((0.1, -1000, 0), (0.1, N_PIX, N_PIX + 1000),
                                 (0.3, NO_ID, NO_ID + 1)):
            mask = rng.random(n) < share
            pix[mask] = rng.integers(low, high, int(mask.sum()))
    elif case == "offset":
        pix[rng.random(n) < 0.4] = NO_ID
        offset = 1
    elif case == "clear_plane":
        prior = False
    bits = rng.integers(0, 0x3F800001, n).astype(np.int32)
    fid = rng.integers(-(2**31), 2**31 - 1, n, dtype=np.int64).astype(np.int32)
    bits[pix == NO_ID] = NO_ID
    return (pix, bits, fid), N_PIX, prior, offset


MERGE_CASES = ("dense", "all_no_id", "n=1", "n=3", "n=2^20+3", "offset",
               "runs", "tail_at_chunk", "tail_after_chunk", "off_plane",
               "clear_plane")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K3, K4 and sort4 have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
class TestFragmentKernelsOnCard:
    @pytest.mark.parametrize("voronoi", [True, False])
    def test_emit_kernel_matches_plain(self, cuda_device, voronoi):
        """K3 against its plain twin on a table of every window parity up
        to the kernel's limit, classes of more slots than rows, a -0.0
        flat depth and a padding tail."""
        w, h = 640, 360
        view_pos, ndc, radius, ids, proj = splat_rows(31, 3000, w, h, 9.0)
        ndc[::11, 2] = -0.0
        rung = np.random.default_rng(31).integers(-1, 8, 3000)
        dev = lambda a: as_t(a, cuda_device)
        args = [dev(a) for a in (view_pos, ndc, radius, ids)]
        perm, counts, offsets = tsplat.compact_classes(
            dev(rung.astype(np.int32)), 8)
        classes = tuple(tsplat.FragmentClass(k, c, rows) for k, c, rows in (
            (1, 0, 1024), (2, 1, 300), (5, 2, 4096), (8, 3, 64),
            (17, 4, 512), (33, 5, 4), (65, 6, 400), (128, 7, 16)))
        length = tsplat.fragment_total(classes) + 5000
        before = tsplat.fragment_launches
        got = tsplat.emit_fragment_columns(*args, perm, offsets, counts,
                                           dev(proj), h, w, classes, voronoi,
                                           length)
        want = tsplat.emit_fragment_columns_reference(
            *args, perm, offsets, counts, dev(proj), h, w, classes, voronoi,
            length)
        torch.cuda.synchronize()
        assert tsplat.fragment_launches == before + 1
        for g, r in zip(got, want):
            assert torch.equal(g, r)
        assert (got[0] != NO_ID).sum() > 50_000

    def test_merge_kernel_matches_plain(self, cuda_device):
        """K4 against its plain twin: a sorted list with runs across every
        thread block, ids with the sign bit set, the padding tail."""
        rng = np.random.default_rng(3)
        n, n_pix = 1 << 20, 1280 * 720
        pix = rng.integers(0, n_pix, n).astype(np.int32)
        pix[rng.random(n) < 0.1] = NO_ID
        pix[:1000] = 17  # a run of 1000 rows
        bits = rng.integers(0, 0x3F800001, n).astype(np.int32)
        fid = rng.integers(-(2**31), 2**31 - 1, n, dtype=np.int64).astype(
            np.int32)
        cols = tsplat._sort4_frags(as_t(pix, cuda_device),
                                   as_t(bits, cuda_device),
                                   as_t(fid, cuda_device))
        fb_k = tsplat.make_framebuffer(720, 1280, cuda_device).packed
        fb_k[::3] = (0x3F000000 << 32) | 5
        fb_p = fb_k.clone()
        before = tsplat.merge_launches
        tsplat.sorted_merge(fb_k, *cols[:3])
        tsplat.sorted_merge_reference(fb_p, *cols[:3])
        torch.cuda.synchronize()
        assert tsplat.merge_launches == before + 1
        assert torch.equal(fb_k, fb_p)
        assert (fb_k != tsplat.make_framebuffer(720, 1280, cuda_device)
                .packed).sum() > 100_000

    @pytest.mark.parametrize("case", MERGE_CASES)
    def test_merge_kernel_cases(self, cuda_device, case):
        """K4 against its plain twin where its vector loads, run starts
        from registers and stop at the _NO_ID tail could part from it: a
        dense list, an all-_NO_ID list, 1, 3 and 2^20 + 3 rows, columns
        4 B past a 16-byte boundary (a [1:] view), runs across vectors,
        lanes, chunks and strides, the tail at a chunk boundary and one
        row past it, pixels off the plane before the tail, a plane that
        holds words (every case but ``clear_plane``)."""
        cols, n_pix, prior, offset = merge_case(case)
        cols = [c.to(cuda_device)[offset:] for c in sorted_rows(*cols)[:3]]
        if case == "offset":
            assert cols[0].data_ptr() % 16 == 4
        fb = tsplat.make_framebuffer(1, n_pix, cuda_device).packed
        if prior:
            fb[::3] = (0x3F000000 << 32) | 5
        fb_p = fb.clone()
        before = tsplat.merge_launches
        tsplat.sorted_merge(fb, *cols)
        tsplat.sorted_merge_reference(fb_p, *cols)
        torch.cuda.synchronize()
        assert tsplat.merge_launches == before + 1
        assert torch.equal(fb, fb_p)

    @pytest.mark.parametrize("log_n", [21, 22, 23, 24, 25, 26])
    def test_sort4_at_fragment_lengths(self, cuda_device, log_n):
        """sort4 at the sorted raster's lengths, above phase 2's 2^22 (a
        1280x720 sorted frame sorts 2^26 rows): fragment-shaped keys
        (pixels, _NO_ID tails, depth ties)."""
        n = 1 << log_n
        rng = np.random.default_rng(log_n)
        pix = rng.integers(0, 1280 * 720, n).astype(np.int32)
        pix[rng.random(n) < 0.5] = NO_ID
        bits = rng.integers(0, 64, n).astype(np.int32)
        bits[pix == NO_ID] = NO_ID
        fid = rng.integers(1, 1 << 22, n).astype(np.int32)
        cols = [as_t(c, cuda_device) for c in
                (pix, bits, fid, np.arange(n, dtype=np.int32))]
        got = tsort.sort4(*cols)
        want = tsort.sort4_reference(*cols)
        torch.cuda.synchronize()
        for g, r in zip(got, want):
            assert torch.equal(g, r)

    def test_sorted_raster_merge_on_card_matches_cpu(self, cuda_device):
        pix, depth, fid, prior, _ = fragment_list(2, n=8192, w=64, h=48)
        out = []
        for device in (cuda_device, "cpu"):
            fb = tsplat.Framebuffer(prior.clone().to(device))
            tsplat.sorted_raster_merge(fb, as_t(pix, device),
                                       as_t(depth, device),
                                       as_t(fid, device))
            out.append(fb.packed.cpu())
        assert torch.equal(*out)
