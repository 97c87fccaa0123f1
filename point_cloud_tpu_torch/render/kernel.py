"""Cull, LOD walk and footprint classification of the frame (counterpart
of render/kernel.py).

- NumPy half, copied from the reference (kernel.py:63-123):
  :data:`HASH_EMPTY`, :data:`BUCKET_ROWS`, :func:`_hash_rows_np` and
  :func:`build_loaded_cells_hash`, the host side of the loaded-cells hash.
- Torch half: :func:`hash_member` and :func:`lod_select` (the LOD walk,
  integer compares after one divide: K6, ``csrc/lod_select.cu``, one
  launch a call; its plain version :func:`lod_select_reference`, the
  eager walk a level at a time), and the camera pass
  :func:`cull_classify`, whose callers :func:`_cull_body`,
  :func:`cull_classify_pass` and :func:`cull_lod_pass` keep the
  reference's signatures and outputs; :func:`fit_counts`, the
  multi-dispatch arm's cumulative counts; and two reference functions
  that no frame calls, :func:`loaded_cells_member` (the WGSL binary
  search) and :func:`compact_visible`.

:func:`cull_classify` launches the hand-written kernel ``csrc/cull.cu``
on a CUDA tensor, or raises; on a CPU tensor it runs
:func:`cull_classify_reference`, its plain PyTorch twin with the same
IEEE arithmetic in the same order (the 4-term dot products pairwise, as
XLA:CPU sums its (N,4)x(4,4) product; never ``torch.matmul``, never
``.sum()`` or ``norm``). Every divisor is a tensor on the data's device:
PyTorch's CUDA division by a CPU scalar multiplies by the reciprocal.
``launches`` counts the kernel's launches. :func:`lod_select` routes the
same way (the kernel on a CUDA tensor or a raise, the plain version on a
CPU tensor); ``lod_launches`` counts K6's launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

MAX_HIERARCHIES = 24  # static unroll bound for the LOD walk
PYRAMID_TILE = 8  # px per coarse occlusion tile (depth-pyramid pre-cull)

launches = 0  # K1
lod_launches = 0  # K6

# --- loaded-cell membership: the bucketized hash table (NumPy side) -------

HASH_EMPTY = np.int32(np.iinfo(np.int32).min)  # sentinel row value
BUCKET_ROWS = 4  # rows per aligned bucket: one gather probes all four

_HC1 = np.uint32(0x9E3779B1)
_HC2 = np.uint32(0x85EBCA77)
_HC3 = np.uint32(0xC2B2AE3D)


def _hash_rows_np(rows: np.ndarray) -> np.ndarray:
    """uint32 hash of (M, 4) int32 rows (NumPy side, wraparound)."""
    h = np.uint32(0x1000193)
    out = np.full(len(rows), h, np.uint32)
    for i in range(4):
        out = (out ^ (rows[:, i].astype(np.uint32) * _HC1)) * _HC2
        out ^= out >> np.uint32(15)
    out *= _HC3
    return out ^ (out >> np.uint32(13))


def build_loaded_cells_hash(table: np.ndarray) -> np.ndarray:
    """Bucketized table of (h, x, y, z) rows -> (NB, BUCKET_ROWS*4) i32.

    NB is a power of two with NB*BUCKET_ROWS >= 2*M; each key lands in
    bucket ``hash & (NB-1)``; a bucket that would exceed BUCKET_ROWS rows
    grows the whole table (so lookups never probe a second bucket).
    Empty lanes hold HASH_EMPTY rows, which can never equal a real probe
    target (targets carry h >= 1). Duplicate input rows are deduplicated
    so they cannot artificially overflow a bucket.
    """
    rows = np.asarray(table, np.int32).reshape(-1, 4)
    if len(rows):
        rows = np.unique(rows, axis=0)
    nb = 64
    while nb * BUCKET_ROWS < 2 * max(len(rows), 1):
        nb *= 2
    while True:
        slots = np.full((nb, BUCKET_ROWS * 4), HASH_EMPTY, np.int32)
        fill = np.zeros(nb, np.int32)
        ok = True
        bucket = (_hash_rows_np(rows) & np.uint32(nb - 1)).astype(np.int64)
        for row, b in zip(rows, bucket):
            k = fill[b]
            if k >= BUCKET_ROWS:
                ok = False
                break
            slots[b, 4 * k : 4 * k + 4] = row
            fill[b] = k + 1
        if ok:
            return slots
        nb *= 2


# --- loaded-cell membership and the LOD walk (torch side) -----------------

_U32 = 0xFFFFFFFF


def _mul_u32(a, c: int):
    """``(a * c) mod 2^32`` for int64 ``a`` in [0, 2^32) and a uint32
    constant ``c``, without overflowing int64: the high half of ``a`` only
    reaches bits 16-31 of the product."""
    lo = (a & 0xFFFF) * c
    hi = (((a >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _hash_rows_torch(rows):
    """The uint32 row hash of :func:`_hash_rows_np` in int64 arithmetic:
    every step masked to 32 bits, so the shifts are logical (the
    reference's uint32 ones, not an int32 arithmetic shift)."""
    out = torch.full(rows.shape[:-1], 0x1000193, dtype=torch.int64,
                     device=rows.device)
    for i in range(4):
        col = rows[..., i].to(torch.int64) & _U32
        out = _mul_u32(out ^ _mul_u32(col, int(_HC1)), int(_HC2))
        out = out ^ (out >> 15)
    out = _mul_u32(out, int(_HC3))
    return out ^ (out >> 13)


def hash_member(hash_table, targets):
    """Exact membership of (N, 4) i32 target rows in a table built by
    :func:`build_loaded_cells_hash`: one bucket gather per target, then
    BUCKET_ROWS full-row compares (kernel.py:126-136)."""
    nb = hash_table.shape[0]
    bucket = _hash_rows_torch(targets) & (nb - 1)
    cand = hash_table[bucket].reshape(-1, BUCKET_ROWS, 4)
    return (cand == targets[:, None, :]).all(dim=-1).any(dim=-1)


def _lex_less(row_a, row_b):
    """Elementwise lexicographic < between (..., 4) int32 key rows
    (kernel.py:38-48)."""
    a0, a1, a2, a3 = (row_a[..., i] for i in range(4))
    b0, b1, b2, b3 = (row_b[..., i] for i in range(4))
    return ((a0 < b0) | ((a0 == b0) & (a1 < b1))
            | ((a0 == b0) & (a1 == b1) & (a2 < b2))
            | ((a0 == b0) & (a1 == b1) & (a2 == b2) & (a3 < b3)))


def loaded_cells_member(table, targets):
    """Membership of (N, 4) i32 target rows in a row-sorted (M, 4) table:
    the lock-step lexicographic binary search of kernel.py:139-161 (the
    WGSL search, compute.wgsl:127-155). A reference function: the frame
    uses :func:`hash_member`."""
    m = table.shape[0]
    n = targets.shape[0]
    dev = targets.device
    if m == 0:
        return torch.zeros(n, dtype=torch.bool, device=dev)
    lo = torch.zeros(n, dtype=torch.int64, device=dev)
    hi = torch.full((n,), m, dtype=torch.int64, device=dev)
    steps = max(1, int(np.ceil(np.log2(m + 1))) + 1)
    for _ in range(steps):
        mid = (lo + hi) // 2
        less = _lex_less(table[mid.clamp(0, m - 1)], targets) & (mid < m)
        lo = torch.where(less, mid + 1, lo)
        hi = torch.where(less, hi, mid)
    found = (table[lo.clamp(0, m - 1)] == targets).all(dim=-1)
    return (lo < m) & found


def lod_select_reference(positions, point_hierarchy, cell_sizes,
                         num_hierarchies: int, loaded_cells):
    """Plain version of K6, LOD selection (kernel.py:172-196): walk from
    each point's own hierarchy toward finer ones while the containing
    finer cell is loaded. Camera-independent, so the renderer caches it
    per loaded set."""
    n = positions.shape[0]
    last = num_hierarchies - 1
    own = torch.clamp_max(point_hierarchy, last)
    result = own
    alive = torch.ones(n, dtype=torch.bool, device=positions.device)
    for h in range(1, num_hierarchies):
        # floor(pos / cell_size): the divisor a one-element device tensor
        idx = torch.floor(positions / cell_sizes[h : h + 1]).to(torch.int32)
        target = torch.cat(
            [torch.full((n, 1), h, dtype=torch.int32, device=positions.device),
             idx], dim=1)
        found = hash_member(loaded_cells, target)
        relevant = (own < h) & (h <= last)
        alive = torch.where(relevant, alive & found, alive)
        result = torch.where(relevant & alive, h, result)
    return result


def _check_tensors(name: str, expect, dev) -> None:
    """Each ``(tensor, dtype, shape)`` of ``expect`` is a contiguous tensor
    of that dtype and shape on ``dev``, as a CUDA wrapper's launch needs."""
    for t, dtype, shape in expect:
        if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(
                f"{name} takes {dtype} {shape} contiguous tensors on {dev}; "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _check_lod_args(positions, point_hierarchy, cell_sizes,
                    num_hierarchies: int, loaded_cells):
    n = positions.shape[0]
    nb = loaded_cells.shape[:1]
    _check_tensors("lod_select", (
        (positions, torch.float32, (n, 3)),
        (point_hierarchy, torch.int32, (n,)),
        (cell_sizes, torch.float32, (cell_sizes.numel(),)),
        (loaded_cells, torch.int32, (*nb, BUCKET_ROWS * 4))),
        positions.device)
    if cell_sizes.numel() < num_hierarchies:
        raise ValueError("lod_select: cell_sizes needs an entry a hierarchy")
    if not nb[0] or nb[0] & (nb[0] - 1) or loaded_cells.data_ptr() % 16:
        raise ValueError("lod_select: loaded_cells must be a 16-byte aligned "
                         "(NB, 16) table, NB a power of two "
                         "(build_loaded_cells_hash)")


def lod_select(positions, point_hierarchy, cell_sizes, num_hierarchies: int,
               loaded_cells):
    """K6: :func:`lod_select_reference`'s function, launched as the
    ``csrc/lod_select.cu`` kernel on a CUDA tensor (one launch a call, no
    fallback) and run as that plain version on a CPU tensor. Same
    arguments and result ((N,) int32)."""
    global lod_launches
    dev = positions.device
    if dev.type == "cpu":
        return lod_select_reference(positions, point_hierarchy, cell_sizes,
                                    num_hierarchies, loaded_cells)
    if dev.type != "cuda":
        raise ValueError(f"lod_select runs on cuda or cpu, not {dev}")
    _check_lod_args(positions, point_hierarchy, cell_sizes, num_hierarchies,
                    loaded_cells)
    from ..ops.runtime import load_kernels

    lib = load_kernels()
    n = positions.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pc_lod_select(
            positions.data_ptr(), point_hierarchy.data_ptr(),
            cell_sizes.data_ptr(), loaded_cells.data_ptr(),
            loaded_cells.shape[0], int(num_hierarchies) - 1, out.data_ptr(),
            n, stream)
    if rc != 0:
        raise RuntimeError(f"pc_lod_select launch failed: cudaError {rc}")
    lod_launches += 1
    return out


# --- the camera pass: K1 and its plain twin -------------------------------


def _dot4(m, j: int, a0, a1, a2, a3=None):
    """Row ``j`` of ``m`` against (a0, a1, a2, a3), summed pairwise; a
    missing ``a3`` is the homogeneous 1."""
    last = m[j, 3] if a3 is None else a3 * m[j, 3]
    return (a0 * m[j, 0] + a1 * m[j, 1]) + (a2 * m[j, 2] + last)


def coarse_depth_grid(depth):
    """The depth pyramid's dilated coarse max grid (kernel.py:307-325):
    max over PYRAMID_TILE^2 tiles (the plane padded with the clear depth),
    then a 3x3 dilate whose neighbours wrap at the borders like
    ``jnp.roll``: a wrapped neighbour only adds area to the max, which
    keeps the gate conservative."""
    t = PYRAMID_TILE
    hgt, wid = depth.shape
    hp, wp = -(-hgt // t) * t, -(-wid // t) * t
    if (hp, wp) != (hgt, wid):
        depth = torch.nn.functional.pad(
            depth, (0, wp - wid, 0, hp - hgt), value=1.0)
    coarse = depth.reshape(hp // t, t, wp // t, t).amax(dim=(1, 3))
    for ax in (0, 1):
        coarse = torch.maximum(
            coarse,
            torch.maximum(torch.roll(coarse, 1, ax), torch.roll(coarse, -1, ax)),
        )
    return coarse.contiguous()


def cull_classify_reference(positions, hier_base, valid, view, projection,
                            cam_pos, spacings, far_distances,
                            size_by_distance: bool, max_hierarchy: int,
                            thresholds, width: int, height: int,
                            depth=None, coarse=None):
    """Plain version of K1: the reference's ``_cull_body`` (kernel.py:
    205-346) plus the exclusive rung of splat.py:729-750.

    Returns (keep, hierarchy, view_pos (N,4), ndc (N,3), radius, rmax,
    rung): ``rung`` is the first ladder rung j < R-1 with rmax <
    thresholds[j], else R-1, and -1 where the point is not kept. ``depth``
    turns the occlusion test on, ``coarse`` (:func:`coarse_depth_grid`)
    the depth-pyramid gate."""
    from .splat import splat_pixel_radii

    dev = positions.device
    x, y, z = positions[:, 0], positions[:, 1], positions[:, 2]
    vp = [_dot4(view, j, x, y, z) for j in range(4)]
    clip = [_dot4(projection, j, *vp) for j in range(4)]
    ndc = [clip[j] / clip[3] for j in range(3)]
    keep = ((ndc[0].abs() <= 1.0) & (ndc[1].abs() <= 1.0)
            & ((ndc[2] - 0.5).abs() <= 0.5) & valid)

    # distance override (kernel.py:230-243)
    dx, dy, dz = x - cam_pos[0], y - cam_pos[1], z - cam_pos[2]
    dist = torch.sqrt((dx * dx + dy * dy) + dz * dz)
    hier_ids = torch.arange(MAX_HIERARCHIES, dtype=torch.int32, device=dev)
    cand = ((hier_ids[None, :] > hier_base[:, None])
            & (hier_ids[None, :] <= max_hierarchy)
            & (dist[:, None] < far_distances[None, :]))
    override = torch.where(cand, hier_ids[None, :], -1).amax(dim=1)
    hierarchy = hier_base
    if size_by_distance:
        hierarchy = torch.where(override >= 0, override, hier_base)
    in_table = (hierarchy >= 0) & (hierarchy < MAX_HIERARCHIES)
    radius = torch.where(
        in_table, spacings[hierarchy.clamp(0, MAX_HIERARCHIES - 1).long()], 0.0)

    view_pos = torch.stack(vp, dim=1)
    rx, ry = splat_pixel_radii(view_pos, radius, projection, width, height)
    rmax = torch.maximum(rx, ry)

    if depth is not None:  # occlusion (kernel.py:259-283)
        u = (ndc[0] * 0.5 + 0.5) * width
        v = (ndc[1] * -0.5 + 0.5) * height
        ui = _trunc_index(u, width)
        vi = _trunc_index(v, height)
        depth_at = depth.reshape(-1)[vi * width + ui]
        mv2 = vp[2] + radius
        moved_z = (_dot4(projection, 2, vp[0], vp[1], mv2, vp[3])
                   / _dot4(projection, 3, vp[0], vp[1], mv2, vp[3]))
        radius_z = ndc[2] - moved_z
        keep = keep & ((moved_z < depth_at)
                       | ((moved_z - depth_at) < radius_z * 3.0))
        if coarse is not None:  # depth-pyramid gate (kernel.py:304-344)
            t = PYRAMID_TILE
            coarse_at = coarse.reshape(-1)[
                (vi // t) * coarse.shape[1] + (ui // t)]
            in_front = (vp[2] + radius) < 0.0
            reject = in_front & (rmax <= float(t - 1)) & (moved_z > coarse_at)
            keep = keep & ~reject

    n_rungs = thresholds.shape[0]
    rung = torch.full_like(hier_base, n_rungs - 1)
    for j in range(n_rungs - 2, -1, -1):  # the first fitting rung wins
        rung = torch.where(rmax < thresholds[j], j, rung)
    rung = torch.where(keep, rung, -1).to(torch.int32)
    return (keep, hierarchy.to(torch.int32), view_pos,
            torch.stack(ndc, dim=1), radius, rmax, rung)


def _trunc_index(u, size: int):
    """``clip(int(u), 0, size - 1)``: truncation toward zero, then the
    clamp. Out-of-range and NaN centres (points near the eye plane) land
    anywhere in range; they fail the NDC test and are never kept."""
    u = torch.nan_to_num(u, nan=0.0).clamp(-1.0, float(size))
    return u.to(torch.int32).clamp(0, size - 1).long()


def _check_cull_args(tensors, dev):
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"cull_classify: {name} is on {t.device}, not {dev}")
        if not t.is_contiguous():
            raise ValueError(f"cull_classify: {name} must be contiguous")
    expect = {"positions": torch.float32, "hier_base": torch.int32,
              "valid": torch.bool, "view": torch.float32,
              "projection": torch.float32, "cam_pos": torch.float32,
              "spacings": torch.float32, "far_distances": torch.float32,
              "thresholds": torch.float32, "depth": torch.float32,
              "coarse": torch.float32}
    for name, t in tensors.items():
        if t.dtype != expect[name]:
            raise ValueError(f"cull_classify: {name} must be {expect[name]}")
    n = tensors["positions"].shape[0]
    if (tensors["positions"].shape != (n, 3)
            or tensors["hier_base"].shape != (n,)
            or tensors["valid"].shape != (n,)):
        raise ValueError("cull_classify: positions (N,3), hier_base and valid (N,)")
    if tensors["spacings"].numel() < MAX_HIERARCHIES or \
            tensors["far_distances"].numel() < MAX_HIERARCHIES:
        raise ValueError("cull_classify: spacings and far_distances need 24 entries")
    if tensors["thresholds"].numel() < 1:
        raise ValueError("cull_classify: at least one ladder threshold")


def cull_classify(positions, hier_base, valid, view, projection, cam_pos,
                  spacings, far_distances, size_by_distance: bool,
                  max_hierarchy: int, thresholds, width: int, height: int,
                  depth=None, coarse=None):
    """K1: :func:`cull_classify_reference`'s function, launched as the
    ``csrc/cull.cu`` kernel on a CUDA tensor (no fallback) and run as that
    plain version on a CPU tensor. Same arguments and outputs."""
    global launches
    dev = positions.device
    args = (positions, hier_base, valid, view, projection, cam_pos, spacings,
            far_distances, size_by_distance, max_hierarchy, thresholds,
            width, height)
    if dev.type == "cpu":
        return cull_classify_reference(*args, depth=depth, coarse=coarse)
    if dev.type != "cuda":
        raise ValueError(f"cull_classify runs on cuda or cpu, not {dev}")
    tensors = dict(positions=positions, hier_base=hier_base, valid=valid,
                   view=view, projection=projection, cam_pos=cam_pos,
                   spacings=spacings, far_distances=far_distances,
                   thresholds=thresholds)
    if depth is not None:
        tensors["depth"] = depth
        if depth.shape != (height, width):
            raise ValueError("cull_classify: depth must be (height, width)")
    if coarse is not None:
        if depth is None:
            raise ValueError("cull_classify: the pyramid gate needs the depth")
        tensors["coarse"] = coarse
    _check_cull_args(tensors, dev)
    from ..ops.runtime import load_kernels

    lib = load_kernels()
    n = positions.shape[0]

    def out(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    keep, hierarchy = out(n, dtype=torch.bool), out(n, dtype=torch.int32)
    view_pos, ndc, radius, rmax = out(n, 4), out(n, 3), out(n), out(n)
    rung = out(n, dtype=torch.int32)
    null = ctypes.c_void_p(None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pc_cull_classify(
            positions.data_ptr(), hier_base.data_ptr(), valid.data_ptr(),
            view.data_ptr(), projection.data_ptr(), cam_pos.data_ptr(),
            spacings.data_ptr(), far_distances.data_ptr(),
            int(bool(size_by_distance)), int(max_hierarchy),
            depth.data_ptr() if depth is not None else null,
            coarse.data_ptr() if coarse is not None else null,
            coarse.shape[1] if coarse is not None else 0,
            thresholds.data_ptr(), thresholds.numel(), width, height,
            keep.data_ptr(), hierarchy.data_ptr(), view_pos.data_ptr(),
            ndc.data_ptr(), radius.data_ptr(), rmax.data_ptr(),
            rung.data_ptr(), n, stream)
    if rc != 0:
        raise RuntimeError(f"pc_cull_classify launch failed: cudaError {rc}")
    launches += 1
    return keep, hierarchy, view_pos, ndc, radius, rmax, rung


def _catch_all(device):
    """A one-rung ladder: every kept point in rung 0."""
    return torch.full((1,), np.inf, dtype=torch.float32, device=device)


def _cull_body(positions, hier_base, valid, view, projection, cam_pos,
              spacings, far_distances, size_by_distance: bool,
              max_hierarchy: int, depth, use_occlusion: bool,
              use_pyramid: bool = False):
    """The reference's ``_cull_body`` (kernel.py:205-346) through K1:
    returns (keep, hierarchy, ndc, view_pos, radius). The pixel size comes
    from ``depth``: only the occlusion tests read it."""
    height = width = 1
    if use_occlusion:
        if depth is None:
            raise ValueError("use_occlusion needs the depth plane")
        height, width = depth.shape
    else:
        depth = None
    coarse = coarse_depth_grid(depth) if use_occlusion and use_pyramid else None
    keep, hierarchy, view_pos, ndc, radius, _, _ = cull_classify(
        positions, hier_base, valid, view, projection, cam_pos, spacings,
        far_distances, size_by_distance, max_hierarchy,
        _catch_all(positions.device), width, height, depth=depth,
        coarse=coarse)
    return keep, hierarchy, ndc, view_pos, radius


def cull_lod_pass(positions, point_hierarchy, valid, view, projection,
                  cam_pos, cell_sizes, spacings, num_hierarchies: int,
                  loaded_cells, far_distances, size_by_distance: bool,
                  max_hierarchy: int, depth=None, use_occlusion: bool = False,
                  use_pyramid: bool = False):
    """The fused one-shot form (kernel.py:353-391): the LOD walk, then the
    camera pass. Returns (visible (N,) bool, hierarchy (N,) i32, ndc)."""
    hier_base = lod_select(positions, point_hierarchy, cell_sizes,
                           num_hierarchies, loaded_cells)
    keep, hierarchy, ndc, _, _ = _cull_body(
        positions, hier_base, valid, view, projection, cam_pos, spacings,
        far_distances, size_by_distance, max_hierarchy, depth,
        use_occlusion, use_pyramid)
    return keep, hierarchy, ndc


def cull_classify_pass(positions, hier_base, valid, view, projection,
                       cam_pos, spacings, far_distances,
                       size_by_distance: bool, max_hierarchy: int,
                       fit_thresholds, width: int, height: int, depth=None,
                       use_occlusion: bool = False, use_pyramid: bool = False):
    """The camera pass with the cumulative ladder counts (kernel.py:
    398-437). Returns (keep, hierarchy, ndc, view_pos, radius, rmax,
    counts_vec): ``counts_vec`` is [kept total, then the kept splats with
    rmax < fit_thresholds[i] for each rung]."""
    depth = depth if use_occlusion else None
    coarse = coarse_depth_grid(depth) if depth is not None and use_pyramid \
        else None
    keep, hierarchy, view_pos, ndc, radius, rmax, _ = cull_classify(
        positions, hier_base, valid, view, projection, cam_pos, spacings,
        far_distances, size_by_distance, max_hierarchy,
        _catch_all(positions.device), width, height, depth=depth,
        coarse=coarse)
    return (keep, hierarchy, ndc, view_pos, radius, rmax,
            fit_counts(keep, rmax, fit_thresholds))


def fit_counts(keep, rmax, fit_thresholds):
    """The "cum" counts vector of kernel.py:432-436: [kept total, then the
    kept splats with rmax < fit_thresholds[i] for each rung], (W+1,) i32
    on the device."""
    fits = keep[None, :] & (rmax[None, :] < fit_thresholds[:, None])
    return torch.cat([keep.sum().reshape(1),
                      fits.sum(dim=1)]).to(torch.int32)


def compact_visible(mask, *arrays):
    """Stable compaction (kernel.py:440-451): the rows where ``mask``
    holds gathered to the front, the tail filled from row 0. Returns
    (count, compacted arrays). A reference function with no caller in the
    frame."""
    n = mask.shape[0]
    count = mask.to(torch.int32).sum()
    idx = torch.zeros(n, dtype=torch.int64, device=mask.device)
    hits = torch.nonzero(mask).reshape(-1)
    idx[: hits.shape[0]] = hits
    return count, tuple(a[idx] for a in arrays)
