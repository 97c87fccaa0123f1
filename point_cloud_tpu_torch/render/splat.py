"""Splat raster of the frame (counterpart of render/splat.py).

The framebuffer is one int64 plane of ``depth_bits << 32 | point_id``:
depths are in [0, 1], where f32 bits order like the values, so the
minimum word is the reference's depth test (LessEqual, ties to the
smallest id, splat.py:262-298) in one comparison. The clear word is
``bits(1.0) << 32 | _NO_ID``; the occlusion depth plane is the high word.

- :func:`compact_classes` ranks a bucket's kept points into exclusive
  window-rung regions of one permutation, with device-side counts and
  offsets and no host sync. It, :func:`compact_perm` and the budget arm's
  :func:`budget_table` are K5, :func:`class_rank`: on a CUDA tensor the
  hand-written ``csrc/class_rank.cu`` (a tile histogram, its scan and a
  stable scatter, O(N + C)), on a CPU tensor the plain versions
  (:func:`compact_classes_reference`: one flat ``cumsum`` over the
  (C+1) x N one-hot, a ``gather`` and a ``scatter_``;
  :func:`compact_perm_reference`).
- :func:`splat_raster_segments` is K2, the raster of one bucket: every
  :class:`Segment` of :func:`bucket_segments` (a rung's region of
  ``perm`` through its own window, capped for an overflow rung, or the
  tail beyond that cap through the footprint window; any number of
  segments, any window), the rungs' counts and offsets read from device
  memory. On a CUDA tensor it is one launch of the hand-written kernel
  ``csrc/splat.cu`` (lanes along the window's columns, one 64-bit
  ``atomicMin`` a lit fragment) over the segment table, which
  :func:`_device_table` uploads once a table, or it raises; on a
  CPU tensor it runs :func:`splat_raster_segments_reference`, its plain
  twin: a loop over the segments on :func:`splat_raster_reference`,
  which expands the fragments with torch ops in the reference's order
  and ``scatter_reduce_(..., "amin")``s them chunk by chunk.
  :func:`splat_raster` is the same kernel on one segment.
- :func:`render_bucket_pass` is the reference's bucket megakernel
  (splat.py:656-835): the cull (K1), the rung ranking and one K2 launch
  over the bucket's segments, with chunked rungs or with the budget arm's
  static row budgets (:func:`budget_table`: a rung's rows past its budget
  spill into the footprint raster). :func:`render_frame_pass` is frame
  fusion: every bucket's pass, then the packed resolve, in one call.
- The multi-dispatch arm's rasters (:func:`compact_perm`,
  :func:`raster_compacted`, :func:`rasterize_splats`,
  :func:`rasterize_class_slice`) are each one K2 segment whose cap is the
  budget: rows past it are dropped as the reference's compaction drops
  them.
- The sorted raster: K3 (:func:`emit_fragment_columns`, the hand-written
  ``csrc/fragments.cu``) writes a bucket's fragments as the four sort
  columns, ``sort4`` orders them (:func:`_sort4_frags`), K4
  (:func:`sorted_merge`, ``csrc/sorted_merge.cu``) merges the first
  fragment of each pixel run into the plane. Each has a plain version
  that a CPU tensor runs; :func:`emit_fragments` and
  :func:`sorted_raster_merge_reference` keep the reference's functions
  step by step for the tests.
- :func:`resolve_framebuffer` and :func:`pack_frame` turn the plane into
  the frame the host reads.

``launches``, ``fragment_launches``, ``merge_launches`` and
``rank_launches`` count the calls of K2, K3, K4 and K5.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import kernel
from .kernel import _check_tensors

CLEAR_COLOR = (0.16, 0.16, 0.16)  # wgpu.rs:310-316
CLEAR_COLOR_U8 = tuple(int(c * 255.0 + 0.5) for c in CLEAR_COLOR)
assert len(set(CLEAR_COLOR_U8)) == 1  # resolve_framebuffer fills one level
CLEAR_DEPTH = 1.0
DEFAULT_FOOTPRINT = 5

_NO_ID = np.int32(2**31 - 1)
_CLEAR_WORD = (int(np.float32(CLEAR_DEPTH).view(np.int32)) << 32) | int(_NO_ID)
_NEVER_WINS = np.iinfo(np.int64).max  # a masked fragment's word

launches = 0


class Framebuffer(NamedTuple):
    """(H*W,) int64 words ``depth_bits << 32 | point_id``."""

    packed: torch.Tensor

    @property
    def depth(self) -> torch.Tensor:
        """(H*W,) f32 depth, the high words."""
        return (self.packed >> 32).to(torch.int32).view(torch.float32)

    @property
    def point_id(self) -> torch.Tensor:
        """(H*W,) i32 ids, ``_NO_ID`` where uncovered."""
        return (self.packed & 0xFFFFFFFF).to(torch.int32)


def make_framebuffer(height: int, width: int, device="cpu") -> Framebuffer:
    return Framebuffer(torch.full((height * width,), _CLEAR_WORD,
                                  dtype=torch.int64, device=device))


def compact_classes(rung, n_classes: int):
    """Rank exclusive classes into one permutation (splat.py:97-139).

    ``rung`` is (N,) i32, a class in [0, C) or -1 for none. Returns the
    (2N,) i32 ``perm`` whose region [offsets[c], offsets[c] + counts[c])
    holds class c's rows in row order, and the (C,) i32 ``counts`` and
    ``offsets``, all on the device: nothing here waits for the host. The
    2N length is the reference's pad contract; the slots past the last
    class hold 0 and are never read.

    On a CUDA tensor it is K5 (:func:`class_rank`: a tile histogram, its
    scan and a stable scatter, O(N + C)); on a CPU tensor its plain
    version, :func:`compact_classes_reference`."""
    perm, counts, offsets, _ = class_rank(rung, n_classes)
    return perm, counts, offsets


def compact_classes_reference(rung, n_classes: int):
    """Plain version of :func:`compact_classes`: one inclusive cumsum over
    the class-major (C+1, N) one-hot, read as one flat vector, gives each
    row's slot (:func:`rank_classes`), and one scatter the permutation
    (:func:`class_perm`). O((C+1) N) work."""
    dest, counts, offsets = rank_classes(rung, n_classes)
    return class_perm(dest), counts, offsets


def class_perm(dest):
    """The (2N,) i32 ``perm`` of :func:`rank_classes`' ``dest``: row i at
    slot dest[i]; the rows of no class (dest 2N) land in a dropped slot."""
    n = dest.shape[0]
    perm = torch.zeros(2 * n + 1, dtype=torch.int32, device=dest.device)
    perm.scatter_(0, dest, torch.arange(n, dtype=torch.int32,
                                        device=dest.device))
    return perm[: 2 * n]


def rank_classes(rung, n_classes: int):
    """(dest, counts, offsets) of :func:`compact_classes_reference`:
    ``dest`` (N,) i64 is each row's slot in ``perm`` (offsets[c] + its rank
    in class c, in row order), 2N for a row of no class. At (c, i) the flat
    cumsum counts the rows of classes before c plus class c's rows up to
    i, which is row i's slot + 1; its value at the end of row c is
    offsets[c] + counts[c]."""
    n = rung.shape[0]
    dev = rung.device
    cls = torch.where(rung >= 0, rung, n_classes).long()
    ids = torch.arange(n_classes + 1, dtype=torch.int64, device=dev)
    onehot = (cls[None, :] == ids[:, None]).reshape(-1)
    running = torch.cumsum(onehot, 0, dtype=torch.int32).reshape(
        n_classes + 1, n)
    ends = running[:n_classes, -1]
    offsets = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                         ends[:-1]])
    counts = ends - offsets
    dest = running.gather(0, cls[None, :])[0].long() - 1
    return torch.where(cls < n_classes, dest, 2 * n), counts, offsets


def compact_perm(keep, out_size: int):
    """The index half of the reference's ``compact_rows`` (splat.py:65-95):
    a stable compaction of the ``keep`` rows to ``out_size`` slots. Returns
    the (out_size,) i32 ``perm``, whose first min(count, out_size) entries
    are the kept rows in row order (the other slots hold row 0), and the
    (1,) i32 ``count`` of kept rows, on the device. Kept rows past
    ``out_size`` are dropped. K5 with one class and a cap on a CUDA tensor
    (:func:`class_rank`), its plain version
    :func:`compact_perm_reference` on a CPU tensor."""
    perm, count, _, _ = class_rank(keep, 1, out_size=out_size)
    return perm, count


def compact_perm_reference(keep, out_size: int):
    """Plain version of :func:`compact_perm`: a cumsum of ``keep`` ranks the
    kept rows, a scatter places them."""
    n = keep.shape[0]
    dev = keep.device
    k = keep.to(torch.int32)
    rank = torch.cumsum(k, 0, dtype=torch.int32) - 1
    dest = torch.where(keep, rank, out_size).clamp_max(out_size).long()
    perm = torch.zeros(out_size + 1, dtype=torch.int32, device=dev)
    perm.scatter_(0, dest, torch.arange(n, dtype=torch.int32, device=dev))
    return perm[:out_size], k.sum(dtype=torch.int32).reshape(1)


# --- K5, the class ranking ---------------------------------------------------

rank_launches = 0  # K5
MAX_RANK_ROWS = (1 << 30) - 1  # 2N slots must fit i32


def _check_rank(rung, n_classes: int, out_size, with_dest: bool) -> None:
    """Raise for a call :func:`class_rank` does not take: a ranking of
    classes takes a 1-D i32 ``rung`` and C >= 1; a capped one (``out_size``
    given) one class of a 1-D bool mask and no ``dest``."""
    capped = out_size is not None
    dtype = torch.bool if capped else torch.int32
    if rung.dtype != dtype or rung.dim() != 1 or not rung.is_contiguous():
        raise ValueError(f"class_rank takes a contiguous 1-D {dtype} "
                         f"{'mask' if capped else 'rung'}; got {rung.dtype} "
                         f"{tuple(rung.shape)}")
    if n_classes < 1 or (capped and (n_classes != 1 or with_dest
                                     or out_size < 0)):
        raise ValueError(f"class_rank takes C >= 1, or one class, a cap >= 0 "
                         f"and no dest; got C={n_classes}, out_size="
                         f"{out_size}, with_dest={with_dest}")


def class_rank_reference(rung, n_classes: int, out_size=None,
                         with_dest: bool = False):
    """Plain version of K5: (perm, counts, offsets, dest). Without
    ``out_size``, :func:`compact_classes_reference`'s ranking and, when
    ``with_dest``, :func:`rank_classes`' ``dest`` as i32 (2N for no
    class); with it, :func:`compact_perm_reference` of the mask, offsets
    [0] and no dest."""
    if out_size is None:
        dest, counts, offsets = rank_classes(rung, n_classes)
        return (class_perm(dest), counts, offsets,
                dest.to(torch.int32) if with_dest else None)
    perm, count = compact_perm_reference(rung, out_size)
    return perm, count, torch.zeros(1, dtype=torch.int32,
                                    device=rung.device), None


def class_rank(rung, n_classes: int, out_size=None, with_dest: bool = False):
    """K5: a stable ranking of rows into classes, (perm, counts, offsets,
    dest) on the device with no host sync. ``rung`` (N,) i32 holds a class
    in [0, C) or -1: ``perm`` (2N,) holds class c's rows in row order at
    [offsets[c], offsets[c] + counts[c]), 0 past the last class, and
    ``dest`` (N,) i32, when ``with_dest``, each row's slot (2N for no
    class). With ``out_size``, ``rung`` is a bool mask of one class:
    ``perm`` has ``out_size`` slots, kept rows past them are dropped and
    ``counts`` is the uncapped (1,) count. On a CUDA tensor three launches
    of ``csrc/class_rank.cu`` (no fallback); on a CPU tensor the plain
    version, :func:`class_rank_reference`."""
    global rank_launches
    _check_rank(rung, n_classes, out_size, with_dest)
    dev = rung.device
    if dev.type == "cpu":
        return class_rank_reference(rung, n_classes, out_size, with_dest)
    if dev.type != "cuda":
        raise ValueError(f"class_rank runs on cuda or cpu, not {dev}")
    n = rung.shape[0]
    if not 1 <= n <= MAX_RANK_ROWS:
        raise ValueError(f"class_rank kernel takes 1..2^30-1 rows, got {n}")
    from ..ops.runtime import load_kernels

    lib = load_kernels()
    size = 2 * n if out_size is None else out_size
    need = lib.pc_class_rank_scratch(n, n_classes)
    perm = torch.empty(size, dtype=torch.int32, device=dev)
    counts = torch.empty(n_classes, dtype=torch.int32, device=dev)
    offsets = torch.empty(n_classes, dtype=torch.int32, device=dev)
    dest = (torch.empty(n, dtype=torch.int32, device=dev) if with_dest
            else None)
    scratch = torch.empty(need, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pc_class_rank(
            rung.data_ptr(), int(out_size is not None), n, n_classes,
            perm.data_ptr(), size, counts.data_ptr(), offsets.data_ptr(),
            None if dest is None else dest.data_ptr(), scratch.data_ptr(),
            need, stream)
    if rc != 0:
        raise RuntimeError(f"pc_class_rank launch failed: cudaError {rc}")
    rank_launches += 1
    return perm, counts, offsets, dest


def compact_rows(keep, view_pos, ndc, radius, point_id, out_size: int):
    """The reference's ``compact_rows`` (splat.py:65-95): the kept rows'
    payloads packed into ``out_size`` rows, and the (out_size,) valid mask
    ``arange(out_size) < count``. The rasters below do not call it: K2
    reads rows through :func:`compact_perm`'s ``perm`` itself."""
    perm, count = compact_perm(keep, out_size)
    p = perm.long()
    valid = torch.arange(out_size, dtype=torch.int32,
                         device=keep.device) < count
    return view_pos[p], ndc[p], radius[p], point_id[p], valid


RUNG_CHUNK_FRAGS = 1 << 16
# fragment cap per OVERFLOW rung (k > footprint): rows beyond
# rung_chunk_rows(k, n) * RUNG_CAP_CHUNKS render clipped through the
# footprint window for that frame (splat.py:595-601)
RUNG_CAP_CHUNKS = 64


def rung_chunk_rows(k: int, n: int) -> int:
    """Rows per chunk for a k x k rung (splat.py:604-611): the pow2 that
    keeps a chunk near RUNG_CHUNK_FRAGS fragments, in [8, 8192], at most
    the bucket size."""
    ch = max(RUNG_CHUNK_FRAGS // (k * k), 8)
    ch = 1 << (ch.bit_length() - 1)
    return max(min(ch, 8192, n), 1)


def splat_pixel_radii(view_pos, radius, projection, width: int, height: int):
    """Projected splat half-extents in pixels (splat.py:142-157):
    ``radius * P[0,0] / w * (W / 2)`` with ``w = max(-z_view, 1e-6)``."""
    eps = torch.full((), 1e-6, dtype=torch.float32, device=view_pos.device)
    w_clip = torch.maximum(-view_pos[:, 2], eps)
    rx = radius * projection[0, 0] / w_clip * (0.5 * width)
    ry = radius * projection[1, 1] / w_clip * (0.5 * height)
    return torch.maximum(rx, eps), torch.maximum(ry, eps)


def fragments(view_pos, ndc, radius, point_id, projection, height: int,
               width: int, k: int, voronoi: bool):
    """Expand rows into (rows, k*k) fragments (splat.py:187-259): returns
    (flat pixel index, framebuffer word, valid), the word already
    ``depth_bits << 32 | id`` with -0.0 mapped to +0.0."""
    frag_x, frag_y, depth, valid = fragment_values(
        view_pos, ndc, radius, projection, height, width, k, voronoi)
    fx = torch.where(valid, frag_x, 0.0).to(torch.int64)
    fy = torch.where(valid, frag_y, 0.0).to(torch.int64)
    depth = torch.where(depth == 0.0, 0.0, depth)  # -0.0 -> +0.0
    bits = depth.view(torch.int32).to(torch.int64)
    word = (bits << 32) | (point_id[:, None].to(torch.int64) & 0xFFFFFFFF)
    return fy * width + fx, word, valid


def fragment_values(view_pos, ndc, radius, projection, height: int,
                    width: int, k: int, voronoi: bool):
    """The fragment math of splat.py:197-247 on (rows, k*k): returns the
    fragments' pixel x and y (f32), their depth (f32, -0.0 kept) and
    whether each is valid (inside the circle, on screen, depth in
    [0, 1])."""
    dev = view_pos.device
    px = (ndc[:, 0] * 0.5 + 0.5) * width
    py = (ndc[:, 1] * -0.5 + 0.5) * height
    rx, ry = splat_pixel_radii(view_pos, radius, projection, width, height)
    if k % 2:
        half = (k - 1) // 2
        base_x, base_y = torch.round(px), torch.round(py)  # half to even
    else:
        half = k // 2 - 1
        base_x, base_y = torch.floor(px), torch.floor(py)
    offs = torch.arange(-half, k - half, dtype=torch.float32, device=dev)
    dx = offs.repeat(k)  # (k*k,): f = iy * k + ix
    dy = offs.repeat_interleave(k)
    frag_x = base_x[:, None] + dx[None, :]
    frag_y = base_y[:, None] + dy[None, :]
    nx = (frag_x - px[:, None]) / rx[:, None]
    ny = (frag_y - py[:, None]) / ry[:, None]
    d2 = nx * nx + ny * ny
    inside = d2 <= 1.0
    if voronoi:
        moved_z = view_pos[:, 2:3] + radius[:, None] * (1.0 - d2)
        depth = (projection[2, 2] * moved_z + projection[2, 3]) / -moved_z
    else:
        depth = ndc[:, 2:3].expand(d2.shape)
    on_screen = ((frag_x >= 0) & (frag_x < width)
                 & (frag_y >= 0) & (frag_y < height))
    valid = inside & on_screen & (depth >= 0.0) & (depth <= 1.0)
    return frag_x, frag_y, depth, valid


def splat_raster_reference(fb, view_pos, ndc, radius, point_id, perm, start,
                           count, projection, height: int, width: int, k: int,
                           voronoi: bool, chunk_rows: int):
    """Plain version of K2: raster rows ``perm[start + i]``, ``i <
    count``, through a k x k window into the (H*W,) int64 plane ``fb``,
    in place, ``chunk_rows`` rows at a time like the reference's chunk
    loop (splat.py:614-653). Reads ``start`` and ``count`` to the host."""
    s, c = int(start.reshape(-1)[0]), int(count.reshape(-1)[0])
    for c0 in range(0, c, chunk_rows):
        rows = perm[s + c0 : s + min(c0 + chunk_rows, c)].long()
        idx, word, valid = fragments(
            view_pos[rows], ndc[rows], radius[rows], point_id[rows],
            projection, height, width, k, voronoi)
        word = torch.where(valid, word, _NEVER_WINS)
        fb.scatter_reduce_(0, idx.reshape(-1), word.reshape(-1), "amin")
    return fb


class Segment(NamedTuple):
    """One run of ``perm`` rows drawn through one k x k window: rung
    ``rung``'s region, its first ``cap`` rows (``tail`` False) or the rows
    beyond them (``tail`` True)."""

    k: int
    rung: int
    cap: int
    tail: bool


NO_CAP = 1 << 30  # the cap of a rung that has none


def bucket_segments(rungs: tuple, footprint: int, n: int) -> tuple:
    """The segments of one bucket of ``n`` rows (splat.py:752-785): each
    rung's region through its own window, footprint rung first, an
    overflow rung (k > footprint) capped at rung_chunk_rows(k, n) *
    RUNG_CAP_CHUNKS rows; then each overflow rung's tail beyond its cap
    through the footprint window."""
    fp_i = rungs.index(footprint)
    caps = [rung_chunk_rows(k, n) * RUNG_CAP_CHUNKS if k > footprint
            else NO_CAP for k in rungs]
    order = [fp_i] + [j for j in range(len(rungs)) if j != fp_i]
    segs = [Segment(rungs[j], j, caps[j], False) for j in order]
    segs += [Segment(footprint, j, caps[j], True)
             for j, k in enumerate(rungs) if k > footprint]
    return tuple(segs)


def segment_bounds(seg: Segment, offsets, counts):
    """(start, count) of a segment as one-element i32 tensors on the
    rungs' device; nothing waits for the host."""
    start = offsets[seg.rung : seg.rung + 1]
    count = counts[seg.rung : seg.rung + 1]
    if seg.tail:
        return start + seg.cap, torch.clamp_min(count - seg.cap, 0)
    return start, torch.clamp_max(count, seg.cap)


def splat_raster_segments_reference(fb, view_pos, ndc, radius, point_id, perm,
                                    offsets, counts, projection, height: int,
                                    width: int, segments: tuple,
                                    voronoi: bool, raster=None):
    """Plain version of K2 for a bucket: ``raster`` (default
    :func:`splat_raster_reference`) once a segment, each with its window
    and the reference's chunk size. The plane is a minimum, so the order
    of the segments does not show in it."""
    raster = raster or splat_raster_reference
    n = view_pos.shape[0]
    for seg in segments:
        start, count = segment_bounds(seg, offsets, counts)
        raster(fb, view_pos, ndc, radius, point_id, perm, start, count,
               projection, height, width, seg.k, voronoi,
               rung_chunk_rows(seg.k, n))
    return fb


_TABLE_LIMIT = 256  # cached device tables
_tables: dict = {}  # (kind, rows, device) -> (n, 4) i32 device tensor


def _device_table(kind: str, rows: tuple, device) -> torch.Tensor:
    """The (n, 4) i32 table ``rows`` on ``device``: uploaded through pinned
    memory without waiting on the card, once a table and device (a
    bucket's segments change only with its ladder, size and budgets), then
    cached. The kernels read their tables from it."""
    key = (kind, rows, device)
    table = _tables.get(key)
    if table is None:
        host = torch.tensor(rows, dtype=torch.int32).pin_memory()
        table = host.to(device, non_blocking=True)
        if len(_tables) >= _TABLE_LIMIT:
            _tables.pop(next(iter(_tables)))
        _tables[key] = table
    return table


def window_tiles(k: int) -> int:
    """K2's tiles of a k x k window: slabs of 16 rows by passes of 32
    columns (``csrc/splat.cu`` ``shape_of``)."""
    return -(-k // 16) * -(-k // 32)


def _check_segments(segments: tuple, n_rungs: int, perm_rows: int) -> None:
    """Raise for a table ``pc_splat_raster`` cannot take: no segment, a
    window below 1 or past i32, a negative cap, a rung outside the counts,
    or more units than 64 bits count (a segment draws at most
    ``perm_rows`` rows, a unit at least one row of one tile)."""
    if not segments:
        raise ValueError("splat_raster takes at least one segment")
    for seg in segments:
        if (not 1 <= seg.k < 1 << 31 or not 0 <= seg.cap < 1 << 31
                or not 0 <= seg.rung < n_rungs):
            raise ValueError(f"splat_raster takes windows k >= 1, caps >= 0 "
                             f"and rungs below {n_rungs}; got {seg}")
    if perm_rows * sum(window_tiles(seg.k) for seg in segments) >= 1 << 62:
        raise ValueError("splat_raster: the segments' units pass 64 bits")


def splat_raster_segments(fb, view_pos, ndc, radius, point_id, perm, offsets,
                          counts, projection, height: int, width: int,
                          segments: tuple, voronoi: bool):
    """K2: raster every :class:`Segment` of a bucket into the (H*W,) int64
    plane ``fb``, in place. ``offsets`` and ``counts`` are the rungs' (R,)
    i32 device tensors. On a CUDA tensor one launch of the ``csrc/splat.cu``
    kernel, which reads them itself (no fallback); on a CPU tensor the
    plain version, :func:`splat_raster_segments_reference`."""
    global launches
    dev = fb.device
    if dev.type == "cpu":
        return splat_raster_segments_reference(
            fb, view_pos, ndc, radius, point_id, perm, offsets, counts,
            projection, height, width, segments, voronoi)
    if dev.type != "cuda":
        raise ValueError(f"splat_raster runs on cuda or cpu, not {dev}")
    expect = ((fb, torch.int64, (height * width,)),
              (view_pos, torch.float32, (view_pos.shape[0], 4)),
              (ndc, torch.float32, (view_pos.shape[0], 3)),
              (radius, torch.float32, (view_pos.shape[0],)),
              (point_id, torch.int32, (view_pos.shape[0],)),
              (perm, torch.int32, (perm.shape[0],)),
              (offsets, torch.int32, (counts.shape[0],)),
              (counts, torch.int32, (counts.shape[0],)),
              (projection, torch.float32, (4, 4)))
    _check_tensors("splat_raster", expect, dev)
    _check_segments(segments, counts.shape[0], perm.shape[0])
    from ..ops.runtime import load_kernels

    lib = load_kernels()
    with torch.cuda.device(dev):
        table = _device_table("segments", tuple(
            (seg.k, seg.rung, seg.cap, int(seg.tail)) for seg in segments),
            dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pc_splat_raster(
            fb.data_ptr(), view_pos.data_ptr(), ndc.data_ptr(),
            radius.data_ptr(), point_id.data_ptr(), perm.data_ptr(),
            offsets.data_ptr(), counts.data_ptr(), projection.data_ptr(),
            width, height, int(bool(voronoi)), len(segments),
            table.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"pc_splat_raster launch failed: cudaError {rc}")
    launches += 1
    return fb


def splat_raster(fb, view_pos, ndc, radius, point_id, perm, start, count,
                 projection, height: int, width: int, k: int, voronoi: bool,
                 chunk_rows: int):
    """K2 on one segment: :func:`splat_raster_reference`'s function, as one
    launch of the bucket kernel on a CUDA tensor (no fallback) and as the
    plain version on a CPU tensor. ``start`` and ``count`` are one-element
    int32 tensors; on the card the kernel reads them itself."""
    if fb.device.type == "cpu":
        return splat_raster_reference(
            fb, view_pos, ndc, radius, point_id, perm, start, count,
            projection, height, width, k, voronoi, chunk_rows)
    return splat_raster_segments(
        fb, view_pos, ndc, radius, point_id, perm, start, count, projection,
        height, width, (Segment(k, 0, NO_CAP, False),), voronoi)


def framebuffer_depth(fb: Framebuffer, height: int, width: int):
    """The (H, W) f32 depth plane of a framebuffer (its high words)."""
    return fb.depth.reshape(height, width)


def render_bucket_pass(framebuffer: Framebuffer, positions, hier_base, valid,
                       point_id, view, projection, cam_pos, spacings,
                       far_distances, size_by_distance: bool,
                       max_hierarchy: int, thresholds, *, height: int,
                       width: int, footprint: int = DEFAULT_FOOTPRINT,
                       voronoi: bool = True, use_occlusion: bool = False,
                       use_pyramid: bool = False, overflow_ks: tuple = (),
                       sub_ks: tuple = (), out_size: int = 0,
                       overflow_rows: tuple = (), sub_rows: tuple = (),
                       chunked: bool = True, cull=None, raster=None):
    """One bucket's frame chain, the reference's bucket megakernel
    (splat.py:656-835). Rasters into ``framebuffer`` in place and returns
    (framebuffer, counts_vec): [kept total, then each rung's exclusive
    count in (sub_ks..., footprint, overflow_ks...) order], an (R+1,) i32
    device tensor.

    ``thresholds`` holds the rungs' k/2 as an (R,) f32 device tensor. The
    cull reads the running depth (near buckets raster first). One K2
    launch rasters the bucket. ``chunked`` (the default arm): every
    rung's region of the ranking through its own window, an overflow rung
    at most its cap of rows, and the rest (its tail) through the footprint
    window (:func:`bucket_segments`). Not ``chunked``, the budget arm
    (splat.py:791-835): each sub and overflow rung draws at most its
    static row budget (``sub_rows``, ``overflow_rows``), its rows past the
    budget spill into the footprint raster, which draws the first
    ``out_size`` rows, in row order, of the footprint rung's rows and the
    spill (:func:`budget_table`). Nothing here waits for the device.
    ``cull`` and ``raster`` default to K1 and K2; passing their plain
    versions runs the same chain as a twin on any device."""
    cull = cull or kernel.cull_classify
    fb = framebuffer.packed
    rungs = tuple(sub_ks) + (footprint,) + tuple(overflow_ks)
    if thresholds.shape[0] != len(rungs):
        raise ValueError("one threshold per rung")
    depth = coarse = None
    if use_occlusion:
        depth = framebuffer_depth(framebuffer, height, width)
        if use_pyramid:
            coarse = kernel.coarse_depth_grid(depth)
    keep, _, view_pos, ndc, radius, _, rung = cull(
        positions, hier_base, valid, view, projection, cam_pos, spacings,
        far_distances, size_by_distance, max_hierarchy, thresholds, width,
        height, depth=depth, coarse=coarse)
    if chunked:
        perm, counts, offsets = compact_classes(rung, len(rungs))
        raster_rungs(fb, view_pos, ndc, radius, point_id, perm, counts,
                     offsets, projection, height=height, width=width,
                     rungs=rungs, footprint=footprint, voronoi=voronoi,
                     raster=raster)
    else:
        if (len(sub_rows), len(overflow_rows)) != (len(sub_ks),
                                                   len(overflow_ks)):
            raise ValueError("one row budget per sub and overflow rung")
        budgets = tuple(sub_rows) + (None,) + tuple(overflow_rows)
        segments, perm, all_counts, all_offsets, counts = budget_table(
            rung, rungs, len(sub_ks), budgets, out_size)
        raster_segments(fb, view_pos, ndc, radius, point_id, perm,
                        all_offsets, all_counts, projection, height, width,
                        segments, voronoi, raster)
    counts_vec = torch.cat([keep.sum().reshape(1).to(torch.int32), counts])
    return framebuffer, counts_vec


def budget_table(rung, rungs: tuple, fp_i: int, budgets: tuple,
                 out_size: int):
    """The budget arm's raster table (splat.py:791-835) for a bucket ranked
    into ``rungs`` (``rung``: K1's exclusive rung, -1 where not kept):
    returns (segments, perm, counts, offsets, rung_counts). Rung j (not the
    footprint rung ``fp_i``) draws its first ``budgets[j]`` rows through
    its own window; its rows of rank >= budgets[j] spill into the footprint
    mask, whose rows, in row order, :func:`compact_perm` packs into
    ``out_size`` slots after the rungs' 2N ranking (one more entry of
    ``counts`` and ``offsets``), drawn through the footprint window. The
    spill is a ranking of its own, not K2's capped tail. Both rankings are
    K5 on the card (:func:`class_rank`, the first with each row's slot,
    from which the spill mask is elementwise torch). ``rung_counts``
    are the rungs' (R,) exclusive counts."""
    n = rung.shape[0]
    dev = rung.device
    n_rungs = len(rungs)
    rung_perm, rung_counts, offsets, dest = class_rank(rung, n_rungs,
                                                       with_dest=True)
    cls = torch.where(rung >= 0, rung, n_rungs).long()
    # a row's rank in its rung, and the rung's budget (none: the bucket)
    limit = torch.tensor([n if b is None else b for b in budgets] + [n],
                         dtype=torch.int64, device=dev)
    rank = dest.long() - torch.cat([offsets, offsets[:1]]).long()[cls]
    fp_mask = (cls == fp_i) | ((cls < n_rungs) & (rank >= limit[cls]))
    fp_perm, fp_count = compact_perm(fp_mask, out_size)
    perm = torch.cat([rung_perm, fp_perm])
    counts = torch.cat([rung_counts, fp_count])
    offsets_all = torch.cat([offsets, torch.full(
        (1,), 2 * n, dtype=torch.int32, device=dev)])
    segments = (Segment(rungs[fp_i], n_rungs, out_size, False),) + tuple(
        Segment(k, j, budgets[j], False)
        for j, k in enumerate(rungs) if j != fp_i)
    return segments, perm, counts, offsets_all, rung_counts


def raster_segments(fb, view_pos, ndc, radius, point_id, perm, offsets,
                    counts, projection, height: int, width: int,
                    segments: tuple, voronoi: bool, raster=None):
    """K2 over ``segments`` (one launch on the card), or with ``raster``
    that function once a segment: the plain twin's loop."""
    if raster is None:
        return splat_raster_segments(
            fb, view_pos, ndc, radius, point_id, perm, offsets, counts,
            projection, height, width, segments, voronoi)
    return splat_raster_segments_reference(
        fb, view_pos, ndc, radius, point_id, perm, offsets, counts,
        projection, height, width, segments, voronoi, raster=raster)


def raster_rungs(fb, view_pos, ndc, radius, point_id, perm, counts, offsets,
                 projection, *, height: int, width: int, rungs: tuple,
                 footprint: int, voronoi: bool, raster=None):
    """The rung rasters of one bucket (splat.py:752-785), the segments of
    :func:`bucket_segments`: by default one K2 call for all of them (one
    launch on the card); with ``raster``, that function once a segment
    with device-side start and count, the plain twin's loop."""
    segments = bucket_segments(rungs, footprint, view_pos.shape[0])
    return raster_segments(fb, view_pos, ndc, radius, point_id, perm,
                           offsets, counts, projection, height, width,
                           segments, voronoi, raster)


# --- the multi-dispatch arm's rasters (splat.py:302-369) -------------------
#
# Each is one K2 call over one segment whose cap is the budget: the rows
# past it are dropped, as the reference's mode="drop" compaction drops them.


def raster_compacted(framebuffer: Framebuffer, view_pos, ndc, radius,
                     point_id, keep, projection, height: int, width: int,
                     footprint: int, voronoi: bool, out_size: int):
    """The reference's ``compact_rows`` then ``rasterize_splats``
    (renderer.py:671-684): the first ``out_size`` kept rows, in row order,
    through a ``footprint`` window; the rest are dropped. In place."""
    perm, count = compact_perm(keep, out_size)
    zero = torch.zeros(1, dtype=torch.int32, device=keep.device)
    splat_raster_segments(
        framebuffer.packed, view_pos, ndc, radius, point_id, perm, zero,
        count, projection, height, width,
        (Segment(footprint, 0, out_size, False),), voronoi)
    return framebuffer


def rasterize_splats(framebuffer: Framebuffer, view_pos, ndc, radius,
                     point_id, valid, projection, height: int = 720,
                     width: int = 1280, footprint: int = DEFAULT_FOOTPRINT,
                     voronoi: bool = True):
    """The reference's ``rasterize_splats`` (splat.py:302-319): every
    ``valid`` row through a ``footprint`` window, into ``framebuffer`` in
    place. K2 reads rows through a permutation, so the valid rows are
    compacted first, none dropped."""
    return raster_compacted(framebuffer, view_pos, ndc, radius, point_id,
                            valid, projection, height, width, footprint,
                            voronoi, valid.shape[0])


def rasterize_class_slice(framebuffer: Framebuffer, view_pos, ndc, radius,
                          point_id, perm, start, count, projection,
                          height: int, width: int, footprint: int,
                          voronoi: bool, out_size: int):
    """The reference's ``rasterize_class_slice`` (splat.py:326-365): rows
    ``perm[start + i]`` for i < min(count, out_size) (one class of
    :func:`compact_classes`, ``start`` and ``count`` one-element device
    tensors) through a ``footprint`` window, in place; the class's rows
    past ``out_size`` are dropped."""
    splat_raster_segments(
        framebuffer.packed, view_pos, ndc, radius, point_id, perm,
        start.reshape(1), count.reshape(1), projection, height, width,
        (Segment(footprint, 0, out_size, False),), voronoi)
    return framebuffer


# --- frame fusion (splat.py:847-908) ----------------------------------------


def render_frame_pass(bucket_arrays, view, projection, cam_pos, spacings,
                      far_distances, size_by_distance: bool,
                      max_hierarchy: int, colors, thresholds, *, height: int,
                      width: int, footprint: int, voronoi: bool,
                      use_occlusion: bool, bucket_static: tuple,
                      with_depth: bool, chunked: bool = True,
                      use_pyramid: bool = False):
    """A whole frame, the reference's ``render_frame_pass``: every bucket's
    chain (:func:`render_bucket_pass`, near to far, each cull reading the
    running depth), then the packed resolve. ``bucket_arrays`` holds
    (positions, hier_base, valid, point_id) a bucket, ``bucket_static``
    (out_size, overflow_rows, overflow_ks, sub_rows, sub_ks) a bucket, and
    ``thresholds`` the rungs' k/2. On the card it launches what the
    per-bucket path launches and nothing in it waits for the host; it
    queues no CUDA graph. Returns (the packed frame of :func:`pack_frame`
    with every bucket's counts vector in its tail, the framebuffer)."""
    framebuffer = make_framebuffer(height, width, device=colors.device)
    vecs = []
    for (pos, hier_base, valid, ids), (out_size, orows, oks, srows, sks) \
            in zip(bucket_arrays, bucket_static):
        framebuffer, counts_vec = render_bucket_pass(
            framebuffer, pos, hier_base, valid, ids, view, projection,
            cam_pos, spacings, far_distances, size_by_distance,
            max_hierarchy, thresholds, height=height, width=width,
            footprint=footprint, voronoi=voronoi,
            use_occlusion=use_occlusion, use_pyramid=use_pyramid,
            overflow_ks=oks, sub_ks=sks, out_size=out_size,
            overflow_rows=orows, sub_rows=srows, chunked=chunked)
        vecs.append(counts_vec)
    counts = (torch.cat(vecs) if vecs
              else torch.zeros(1, dtype=torch.int32, device=colors.device))
    return (pack_frame(framebuffer, colors, counts, height, width,
                       with_depth), framebuffer)


def resolve_framebuffer(framebuffer: Framebuffer, colors, height: int,
                        width: int):
    """Framebuffer -> (rgb (H, W, 3) u8, depth (H, W) f32)
    (splat.py:911-929): covered pixels take their point's table color,
    the others the 8-bit clear grey."""
    ids = framebuffer.point_id
    hit = ids != int(_NO_ID)
    rgb = colors[torch.where(hit, ids, 0).long(), :3]
    # one grey level in all three channels: a scalar, not an upload
    rgb = torch.where(hit[:, None], rgb, CLEAR_COLOR_U8[0])
    return (rgb.reshape(height, width, 3),
            framebuffer.depth.reshape(height, width))


# fixed count-slot tail of the packed frame (splat.py:932-937)
PACK_COUNTS = 96


def pack_frame(framebuffer: Framebuffer, colors, counts, height: int,
               width: int, with_depth: bool):
    """Everything the host reads, as one u8 buffer (splat.py:940-966):
    [rgb | PACK_COUNTS i32 counts | optional f32 depth]; ``counts`` is
    padded or truncated to PACK_COUNTS."""
    rgb, depth = resolve_framebuffer(framebuffer, colors, height, width)
    counts = counts.to(torch.int32)[:PACK_COUNTS]
    pad = torch.zeros(max(PACK_COUNTS - counts.shape[0], 0),
                      dtype=torch.int32, device=counts.device)
    parts = [rgb.reshape(-1), torch.cat([counts, pad]).view(torch.uint8)]
    if with_depth:
        parts.append(depth.reshape(-1).view(torch.uint8))
    return torch.cat(parts)


# --- the sorted raster (splat.py:372-386, 505-577) -------------------------
#
# A bucket's classes emit their fragments into one list (K3), ``sort4``
# orders it by (pixel, depth bits, id, arrival), and the first row of each
# pixel run merges into the framebuffer (K4). The reference's in-chunk
# partition and block squeeze (``_partition_chunks``,
# ``compact_winner_rows``) exist to keep the TPU's scatters narrow; K4
# reads each row once and writes only the winners, so the port has no
# counterpart of them.

fragment_launches = 0  # K3
merge_launches = 0  # K4


class FragmentClass(NamedTuple):
    """One class of a bucket's sorted raster: the rows of class ``cls`` of
    a :func:`compact_classes` ranking, ``rows`` slots of them (the
    reference's ``out_size``: the class's rows past it are dropped, slots
    past its count are invalid), each through a k x k window."""

    k: int
    cls: int
    rows: int


def emit_fragments(keep, view_pos, ndc, radius, point_id, projection,
                   height: int, width: int, footprint: int, voronoi: bool,
                   out_size: int):
    """The reference's ``emit_fragments`` (splat.py:372-386): the ``keep``
    rows compacted to ``out_size`` (:func:`compact_rows`) and expanded to
    (out_size * k * k,) fragments, row-major: the flat pixel index
    (``_NO_ID`` where the fragment is invalid), the f32 depth (-0.0 kept)
    and the point id. Plain torch: the tests hold it against the
    reference; the frame path runs :func:`emit_fragment_columns`."""
    rows = compact_rows(keep, view_pos, ndc, radius, point_id, out_size)
    return _row_fragments(*rows, projection, height, width, footprint,
                          voronoi)


def _row_fragments(view_pos, ndc, radius, point_id, row_ok, projection,
                   height: int, width: int, k: int, voronoi: bool):
    """(pixel or ``_NO_ID``, depth, id) of every fragment of the given
    rows, row-major; a row with ``row_ok`` False has no valid fragment."""
    fx, fy, depth, valid = fragment_values(view_pos, ndc, radius, projection,
                                           height, width, k, voronoi)
    valid = valid & row_ok[:, None]
    pix = (torch.where(valid, fy, 0.0).to(torch.int32) * width
           + torch.where(valid, fx, 0.0).to(torch.int32))
    pix = torch.where(valid, pix, int(_NO_ID))
    ids = point_id[:, None].expand(depth.shape)
    return pix.reshape(-1), depth.reshape(-1), ids.reshape(-1)


def fragment_columns(pix, depth, ids):
    """The sort's four columns for a fragment list (splat.py:530-536,
    574): the pixel, the depth's f32 bits with -0.0 mapped to +0.0 and
    ``_NO_ID`` where the pixel is, the id, and the arrival index."""
    depth = torch.where(depth == 0.0, 0.0, depth)
    bits = torch.where(pix == int(_NO_ID), int(_NO_ID),
                       depth.view(torch.int32))
    arrival = torch.arange(pix.shape[0], dtype=torch.int32,
                           device=pix.device)
    return (pix.to(torch.int32).contiguous(), bits.contiguous(),
            ids.to(torch.int32).contiguous(), arrival)


def fragment_total(classes: tuple) -> int:
    """Fragment slots of ``classes``: rows * k * k summed."""
    return sum(c.rows * c.k * c.k for c in classes)


def emit_fragment_columns_reference(view_pos, ndc, radius, point_id, perm,
                                    offsets, counts, projection, height: int,
                                    width: int, classes: tuple,
                                    voronoi: bool, length: int):
    """Plain version of K3: the sort's four (length,) i32 columns for a
    bucket's :class:`FragmentClass` list, class after class, each as
    :func:`emit_fragments` lays out its class (slot i of class c holds
    ``perm[offsets[c.cls] + i]`` while i < counts[c.cls], else row 0 and
    no valid fragment), through :func:`fragment_columns`; the slots past
    the classes' fragments are padding rows (``_NO_ID``, ``_NO_ID``, 0)."""
    dev = view_pos.device
    parts = []
    for c in classes:
        i = torch.arange(c.rows, dtype=torch.int64, device=dev)
        row_ok = i < counts[c.cls].long()
        at = (offsets[c.cls].long() + i).clamp_max(perm.shape[0] - 1)
        rows = torch.where(row_ok, perm[at].long(), 0)
        parts.append(_row_fragments(
            view_pos[rows], ndc[rows], radius[rows], point_id[rows], row_ok,
            projection, height, width, c.k, voronoi))
    total = fragment_total(classes)
    if length < total:
        raise ValueError(f"{total} fragments do not fit {length} slots")
    pad = length - total
    pix = torch.cat([p for p, _, _ in parts] + [torch.full(
        (pad,), int(_NO_ID), dtype=torch.int32, device=dev)])
    depth = torch.cat([d for _, d, _ in parts] + [torch.zeros(
        pad, dtype=torch.float32, device=dev)])
    ids = torch.cat([i for _, _, i in parts] + [torch.zeros(
        pad, dtype=torch.int32, device=dev)])
    return fragment_columns(pix, depth, ids)


def emit_fragment_columns(view_pos, ndc, radius, point_id, perm, offsets,
                          counts, projection, height: int, width: int,
                          classes: tuple, voronoi: bool, length: int):
    """K3: :func:`emit_fragment_columns_reference`'s four columns, as one
    launch of ``csrc/fragments.cu`` on a CUDA tensor (no fallback), with
    K2's fragment arithmetic; on a CPU tensor the plain version.
    ``length`` is the columns' (padded) length."""
    global fragment_launches
    dev = view_pos.device
    if dev.type == "cpu":
        return emit_fragment_columns_reference(
            view_pos, ndc, radius, point_id, perm, offsets, counts,
            projection, height, width, classes, voronoi, length)
    if dev.type != "cuda":
        raise ValueError(f"emit_fragments runs on cuda or cpu, not {dev}")
    n = view_pos.shape[0]
    expect = ((view_pos, torch.float32, (n, 4)),
              (ndc, torch.float32, (n, 3)), (radius, torch.float32, (n,)),
              (point_id, torch.int32, (n,)),
              (perm, torch.int32, (perm.shape[0],)),
              (offsets, torch.int32, (counts.shape[0],)),
              (counts, torch.int32, (counts.shape[0],)),
              (projection, torch.float32, (4, 4)))
    _check_tensors("emit_fragments", expect, dev)
    if not classes:
        raise ValueError("emit_fragments takes at least one class")
    for c in classes:
        if c.k < 1 or c.rows < 1 or not 0 <= c.cls < counts.shape[0]:
            raise ValueError(f"emit_fragments takes windows k >= 1, rows >= 1 "
                             f"and classes below {counts.shape[0]}; got {c}")
    total = fragment_total(classes)
    if length < total or length > 1 << 31:
        raise ValueError(f"{total} fragments in {length} slots (at most 2^31)")
    from ..ops.runtime import load_kernels

    lib = load_kernels()
    cols = torch.empty((4, length), dtype=torch.int32, device=dev)
    starts = np.cumsum([0] + [c.rows * c.k * c.k for c in classes[:-1]])
    with torch.cuda.device(dev):
        table = _device_table("classes", tuple(
            (int(at), c.k, c.cls, c.rows) for at, c in zip(starts, classes)),
            dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pc_emit_fragments(
            *(cols[i].data_ptr() for i in range(4)), view_pos.data_ptr(),
            ndc.data_ptr(), radius.data_ptr(), point_id.data_ptr(),
            perm.data_ptr(), offsets.data_ptr(), counts.data_ptr(),
            projection.data_ptr(), width, height, int(bool(voronoi)),
            len(classes), table.data_ptr(), total, length, stream)
    if rc != 0:
        raise RuntimeError(f"pc_emit_fragments launch failed: cudaError {rc}")
    fragment_launches += 1
    return tuple(cols)


def _sort4_frags(pix, depth_bits, ids, arrival=None):
    """The fragment sort (splat.py:567-575): ``sort4`` of (pixel, depth
    bits, id, arrival), the arrival index made here unless given. On the
    card a ``sort4`` launch (a power-of-two length in [2^10, 2^30], or it
    raises); on the CPU its plain version."""
    from ..ops.sort import sort4

    if arrival is None:
        arrival = torch.arange(pix.shape[0], dtype=torch.int32,
                               device=pix.device)
    return sort4(pix, depth_bits, ids, arrival)


def sorted_merge_reference(fb, pix, depth_bits, ids):
    """Plain version of K4: over sorted columns, row i wins where
    ``pix[i] != _NO_ID``, ``pix[i]`` lies on the plane and it starts its
    pixel's run; each winner's word ``depth_bits << 32 | id`` (both as 32
    unsigned bits) merges into the (H*W,) int64 plane ``fb`` by a minimum
    of the words as unsigned 64-bit values, K4's, in place. (The sign flip
    makes torch's signed minimum an unsigned one; words of depths in
    [0, 1] are non-negative either way.)"""
    first = torch.ones_like(pix, dtype=torch.bool)
    first[1:] = pix[1:] != pix[:-1]
    win = first & (pix != int(_NO_ID)) & (pix >= 0) & (pix < fb.shape[0])
    word = ((depth_bits.to(torch.int64) & 0xFFFFFFFF) << 32) | (
        ids.to(torch.int64) & 0xFFFFFFFF)
    flip = int(np.iinfo(np.int64).min)
    fb.bitwise_xor_(flip)
    fb.scatter_reduce_(0, pix[win].long(), word[win] ^ flip, "amin")
    return fb.bitwise_xor_(flip)


def sorted_merge(fb, pix, depth_bits, ids):
    """K4: :func:`sorted_merge_reference`'s merge, one launch of
    ``csrc/sorted_merge.cu`` on a CUDA tensor (no fallback); on a CPU
    tensor the plain version. One winner falls on a pixel in a merge, so
    the kernel's minimum needs no atomic.

    Precondition: the columns are ``sort4``'s output, ascending by pixel,
    so every ``_NO_ID`` row lies in one tail at the end. The kernel stops
    reading where that tail begins; on columns not so sorted its plane
    may differ from the plain version's."""
    global merge_launches
    dev = fb.device
    if dev.type == "cpu":
        return sorted_merge_reference(fb, pix, depth_bits, ids)
    if dev.type != "cuda":
        raise ValueError(f"sorted_merge runs on cuda or cpu, not {dev}")
    n = pix.shape[0]
    _check_tensors("sorted_merge", (
        (fb, torch.int64, (fb.shape[0],)), (pix, torch.int32, (n,)),
        (depth_bits, torch.int32, (n,)), (ids, torch.int32, (n,))), dev)
    from ..ops.runtime import load_kernels

    lib = load_kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pc_sorted_merge(fb.data_ptr(), fb.shape[0], pix.data_ptr(),
                                 depth_bits.data_ptr(), ids.data_ptr(), n,
                                 stream)
    if rc != 0:
        raise RuntimeError(f"pc_sorted_merge launch failed: cudaError {rc}")
    merge_launches += 1
    return fb


def sorted_raster_merge(framebuffer: Framebuffer, pix, depth, ids):
    """The reference's ``sorted_raster_merge`` (splat.py:505-565): one
    depth-tested merge of a fragment list into ``framebuffer``, in place:
    the columns of :func:`fragment_columns`, :func:`_sort4_frags`, then
    :func:`sorted_merge` (K4)."""
    pix_s, bits_s, ids_s, _ = _sort4_frags(*fragment_columns(pix, depth,
                                                             ids))
    sorted_merge(framebuffer.packed, pix_s, bits_s, ids_s)
    return framebuffer


def sorted_raster_merge_reference(framebuffer: Framebuffer, pix, depth, ids):
    """The reference's ``sorted_raster_merge`` step by step, as plain torch
    on a fresh plane (the tests hold K4's one-pass merge to it): -0.0 to
    +0.0, the depth bits, ``_NO_ID`` for invalid rows, the sort, the first
    row of each pixel run, a stable compaction of the winners (for the
    reference's ``compact_winner_rows``), then a scatter-min of depth and,
    among the pixels' minimum depths, of ids."""
    from ..ops.sort import sort4_reference

    pix_c, bits_c, ids_c, arrival = fragment_columns(pix, depth, ids)
    pix_s, bits_s, ids_s, _ = sort4_reference(pix_c, bits_c, ids_c, arrival)
    first = torch.ones_like(pix_s, dtype=torch.bool)
    first[1:] = pix_s[1:] != pix_s[:-1]
    win = torch.nonzero(first & (pix_s != int(_NO_ID))).reshape(-1)
    target = pix_s[win].long()
    depth_w = bits_s[win].view(torch.float32)
    old_depth = framebuffer.depth
    new_depth = old_depth.scatter_reduce(0, target, depth_w, "amin")
    ids0 = torch.where(new_depth < old_depth, int(_NO_ID),
                       framebuffer.point_id)
    ok = depth_w == new_depth[target]
    new_ids = ids0.scatter_reduce(0, target[ok], ids_s[win][ok], "amin")
    packed = ((new_depth.view(torch.int32).to(torch.int64) << 32)
              | (new_ids.to(torch.int64) & 0xFFFFFFFF))
    return Framebuffer(packed)
