"""Splat raster of the frame (counterpart of render/splat.py).

The framebuffer is one int64 plane of ``depth_bits << 32 | point_id``:
depths are in [0, 1], where f32 bits order like the values, so the
minimum word is the reference's depth test (LessEqual, ties to the
smallest id, splat.py:262-298) in one comparison. The clear word is
``bits(1.0) << 32 | _NO_ID``; the occlusion depth plane is the high word.

- :func:`compact_classes` ranks a bucket's kept points into exclusive
  window-rung regions of one permutation, with device-side counts and
  offsets and no host sync (one flat ``cumsum``, a ``gather`` and a
  ``scatter_``).
- :func:`splat_raster_segments` is K2, the raster of one bucket: every
  :class:`Segment` of :func:`bucket_segments` (a rung's region of
  ``perm`` through its own window, capped for an overflow rung, or the
  tail beyond that cap through the footprint window; at footprint 1 one
  segment over every kept row, :func:`raster_table`), the rungs' counts
  and offsets read from device memory. On a CUDA tensor it is one launch
  of the hand-written kernel ``csrc/splat.cu`` (lanes along the window's
  columns, one 64-bit ``atomicMin`` a lit fragment), or it raises; on a
  CPU tensor it runs :func:`splat_raster_segments_reference`, its plain
  twin: a loop over the segments on :func:`splat_raster_reference`,
  which expands the fragments with torch ops in the reference's order
  and ``scatter_reduce_(..., "amin")``s them chunk by chunk.
  :func:`splat_raster` is the same kernel on one segment.
- :func:`render_bucket_pass` is the chunked arm of the reference's
  bucket megakernel (splat.py:656-789): the cull (K1), the rung ranking
  and the raster of the bucket's segments (K2).
- :func:`resolve_framebuffer` and :func:`pack_frame` turn the plane into
  the frame the host reads.

``launches`` counts the raster kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import kernel

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
    2N length is the reference's pad contract; unfilled slots hold row 0
    and are never read.

    One inclusive cumsum over the class-major (C+1, N) one-hot, read as
    one flat vector, gives everything: at (c, i) it counts the rows of
    classes before c plus class c's rows up to i, which is row i's
    destination + 1; its value at the end of row c is offsets[c] +
    counts[c]. A flat scan keeps the whole card busy. A first cut that
    scanned along the 13 rows (one block a row) and scatter_add_-ed the
    counts (every thread on 13 words) took ~1.5 ms and ~0.7 ms a 2^20-row
    bucket (chip_smoke.py's profiled frame, H100 80GB HBM3, 700 W)."""
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
    dest = torch.where(cls < n_classes, dest, 2 * n)
    perm = torch.zeros(2 * n + 1, dtype=torch.int32, device=dev)
    perm.scatter_(0, dest, torch.arange(n, dtype=torch.int32, device=dev))
    return perm[: 2 * n], counts, offsets


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
    fx = torch.where(valid, frag_x, 0.0).to(torch.int64)
    fy = torch.where(valid, frag_y, 0.0).to(torch.int64)
    depth = torch.where(depth == 0.0, 0.0, depth)  # -0.0 -> +0.0
    bits = depth.view(torch.int32).to(torch.int64)
    word = (bits << 32) | (point_id[:, None].to(torch.int64) & 0xFFFFFFFF)
    return fy * width + fx, word, valid


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
MAX_SEGMENTS = 32  # csrc/splat.cu kMaxSegments
MAX_WINDOW = 128  # csrc/splat.cu kMaxWindow


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


def raster_table(rungs: tuple, footprint: int, n: int, counts, offsets):
    """(segments, counts, offsets) that K2 rasters a bucket of ``n`` rows
    ranked into ``rungs`` by: the rungs' own (R,) counts and offsets with
    :func:`bucket_segments`, or at footprint 1 one segment of k = 1 over
    every kept row (the reference's footprint-1 arm, renderer.py:879-886,
    has no overflow rung: each splat is clipped to its centre pixel), with
    one-element counts and offsets on the device. The ranking keeps the
    ladder's classes either way; they give the frame's counts."""
    if footprint != 1:
        return bucket_segments(rungs, footprint, n), counts, offsets
    # the classes lie one after another from perm[0]
    total = counts.sum(dtype=torch.int32).reshape(1)
    return (Segment(1, 0, NO_CAP, False),), total, torch.zeros_like(total)


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


def _segment_table(segments: tuple):
    """The segments as the four int arrays ``pc_splat_raster`` takes."""
    return tuple((ctypes.c_int * len(segments))(*(int(v) for v in col))
                 for col in zip(*segments))


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
    for t, dtype, shape in expect:
        if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(
                f"splat_raster takes {dtype} {shape} contiguous tensors on "
                f"{dev}; got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not 1 <= len(segments) <= MAX_SEGMENTS:
        raise ValueError(f"1 to {MAX_SEGMENTS} segments a launch, got "
                         f"{len(segments)}")
    for seg in segments:
        if (not 1 <= seg.k <= MAX_WINDOW or seg.cap < 0
                or not 0 <= seg.rung < counts.shape[0]):
            raise ValueError(f"the kernel takes windows of 1 to {MAX_WINDOW}, "
                             f"caps >= 0 and rungs below {counts.shape[0]}; "
                             f"got {seg}")
    from ..ops.runtime import load_kernels

    lib = load_kernels()
    ks, rungs, caps, tails = _segment_table(segments)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pc_splat_raster(
            fb.data_ptr(), view_pos.data_ptr(), ndc.data_ptr(),
            radius.data_ptr(), point_id.data_ptr(), perm.data_ptr(),
            offsets.data_ptr(), counts.data_ptr(), projection.data_ptr(),
            width, height, int(bool(voronoi)), len(segments), ks, rungs,
            caps, tails, stream)
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
                       sub_ks: tuple = (), cull=None, raster=None):
    """One bucket's frame chain: the chunked arm of the reference's bucket
    megakernel (splat.py:656-789). Rasters into ``framebuffer`` in place
    and returns (framebuffer, counts_vec): [kept total, then each rung's
    exclusive count in (sub_ks..., footprint, overflow_ks...) order], an
    (R+1,) i32 device tensor.

    ``thresholds`` holds the rungs' k/2 as an (R,) f32 device tensor. The
    cull reads the running depth (near buckets raster first). One K2
    launch rasters the bucket: every rung's region of the ranking through
    its own window, an overflow rung at most its cap of rows, and the rest
    (its tail) through the footprint window; at footprint 1, every kept row
    through the 1x1 window (:func:`raster_table`). Nothing here waits for the
    device. ``cull`` and ``raster`` default to K1 and K2; passing
    their plain versions runs the same chain as a twin on any device."""
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
    perm, counts, offsets = compact_classes(rung, len(rungs))
    raster_rungs(fb, view_pos, ndc, radius, point_id, perm, counts, offsets,
                 projection, height=height, width=width, rungs=rungs,
                 footprint=footprint, voronoi=voronoi, raster=raster)
    counts_vec = torch.cat([keep.sum().reshape(1).to(torch.int32), counts])
    return framebuffer, counts_vec


def raster_rungs(fb, view_pos, ndc, radius, point_id, perm, counts, offsets,
                 projection, *, height: int, width: int, rungs: tuple,
                 footprint: int, voronoi: bool, raster=None):
    """The rung rasters of one bucket (splat.py:752-785), the segments of
    :func:`raster_table`: by default one K2 call for all of them (one
    launch on the card); with ``raster``, that function once a segment
    with device-side start and count, the plain twin's loop."""
    segments, counts, offsets = raster_table(rungs, footprint,
                                             view_pos.shape[0], counts, offsets)
    if raster is None:
        return splat_raster_segments(
            fb, view_pos, ndc, radius, point_id, perm, offsets, counts,
            projection, height, width, segments, voronoi)
    return splat_raster_segments_reference(
        fb, view_pos, ndc, radius, point_id, perm, offsets, counts,
        projection, height, width, segments, voronoi, raster=raster)


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
