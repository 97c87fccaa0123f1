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
- :func:`splat_raster` rasters one rung's region: rows ``perm[start +
  i]`` for ``i < count``, ``start`` and ``count`` read from device
  memory. On a CUDA tensor it launches the hand-written kernel
  ``csrc/splat.cu`` (one 64-bit ``atomicMin`` a fragment), or raises; on
  a CPU tensor it runs :func:`splat_raster_reference`, its plain twin,
  which expands the fragments with torch ops in the reference's order
  and ``scatter_reduce_(..., "amin")``s them chunk by chunk.
- :func:`render_bucket_pass` is the chunked arm of the reference's
  bucket megakernel (splat.py:656-789): the cull (K1), the rung ranking,
  one raster per rung and one per overflow rung's capped tail.
- :func:`resolve_framebuffer` and :func:`pack_frame` turn the plane into
  the frame the host reads.

``launches`` counts the raster kernel's launches.
"""

from __future__ import annotations

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


def splat_raster(fb, view_pos, ndc, radius, point_id, perm, start, count,
                 projection, height: int, width: int, k: int, voronoi: bool,
                 chunk_rows: int):
    """K2: :func:`splat_raster_reference`'s function, launched as the
    ``csrc/splat.cu`` kernel on a CUDA tensor (no fallback) and run as the
    plain version on a CPU tensor. ``start`` and ``count`` are one-element
    int32 tensors; on the card the kernel reads them itself."""
    global launches
    dev = fb.device
    if dev.type == "cpu":
        return splat_raster_reference(
            fb, view_pos, ndc, radius, point_id, perm, start, count,
            projection, height, width, k, voronoi, chunk_rows)
    if dev.type != "cuda":
        raise ValueError(f"splat_raster runs on cuda or cpu, not {dev}")
    expect = ((fb, torch.int64, (height * width,)),
              (view_pos, torch.float32, (view_pos.shape[0], 4)),
              (ndc, torch.float32, (view_pos.shape[0], 3)),
              (radius, torch.float32, (view_pos.shape[0],)),
              (point_id, torch.int32, (view_pos.shape[0],)),
              (perm, torch.int32, (perm.shape[0],)),
              (start, torch.int32, (1,)), (count, torch.int32, (1,)),
              (projection, torch.float32, (4, 4)))
    for t, dtype, shape in expect:
        if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(
                f"splat_raster takes {dtype} {shape} contiguous tensors on "
                f"{dev}; got {t.dtype} {tuple(t.shape)} on {t.device}")
    if k < 1:
        raise ValueError(f"window k must be >= 1, got {k}")
    from ..ops.runtime import load_kernels

    lib = load_kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pc_splat_raster(
            fb.data_ptr(), view_pos.data_ptr(), ndc.data_ptr(),
            radius.data_ptr(), point_id.data_ptr(), perm.data_ptr(),
            start.data_ptr(), count.data_ptr(), projection.data_ptr(),
            width, height, k, int(bool(voronoi)), view_pos.shape[0], stream)
    if rc != 0:
        raise RuntimeError(f"pc_splat_raster launch failed: cudaError {rc}")
    launches += 1
    return fb


_caps_cache: dict = {}


def _rung_caps(rungs: tuple, footprint: int, n: int, device):
    """(R,) i32 row caps: rung_chunk_rows(k, n) * RUNG_CAP_CHUNKS for an
    overflow rung, 2^30 (no cap) for the others; uploaded once a key."""
    key = (rungs, footprint, n, RUNG_CAP_CHUNKS, str(device))
    caps = _caps_cache.get(key)
    if caps is None:
        caps = torch.tensor(
            [rung_chunk_rows(k, n) * RUNG_CAP_CHUNKS if k > footprint
             else 1 << 30 for k in rungs], dtype=torch.int32, device=device)
        if len(_caps_cache) > 64:
            _caps_cache.pop(next(iter(_caps_cache)))
        _caps_cache[key] = caps
    return caps


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
    cull reads the running depth (near buckets raster first). Every rung
    rasters its region of the ranking in one launch with device-side
    start and count, footprint rung first; an overflow rung rasters at
    most its cap of rows through its own window, and the rest (its tail)
    through the footprint window, one more launch. Nothing here waits for
    the device. ``cull`` and ``raster`` default to K1 and K2; passing
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
    """The rung rasters of one bucket (splat.py:752-785): each rung's
    region of ``perm`` through its k x k window, footprint rung first,
    an overflow rung (k > footprint) capped at rung_chunk_rows(k, n) *
    RUNG_CAP_CHUNKS rows, and each overflow rung's tail beyond its cap
    through the footprint window. One ``raster`` call (K2 by default)
    each, with device-side start and count."""
    raster = raster or splat_raster
    n = view_pos.shape[0]
    caps = _rung_caps(rungs, footprint, n, fb.device)
    eff = torch.minimum(counts, caps)
    tail_start = offsets + caps
    tail_count = torch.clamp_min(counts - caps, 0)
    fp_i = rungs.index(footprint)
    for j in [fp_i] + [j for j in range(len(rungs)) if j != fp_i]:
        k = rungs[j]
        raster(fb, view_pos, ndc, radius, point_id, perm, offsets[j : j + 1],
               eff[j : j + 1], projection, height, width, k, voronoi,
               rung_chunk_rows(k, n))
    ch_fp = rung_chunk_rows(footprint, n)
    for j, k in enumerate(rungs):
        if k > footprint:  # the capped tail, clipped to the footprint
            raster(fb, view_pos, ndc, radius, point_id, perm,
                   tail_start[j : j + 1], tail_count[j : j + 1], projection,
                   height, width, footprint, voronoi, ch_fp)
    return fb


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
