"""A frame of the store viewer in plain torch, from the store's files.

The frame's definition, as the viewer draws it with its default settings:

- the loaded cells sort by (bucket, distance to the camera), the bucket
  being ilog2 of the distance; buckets draw near to far, each into the
  same framebuffer of (depth bits << 32 | point id) words, the least word
  winning a pixel; point ids count from 1 over the frame's rows;
- a point draws at the finest loaded hierarchy that contains it (the LOD
  walk from its own cell's hierarchy down while the finer cell is loaded),
  with that hierarchy's splat radius;
- it is kept when its NDC lies in the view box and it passes the
  occlusion tests against the depth the nearer buckets left (the moved
  depth within three splat depths, and the 8 px depth-pyramid gate);
- a kept point splats through the first window of the ladder (1..4, the
  footprint 5, 6, 7, 8, 9, 17, 33, 65 px) whose half-width exceeds its
  pixel radius; in a wider-than-footprint rung, rows past the rung's cap
  (in row order) draw through the footprint window; a fragment inside
  the ellipse, on screen and with depth in [0, 1] writes its voronoi
  depth;
- a covered pixel takes its point's colour, the rest the clear grey.

Each formula keeps the published operation order (4-term dot products
pairwise, divisions by tensors on the data's device) so that the frame
can be compared pixel for pixel. ``dtype`` renders positions in a lower
precision (the control).
"""

from __future__ import annotations

import numpy as np
import torch

from . import hexgrid
from .store import read_cell

MAX_HIERARCHIES = 24
PYRAMID_TILE = 8
FOOTPRINT = 5
LADDER = (1, 2, 3, 4, 5, 6, 7, 8, 9, 17, 33, 65)
CLEAR_GREY = int(0.16 * 255.0 + 0.5)
NO_ID = 2**31 - 1
CLEAR_WORD = (int(np.float32(1.0).view(np.int32)) << 32) | NO_ID
NEVER_WINS = np.iinfo(np.int64).max
CHUNK_FRAGMENTS = 1 << 22


class CellFiles:
    """Cells read from a store's files, kept by id: (pos (3,) f32 centre,
    positions (n, 3) f32, colours (n, 4) u8) in file order, the points
    then every staged overflow group."""

    def __init__(self, store_dir):
        self.store_dir = store_dir
        self._cells: dict = {}

    def get(self, h: int, index: tuple):
        key = (h, *index)
        hit = self._cells.get(key)
        if hit is None:
            path = self.store_dir / f"h_{h}" / "c_{}_{}_{}.bin".format(*index)
            head, points, groups = read_cell(path.read_bytes())
            recs = [points] + [g for _, g in groups if g is not None]
            recs = np.concatenate(recs)
            hit = (np.asarray(head[9:12], np.float32),
                   np.ascontiguousarray(recs["pos"]),
                   np.ascontiguousarray(recs["color"]))
            self._cells[key] = hit
        return hit

    def exists(self, h: int, index: tuple) -> bool:
        return (self.store_dir / f"h_{h}" /
                "c_{}_{}_{}.bin".format(*index)).is_file()


def pad_rows(n: int, minimum: int = 1 << 12) -> int:
    size = minimum
    while size < n:
        size *= 2
    return size


def rung_cap(k: int, n: int) -> int:
    """Rows a wider-than-footprint rung draws through its own window."""
    ch = max((1 << 16) // (k * k), 8)
    ch = 1 << (ch.bit_length() - 1)
    return max(min(ch, 8192, n), 1) * 64


def _dot4(m, j, a0, a1, a2, a3=None):
    last = m[j, 3] if a3 is None else a3 * m[j, 3]
    return (a0 * m[j, 0] + a1 * m[j, 1]) + (a2 * m[j, 2] + last)


def _coarse(depth):
    t = PYRAMID_TILE
    hgt, wid = depth.shape
    hp, wp = -(-hgt // t) * t, -(-wid // t) * t
    if (hp, wp) != (hgt, wid):
        depth = torch.nn.functional.pad(depth, (0, wp - wid, 0, hp - hgt),
                                        value=1.0)
    coarse = depth.reshape(hp // t, t, wp // t, t).amax(dim=(1, 3))
    for ax in (0, 1):
        coarse = torch.maximum(coarse, torch.maximum(
            torch.roll(coarse, 1, ax), torch.roll(coarse, -1, ax)))
    return coarse


def _trunc_index(u, size: int):
    u = torch.nan_to_num(u, nan=0.0).clamp(-1.0, float(size))
    return u.to(torch.int32).clamp(0, size - 1).long()


def render(cells: CellFiles, loaded: list, meta: dict, pose, width: int,
           height: int, device, dtype=torch.float32) -> np.ndarray:
    """(height, width, 3) u8 frame of the ``loaded`` cells ((h, index)
    pairs, in the order the viewer holds them) seen from ``pose``."""
    from .view import projection_matrix

    config = meta["config"]
    levels = max(int(meta["hierarchies"]), 1)
    cam = pose.translation
    rows = []
    for h, index in loaded:
        center, pos, col = cells.get(h, index)
        if len(pos) == 0:
            continue
        distance = float(np.linalg.norm(center - cam))
        bucket = max(int(distance).bit_length() - 1, 0)
        rows.append((bucket, distance, h, pos, col))
    rows.sort(key=lambda r: (r[0], r[1]))

    sizes = np.zeros(MAX_HIERARCHIES, np.float32)
    spacings = np.zeros(MAX_HIERARCHIES, np.float32)
    for h in range(min(int(meta["hierarchies"]), MAX_HIERARCHIES)):
        cs = hexgrid.cell_size(config, h)
        sizes[h] = cs
        radius = hexgrid.sub_cell_size(config, cs) * np.float32(0.5)
        spacings[h] = np.float32(np.hypot(radius, radius * np.float32(0.5))
                                 * np.float32(1.05))
    loaded_keys = _cell_keys(torch.as_tensor(
        np.asarray([[h, *i] for h, i in loaded], np.int64).reshape(-1, 4),
        device=device))
    loaded_keys = torch.sort(loaded_keys).values

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    view = dev(pose.view_matrix()).to(dtype)
    proj = dev(projection_matrix(width / height,
                                 float(config["max_cell_size"]) * 5.0)
               ).to(dtype)
    cam_t = dev(cam).to(dtype)
    sizes_t, spacings_t = dev(sizes), dev(spacings).to(dtype)
    fb = torch.full((height * width,), CLEAR_WORD, dtype=torch.int64,
                    device=device)
    colors = [np.zeros((1, 4), np.uint8)]
    id_base = 1
    i = 0
    while i < len(rows):
        bucket = rows[i][0]
        j = i
        while j < len(rows) and rows[j][0] == bucket:
            j += 1
        group = rows[i:j]
        i = j
        pos = dev(np.concatenate([r[3] for r in group]))
        own = dev(np.concatenate([np.full(len(r[3]), r[2], np.int64)
                                  for r in group]))
        n_real = pos.shape[0]
        n_pad = pad_rows(max(n_real, 1))
        hier = _lod(pos, own, sizes_t, levels, loaded_keys)
        ids = torch.arange(id_base, id_base + n_real, device=device)
        _bucket(fb, pos.to(dtype), hier, ids, view, proj, cam_t, spacings_t,
                n_pad, width, height, dtype)
        colors.append(np.concatenate([r[4] for r in group]))
        id_base += n_real
    table = dev(np.concatenate(colors))
    pid = fb & 0xFFFFFFFF
    hit = pid != NO_ID
    rgb = table[torch.where(hit, pid, 0), :3]
    rgb = torch.where(hit[:, None], rgb, torch.full_like(rgb, CLEAR_GREY))
    return rgb.reshape(height, width, 3).cpu().numpy()


def _cell_keys(rows):
    """One int64 a (h, x, y, z) row: 6 bits of h, 19 of each index."""
    b = 1 << 18
    return ((rows[:, 0] << 57) | ((rows[:, 1] + b) << 38)
            | ((rows[:, 2] + b) << 19) | (rows[:, 3] + b))


def _lod(pos, own, sizes, levels: int, loaded_keys):
    last = levels - 1
    own = torch.clamp_max(own, last)
    result = own.clone()
    alive = torch.ones(pos.shape[0], dtype=torch.bool, device=pos.device)
    for h in range(1, levels):
        idx = torch.floor(pos / sizes[h:h + 1]).to(torch.int64)
        key = _cell_keys(torch.cat([torch.full_like(idx[:, :1], h), idx], 1))
        at = torch.searchsorted(loaded_keys, key).clamp_max(
            max(loaded_keys.numel() - 1, 0))
        found = (loaded_keys[at] == key) if loaded_keys.numel() else \
            torch.zeros_like(key, dtype=torch.bool)
        relevant = own < h
        alive = torch.where(relevant, alive & found, alive)
        result = torch.where(relevant & alive, h, result)
    return result


def _bucket(fb, pos, hier, ids, view, proj, cam, spacings, n_pad: int,
            width: int, height: int, dtype) -> None:
    """One bucket's cull, ranking and raster into ``fb``, in place."""
    x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
    vp = [_dot4(view, j, x, y, z) for j in range(4)]
    clip = [_dot4(proj, j, *vp) for j in range(4)]
    ndc = [clip[j] / clip[3] for j in range(3)]
    keep = ((ndc[0].abs() <= 1.0) & (ndc[1].abs() <= 1.0)
            & ((ndc[2] - 0.5).abs() <= 0.5))
    radius = spacings[hier.clamp(0, MAX_HIERARCHIES - 1)]
    eps = torch.full((), 1e-6, dtype=dtype, device=pos.device)
    w_clip = torch.maximum(-vp[2], eps)
    rx = torch.maximum(radius * proj[0, 0] / w_clip * (0.5 * width), eps)
    ry = torch.maximum(radius * proj[1, 1] / w_clip * (0.5 * height), eps)
    rmax = torch.maximum(rx, ry)

    depth = (fb >> 32).to(torch.int32).view(torch.float32).reshape(
        height, width).to(dtype)
    u = (ndc[0] * 0.5 + 0.5) * width
    v = (ndc[1] * -0.5 + 0.5) * height
    ui, vi = _trunc_index(u, width), _trunc_index(v, height)
    depth_at = depth.reshape(-1)[vi * width + ui]
    mv2 = vp[2] + radius
    moved_z = (_dot4(proj, 2, vp[0], vp[1], mv2, vp[3])
               / _dot4(proj, 3, vp[0], vp[1], mv2, vp[3]))
    radius_z = ndc[2] - moved_z
    keep = keep & ((moved_z < depth_at)
                   | ((moved_z - depth_at) < radius_z * 3.0))
    coarse = _coarse(depth)
    t = PYRAMID_TILE
    coarse_at = coarse.reshape(-1)[(vi // t) * coarse.shape[1] + (ui // t)]
    in_front = (vp[2] + radius) < 0.0
    keep = keep & ~(in_front & (rmax <= float(t - 1)) & (moved_z > coarse_at))

    rung = torch.full_like(hier, len(LADDER) - 1)
    for j in range(len(LADDER) - 2, -1, -1):
        rung = torch.where(rmax < LADDER[j] / 2.0, j, rung)
    view_pos = torch.stack(vp, dim=1)
    ndc_t = torch.stack(ndc, dim=1)
    for j, k in enumerate(LADDER):
        rows = torch.nonzero(keep & (rung == j)).reshape(-1)
        if rows.numel() == 0:
            continue
        if k > FOOTPRINT:
            cap = rung_cap(k, n_pad)
            _raster(fb, view_pos, ndc_t, radius, ids, proj, rows[:cap], k,
                    width, height)
            _raster(fb, view_pos, ndc_t, radius, ids, proj, rows[cap:],
                    FOOTPRINT, width, height)
        else:
            _raster(fb, view_pos, ndc_t, radius, ids, proj, rows, k, width,
                    height)


def _raster(fb, view_pos, ndc, radius, ids, proj, rows, k: int, width: int,
            height: int) -> None:
    """Splat ``rows`` through a k x k window: the least word a pixel."""
    step = max(CHUNK_FRAGMENTS // (k * k), 1)
    for c0 in range(0, rows.numel(), step):
        r = rows[c0:c0 + step]
        vp, nd, rad = view_pos[r], ndc[r], radius[r]
        dev = vp.device
        px = (nd[:, 0] * 0.5 + 0.5) * width
        py = (nd[:, 1] * -0.5 + 0.5) * height
        eps = torch.full((), 1e-6, dtype=vp.dtype, device=dev)
        w_clip = torch.maximum(-vp[:, 2], eps)
        rx = torch.maximum(rad * proj[0, 0] / w_clip * (0.5 * width), eps)
        ry = torch.maximum(rad * proj[1, 1] / w_clip * (0.5 * height), eps)
        if k % 2:
            half = (k - 1) // 2
            bx, by = torch.round(px), torch.round(py)
        else:
            half = k // 2 - 1
            bx, by = torch.floor(px), torch.floor(py)
        offs = torch.arange(-half, k - half, dtype=vp.dtype, device=dev)
        fx = bx[:, None] + offs.repeat(k)[None, :]
        fy = by[:, None] + offs.repeat_interleave(k)[None, :]
        nx = (fx - px[:, None]) / rx[:, None]
        ny = (fy - py[:, None]) / ry[:, None]
        d2 = nx * nx + ny * ny
        moved = vp[:, 2:3] + rad[:, None] * (1.0 - d2)
        depth = (proj[2, 2] * moved + proj[2, 3]) / -moved
        ok = ((d2 <= 1.0) & (fx >= 0) & (fx < width) & (fy >= 0)
              & (fy < height) & (depth >= 0.0) & (depth <= 1.0))
        depth = depth.to(torch.float32)
        depth = torch.where(depth == 0.0, 0.0, depth)
        bits = depth.view(torch.int32).to(torch.int64)
        word = (bits << 32) | (ids[r][:, None] & 0xFFFFFFFF)
        word = torch.where(ok, word, NEVER_WINS)
        pix = (torch.where(ok, fy, 0.0).to(torch.int64) * width
               + torch.where(ok, fx, 0.0).to(torch.int64))
        fb.scatter_reduce_(0, pix.reshape(-1), word.reshape(-1), "amin")
