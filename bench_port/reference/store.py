"""The cell store in plain NumPy and torch: read a cell, build a store.

A store is ``metadata.json`` plus one file a cell, ``h_<h>/c_<x>_<y>_<z>.bin``:
a 48-byte header (hierarchy, index, total, point and overflow counts, cell
size, sub-cell size, centre), the cell's points (16 B: xyz f32, rgba u8)
sorted by slot, then its overflow groups keyed by the next hierarchy's
cell index, a count of 0 marking a group that was flushed downward.

:func:`build_store` writes the store of a cloud converted in one batch
(a group flushes when it holds more than the limit) for the frame cells'
set-up.
"""

from __future__ import annotations

import json
import os
import struct
from pathlib import Path

import numpy as np
import torch

from . import hexgrid

HEADER = struct.Struct("<IiiiIIIfffff")
RECORD = np.dtype([("pos", "<f4", 3), ("color", "u1", 4)])


# --- reading ---------------------------------------------------------------


def read_cell(data: bytes):
    """(header tuple, points (n,) RECORD, [(key, records or None), ...])."""
    head = HEADER.unpack_from(data, 0)
    off = HEADER.size
    n = head[5]
    points = np.frombuffer(data, RECORD, n, off)
    off += n * RECORD.itemsize
    (n_keys,) = struct.unpack_from("<B", data, off)
    off += 1
    groups = []
    for _ in range(n_keys):
        kx, ky, kz, count = struct.unpack_from("<iiiI", data, off)
        off += 16
        if count == 0:
            groups.append(((kx, ky, kz), None))
        else:
            groups.append(((kx, ky, kz),
                           np.frombuffer(data, RECORD, count, off)))
            off += count * RECORD.itemsize
    if off != len(data):
        raise ValueError(f"{len(data) - off} trailing bytes")
    return head, points, groups


# --- shared pieces -----------------------------------------------------------


def record_keys(pos: np.ndarray, colors: np.ndarray) -> np.ndarray:
    """(N, 4) int32 rows identifying a record bit for bit: x, y, z bits and
    the rgba bytes as one word."""
    pos = np.ascontiguousarray(pos, np.float32)
    rgba = np.ascontiguousarray(colors, np.uint8).view(np.int32).reshape(-1)
    return np.concatenate([pos.view(np.int32), rgba[:, None]], axis=1)


def _lexsort(rows: torch.Tensor) -> torch.Tensor:
    """The order that sorts (N, k) ``rows`` lexicographically (stable)."""
    order = torch.arange(rows.shape[0], device=rows.device)
    for c in range(rows.shape[1] - 1, -1, -1):
        order = order[torch.argsort(rows[order, c], stable=True)]
    return order


def _starts(sorted_rows: torch.Tensor) -> torch.Tensor:
    """Whether each row of sorted (N, k) rows begins a run of equal rows."""
    new = torch.ones(sorted_rows.shape[0], dtype=torch.bool,
                     device=sorted_rows.device)
    if sorted_rows.shape[0]:
        new[1:] = (sorted_rows[1:] != sorted_rows[:-1]).any(dim=1)
    return new


def _group_ids(rows: torch.Tensor) -> torch.Tensor:
    """Dense id of each distinct row (lexicographic order)."""
    order = _lexsort(rows)
    gid = torch.empty(rows.shape[0], dtype=torch.int64, device=rows.device)
    gid[order] = torch.cumsum(_starts(rows[order]).to(torch.int64), 0) - 1
    return gid


# --- building ----------------------------------------------------------------


def build_store(out_dir, positions: np.ndarray, colors: np.ndarray,
                config: dict, device, name: str = "bench") -> dict:
    """Write the store of ``positions``/``colors`` converted as one batch:
    at each level every (cell, slot) keeps its nearest point (the earliest
    on a tie); a cell's losers group by child cell; a group of more than
    the overflow limit flushes to the next level, a smaller one stays
    staged. Returns the metadata written."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    limit = int(config["cell_point_overflow_limit"])
    pos_np = np.ascontiguousarray(positions, np.float32)
    col_np = np.ascontiguousarray(colors, np.uint8)
    pos = torch.as_tensor(pos_np, device=device)
    keys = torch.as_tensor(record_keys(pos_np, col_np), device=device)
    keys = torch.cat([keys[:, :3].to(torch.int64),
                      keys[:, 3:].to(torch.int64) & 0xFFFFFFFF], dim=1)
    alive = torch.arange(len(pos_np), device=device)  # input rows, in order
    h = 0
    while alive.numel():
        cs = hexgrid.cell_size(config, h)
        radius = hexgrid.sub_cell_size(config, cs) / np.float32(2.0)
        p = pos[alive]
        cidx = hexgrid.cell_index(p, cs)
        slot, dist = hexgrid.slots_and_dist(p, radius)
        gid = _group_ids(torch.cat([cidx, slot], dim=1))
        # the first of each (cell, slot) by (distance, input row) wins
        perm = torch.argsort(dist.to(torch.float32), stable=True)
        perm = perm[torch.argsort(gid[perm], stable=True)]
        first = torch.ones(perm.numel(), dtype=torch.bool, device=device)
        first[1:] = gid[perm[1:]] != gid[perm[:-1]]
        won = torch.zeros_like(first)
        won[perm[first]] = True
        lost = ~won
        child = hexgrid.cell_index(p[lost], hexgrid.cell_size(config, h + 1))
        group = torch.cat([cidx[lost], child], dim=1)
        ggid = _group_ids(group)
        flush = (torch.bincount(ggid)[ggid] > limit if ggid.numel()
                 else ggid.bool())
        # winners by (cell, slot); losers by (cell, child, record bits)
        w_rows = torch.cat([cidx[won], slot[won]], dim=1)
        w_order = _lexsort(w_rows)
        w_cells = w_rows[w_order, :3]
        w_first = torch.nonzero(_starts(w_cells)).reshape(-1)
        l_order = _lexsort(torch.cat([group.to(torch.int64),
                                      keys[alive[lost]]], dim=1))
        l_group = group[l_order]
        g_first = torch.nonzero(_starts(l_group)).reshape(-1)
        l_flush = flush[l_order]
        _write_level(out_dir, h, config, w_cells[w_first].cpu().numpy(),
                     w_first.cpu().numpy(),
                     alive[won][w_order].cpu().numpy(),
                     l_group[g_first].cpu().numpy(),
                     g_first.cpu().numpy(), l_flush[g_first].cpu().numpy(),
                     l_order.numel(),
                     alive[lost][l_order][~l_flush].cpu().numpy(),
                     pos_np, col_np)
        alive = alive[lost][flush]
        h += 1
    bbox_min = pos_np.min(axis=0) if len(pos_np) else np.zeros(3, np.float32)
    bbox_max = pos_np.max(axis=0) if len(pos_np) else np.zeros(3, np.float32)
    meta = {
        "version": "1.0", "name": name,
        "number_of_points": int(len(pos_np)), "hierarchies": h,
        "bounding_box": {"min": [float(v) for v in bbox_min],
                         "max": [float(v) for v in bbox_max]},
        "config": {
            "cell_point_overflow_limit": limit,
            "sub_grid_dimension": int(config["sub_grid_dimension"]),
            "max_cell_size": float(np.float32(config["max_cell_size"]))},
    }
    (out_dir / "metadata.json").write_text(json.dumps(meta, indent=2))
    return meta


def _write_level(out_dir: Path, h: int, config: dict, cells, cell_first,
                 win_rows, groups, group_first, group_flush, n_lost: int,
                 staged_rows, pos_np, col_np) -> None:
    """One file a cell of level ``h``: its points in slot order, then its
    overflow groups by key, each staged in record-bit order or marked
    flushed. ``win_rows`` are the winners' input rows sorted by (cell,
    slot), ``cells`` each cell once with its first row in ``cell_first``;
    ``groups`` each (cell, child) group once in order, with its first row
    among the ``n_lost`` sorted losers and whether it flushed;
    ``staged_rows`` the input rows of the groups that stayed, in order."""
    size = hexgrid.cell_size(config, h)
    sub = hexgrid.sub_cell_size(config, size)
    level_dir = out_dir / f"h_{h}"
    level_dir.mkdir(exist_ok=True)
    centers = hexgrid.cell_pos(cells, size).tolist()
    cell_bounds = list(cell_first) + [len(win_rows)]
    w_rec = _records(pos_np[win_rows], col_np[win_rows])
    s_rec = _records(pos_np[staged_rows], col_np[staged_rows])
    group_len = np.diff(np.append(group_first, n_lost))
    keys = groups.tolist()
    g = 0
    at = 0  # staged records written so far
    for i, cell in enumerate(cells.tolist()):
        a, b = cell_bounds[i], cell_bounds[i + 1]
        parts = []
        n_ovf = n_groups = 0
        while g < len(keys) and keys[g][:3] == cell:
            if group_flush[g]:
                parts.append(struct.pack("<iiiI", *keys[g][3:], 0))
            else:
                k = int(group_len[g])
                parts.append(struct.pack("<iiiI", *keys[g][3:], k))
                parts.append(s_rec[at:at + k].tobytes())
                at += k
                n_ovf += k
            n_groups += 1
            g += 1
        head = HEADER.pack(h, *cell, b - a + n_ovf, b - a, n_ovf,
                           float(size), float(sub), *centers[i])
        with open(level_dir / "c_{}_{}_{}.bin".format(*cell), "wb") as f:
            f.write(b"".join([head, w_rec[a:b].tobytes(),
                              struct.pack("<B", n_groups)] + parts))


def _records(pos: np.ndarray, col: np.ndarray) -> np.ndarray:
    rec = np.empty(len(pos), RECORD)
    rec["pos"] = pos
    rec["color"] = col
    return rec


def remove_tree(path) -> None:
    """Delete a directory tree the benchmark made."""
    path = Path(path)
    if not path.exists():
        return
    for root, dirs, files in os.walk(path, topdown=False):
        for f in files:
            os.unlink(os.path.join(root, f))
        for d in dirs:
            os.rmdir(os.path.join(root, d))
    os.rmdir(path)
