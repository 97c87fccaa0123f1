"""Cells: the hex-dedup point containers and their binary codec.

Copy of the reference's ``core/cell.py``: ``tests/test_torch_host.py``
holds its results equal to the reference's. The port adds
:meth:`Cell.point_columns`, the renderer's read of a cell's points.

Capability parity with the reference's ``Cell`` (point-converter/src/cell.rs):

- each cell keeps at most one point per hexagonal-prism sub-grid slot; a new
  point displaces the stored one only if it is strictly closer to the slot's
  center (cell.rs:70-94),
- displaced/colliding points stage in an ``overflow`` buffer keyed by the
  *next* hierarchy's cell index, flushing downward once a slot exceeds
  ``cell_point_overflow_limit`` and tombstoning so later points pass straight
  through (cell.rs:108-153),
- the on-disk layout is Header(48B) + points + overflow entries
  (cell.rs:155-229, header at cell.rs:280-335).

TPU-first redesign: the reference inserts points one HashMap entry at a
time; here a cell is structure-of-arrays and ``add_points`` is one
vectorized batch-dedup (sort + segmented argmin) followed by an LSM-style
merge against the stored grid: occupied slots live in sorted, immutable
*segments* (packed int64 slot keys + validity bitmaps), batch winners probe
them with ``searchsorted`` (O(batch log stored) — stored points are never
rescanned or re-sorted per batch, unlike a naive concat+sort), displaced
incumbents invalidate in place, and segments compact when they pile up.
Dedup outcome parity: for distinct distances the winner set is identical to
the reference's sequential insertion; on exact distance ties the stored
point wins (matching cell.rs:80 ``new < old``) and among tied new points
the earliest in batch order wins (matching sequential arrival).

Canonical on-disk point order: the reference's order is FxHashMap iteration
order (non-deterministic across runs); readers re-derive sub-grid indices
from positions (cell.rs:189-195), so any order is readable. We write points
sorted by sub-grid index (x, y, z) and overflow entries sorted by key, making
our stores deterministic.
"""

from __future__ import annotations

import itertools
import struct
from dataclasses import dataclass

import numpy as np

from . import hex as hexgrid
from .metadata import MetadataConfig, hierarchy_string
from .point import POINT_DTYPE, PointBatch

EXTENSION = "bin"

_HEADER_STRUCT = struct.Struct("<IiiiIIIfffff")  # 48 bytes, cell.rs:280-298
assert _HEADER_STRUCT.size == 48


@dataclass(frozen=True)
class CellId:
    hierarchy: int
    index: tuple[int, int, int]

    def path(self) -> str:
        """Relative store path ``h_<n>/c_<x>_<y>_<z>.bin`` (cell.rs:21-31)."""
        x, y, z = self.index
        return f"{hierarchy_string(self.hierarchy)}/c_{x}_{y}_{z}.{EXTENSION}"

    def index_string(self) -> str:
        x, y, z = self.index
        return f"c_{x}_{y}_{z}"


def _distance_sq_to_center(
    positions: np.ndarray, sub_indices: np.ndarray, sub_cell_radius: np.float32
) -> np.ndarray:
    """f32 squared distance from each point to its hex slot center.

    Mirrors the reference compare at cell.rs:75-79 (op order
    ``(dx*dx + dy*dy) + dz*dz``).
    """
    centers = hexgrid.offset_to_world(sub_indices, sub_cell_radius)
    d = positions - centers
    # extreme coordinates overflow to inf — IEEE-defined, identical on
    # the jnp and C++ paths (lockstep-tested); silence only the warning
    with np.errstate(over="ignore"):
        return (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]


_KEY_BIAS = 1 << 20  # packed slot keys cover indices in [-2^20, 2^20)
_MAX_SEGMENTS = 8

# Process-global content-generation counter (see Cell.__init__). CPython's
# itertools.count.__next__ is a single C call, so concurrent bumps from the
# loader/converter threads can't hand out duplicates.
_generation_counter = itertools.count(1)


def _pack_slot_keys(sub_indices: np.ndarray) -> np.ndarray:
    """(N, 3) i32 hex slot -> sortable int64 key (21 bits per axis).

    Raises OverflowError outside +/-2^20 hex slots per axis — beyond the
    spatial range where f32 positions can address distinct slots anyway;
    callers fall back to the exact lexsort merge.
    """
    s = sub_indices.astype(np.int64)
    if len(s) and (s.min() < -_KEY_BIAS or s.max() >= _KEY_BIAS):
        raise OverflowError("hex slot index out of packed-key range")
    return (
        ((s[:, 0] + _KEY_BIAS) << 42)
        | ((s[:, 1] + _KEY_BIAS) << 21)
        | (s[:, 2] + _KEY_BIAS)
    )


def _owned(batch: PointBatch) -> PointBatch:
    """Copy slice-view payloads so a staged chunk never pins its source.

    The device cascade stages per-group SLICES of each level's full
    sorted loser arrays (convert/device.py); a buffer holding such a
    view keeps the whole level array alive for as long as the cell sits
    in the 65,536-entry cache — RSS grew by the cumulative loser-array
    footprint over a long conversion. One 16 B/row copy at staging time
    (the rows would be copied at concat time anyway) caps the buffer's
    footprint at its own rows. Values are unchanged: byte parity holds.
    """
    pos, col = batch.positions, batch.colors
    if pos.base is None and col.base is None:
        return batch
    # .copy(), not ascontiguousarray: a slice view IS contiguous, so
    # ascontiguousarray would hand the same pinning view back
    return PointBatch._wrap(
        pos.copy() if pos.base is not None else pos,
        col.copy() if col.base is not None else col,
    )


class _OverflowBuffer:
    """Staged overflow chunks: O(1) append, concat deferred to first read
    (the hot path appends one group per batch; eager concatenation made
    staging O(buffer) per append)."""

    __slots__ = ("chunks", "n")

    def __init__(self, first: PointBatch):
        self.chunks: list[PointBatch] = [_owned(first)]
        self.n = len(first)

    def append(self, batch: PointBatch) -> None:
        self.chunks.append(_owned(batch))
        self.n += len(batch)

    def __len__(self) -> int:
        return self.n

    def to_batch(self) -> PointBatch:
        if len(self.chunks) > 1:
            self.chunks = [PointBatch.concat(self.chunks)]
        return self.chunks[0]

    @property
    def positions(self) -> np.ndarray:
        return self.to_batch().positions

    @property
    def colors(self) -> np.ndarray:
        return self.to_batch().colors


class _Segment:
    """A sorted, immutable run of occupied slots with a validity bitmap."""

    __slots__ = ("keys", "positions", "colors", "sub_indices", "dist", "valid")

    def __init__(self, keys, positions, colors, sub_indices, dist):
        order = np.argsort(keys, kind="stable")
        self.keys = keys[order]
        self.positions = positions[order]
        self.colors = colors[order]
        self.sub_indices = sub_indices[order]
        self.dist = dist[order]
        self.valid = np.ones(len(keys), bool)

    def __len__(self) -> int:
        return len(self.keys)

    def n_valid(self) -> int:
        return int(self.valid.sum())


class Cell:
    def __init__(
        self,
        cell_id: CellId,
        sub_cell_size: float,
        size: float,
        pos: np.ndarray,
    ):
        self.id = cell_id
        self.sub_cell_size = np.float32(sub_cell_size)
        self.size = np.float32(size)
        self.pos = np.asarray(pos, dtype=np.float32).copy()
        # header counters (cell.rs:238-261)
        self.total_number_of_points = 0
        self.number_of_points = 0
        self.number_of_overflow_points = 0
        # content generation: advanced by every mutating insert so cached
        # derivations of this cell's points (the renderer's device-array/
        # LOD/color caches) invalidate when the in-app converter updates
        # a loaded cell in place (converter.rs:553-592 feeds cells the
        # renderer is already drawing). Drawn from a process-global
        # monotonic counter — NOT persisted and NOT starting at 0 — so a
        # cell that is mutated, saved, unloaded, and later re-read from
        # disk can never reproduce a generation an earlier incarnation
        # already handed to a cache (the store format has no generation
        # field, so a reload restarting at 0 would alias pre-mutation
        # cache entries)
        self.generation = next(_generation_counter)
        # LSM points grid: one valid row per hex slot across all segments
        self._segments: list[_Segment] = []
        self._out_of_range = False  # packed-key fallback latch
        # overflow staging: next-hierarchy cell index -> buffer | None
        self.overflow: dict[tuple[int, int, int], _OverflowBuffer | None] = {}

    # --- queries -----------------------------------------------------------

    def _materialize(self):
        """(positions, colors, sub_indices, dist) of all valid grid rows."""
        if not self._segments:
            return (
                np.empty((0, 3), np.float32),
                np.empty((0, 4), np.uint8),
                np.empty((0, 3), np.int32),
                np.empty(0, np.float32),
            )
        pos, col, sub, dist = [], [], [], []
        for seg in self._segments:
            v = seg.valid
            pos.append(seg.positions[v])
            col.append(seg.colors[v])
            sub.append(seg.sub_indices[v])
            dist.append(seg.dist[v])
        return (
            np.concatenate(pos),
            np.concatenate(col),
            np.concatenate(sub),
            np.concatenate(dist),
        )

    @property
    def points(self) -> PointBatch:
        pos, col, _, _ = self._materialize()
        return PointBatch(pos, col)

    @property
    def sub_indices(self) -> np.ndarray:
        return self._materialize()[2]

    def overflow_points(self) -> PointBatch:
        return PointBatch.concat(
            [b for b in self.overflow.values() if b is not None]
        )

    def all_points(self) -> PointBatch:
        return PointBatch.concat([self.points, self.overflow_points()])

    def point_columns(self) -> tuple[list[np.ndarray], list[np.ndarray]]:
        """The positions and colors of :meth:`all_points`, in its order, as
        lists of arrays to concatenate: a segment with no displaced row and
        each overflow buffer are handed over uncopied, and no sub-grid
        index or distance is gathered (the renderer copies the points
        once, into a bucket's rows)."""
        positions, colors = [], []
        for seg in self._segments:
            if seg.valid.all():
                positions.append(seg.positions)
                colors.append(seg.colors)
            else:
                positions.append(seg.positions[seg.valid])
                colors.append(seg.colors[seg.valid])
        for buf in self.overflow.values():
            if buf is not None:
                batch = buf.to_batch()
                positions.append(batch.positions)
                colors.append(batch.colors)
        return positions, colors

    def sub_grid_indices_for(self, positions: np.ndarray) -> np.ndarray:
        """Hex sub-grid index per point (cell.rs:276-278)."""
        return hexgrid.offset_from_world(
            positions, self.sub_cell_size / np.float32(2.0)
        )

    # --- dedup insert (vectorized equivalent of cell.rs:70-106) -------------

    def add_points(self, batch: PointBatch) -> PointBatch:
        """Insert a batch; returns the displaced/colliding points.

        One winner per hex slot, chosen by least squared distance to the
        slot center; the incumbent stored point wins ties. Two stages:
        batch-local dedup (one lexsort over the batch only), then the LSM
        merge against stored segments (:meth:`merge_winners`).
        """
        if len(batch) == 0:
            return PointBatch.empty()

        new_sub = self.sub_grid_indices_for(batch.positions)
        radius = self.sub_cell_size / np.float32(2.0)
        dist = _distance_sq_to_center(batch.positions, new_sub, radius)
        priority = np.arange(len(batch), dtype=np.int64)

        order = np.lexsort(
            (priority, dist, new_sub[:, 2], new_sub[:, 1], new_sub[:, 0])
        )
        sorted_sub = new_sub[order]
        is_first = np.empty(len(order), dtype=bool)
        is_first[0] = True
        is_first[1:] = np.any(sorted_sub[1:] != sorted_sub[:-1], axis=1)
        winner_rows = order[is_first]
        loser_rows = order[~is_first]

        displaced = self.merge_winners(
            batch.positions[winner_rows],
            batch.colors[winner_rows],
            new_sub[winner_rows],
            dist[winner_rows],
        )
        return PointBatch.concat(
            [displaced, PointBatch(batch.positions[np.sort(loser_rows)],
                                   batch.colors[np.sort(loser_rows)])]
        )

    def merge_winners(
        self,
        positions: np.ndarray,
        colors: np.ndarray,
        sub_indices: np.ndarray,
        dist: np.ndarray,
    ) -> PointBatch:
        """LSM merge of pre-deduped batch winners (unique slots) into the
        grid; returns losers (displaced incumbents + batch rows that lost).

        Each winner probes the sorted segments with one ``searchsorted``
        per segment; a strictly closer newcomer invalidates the incumbent
        in place (cell.rs:80: ties keep the stored point).
        """
        n = len(positions)
        if n == 0:
            return PointBatch.empty()
        self.generation = next(_generation_counter)
        if self._out_of_range:
            return self._merge_winners_exact_fallback(
                positions, colors, sub_indices, dist
            )
        try:
            keys = _pack_slot_keys(sub_indices)
        except OverflowError:
            return self._merge_winners_exact_fallback(
                positions, colors, sub_indices, dist
            )

        probed = None
        if self._segments and n >= 4096:
            from ..native import lsm_probe_native

            seg_offsets = np.cumsum(
                [0] + [len(s) for s in self._segments], dtype=np.int64
            )
            probed = lsm_probe_native(
                np.concatenate([s.keys for s in self._segments]),
                np.concatenate([s.valid for s in self._segments]),
                np.concatenate([s.dist for s in self._segments]),
                seg_offsets,
                keys,
            )
        if probed is not None:
            inc_dist, inc_seg, inc_loc = probed
        else:
            inc_dist = np.full(n, np.inf, np.float32)
            inc_seg = np.full(n, -1, np.int32)
            inc_loc = np.zeros(n, np.int64)
            for si, seg in enumerate(self._segments):
                loc = np.searchsorted(seg.keys, keys)
                locc = np.minimum(loc, len(seg) - 1)
                hit = (
                    (loc < len(seg))
                    & (seg.keys[locc] == keys)
                    & seg.valid[locc]
                )
                # invariant: at most one valid row per key across segments
                inc_dist = np.where(hit, seg.dist[locc], inc_dist)
                inc_seg = np.where(hit, si, inc_seg)
                inc_loc = np.where(hit, locc, inc_loc)

        has_inc = inc_seg >= 0
        new_wins = ~has_inc | (dist < inc_dist)  # strict: cell.rs:80

        displaced_chunks = []
        displace = has_inc & new_wins
        if displace.any():
            for si in np.unique(inc_seg[displace]):
                seg = self._segments[si]
                locs = inc_loc[displace & (inc_seg == si)]
                displaced_chunks.append(
                    PointBatch(seg.positions[locs], seg.colors[locs])
                )
                seg.valid[locs] = False

        enter = new_wins
        if enter.any():
            self._segments.append(
                _Segment(
                    keys[enter], np.ascontiguousarray(positions[enter]),
                    np.ascontiguousarray(colors[enter]),
                    np.ascontiguousarray(sub_indices[enter]),
                    np.ascontiguousarray(dist[enter]),
                )
            )
            if len(self._segments) > _MAX_SEGMENTS:
                self._compact()

        newly_occupied = int((~has_inc).sum())
        self.total_number_of_points += newly_occupied
        self.number_of_points += newly_occupied

        lost_batch = PointBatch(
            np.ascontiguousarray(positions[~new_wins]),
            np.ascontiguousarray(colors[~new_wins]),
        )
        return PointBatch.concat(displaced_chunks + [lost_batch])

    def _merge_winners_exact_fallback(self, positions, colors, sub_indices,
                                      dist) -> PointBatch:
        """Exact merge for slot indices beyond the packed-key range:
        compact everything, then one lexsort over stored + new rows."""
        s_pos, s_col, s_sub, s_dist = self._materialize()
        all_pos = np.concatenate([s_pos, positions])
        all_col = np.concatenate([s_col, colors])
        all_sub = np.concatenate([s_sub, sub_indices])
        all_dist = np.concatenate([s_dist, dist])
        priority = np.arange(len(all_pos), dtype=np.int64)
        order = np.lexsort(
            (priority, all_dist, all_sub[:, 2], all_sub[:, 1], all_sub[:, 0])
        )
        sorted_sub = all_sub[order]
        is_first = np.empty(len(order), dtype=bool)
        is_first[0] = True
        is_first[1:] = np.any(sorted_sub[1:] != sorted_sub[:-1], axis=1)
        winner_rows = np.sort(order[is_first])
        loser_rows = np.sort(order[~is_first])

        newly = int(is_first.sum()) - len(s_pos)
        self.total_number_of_points += newly
        self.number_of_points += newly
        seg = _Segment.__new__(_Segment)
        seg.keys = np.arange(len(winner_rows), dtype=np.int64)  # placeholder
        # rebuild via constructor path to keep key order consistent: store
        # with clipped keys is unusable, so keep a single unsorted-keys
        # segment and force future merges through this fallback again
        seg.positions = all_pos[winner_rows]
        seg.colors = all_col[winner_rows]
        seg.sub_indices = all_sub[winner_rows]
        seg.dist = all_dist[winner_rows]
        seg.valid = np.ones(len(winner_rows), bool)
        self._segments = [seg]
        self._out_of_range = True
        return PointBatch(all_pos[loser_rows], all_col[loser_rows])

    def _compact(self) -> None:
        """Merge all segments into one (amortized; keeps probes O(log n))."""
        pos, col, sub, dist = self._materialize()
        keys = _pack_slot_keys(sub)
        self._segments = [_Segment(keys, pos, col, sub, dist)]

    # --- overflow cascade (cell.rs:108-153, exact accounting) ---------------

    @staticmethod
    def _canonical_overflow_order(points: PointBatch) -> PointBatch:
        """Sort a staged overflow group by full record bits.

        The reference stages overflow in arrival order, which depends on
        hash-map iteration (non-deterministic across its own runs). We
        canonicalize each staged group so the host and device pipelines —
        which produce losers in different orders — stage byte-identical
        overflow buffers. Bit patterns (not float values) are the keys so
        -0.0/0.0 and NaNs order deterministically; fully identical records
        are interchangeable. Key order: position x/y/z bits, then the RGBA
        bytes as one little-endian u32 (the same keys the device pipeline
        uses for its presorted global staging order, convert/device.py).
        """
        if len(points) <= 1:
            return points
        pos_bits = points.positions.view(np.int32)
        color_key = np.ascontiguousarray(points.colors).view(np.uint32)[:, 0]
        order = np.lexsort(
            (color_key, pos_bits[:, 2], pos_bits[:, 1], pos_bits[:, 0])
        )
        return points[order]

    def add_points_in_overflow(
        self,
        grouped: dict[tuple[int, int, int], PointBatch],
        config: MetadataConfig,
        presorted: bool = False,
    ) -> dict[tuple[int, int, int], PointBatch]:
        """Stage loser points per next-hierarchy cell; return flushed groups.

        ``presorted=True`` promises each group is already in canonical
        record order (the device pipeline sorts all losers globally once).
        """
        limit = int(config.cell_point_overflow_limit)
        remaining: dict[tuple[int, int, int], PointBatch] = {}
        if grouped:
            self.generation = next(_generation_counter)

        for cell_index, points in grouped.items():
            if not presorted:
                points = self._canonical_overflow_order(points)
            if cell_index not in self.overflow:
                if len(points) <= limit:
                    self.total_number_of_points += len(points)
                    self.number_of_overflow_points += len(points)
                    self.overflow[cell_index] = _OverflowBuffer(points)
                else:
                    remaining[cell_index] = points
                    self.overflow[cell_index] = None  # tombstone
            else:
                slot = self.overflow[cell_index]
                if slot is None:  # tombstoned: pass straight through
                    remaining[cell_index] = points
                else:
                    old_len = len(slot)
                    new_len = len(points)
                    if old_len + new_len < limit:
                        self.total_number_of_points += new_len
                        self.number_of_overflow_points += new_len
                        slot.append(points)
                    else:
                        self.total_number_of_points -= old_len
                        self.number_of_overflow_points -= old_len
                        self.overflow[cell_index] = None
                        remaining[cell_index] = PointBatch.concat(
                            slot.chunks + [points]
                        )

        return remaining

    # --- binary codec (cell.rs:155-229) --------------------------------------

    def to_bytes(self) -> bytes:
        out = [
            _HEADER_STRUCT.pack(
                self.id.hierarchy,
                *self.id.index,
                self.total_number_of_points,
                self.number_of_points,
                self.number_of_overflow_points,
                float(self.size),
                float(self.sub_cell_size),
                *(float(v) for v in self.pos),
            )
        ]
        # canonical order: sort by sub-grid index
        pos, col, sub, _ = self._materialize()
        if len(pos):
            order = np.lexsort((sub[:, 2], sub[:, 1], sub[:, 0]))
            out.append(PointBatch(pos[order], col[order]).to_bytes())

        overflow_keys = sorted(self.overflow.keys())
        out.append(struct.pack("<B", len(overflow_keys)))
        for key in overflow_keys:
            points = self.overflow[key]
            out.append(struct.pack("<iii", *key))
            if points is None or len(points) == 0:
                out.append(struct.pack("<I", 0))  # 0 encodes the tombstone
            else:
                out.append(struct.pack("<I", len(points)))
                out.append(points.to_batch().to_bytes())
        return b"".join(out)

    @staticmethod
    def from_bytes(data: bytes | memoryview) -> "Cell":
        mv = memoryview(data)
        (
            hierarchy,
            ix,
            iy,
            iz,
            total,
            n_points,
            n_overflow,
            size,
            sub_cell_size,
            px,
            py,
            pz,
        ) = _HEADER_STRUCT.unpack_from(mv, 0)
        offset = _HEADER_STRUCT.size

        cell = Cell(
            CellId(hierarchy, (ix, iy, iz)),
            sub_cell_size,
            size,
            np.array([px, py, pz], dtype=np.float32),
        )
        cell.total_number_of_points = total
        cell.number_of_points = n_points
        cell.number_of_overflow_points = n_overflow

        points = PointBatch.from_bytes(mv[offset : offset + n_points * POINT_DTYPE.itemsize])
        offset += n_points * POINT_DTYPE.itemsize
        # re-derive sub-grid indices from positions, like cell.rs:189-195
        if len(points):
            sub = cell.sub_grid_indices_for(points.positions)
            radius = cell.sub_cell_size / np.float32(2.0)
            dist = _distance_sq_to_center(points.positions, sub, radius)
            try:
                keys = _pack_slot_keys(sub)
                cell._segments = [
                    _Segment(keys, points.positions, points.colors, sub, dist)
                ]
            except OverflowError:
                cell._out_of_range = True
                seg = _Segment.__new__(_Segment)
                seg.keys = np.arange(len(points), dtype=np.int64)
                seg.positions = points.positions
                seg.colors = points.colors
                seg.sub_indices = sub
                seg.dist = dist
                seg.valid = np.ones(len(points), bool)
                cell._segments = [seg]

        (overflow_len,) = struct.unpack_from("<B", mv, offset)
        offset += 1
        for _ in range(overflow_len):
            kx, ky, kz, count = struct.unpack_from("<iiiI", mv, offset)
            offset += 16
            if count == 0:
                cell.overflow[(kx, ky, kz)] = None
            else:
                cell.overflow[(kx, ky, kz)] = _OverflowBuffer(
                    PointBatch.from_bytes(
                        mv[offset : offset + count * POINT_DTYPE.itemsize]
                    )
                )
                offset += count * POINT_DTYPE.itemsize
        return cell

    @staticmethod
    def from_path(path) -> "Cell":
        with open(path, "rb") as f:
            return Cell.from_bytes(f.read())

    def write_to_path(self, path) -> None:
        """Atomic write (tmp + rename), matching the native
        AsyncStoreWriter's contract: a crash never leaves a truncated
        cell, and REPLACING (not truncating in place) means a cell file
        that was hardlinked into another store (merge_stores' verbatim
        copy phase) can be updated without corrupting the link source.

        The temp name is unique per process and thread, in the cell's own
        directory (so the rename stays atomic): two writers of one cell
        each publish a complete file, never one half written by the other
        (the reference's fixed ``{path}.tmp`` is shared between them)."""
        import contextlib
        import os
        import threading

        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        try:
            with open(tmp, "wb") as f:
                f.write(self.to_bytes())
            os.replace(tmp, path)
        except BaseException:
            with contextlib.suppress(FileNotFoundError):
                os.unlink(tmp)
            raise
