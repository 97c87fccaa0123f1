"""Device-backed converters: the whole-batch dedup pass on the card.

Counterpart of ``point_cloud_tpu/convert/device.py``.
:class:`DeviceConverter` (reference :115-472) writes stores identical to
the host :class:`~.converter.Converter` (same winner sets, same
counters, same metadata), but replaces the per-cell batch dedup with one
device pass per hierarchy level over the *entire* batch (ops/dedup.py).
Per batch, per hierarchy level:

1. one device pass sorts the batch by (cell, hex slot, distance,
   arrival) and flags the batch-local winner of every slot; one packed
   i32 per row returns to the host, which rebuilds the rows' keys and
   re-decides suspect rows exactly (``collect_dedup``),
2. the sorted output is grouped by cell, so the host splits it with
   boundary diffs — no per-point work,
3. each touched cell merges its batch winners against its stored grid via
   the LSM ``Cell.merge_winners``; displaced incumbents come back out,
4. losers (batch + displaced) regroup by (cell, next-hierarchy cell) in one
   lexsort and run the overflow-limit accounting
   (Cell.add_points_in_overflow); flushed groups become the next level's
   input.

Two-stage dedup (batch argmin, then merge vs incumbents) equals the
reference's sequential insertion outcome: argmin per slot is associative,
and ties keep first-arrival/incumbent in both stages (cell.rs:80).

:class:`DevicePrefetchMixin` (reference :71-112) dispatches the next
batch's level-0 pass while the host merges the current one; the
``--device-native`` converters share it. The reference's environment
reads (``PCT_HOST_CASCADE_THRESHOLD``, ``PCT_RESIDENT``) are plain
constants here, and its ``copy_to_host_async`` hint is dropped: the
port's dispatch starts a pinned readback and records an event itself.
"""

from __future__ import annotations

import numpy as np

from ..core.cell import CellId
from ..core.point import PointBatch
from ..native import staging_sort_native
from ..ops.dedup import collect_dedup, dispatch_dedup, dispatch_dedup_auto
from ..ops.runtime import resolve_device
from ..utils.tracing import stage
from .converter import DEFAULT_CACHE_SIZE, Converter
from .pipeline import group_points_host

# cascade tails below this many rows finish in the host NumPy path
# (the reference's 2^14; its H100 break-even is not measured)
HOST_CASCADE_THRESHOLD = 1 << 14

# device-resident cascade: levels >= 1 upload row indices into the
# level-0 device buffer instead of re-uploading positions
RESIDENT_ENABLED = True


def _row_boundaries(rows: np.ndarray) -> np.ndarray:
    """Start offsets of equal-row runs in a row-sorted (N, K) array."""
    if len(rows) == 0:
        return np.empty(0, np.int64)
    change = np.any(rows[1:] != rows[:-1], axis=1)
    return np.concatenate([[0], np.nonzero(change)[0] + 1])



class DevicePrefetchMixin:
    """Dispatch the next batch's level-0 device pass while the host merges
    the current one. Needs ``self.device`` and ``self.metadata``."""

    def prefetch(self, batch: PointBatch) -> None:
        """Start the next batch's level-0 pass; ``add_points_batch`` picks
        the result up by array identity."""
        handles = getattr(self, "_prefetch_handles", None)
        if handles is None:
            handles = self._prefetch_handles = {}
        if id(batch.positions) in handles:
            return  # already dispatched (the entry keeps the array alive,
            # so its id cannot be recycled while present)
        config = self.metadata.config
        cell_size = config.cell_size(0)
        handle = dispatch_dedup(
            batch.positions, cell_size, config.sub_cell_size(cell_size),
            device=self.device,
        )
        handles[id(batch.positions)] = (batch.positions, handle)
        while len(handles) > 4:  # bound stale entries
            # a pipelined worker pops from this dict concurrently
            # (_take_prefetch): tolerate the key vanishing and the resize
            # RuntimeError
            try:
                handles.pop(next(iter(handles)), None)
            except (RuntimeError, StopIteration):
                break

    def _take_prefetch(self, positions):
        handles = getattr(self, "_prefetch_handles", None)
        if not handles:
            return None
        entry = handles.pop(id(positions), None)
        if entry is not None and entry[0] is positions:
            return entry[1]
        return None


class DeviceConverter(DevicePrefetchMixin, Converter):
    """Drop-in converter whose dedup pass runs on ``device``.

    ``device`` is explicit: ``"cuda"`` without a card raises before any
    store I/O; ``"cpu"`` runs the plain versions (the tests).
    """

    _merge_pool = None  # lazy, closed in close()

    def __init__(self, metadata, working_directory,
                 cache_size: int = DEFAULT_CACHE_SIZE,
                 async_io: bool = True, *, device="cuda"):
        self.device = resolve_device(device)  # raises before any store I/O
        super().__init__(metadata, working_directory, cache_size=cache_size,
                         async_io=async_io)

    def _merge_parallel(self, merge_one, items) -> list:
        """Run per-cell LSM merges concurrently once there are enough
        groups to amortize pool dispatch (cells are disjoint, so
        merge_one calls never share mutable state)."""
        items = list(items)
        if len(items) >= 4:
            if self._merge_pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._merge_pool = ThreadPoolExecutor(8)
            return list(self._merge_pool.map(merge_one, items))
        return [merge_one(item) for item in items]

    def close(self) -> None:
        super().close()
        if self._merge_pool is not None:
            self._merge_pool.shutdown()
            self._merge_pool = None

    def add_points_batch(self, batch: PointBatch) -> None:
        self._update_bounding_box(batch)
        self.metadata.number_of_points += len(batch)
        self._cascade(batch.positions, batch.colors, 0)

    def _add_points_in_hierarchy(self, hierarchy, grouped) -> None:
        # keep the host-grouped entry point working (e.g. for tests)
        batches = [grouped[k] for k in sorted(grouped)]
        merged = PointBatch.concat(batches)
        self._cascade(merged.positions, merged.colors, hierarchy)

    def _cascade(
        self, positions: np.ndarray, colors: np.ndarray, hierarchy: int
    ) -> None:
        config = self.metadata.config
        # device-resident context: ctx["resident"] holds the most recent
        # full-upload device buffer; ``src`` maps each row of the current
        # level to a resident row (>= 0) or marks it foreign (-1). Deeper
        # levels then upload 4 B/row of indices instead of 12 B/row of
        # positions (see ops.dedup.dispatch_dedup_resident).
        ctx: dict = {"resident": None}
        src: np.ndarray | None = None
        while len(positions):
            prefetch_handle = self._take_prefetch(positions)
            if (
                len(positions) < HOST_CASCADE_THRESHOLD
                and prefetch_handle is None
            ):
                # small tail: finish the cascade host-side (same semantics,
                # Cell.add_points shares the dedup + merge code)
                grouped = group_points_host(
                    PointBatch(positions, colors), hierarchy, config
                )
                Converter._add_points_in_hierarchy(self, hierarchy, grouped)
                return
            positions, colors, src = self._cascade_level(
                positions, colors, hierarchy, prefetch_handle, src, ctx
            )
            hierarchy += 1

    def _cascade_level(
        self, positions: np.ndarray, colors: np.ndarray, hierarchy: int,
        prefetch_handle: dict | None = None,
        src: np.ndarray | None = None, ctx: dict | None = None,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
        """Process one hierarchy level; returns the next level's input
        (positions, colors, src-into-resident-buffer or None)."""
        # every cell this level touches is pinned until the level completes:
        # an LRU eviction between get_cell and the merge/staging mutation
        # would write pre-merge bytes and later reload that stale copy over
        # the mutated in-memory object (silent store corruption)
        pinned: list = []
        try:
            return self._cascade_level_pinned(
                positions, colors, hierarchy, prefetch_handle, pinned,
                src, ctx if ctx is not None else {"resident": None},
            )
        finally:
            if pinned:
                self.unpin_cells(pinned)

    def _cascade_level_pinned(
        self, positions, colors, hierarchy, prefetch_handle, pinned,
        src=None, ctx=None,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
        if ctx is None:
            ctx = {"resident": None}
        config = self.metadata.config
        self._create_hierarchy_folder(hierarchy)
        cell_size = config.cell_size(hierarchy)
        sub_cell_size = config.sub_cell_size(cell_size)
        next_cell_size = np.float32(cell_size) / np.float32(2.0)

        # --- 1+2. device pass + host-side rebuild -----------------------
        l_pos_chunks: list[np.ndarray] = []
        l_col_chunks: list[np.ndarray] = []
        l_cell_chunks: list[np.ndarray] = []
        l_next_chunks: list[np.ndarray] = []
        l_src_chunks: list[np.ndarray] = []

        if len(positions):
            handle, ctx["resident"], src, src_arr = dispatch_dedup_auto(
                ctx.get("resident"), src, positions,
                cell_size, sub_cell_size,
                prefetch_handle=prefetch_handle,
                enabled=RESIDENT_ENABLED, device=self.device,
            )
            with stage("device_dedup+rebuild"):
                perm, winner, cell_idx_s, sub_idx_s, dist_s, next_idx_s = (
                    collect_dedup(
                        handle, positions, cell_size, sub_cell_size
                    )
                )
            pos_s = positions[perm]
            col_s = colors[perm]
            src_s = src_arr[perm]

            starts = _row_boundaries(cell_idx_s)
            ends = np.append(starts[1:], len(cell_idx_s))
            # cells come back in hash order; under a (rare) cell-hash
            # collision one cell's rows can split into multiple spans.
            # bulk tolist: per-element int() is a GIL hotspot when the
            # wavefront pipeline runs two cascades concurrently
            run_keys = [tuple(r) for r in cell_idx_s[starts].tolist()]
            seen: dict[tuple[int, int, int], list[tuple[int, int]]] = {}
            for key, s, e in zip(run_keys, starts.tolist(), ends.tolist()):
                seen.setdefault(key, []).append((s, e))

            # --- 3. LSM merge per touched cell --------------------------
            # cells are independent: merges run on a thread pool (NumPy
            # releases the GIL in sort/searchsorted/gather kernels)
            cells = {}
            for key in seen:
                cell_id = CellId(hierarchy, key)
                cells[key] = self.get_cell(cell_id, pin=True)
                pinned.append(cell_id)

            def merge_one(item):
                key, spans = item
                rows = (
                    np.arange(spans[0][0], spans[0][1])
                    if len(spans) == 1
                    else np.concatenate(
                        [np.arange(s, e) for s, e in spans]
                    )
                )
                win = rows[winner[rows]]
                lose = rows[~winner[rows]]
                displaced = cells[key].merge_winners(
                    pos_s[win], col_s[win], sub_idx_s[win], dist_s[win]
                )
                return key, lose, displaced

            with stage("lsm_merge"):
                results = self._merge_parallel(merge_one, seen.items())

                for key, lose, displaced in results:
                    if len(lose):
                        l_pos_chunks.append(pos_s[lose])
                        l_col_chunks.append(col_s[lose])
                        l_cell_chunks.append(cell_idx_s[lose])
                        l_next_chunks.append(next_idx_s[lose])
                        l_src_chunks.append(src_s[lose])
                    if len(displaced):
                        l_pos_chunks.append(displaced.positions)
                        l_col_chunks.append(displaced.colors)
                        l_cell_chunks.append(
                            np.broadcast_to(
                                np.asarray(key, np.int32),
                                (len(displaced), 3),
                            )
                        )
                        l_next_chunks.append(
                            config.cell_index(
                                displaced.positions, next_cell_size
                            )
                        )
                        l_src_chunks.append(
                            np.full(len(displaced), -1, np.int32)
                        )

        return self._stage_and_flush(
            hierarchy, l_pos_chunks, l_col_chunks, l_cell_chunks,
            l_next_chunks, pinned, l_src_chunks,
        )

    def _stage_and_flush(
        self, hierarchy, l_pos_chunks, l_col_chunks, l_cell_chunks,
        l_next_chunks, pinned, l_src_chunks=None,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
        """Step 4: losers -> overflow accounting; returns next level input.

        Input order of the chunks is irrelevant: one global canonical sort
        (cell, next-cell, record bits) fixes both the group processing
        order and each group's staged record order, so any producer —
        single-device cascade or the owner-sharded mesh pass — flushes
        byte-identical overflow state and feeds the next level in the
        same order (the byte-parity invariant, CLAUDE.md #1).

        ``l_src_chunks`` (optional) carries each loser row's index into
        the batch's resident device buffer (-1 = foreign); the returned
        third element maps the next level's rows the same way, enabling
        the device-resident dispatch. Points that stay staged across
        batches lose their src (the buffer dies with the batch): flushed
        groups mark previously-staged rows -1 via the old-then-new concat
        order of Cell.add_points_in_overflow.
        """
        config = self.metadata.config
        if not l_pos_chunks:
            return (
                np.empty((0, 3), np.float32), np.empty((0, 4), np.uint8),
                None,
            )
        track_src = l_src_chunks is not None and len(l_src_chunks) == len(
            l_pos_chunks
        )

        # --- 4. losers -> overflow accounting ---------------------------
        with stage("overflow_staging"):
            l_pos = np.ascontiguousarray(np.concatenate(l_pos_chunks))
            l_col = np.ascontiguousarray(np.concatenate(l_col_chunks))
            l_cell = np.concatenate(l_cell_chunks)
            l_next = np.concatenate(l_next_chunks)
            # one global sort orders groups by (cell, next) AND leaves
            # every group in canonical record order (matching
            # Cell._canonical_overflow_order, so staging is presorted)
            pos_bits = l_pos.view(np.int32)
            color_key = l_col.view(np.uint32)[:, 0]
            # pack the two index triples into int64 keys when in range
            # (the common case) — 6-key lexsort instead of 10
            bias = np.int64(1) << 20
            lo, hi = -(1 << 20), (1 << 20) - 1
            if (
                l_cell.min(initial=0) >= lo and l_cell.max(initial=0) <= hi
                and l_next.min(initial=0) >= lo
                and l_next.max(initial=0) <= hi
            ):
                def pack3(a):
                    a64 = a.astype(np.int64)
                    return (
                        ((a64[:, 0] + bias) << 42)
                        | ((a64[:, 1] + bias) << 21)
                        | (a64[:, 2] + bias)
                    )

                cell_key = pack3(l_cell)
                next_key = pack3(l_next)
                order = staging_sort_native(
                    cell_key, next_key, pos_bits, color_key
                )
                if order is None:
                    order = np.lexsort(
                        (
                            color_key,
                            pos_bits[:, 2], pos_bits[:, 1],
                            pos_bits[:, 0],
                            next_key, cell_key,
                        )
                    )
            else:
                order = np.lexsort(
                    (
                        color_key,
                        pos_bits[:, 2], pos_bits[:, 1], pos_bits[:, 0],
                        l_next[:, 2], l_next[:, 1], l_next[:, 0],
                        l_cell[:, 2], l_cell[:, 1], l_cell[:, 0],
                    )
                )
            l_pos = l_pos[order]
            l_col = l_col[order]
            l_cell = l_cell[order]
            l_next = l_next[order]
            l_src = (
                np.concatenate(l_src_chunks)[order] if track_src else None
            )

            next_chunks_pos: list[np.ndarray] = []
            next_chunks_col: list[np.ndarray] = []
            next_chunks_src: list[np.ndarray] = []
            g_starts = _row_boundaries(
                np.concatenate([l_cell, l_next], axis=1)
            )
            g_ends = np.append(g_starts[1:], len(l_pos))
            # group the (cell, next-cell) runs per cell, then apply the
            # overflow-limit accounting one cell at a time. Bulk-convert
            # boundary rows once (per-element int() in the loop is the
            # GIL hotspot under the wavefront pipeline)
            cell_keys = [tuple(r) for r in l_cell[g_starts].tolist()]
            next_keys = [tuple(r) for r in l_next[g_starts].tolist()]
            starts_list = g_starts.tolist()
            ends_list = g_ends.tolist()
            n_groups = len(starts_list)
            i = 0
            while i < n_groups:
                cell_key = cell_keys[i]
                grouped: dict[tuple[int, int, int], PointBatch] = {}
                spans: dict[tuple[int, int, int], tuple[int, int]] = {}
                while i < n_groups and cell_keys[i] == cell_key:
                    s, e = starts_list[i], ends_list[i]
                    grouped[next_keys[i]] = PointBatch._wrap(
                        l_pos[s:e], l_col[s:e]
                    )
                    spans[next_keys[i]] = (s, e)
                    i += 1
                overflow_id = CellId(hierarchy, cell_key)
                cell = self.get_cell(overflow_id, pin=True)
                pinned.append(overflow_id)
                remaining = cell.add_points_in_overflow(
                    grouped, config, presorted=True
                )
                for key in sorted(remaining):
                    rem = remaining[key]
                    next_chunks_pos.append(rem.positions)
                    next_chunks_col.append(rem.colors)
                    if track_src:
                        # a flushed group is [previously staged rows] ++
                        # [this level's rows] (Cell.add_points_in_overflow
                        # concat order); only the latter have src
                        s, e = spans[key]
                        old = len(rem) - (e - s)
                        next_chunks_src.append(
                            np.concatenate(
                                [np.full(old, -1, np.int32), l_src[s:e]]
                            )
                            if old
                            else l_src[s:e]
                        )

        if next_chunks_pos:
            return (
                np.concatenate(next_chunks_pos),
                np.concatenate(next_chunks_col),
                np.concatenate(next_chunks_src) if track_src else None,
            )
        return (
            np.empty((0, 3), np.float32), np.empty((0, 4), np.uint8), None
        )
