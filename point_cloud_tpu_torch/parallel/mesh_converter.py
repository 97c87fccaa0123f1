"""Mesh-sharded converter: multi-device conversion, merge included
(counterpart of parallel/mesh_converter.py).

Every cascade level runs as ONE owner-sharded pass
(parallel/owner_cascade.py): shard-local dedup (stage A), a slot-owner
``all_to_all``, and an owner-local merge sort (stage B). The host then:

1. classifies every input row from the two packed outputs (4 B/row each):
   clean stage-A losers are global losers; shipped rows take their stage-B
   verdict; suspect/spilled rows form the exact host *sideband*,
2. audits the device verdicts with the exact host keys and resolves the
   sideband against the device winners (:func:`resolve_sideband` — rare
   rows, exact semantics),
3. merges the final winner set into the per-cell LSM grids (thread pool;
   cells are disjoint so merges don't contend), and
4. feeds all losers through the shared canonical staging step
   (DeviceConverter._stage_and_flush), which makes the store bytes
   independent of where each row was processed.

One fault of the reference is not carried over: its loser audit sends a
loser to the sideband only when the loser's true key has a clean device
winner that it beats (``found & beats``), so a loser whose key has no
clean winner at all (``~found``) stayed a loser even where it should
win. Here every such loser joins the sideband too, where the exact
resolution decides it, as the single-device ``audit_device_runs`` does.

Byte-identity to the host oracle is asserted file by file in
tests/test_torch_parallel.py, including with forced single-row bucket
capacity (everything spills -> the sideband carries the whole batch).
"""

from __future__ import annotations

import logging

import numpy as np

from ..convert.device import DeviceConverter
from ..core.cell import CellId
from ..ops.dedup import host_keys_full
from ..utils.tracing import stage
from .mesh import make_mesh
from .owner_cascade import (
    ARR_MASK,
    OwnerShardedPass,
    PERM_MASK,
    SPILL_BIT,
    SUSPECT_BIT,
    WINNER_BIT,
)

log = logging.getLogger(__name__)

MESH_MIN_ROWS = 16_384  # below this the single-device pass is faster


def _key_bytes(cell_idx: np.ndarray, sub_idx: np.ndarray) -> np.ndarray:
    """(n,) void view of the packed 6-int true key — byte-comparable
    rows for the run audit's sort/searchsorted set logic."""
    k = np.ascontiguousarray(
        np.concatenate([cell_idx, sub_idx], axis=1)
    )
    return k.view(f"V{k.dtype.itemsize * k.shape[1]}").reshape(-1)


def resolve_sideband(
    side_arr, side_keys, win_arr, win_keys,
):
    """Exact winner correction for sideband rows (suspects + spills).

    Args:
      side_arr: (S,) global arrival indices of sideband rows.
      side_keys: (cell_idx, sub_idx, dist, next_idx) for those rows.
      win_arr: (W,) arrivals of the device-decided clean winners.
      win_keys: their keys (same tuple layout).

    Returns (keep_mask over win_arr, side_winner_rows, side_loser_rows)
    where the row arrays index into side_arr. Semantics: per true slot,
    the winner is min-(distance, arrival) over {device winner} ∪
    {sideband rows of that slot}; ties keep the earliest arrival
    (reference cell.rs:80 via the host oracle's ordering).
    ``side_winner_rows`` come in slot order, the slots numbered by their
    key bytes.
    """
    S = len(side_arr)
    if S == 0:
        return np.ones(len(win_arr), bool), np.empty(0, np.int64), np.empty(
            0, np.int64
        )
    s_cell, s_sub, s_dist, _ = side_keys
    w_cell, w_sub, w_dist, _ = win_keys
    W = len(win_arr)

    # slot ids over the sideband's keys only; a winner takes part when its
    # key is among them. The reference numbers the slots of the whole
    # union with np.unique(axis=0), a sort of every winner: 199 ms of a
    # 2^18-row level's 545 on the host of an H100 machine (chip_smoke.py
    # phase 8)
    keys, s_id = np.unique(_key_bytes(s_cell, s_sub), return_inverse=True)
    w_kb = _key_bytes(w_cell, w_sub)
    at = np.minimum(np.searchsorted(keys, w_kb), len(keys) - 1)
    t_rows = np.nonzero(keys[at] == w_kb)[0]  # winners with sideband rows

    # competition pool: touched winners (flag 0) + sideband rows (flag 1)
    pool_id = np.concatenate([at[t_rows], s_id.reshape(-1)])
    pool_dist = np.concatenate([w_dist[t_rows], s_dist])
    pool_arr = np.concatenate([win_arr[t_rows], side_arr])
    pool_is_side = np.concatenate(
        [np.zeros(len(t_rows), bool), np.ones(S, bool)]
    )
    # per slot: winner = first by (dist, arrival); stable lexsort
    order = np.lexsort((pool_arr, pool_dist, pool_id))
    id_sorted = pool_id[order]
    first = np.ones(len(order), bool)
    first[1:] = id_sorted[1:] != id_sorted[:-1]

    win_pool_rows = order[first]
    lose_pool_rows = order[~first]

    keep = np.ones(W, bool)
    # touched winners that did NOT come first are demoted
    demoted_pool = lose_pool_rows[~pool_is_side[lose_pool_rows]]
    keep[t_rows[demoted_pool]] = False

    T = len(t_rows)
    side_winner_rows = win_pool_rows[pool_is_side[win_pool_rows]] - T
    side_loser_rows = lose_pool_rows[pool_is_side[lose_pool_rows]] - T
    return keep, side_winner_rows, np.sort(side_loser_rows)


class MeshConverter(DeviceConverter):
    """A :class:`DeviceConverter` whose cascade levels of at least
    ``min_mesh_rows`` rows run the owner-sharded pass over ``mesh`` (by
    default ``make_mesh(n_devices, local=local, device=device)``); smaller
    levels run the single-device pass on the mesh's first device."""

    def __init__(self, metadata, working_directory, n_devices=None,
                 cache_size=None, min_mesh_rows: int | None = None,
                 capacity: int | None = None, local: bool = False,
                 *, mesh=None, device="cuda", **kwargs):
        from ..convert.converter import DEFAULT_CACHE_SIZE

        # the mesh first: a missing card raises before any store I/O
        self.mesh = mesh or make_mesh(n_devices, local=local, device=device)
        super().__init__(
            metadata, working_directory,
            cache_size=cache_size or DEFAULT_CACHE_SIZE,
            device=self.mesh.devices[0],
        )
        self.owner_pass = OwnerShardedPass(self.mesh, capacity=capacity)
        # below this many rows the single-device pass is faster; 0 forces
        # the sharded path (dry runs / tests on tiny shapes)
        self.min_mesh_rows = (
            MESH_MIN_ROWS if min_mesh_rows is None else min_mesh_rows
        )
        self.sideband_spilled = 0
        self.sideband_suspect = 0

    def prefetch(self, batch) -> None:
        """No-op: a prefetched single-device pass would be discarded work
        on every level the mesh takes."""

    def _cascade_level_pinned(
        self, positions, colors, hierarchy, prefetch_handle, pinned,
        src=None, ctx=None,
    ):
        if len(positions) < self.min_mesh_rows:
            return super()._cascade_level_pinned(
                positions, colors, hierarchy, prefetch_handle, pinned,
                src, ctx,
            )

        config = self.metadata.config
        self._create_hierarchy_folder(hierarchy)
        cell_size = config.cell_size(hierarchy)
        sub_cell_size = config.sub_cell_size(cell_size)
        next_cell_size = np.float32(cell_size) / np.float32(2.0)
        n_dev = self.owner_pass.n

        with stage("mesh_owner_pass"):
            out = self.owner_pass(positions, cell_size, sub_cell_size)
        n = out["n"]
        ss = out["shard_size"]
        a = out["a_packed"]
        b = out["b_packed"]

        with stage("mesh_classify"):
            # ---- stage A decode: global arrival + role per input row ----
            perm_local = (a & PERM_MASK).astype(np.int64)
            shard_of = np.repeat(np.arange(n_dev, dtype=np.int64), ss)
            arrival_a = perm_local + shard_of * ss
            valid_a = arrival_a < n
            win_a = (a & WINNER_BIT) != 0
            sus_a = (a & SUSPECT_BIT) != 0
            spl_a = (a & SPILL_BIT) != 0

            losers_a = arrival_a[valid_a & ~win_a & ~sus_a]
            sideband_a = arrival_a[valid_a & (sus_a | (win_a & spl_a))]

            # ---- stage B decode ----------------------------------------
            arr1 = b & ARR_MASK
            valid_b = arr1 != 0
            arrival_b = (arr1 - 1).astype(np.int64)
            win_b = (b & WINNER_BIT) != 0
            sus_b = (b & SUSPECT_BIT) != 0

            b_win = arrival_b[valid_b & win_b & ~sus_b]
            b_lose = arrival_b[valid_b & ~win_b & ~sus_b]
            b_side = arrival_b[valid_b & sus_b]

            side_arr = np.concatenate([sideband_a, b_side])
            self.sideband_spilled += int((valid_a & win_a & spl_a).sum())
            self.sideband_suspect += int(
                (valid_a & sus_a).sum() + len(b_side)
            )
            if len(side_arr) > len(positions) // 8 and len(side_arr) > 4096:
                log.info(
                    "mesh sideband at hierarchy %d: %d of %d rows "
                    "(spilled buckets or hash collisions) resolved on host",
                    hierarchy, len(side_arr), n,
                )

        with stage("mesh_host_keys"):
            win_keys = host_keys_full(
                positions[b_win], cell_size, sub_cell_size
            )

        with stage("mesh_run_audit"):
            # host-key audit of the device verdicts (ops/dedup.py
            # audit_device_runs rationale; round-5 fuzz finding): device
            # quantization can drift on boundary-exact coordinates
            # (backend fma contraction), so a row can be decided in the
            # WRONG slot's contest while looking self-consistent on
            # device. With the exact host keys two invariants restore
            # host-identical winners through the EXISTING sideband:
            # (1) no true key may carry two device winners — extras are
            # demoted into the sideband; (2) no loser may beat its true
            # key's winner under the exact (dist, arrival) order — such
            # losers join the sideband, where resolve_sideband already
            # compares them against the incumbent winner exactly.
            b_losers = np.concatenate([losers_a, b_lose])
            w_kb = _key_bytes(win_keys[0], win_keys[1])
            w_order = np.argsort(w_kb, kind="stable")
            w_kb_s = w_kb[w_order]
            dup_s = np.zeros(len(w_kb_s), bool)
            if len(w_kb_s) > 1:
                eq = w_kb_s[1:] == w_kb_s[:-1]
                dup_s[1:] |= eq
                dup_s[:-1] |= eq
            demote = np.zeros(len(b_win), bool)
            demote[w_order[dup_s]] = True
            beat_rows = np.empty(0, np.int64)
            if len(b_losers) and len(w_kb_s):
                lose_keys = host_keys_full(
                    positions[b_losers], cell_size, sub_cell_size
                )
                l_kb = _key_bytes(lose_keys[0], lose_keys[1])
                ins = np.searchsorted(w_kb_s, l_kb)
                ins_c = np.minimum(ins, len(w_kb_s) - 1)
                found = w_kb_s[ins_c] == l_kb
                wrow = w_order[ins_c]
                w_d = win_keys[2][wrow]
                w_a = b_win[wrow]
                l_d = lose_keys[2]
                l_a = b_losers
                beats = found & (
                    (l_d < w_d) | ((l_d == w_d) & (l_a < w_a))
                )
                # a loser whose true key has no clean winner joins the
                # sideband too: nothing on the device decided its slot
                # (the reference keeps it a loser, mesh_converter.py:
                # 246-262; audit_device_runs catches the same case)
                to_side = beats | ~found
                beat_rows = b_losers[to_side]
                # a row moved into the sideband must leave the loser
                # list — the sideband resolution re-decides its fate
                # (winner, or loser via side_lose_rows), and keeping it
                # in both would duplicate the point
                b_losers = b_losers[~to_side]
            elif len(b_losers):
                # no clean winner at all: every loser's slot is undecided
                beat_rows = b_losers
                b_losers = b_losers[:0]
            if demote.any() or len(beat_rows):
                self.sideband_suspect += int(demote.sum()) + len(beat_rows)
                side_arr = np.concatenate(
                    [side_arr, b_win[demote], beat_rows]
                )
                b_win = b_win[~demote]
                win_keys = tuple(k[~demote] for k in win_keys)

            side_keys = (
                host_keys_full(positions[side_arr], cell_size, sub_cell_size)
                if len(side_arr)
                else None
            )

        # ---- sideband resolution (exact, host) --------------------------
        if len(side_arr):
            with stage("mesh_sideband"):
                keep, side_win_rows, side_lose_rows = resolve_sideband(
                    side_arr, side_keys, b_win, win_keys
                )
            final_w_arr = np.concatenate([b_win[keep], side_arr[side_win_rows]])
            w_cell = np.concatenate(
                [win_keys[0][keep], side_keys[0][side_win_rows]]
            )
            w_sub = np.concatenate(
                [win_keys[1][keep], side_keys[1][side_win_rows]]
            )
            w_dist = np.concatenate(
                [win_keys[2][keep], side_keys[2][side_win_rows]]
            )
            extra_losers = [
                b_win[~keep],  # demoted device winners
                side_arr[side_lose_rows],
            ]
        else:
            final_w_arr = b_win
            w_cell, w_sub, w_dist, _ = win_keys
            extra_losers = []

        # ---- per-cell LSM merge (disjoint cells; thread pool) ------------
        l_pos_chunks: list[np.ndarray] = []
        l_col_chunks: list[np.ndarray] = []
        l_cell_chunks: list[np.ndarray] = []
        l_next_chunks: list[np.ndarray] = []

        if len(final_w_arr):
            order = np.lexsort((w_sub[:, 2], w_sub[:, 1], w_sub[:, 0],
                                w_cell[:, 2], w_cell[:, 1], w_cell[:, 0]))
            final_w_arr = final_w_arr[order]
            w_cell = w_cell[order]
            w_sub = w_sub[order]
            w_dist = w_dist[order]
            w_pos = positions[final_w_arr]
            w_col = colors[final_w_arr]

            change = np.any(w_cell[1:] != w_cell[:-1], axis=1)
            starts = np.concatenate([[0], np.nonzero(change)[0] + 1])
            ends = np.append(starts[1:], len(w_cell))
            keys = [tuple(r) for r in w_cell[starts].tolist()]

            cells = {}
            for key in keys:
                cell_id = CellId(hierarchy, key)
                cells[key] = self.get_cell(cell_id, pin=True)
                pinned.append(cell_id)

            def merge_one(item):
                key, s, e = item
                displaced = cells[key].merge_winners(
                    w_pos[s:e], w_col[s:e], w_sub[s:e], w_dist[s:e]
                )
                return key, displaced

            with stage("lsm_merge"):
                results = self._merge_parallel(
                    merge_one, zip(keys, starts.tolist(), ends.tolist())
                )

            for key, displaced in results:
                if len(displaced):
                    l_pos_chunks.append(displaced.positions)
                    l_col_chunks.append(displaced.colors)
                    l_cell_chunks.append(
                        np.broadcast_to(
                            np.asarray(key, np.int32), (len(displaced), 3)
                        )
                    )
                    l_next_chunks.append(
                        config.cell_index(displaced.positions, next_cell_size)
                    )

        # ---- losers ------------------------------------------------------
        # b_losers = losers_a ++ b_lose minus any row the run audit
        # moved into the sideband (whose verdict extra_losers carries)
        loser_arr = np.concatenate(
            [b_losers] + extra_losers
        ).astype(np.int64)
        if len(loser_arr):
            l_pos = np.ascontiguousarray(positions[loser_arr])
            l_col = np.ascontiguousarray(colors[loser_arr])
            l_cell, _, _, l_next = host_keys_full(
                l_pos, cell_size, sub_cell_size
            )
            l_pos_chunks.append(l_pos)
            l_col_chunks.append(l_col)
            l_cell_chunks.append(l_cell)
            l_next_chunks.append(l_next)

        return self._stage_and_flush(
            hierarchy, l_pos_chunks, l_col_chunks, l_cell_chunks,
            l_next_chunks, pinned,
        )


def make_mesh_converter_factory(n_devices: int, local: bool = False,
                                device="cuda"):
    """Factory matching the Converter(metadata, dir, cache_size=...) signature
    (used by the CLI's --mesh flag). ``n_devices=0`` means every device of
    ``device``'s kind; ``local`` is the multi-host worker's flag
    (parallel/launch.py), which changes nothing in one process."""

    def factory(metadata, working_directory, cache_size=None):
        return MeshConverter(
            metadata, working_directory, n_devices=n_devices or None,
            cache_size=cache_size, local=local, device=device,
        )

    return factory
