"""Owner-sharded dedup: the multi-device merge stage (counterpart of
parallel/owner_cascade.py).

After the shard-local dedup (stage A), every surviving candidate is
routed to the shard that *owns* its hex slot by an ``all_to_all``, and
each owner runs the global winner-of-winners sort over only its slots
(stage B). Per shard and level the pass sorts four times, each through a
hand-written kernel on the card: the two hash sorts (stage A's and stage
B's) through the fused front end ``quantize_sort4`` (B2 as the load
stage of ``sort4``'s tile kernel, ``ops.quantize_hash``), the routing
sort and stage B's arrival pre-sort through ``sort4``; B3
(``ops.mark_pack``, one launch each) marks and audits the hash sorts'
rows. Every sorted length is a power of two of at least 1024: the batch
pads to 1024·N·2^k rows (2^k·1024 a shard), and stage B pads to a pow2
bucket.

Ownership is keyed by the slot hash, not the cell hash: a slot's winner
must be decided by exactly one shard, and slot-keyed routing stays
load-balanced even where the whole cloud fits in a handful of cells.

Exactness: routing uses fixed-capacity per-(src, dst) buckets. Rows that
don't fit (``spilled``) and rows inside hash-collision or near-tie runs
(``suspect``) are excluded from the device decision and resolved exactly
on the host against the device winners
(``mesh_converter.resolve_sideband``). The final winner per (cell, slot)
is min-(distance, global arrival) over ALL candidates — byte-identical
to the host oracle (tests/test_torch_parallel.py compares stores file by
file).

The body is split at the exchange: :func:`_owner_stage_a` runs once per
shard, :func:`~.mesh.all_to_all` moves the send buffers, and
:func:`_owner_stage_b` runs once per owner. Left out on purpose: the
reference's degrade to the bitonic sort (owner_cascade.py:384-399); on
the card the sort launches its kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.hex import f32_scalar
from ..ops import dedup as dedup_mod
from ..ops.mark_pack import mark_pack
from ..ops.quantize_hash import quantize_sort4
from ..ops.sort import sort4
from .dedup import shard_rows, shard_slices
from .mesh import Mesh, all_to_all

_I32_MAX = 2**31 - 1

# outA bit layout: perm (28 bits) | spilled<<28 | suspect<<29 | winner<<30
PERM_MASK = (1 << 28) - 1
SPILL_BIT = 1 << 28
SUSPECT_BIT = 1 << 29
WINNER_BIT = 1 << 30
# outB bit layout: (arrival + 1) (29 bits, 0 = padding) | suspect<<29 |
# winner<<30
ARR_MASK = (1 << 29) - 1

_GOLDEN = -1640531527  # 0x9E3779B9 as i32


def _iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def _winner_and_suspect(ch_s, sh_s, db_s, perm, positions, cell_size,
                        sub_cell_radius):
    """Winner flags + collision audit over hash-sorted rows
    (owner_cascade.py:70-111): B3 (``ops.mark_pack``; its plain version on
    the CPU) on the sorted columns and the unsorted ``positions`` that
    ``perm`` indexes, which recomputes the true keys of the sorted rows; a
    run holding a key mismatch or a near-tie is suspect. Returns (packed,
    winner, suspect): B3's ``perm | winner << 30 | suspect << 29`` and its
    two flag bits."""
    packed = mark_pack(ch_s, sh_s, db_s, perm, positions, cell_size,
                       sub_cell_radius)
    return packed, (packed & WINNER_BIT) != 0, (packed & SUSPECT_BIT) != 0


def _check_pack_limits(shard_size: int, n_pad: int) -> None:
    """Refuse batches the packed-output bit layouts cannot carry
    (owner_cascade.py:114-128): out_a packs the per-shard perm in 28 bits
    and out_b packs global_arrival + 1 (< n_pad + 1) in 29 bits; beyond
    these the values would bleed into the flag bits."""
    if shard_size > PERM_MASK + 1 or n_pad > ARR_MASK - 1:
        raise ValueError(
            f"owner-sharded pass limit: shard_size={shard_size} "
            f"(max 2^28) / padded batch {n_pad} (max 2^29-2) — "
            "split the batch (lower --batch-size)"
        )


def _owner_stage_a(shard: int, positions, valid, cell_size,
                   sub_cell_radius, *, n_dest: int, capacity: int):
    """Per-shard body before the exchange (owner_cascade.py:171-233):
    stage-A hash sort and flags, then owner routing into the send
    buffers. Returns (out_a, send_pos (n_dest*capacity, 3), send_arr
    (n_dest*capacity,)); out_a is perm | spilled<<28 | suspect<<29 |
    winner<<30 per stage-A-sorted local row."""
    ss = positions.shape[0]
    dev = positions.device

    # ---- stage A: local hash sort + winner/suspect flags ----------------
    ch_s, sh_s, db_s, perm, _, _, _ = dedup_mod._hash_sort(
        positions, valid, cell_size, sub_cell_radius)
    packed, winner, suspect = _winner_and_suspect(
        ch_s, sh_s, db_s, perm, positions, cell_size, sub_cell_radius)

    # ---- owner routing --------------------------------------------------
    # dest = uniform hash of the slot identity, folding in the cell hash
    # so slot-hash collisions across cells still spread; the modulo is
    # of the mixed value's u32 bits
    mixed = dedup_mod._mix(sh_s ^ (ch_s * _GOLDEN))
    dest = ((mixed.to(torch.int64) & 0xFFFFFFFF) % n_dest).to(torch.int32)
    route_ok = winner & ~suspect
    dest = torch.where(route_ok, dest, torch.full_like(dest, n_dest))

    # bucket rows per dest: sort (dest, row); a row's place in its dest's
    # run is its distance from the run's first row, which a binary search
    # of the sorted column finds (the reference fills it with a cummax)
    row_ids = _iota(ss, dev)
    dest_s, src_row, _, _ = sort4(dest, row_ids, row_ids, row_ids)
    run_start = torch.searchsorted(dest_s, dest_s, out_int32=True)
    pos_in_dest = _iota(ss, dev) - run_start
    shipped = (dest_s < n_dest) & (pos_in_dest < capacity)

    # spilled, per stage-A-sorted row: src_row is a permutation of the rows
    src = src_row.long()
    pos_s = positions[perm.long()]
    spilled = torch.zeros(ss, dtype=torch.bool, device=dev)
    spilled[src] = (dest_s < n_dest) & ~shipped

    # send buffers: n_dest*capacity rows of position + global arrival, plus
    # one dropped row that every unshipped row writes to
    arrival_g = perm + shard * ss  # perm indexes local input rows
    slots = n_dest * capacity
    flat = torch.where(shipped, dest_s * capacity + pos_in_dest,
                       torch.full_like(dest_s, slots)).long()
    send_pos = torch.zeros((slots + 1, 3), dtype=torch.float32, device=dev)
    send_pos[flat] = pos_s[src]
    send_arr = torch.full((slots + 1,), -1, dtype=torch.int32, device=dev)
    send_arr[flat] = arrival_g[src]

    # B3's word; perm < 2^28 (_check_pack_limits) leaves bit 28 free
    out_a = packed | (spilled.to(torch.int32) << 28)
    return out_a, send_pos[:slots], send_arr[:slots]


def _owner_stage_b(shard: int, recv_pos, recv_arr, cell_size,
                   sub_cell_radius, *, stage_b_pad: int):
    """Per-owner body after the exchange (owner_cascade.py:235-278): the
    owner-local merge sort of the received rows. Returns out_b,
    (arrival + 1) | suspect<<29 | winner<<30 per stage-B-sorted row, 0 for
    padding."""
    del shard
    dev = recv_pos.device
    n_b = recv_pos.shape[0]
    pos_b, arr_b = recv_pos, recv_arr
    if stage_b_pad > n_b:  # pow2 padding for the sort
        pos_b = torch.cat([pos_b, torch.zeros((stage_b_pad - n_b, 3),
                                              dtype=torch.float32,
                                              device=dev)])
        arr_b = torch.cat([arr_b, torch.full((stage_b_pad - n_b,), -1,
                                             dtype=torch.int32, device=dev)])
    n_b = stage_b_pad

    # pre-sort by global arrival so buffer rank == arrival order: the main
    # sort can then use rank as BOTH the exact-arrival tie-break key and
    # the row pointer (the sort carries no payload)
    arr_key = torch.where(arr_b >= 0, arr_b, torch.full_like(arr_b, _I32_MAX))
    row_b = _iota(n_b, dev)
    arr_s1, row_s1, _, _ = sort4(arr_key, row_b, row_b, row_b)
    pos_b2 = pos_b[row_s1.long()]
    valid_b2 = arr_s1 != _I32_MAX
    arr_b2 = torch.where(valid_b2, arr_s1, torch.full_like(arr_s1, -1))

    # the hash sort (owner_cascade.py:138-153's padded hashes, sorted with
    # the buffer rank, which is B2's arrival column)
    ch_bs, sh_bs, db_bs, rank_s = quantize_sort4(pos_b2, valid_b2, cell_size,
                                                 sub_cell_radius)
    arr_bs = arr_b2[rank_s.long()]
    packed, _, _ = _winner_and_suspect(
        ch_bs, sh_bs, db_bs, rank_s, pos_b2, cell_size, sub_cell_radius)
    valid_bs = ch_bs != _I32_MAX
    return (torch.where(valid_bs, arr_bs + 1, torch.zeros_like(arr_bs))
            | (packed & (SUSPECT_BIT | WINNER_BIT)))


def owner_pass(mesh: Mesh, pos_shards, valid_shards, cell_size,
               sub_cell_radius, *, capacity: int, stage_b_pad: int):
    """The owner-sharded pass over per-shard tensors: stage A on every
    shard, the two ``all_to_all`` exchanges, stage B on every owner.
    ``cell_size`` and ``sub_cell_radius`` are f32 values. Returns the
    per-shard (out_a, out_b) lists."""
    n_dest = mesh.size

    def scalars(dev):
        return f32_scalar(cell_size, dev), f32_scalar(sub_cell_radius, dev)

    a = mesh.map(
        lambda s, pos, val: _owner_stage_a(
            s, pos, val, *scalars(pos.device), n_dest=n_dest,
            capacity=capacity),
        pos_shards, valid_shards)
    recv_pos = all_to_all([x[1] for x in a])
    recv_arr = all_to_all([x[2] for x in a])
    out_b = mesh.map(
        lambda s, pos, arr: _owner_stage_b(
            s, pos, arr, *scalars(pos.device), stage_b_pad=stage_b_pad),
        recv_pos, recv_arr)
    return [x[0] for x in a], out_b


class OwnerShardedPass:
    """Host wrapper of the owner-sharded pass (owner_cascade.py:282-409).

    ``capacity`` is rows per (source, destination) bucket. The default
    gives every destination twice its balanced share of a shard
    (2 * ss / n), so only adversarial slot-hash skew spills — and spills
    stay exact via the host sideband.
    """

    def __init__(self, mesh: Mesh, capacity: int | None = None):
        self.mesh = mesh
        self.n = mesh.size
        self.capacity_override = capacity

    def _capacity_for(self, shard_size: int) -> int:
        if self.capacity_override is not None:
            cap = self.capacity_override
        else:
            cap = max(64, (2 * shard_size) // self.n)
        # pow2 so stage B's sort length (n * cap) stays pow2 for pow2
        # meshes; non-pow2 meshes are padded by stage_b_pad
        p = 1
        while p < cap:
            p *= 2
        return p

    def __call__(self, positions: np.ndarray, cell_size, sub_cell_size):
        """Run the pass; returns a dict of host arrays.

        Output keys:
          n, n_pad, shard_size, capacity, stage_b_pad: static sizes.
          a_packed: (n_pad,) i32 stage-A output (perm/spill/suspect/winner
            bits), concatenated shard slabs in shard order.
          b_packed: (n * stage_b_pad,) i32 stage-B output (arrival+1 /
            suspect / winner bits), concatenated owner slabs.
        """
        n = len(positions)
        n_pad = shard_rows(self.mesh, n)
        shard_size = n_pad // self.n
        _check_pack_limits(shard_size, n_pad)
        capacity = self._capacity_for(shard_size)
        stage_b_pad = dedup_mod.pad_to_bucket(self.n * capacity,
                                              minimum=1024)

        pos_pad = np.zeros((n_pad, 3), np.float32)
        pos_pad[:n] = positions
        valid = np.zeros(n_pad, bool)
        valid[:n] = True
        out_a, out_b = owner_pass(
            self.mesh, shard_slices(self.mesh, pos_pad),
            shard_slices(self.mesh, valid), np.float32(cell_size),
            np.float32(sub_cell_size) / np.float32(2.0),
            capacity=capacity, stage_b_pad=stage_b_pad)
        return {
            "n": n,
            "n_pad": n_pad,
            "shard_size": shard_size,
            "capacity": capacity,
            "stage_b_pad": stage_b_pad,
            "a_packed": np.concatenate([x.cpu().numpy() for x in out_a]),
            "b_packed": np.concatenate([x.cpu().numpy() for x in out_b]),
        }
