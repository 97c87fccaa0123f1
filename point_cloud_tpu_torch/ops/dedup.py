"""Device half of the hex dedup pass, in PyTorch.

Counterpart of ``point_cloud_tpu/ops/dedup.py``: same inputs, same
outputs bit for bit (the packed ``perm | winner<<30 | suspect<<29`` i32
per row). The reference fuses the pass into one XLA program; on the card
the port runs it as hand-written kernels:

1. B2 (``csrc/quantize_hash.cu``): quantize each point (``hex_keys``,
   dedup.py:184-225, with the arithmetic of the torch twins of
   ``core/hex.py``), hash the cell and slot keys (``_hash_cols`` /
   ``_mix``, dedup.py:168-181; i32 wraparound and arithmetic shifts) and
   give the four sort columns with the padding sentinels (``_hash_sort``,
   dedup.py:228-260); in gather mode it first gathers a cascade level's
   rows from the device-resident buffer (dedup.py:428-452);
2. sort (cell hash, slot hash, distance bits, arrival): the sort of
   :func:`point_cloud_tpu_torch.ops.sort.sort4` (the reference's
   ``dispatch_sort4``, dedup.py:116-144). Steps 1 and 2 are one call,
   :func:`~point_cloud_tpu_torch.ops.quantize_hash.quantize_sort4`
   (or ``quantize_sort4_resident``): B2 is the load stage of the sort's
   tile kernel, so the columns are never written unsorted;
3. B3, :func:`~point_cloud_tpu_torch.ops.mark_pack.mark_pack`
   (``csrc/mark_pack.cu``): mark winners, audit hash collisions and float
   near-ties, spread each run's flags over the run and pack one i32 per
   row (``_dedup_light_body``, dedup.py:351-422).

The plain versions of B2 and B3 live here, beside the pass they were
split from: :func:`quantize_hash_reference` (with :func:`hex_keys`,
:func:`_hash_cols`, :func:`_mix`; :func:`resident_rows_reference` for the
gather), :func:`quantize_sort4_reference` and
:func:`quantize_sort4_resident_reference` (those, then
``sort4_reference``) and :func:`mark_pack_reference` (with
:func:`_near_tie_mask` and the cumsum/cummax/cummin run fill). On the CPU the wrappers run them;
on the card a wrapper launches its kernel or raises.

Left out on purpose: the reference's degrade-to-bitonic machinery
(``_PALLAS_BROKEN``, ``_PALLAS_VETTED``, ``_guarded_call``,
``mark_pallas_broken``, the ``PCT_SORT`` branches; dedup.py:83-113,
622-671). On the card the sort launches its kernel or raises; nothing on
this path gives way to a plain version or to the CPU.

The distance is written as separate eager ops in the reference order,
``(dx*dx + dy*dy) + dz*dz``, so no multiply-add fuses into an fma; B2 and
B3 write every step as an ``_rn`` intrinsic for the same reason.

The NumPy host half is a copy of the reference's (dedup.py:323-348,
458-495, 674-765): :func:`collect_dedup` waits for the packed rows,
rebuilds each sorted row's keys on the host (:func:`host_keys_full`, the
C++ pass or NumPy, both bit-identical to the reference's), extends the
suspects with the host-key run audit (:func:`audit_device_runs`) and
re-decides them exactly (:func:`resolve_suspects_host`). The
``--device`` converter (``convert/device.py``) runs it; the
``--device-native`` converter hands the packed rows to the C++ engine,
which does the same work itself.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import hex as hexgrid
from ..core.hex import (
    SQRT_3, f32_scalar, torch_axial_from_world, torch_axial_to_offset,
    torch_cell_index,
)
from ..core.metadata import MetadataConfig
from ..native import hex_keys_native
from ..utils.tracing import stage
from .mark_pack import mark_pack
from .quantize_hash import quantize_sort4, quantize_sort4_resident
from .sort import sort4_reference

_I32_MAX = 2**31 - 1

# near-tie floor (in ulps of the f32 distance) and cancellation-drift
# factor 64 * 2^-24 (exact in f32) — see the reference's _near_tie_mask
_NEAR_TIE_ULPS = 8
_NEAR_TIE_SCALE = float(np.float32(64.0 * 2.0**-24))


def _i32(v: int) -> int:
    """Python int (as u32 bit pattern) -> i32 value."""
    return v - 2**32 if v >= 2**31 else v


# multiplicative mixing constants (dedup.py:152-157)
_PRIMES_A = tuple(_i32(v) for v in (0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F))
_PRIMES_B = tuple(
    _i32(v)
    for v in (0x165667B1, 0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB4F,
              0x94D049BB)
)


def pad_to_bucket(n: int, minimum: int = 1024) -> int:
    """Next power-of-two bucket size (dedup.py:160-165)."""
    size = minimum
    while size < n:
        size *= 2
    return size


def _mix(h):
    """Final avalanche (murmur3-style), int32 wraparound (dedup.py:168)."""
    h = h ^ (h >> 16)
    h = h * -2048144789  # 0x85EBCA6B as i32
    h = h ^ (h >> 13)
    h = h * -1028477387  # 0xC2B2AE35 as i32
    return h ^ (h >> 16)


def _hash_cols(cols, primes):
    h = torch.zeros_like(cols[0])
    for col, p in zip(cols, primes):
        h = (h + col * p) * -1640531527  # golden-ratio constant
    return _mix(h)


def hex_keys(positions, cell_size, sub_cell_radius):
    """Per-point (cell index, hex slot, distance^2 to the slot centre)."""
    dev = positions.device
    radius = f32_scalar(sub_cell_radius, dev)
    cell_idx = torch_cell_index(positions, cell_size)
    axial = torch_axial_from_world(positions, radius)
    sub_idx = torch_axial_to_offset(axial)

    # slot centre (axial_to_world, inlined to reuse axial)
    sqrt3 = f32_scalar(SQRT_3, dev)
    q = axial[..., 0].to(torch.float32)
    r = axial[..., 1].to(torch.float32)
    h = axial[..., 2].to(torch.float32)
    t1 = sqrt3 * q
    t2 = (sqrt3 / 2.0) * r
    cx = radius * (t1 + t2)
    cy = (radius * 1.5) * r
    cz = h * radius

    dx = positions[..., 0] - cx
    dy = positions[..., 1] - cy
    dz = positions[..., 2] - cz
    xx = dx * dx
    yy = dy * dy
    zz = dz * dz
    dist = (xx + yy) + zz  # reference op order (cell.rs:75-79)
    return cell_idx, sub_idx, dist


def _near_tie_mask(same_hash, db_s, pos_s, valid_s):
    """Adjacent-pair near-tie detection (dedup.py:51-81): runs holding a
    pair whose distances are within 8 ulps, or within the
    ``64 * |p|_max * sqrt(d) * 2^-24`` cancellation band, resolve exactly
    on the host."""
    prev_bits = torch.roll(db_s, 1)
    gap_bits = db_s - prev_bits
    d_f = db_s.view(torch.float32)
    prev_f = prev_bits.view(torch.float32)
    pmax = torch.amax(torch.abs(pos_s), dim=-1)
    thr = _NEAR_TIE_SCALE * pmax * torch.sqrt(torch.clamp_min(d_f, 0.0))
    near = (gap_bits <= _NEAR_TIE_ULPS) | ((d_f - prev_f) <= thr)
    return same_hash & near & valid_s


def quantize_hash_reference(positions, valid, cell_size, sub_cell_radius,
                            keys=False):
    """Plain version of B2 (``hex_keys`` + ``_hash_cols`` + the masking of
    ``_hash_sort``, dedup.py:184-260): ``(cell_hash, slot_hash, dist_bits,
    arrival)``, plus ``(cell_idx, sub_idx, dist)`` when ``keys`` is set.
    Padding rows carry ch == i32::MAX (real hashes are clamped to
    0x7FFFFFFE), slot hash 0 and distance bits i32::MAX."""
    n = positions.shape[0]
    cell_idx, sub_idx, dist = hex_keys(positions, cell_size, sub_cell_radius)

    cols_cell = tuple(cell_idx[:, i] for i in range(3))
    cols_all = cols_cell + tuple(sub_idx[:, i] for i in range(3))
    cell_hash = _hash_cols(cols_cell, _PRIMES_A) & 0x7FFFFFFE
    slot_hash = _hash_cols(cols_all, _PRIMES_B)
    max_i32 = torch.full_like(cell_hash, _I32_MAX)
    cell_hash = torch.where(valid, cell_hash, max_i32)  # padding sorts last
    slot_hash = torch.where(valid, slot_hash, torch.zeros_like(slot_hash))

    # distance as order-preserving int bits (f32 >= 0; inf/nan sort high)
    dist_bits = torch.where(valid, dist.view(torch.int32), max_i32)
    # arrival (< 2^30) as the unique 4th column: the sort's total order
    # then equals a stable 3-key sort
    arrival = torch.arange(n, dtype=torch.int32, device=positions.device)
    out = (cell_hash, slot_hash, dist_bits, arrival)
    return out + (cell_idx, sub_idx, dist) if keys else out


def resident_rows_reference(resident, src_packed, extras):
    """Plain version of B2's gather mode (dedup.py:428-452): ``(positions,
    valid)`` of a cascade level. ``src_packed`` >= 0 indexes ``resident``,
    < 0 is ``~index`` into ``extras``, and i32::MAX marks bucket padding,
    which reads row 0 (its values never reach the packed result)."""
    valid = src_packed != _I32_MAX
    is_res = src_packed >= 0
    zero = torch.zeros_like(src_packed)
    res_idx = torch.where(is_res & valid, src_packed, zero).long()
    ext_idx = torch.where(is_res, zero, torch.bitwise_not(src_packed)).long()
    positions = torch.where(
        is_res[:, None], resident[res_idx], extras[ext_idx]
    )
    return positions, valid


def quantize_sort4_reference(positions, valid, cell_size, sub_cell_radius,
                             keys=False):
    """Plain version of the fused front end
    (``ops.quantize_hash.quantize_sort4``): :func:`quantize_hash_reference`,
    its four columns sorted by ``sort4_reference``, then the unsorted keys
    when ``keys`` is set."""
    out = quantize_hash_reference(positions, valid, cell_size,
                                  sub_cell_radius, keys=keys)
    return sort4_reference(*out[:4]) + out[4:]


def quantize_sort4_resident_reference(resident, src_packed, extras,
                                      cell_size, sub_cell_radius):
    """Plain version of ``ops.quantize_hash.quantize_sort4_resident``: the
    gathered rows' sorted columns, then the rows."""
    positions, valid = resident_rows_reference(resident, src_packed, extras)
    return quantize_sort4_reference(positions, valid, cell_size,
                                     sub_cell_radius) + (positions,)


def _hash_sort(positions, valid, cell_size, sub_cell_radius, keys=False):
    """Keys -> hashes -> 4-column sort (dedup.py:228-260): B2 and sort4 in
    one call (``quantize_sort4``).

    Returns (ch_s, sh_s, db_s, perm, cell_idx, sub_idx, dist), the last
    three unsorted and only when ``keys`` is set (None otherwise).
    """
    out = quantize_sort4(positions, valid, cell_size, sub_cell_radius,
                         keys=keys)
    return out[:4] + (out[4:] if keys else (None,) * 3)


def _first_of_run(ch_s, sh_s):
    same_hash = (ch_s == torch.roll(ch_s, 1)) & (sh_s == torch.roll(sh_s, 1))
    first = ~same_hash
    first[0] = True
    return same_hash, first


def dedup_pass(positions, valid, cell_size, sub_cell_radius, next_cell_size):
    """One dedup pass over a padded batch, all per-row outputs
    (dedup.py:263-320): B2 with its keys and sort4 in one call, the
    sorted rows' keys gathered in torch, and B3's winner and suspect
    bits.

    Args: (N, 3) f32 positions, (N,) bool valid mask, and the f32 scalars
    cell size, hex slot radius and next hierarchy's cell size.

    Returns (perm, winner, valid_s, cell_idx_s, sub_idx_s, dist_s,
    next_cell_idx_s, suspect), sorted by (cell hash, slot hash, distance,
    arrival).
    """
    ch_s, sh_s, db_s, perm, cell_idx, sub_idx, dist = _hash_sort(
        positions, valid, cell_size, sub_cell_radius, keys=True
    )
    next_cell_idx = torch_cell_index(positions, next_cell_size)

    p = perm.long()
    cell_idx_s = cell_idx[p]
    sub_idx_s = sub_idx[p]
    dist_s = dist[p]
    next_cell_idx_s = next_cell_idx[p]
    valid_s = valid[p]

    # winners and the collision audit (a run mixing two real keys has an
    # adjacent mismatch, or a near-tie): B3's two flag bits
    packed = mark_pack(ch_s, sh_s, db_s, perm, positions, cell_size,
                       sub_cell_radius)
    winner = (packed & (1 << 30)) != 0
    suspect = (packed & (1 << 29)) != 0

    return (
        perm, winner, valid_s, cell_idx_s, sub_idx_s, dist_s,
        next_cell_idx_s, suspect,
    )


def mark_pack_reference(ch_s, sh_s, db_s, perm, positions, cell_size,
                        sub_cell_radius):
    """Plain version of B3 (``_dedup_light_body`` after the sort,
    dedup.py:351-422): the packed ``perm | winner << 30 | suspect << 29``
    of the sorted columns. The audit recomputes the true keys of the
    sorted rows from ``positions[perm]`` and spreads each run's mismatch
    flags over the run with cumsum/cummax/cummin fills."""
    n = ch_s.shape[0]
    valid_s = ch_s != _I32_MAX  # real hashes are clamped below i32::MAX

    same_hash, first = _first_of_run(ch_s, sh_s)
    winner = first & valid_s

    pos_s = positions[perm.long()]
    cell_idx_s = torch_cell_index(pos_s, cell_size)
    sub_idx_s = torch_axial_to_offset(
        torch_axial_from_world(pos_s, sub_cell_radius)
    )
    key_s = torch.cat([cell_idx_s, sub_idx_s], dim=1)
    diff_prev = torch.any(key_s != torch.roll(key_s, 1, dims=0), dim=1)
    mismatch = same_hash & diff_prev & valid_s
    near_tie = _near_tie_mask(same_hash, db_s, pos_s, valid_s)
    mismatch = mismatch | near_tie
    mismatch[0] = False

    # "any mismatch in my run" = the running count rose between the run's
    # start and its end (mismatch is False on every run's first row)
    s = torch.cumsum(mismatch.to(torch.int32), 0, dtype=torch.int32)
    start_s = torch.cummax(
        torch.where(first, s, torch.full_like(s, -1)), 0
    ).values
    last = torch.roll(first, -1)
    last[n - 1] = True  # run's last row
    end_vals = torch.where(last, s, torch.full_like(s, _I32_MAX))
    end_s = torch.flip(
        torch.cummin(torch.flip(end_vals, (0,)), 0).values, (0,)
    )
    suspect = (end_s > start_s) & valid_s

    return (
        perm
        | (winner.to(torch.int32) << 30)
        | (suspect.to(torch.int32) << 29)
    )


def dedup_pass_light(positions, valid, cell_size, sub_cell_radius):
    """The pass as one packed i32 per row: ``perm | winner << 30 |
    suspect << 29`` (``_dedup_light_body``, dedup.py:351-422): B2 fused
    into sort4 (``quantize_sort4``), then B3."""
    cols = quantize_sort4(positions, valid, cell_size, sub_cell_radius)
    return mark_pack(*cols, positions, cell_size, sub_cell_radius)


def dedup_pass_resident(resident, src_packed, extras, cell_size,
                        sub_cell_radius):
    """A cascade level whose rows are gathered on the device
    (``_dedup_resident_body``, dedup.py:428-452): ``src_packed`` >= 0
    indexes ``resident`` (the batch's level-0 buffer), < 0 is ``~index``
    into ``extras``, and i32::MAX marks bucket padding. B2 in gather mode
    fused into sort4 (``quantize_sort4_resident``; it also writes the
    gathered rows), then B3."""
    *cols, positions = quantize_sort4_resident(
        resident, src_packed, extras, cell_size, sub_cell_radius)
    return mark_pack(*cols, positions, cell_size, sub_cell_radius)


def pass_args(positions: np.ndarray, valid: np.ndarray, cell_size,
              sub_cell_size, device):
    """(positions, valid, cell_size, sub_cell_radius) tensors on
    ``device`` for one pass, with the reference's f32 roundings
    (dedup.py:510-521): the radius is ``f32(sub_cell_size) / f32(2)``."""
    return (
        torch.as_tensor(np.ascontiguousarray(positions, np.float32),
                        device=device),
        torch.as_tensor(np.ascontiguousarray(valid, bool), device=device),
        f32_scalar(np.float32(cell_size), device),
        f32_scalar(np.float32(sub_cell_size) / np.float32(2.0), device),
    )


def _start_readback(handle: dict, packed: torch.Tensor) -> dict:
    """Start the copy of ``packed`` to the host (dedup.py:529-536): on the
    card, a non-blocking copy into pinned memory plus an event that
    :func:`packed_host` waits on. The handle keeps the pinned buffer and
    the event alive until then."""
    handle["packed"] = packed
    if packed.device.type == "cuda":
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        handle["host"], handle["event"] = host, event
    else:
        handle["host"], handle["event"] = packed, None
    return handle


def packed_host(handle: dict) -> np.ndarray:
    """Wait for a dispatched pass; its packed rows ``[0, n)`` as a NumPy
    copy (padding sorts last)."""
    if handle["event"] is not None:
        handle["event"].synchronize()
    return handle["host"].numpy()[: handle["n"]].copy()


def dispatch_dedup(positions: np.ndarray, cell_size, sub_cell_size,
                   n_valid: int | None = None, *, device) -> dict:
    """Pad a batch to its bucket, upload it and start the pass
    (dedup.py:497-526); returns a handle for :func:`packed_host`.

    The 2^15 bucket floor is the reference's. ``pos_dev`` stays in the
    handle: deeper cascade levels gather their rows from it.
    """
    n = len(positions) if n_valid is None else n_valid
    n_pad = pad_to_bucket(max(n, 1), minimum=1 << 15)
    pos_pad = np.zeros((n_pad, 3), np.float32)
    pos_pad[:n] = positions[:n]
    valid = np.zeros(n_pad, bool)
    valid[:n] = True

    args = pass_args(pos_pad, valid, cell_size, sub_cell_size, device)
    packed = dedup_pass_light(*args)
    return _start_readback({"n": n, "pos_dev": args[0]}, packed)


def dispatch_dedup_resident(resident, src: np.ndarray, extras: np.ndarray,
                            cell_size, sub_cell_size) -> dict:
    """Start a cascade level whose rows mostly live on the device already
    (dedup.py:539-568): ``src`` >= 0 indexes ``resident``, < 0 is
    ``~index`` into the (m, 3) host rows ``extras``."""
    device = resident.device
    n = len(src)
    n_pad = pad_to_bucket(max(n, 1), minimum=1 << 15)
    src_pad = np.full(n_pad, _I32_MAX, np.int32)
    src_pad[:n] = src
    m_pad = pad_to_bucket(max(len(extras), 1), minimum=1 << 10)
    extras_pad = np.zeros((m_pad, 3), np.float32)
    extras_pad[: len(extras)] = extras

    packed = dedup_pass_resident(
        resident,
        torch.as_tensor(src_pad, device=device),
        torch.as_tensor(extras_pad, device=device),
        f32_scalar(np.float32(cell_size), device),
        f32_scalar(np.float32(sub_cell_size) / np.float32(2.0), device),
    )
    return _start_readback({"n": n}, packed)


def dispatch_dedup_auto(resident, src, positions, cell_size, sub_cell_size,
                        prefetch_handle=None, enabled=True, *, device):
    """Resident-buffer dispatch vs a fresh full upload for one cascade
    level (dedup.py:571-619): the resident path runs when most rows still
    live in the device buffer.

    Returns ``(handle, resident, src, src_arr)``: the handle, the cascade
    state for the next level, and ``src_arr`` mapping this level's rows
    into the current resident buffer.
    """
    use_resident = (
        enabled
        and prefetch_handle is None
        and resident is not None
        and src is not None
        and (src >= 0).sum() * 2 >= len(src)
    )
    if use_resident:
        foreign = src < 0
        extras = np.ascontiguousarray(positions[foreign])
        src_packed = src.astype(np.int32)
        src_packed[foreign] = ~np.arange(int(foreign.sum()), dtype=np.int32)
        handle = dispatch_dedup_resident(
            resident, src_packed, extras, cell_size, sub_cell_size
        )
    else:
        handle = prefetch_handle or dispatch_dedup(
            positions, cell_size, sub_cell_size, device=device
        )
        resident = handle.get("pos_dev")
        src = None
    src_arr = (
        src if src is not None
        else np.arange(len(positions), dtype=np.int32)
    )
    return handle, resident, src, src_arr


# --- the NumPy host half (dedup.py:323-348, 458-495, 674-765) ---------


def resolve_suspects_host(perm, winner, cell_idx_s, sub_idx_s, dist_s,
                          suspect) -> np.ndarray:
    """Exact host-side re-dedup of hash-collision rows (rare).

    Recomputes winner flags for suspect rows with a full-key lexsort; the
    result is exactly the winner set a collision-free sort would produce.
    Returns the corrected winner array.
    """
    rows = np.nonzero(suspect)[0]
    if len(rows) == 0:
        return winner
    keys = np.concatenate(
        [cell_idx_s[rows], sub_idx_s[rows]], axis=1
    )
    dist = dist_s[rows]
    arrival = perm[rows]
    order = np.lexsort(
        (arrival, dist, keys[:, 5], keys[:, 4], keys[:, 3],
         keys[:, 2], keys[:, 1], keys[:, 0])
    )
    k_sorted = keys[order]
    is_first = np.ones(len(rows), bool)
    is_first[1:] = np.any(k_sorted[1:] != k_sorted[:-1], axis=1)
    winner = winner.copy()
    winner[rows[order]] = is_first
    return winner


def host_keys(positions, cell_size, sub_cell_size):
    """NumPy mirror of :func:`hex_keys` (same f32 ops -> same bits)."""
    config = MetadataConfig()
    cell_idx = config.cell_index(positions, np.float32(cell_size))
    radius = np.float32(sub_cell_size) / np.float32(2.0)
    sub_idx = hexgrid.offset_from_world(positions, radius)
    centers = hexgrid.offset_to_world(sub_idx, radius)
    d = positions - centers
    # extreme coordinates overflow to inf — IEEE-defined, identical on
    # the torch and C++ paths (lockstep-tested); silence only the warning
    with np.errstate(over="ignore"):
        dist = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
    return cell_idx, sub_idx, dist


def host_keys_full(positions, cell_size, sub_cell_size):
    """(cell_idx, sub_idx, dist, next_cell_idx) — C++ kernel when built
    (bit-identical, multi-threaded), NumPy otherwise."""
    cell_size = np.float32(cell_size)
    sub_cell_size = np.float32(sub_cell_size)
    next_cell_size = np.float32(cell_size / np.float32(2.0))
    out = hex_keys_native(
        positions, cell_size,
        np.float32(sub_cell_size / np.float32(2.0)), next_cell_size,
    )
    if out is not None:
        return out
    cell_idx, sub_idx, dist = host_keys(positions, cell_size, sub_cell_size)
    next_idx = MetadataConfig().cell_index(positions, next_cell_size)
    return cell_idx, sub_idx, dist, next_idx


def audit_device_runs(winner, suspect, cell_idx, sub_idx) -> np.ndarray:
    """Host-key audit of the device's run structure; returns the
    extended suspect mask (round-5 fuzz finding).

    The ON-DEVICE audits compare device-recomputed keys, which carry
    the same fma-contraction drift as the sort keys — a boundary-exact
    coordinate whose quantization flipped on the device looks
    self-consistent there (measured: a point at x == 0.0 exactly on a
    hex edge quantized to a different slot than the host). With the
    EXACT host keys of the sorted rows, two global invariants close the
    hole:

    1. a device run boundary (winner flag) must coincide exactly with a
       true-key change — the XOR catches runs that mixed two true keys
       AND one true key split across two runs,
    2. no true key may carry two winners — catches a mis-slotted row
       that formed its own clean run under the wrong hash (invisible
       to any run-local check).

    Every row of every affected true key becomes suspect, so
    :func:`resolve_suspects_host` re-decides those keys exactly; the
    audit costs one winners-only lexsort (no conflicts, the common
    case) plus an isin pass only when something flagged."""
    n = len(winner)
    if n == 0:
        return suspect
    keys = np.ascontiguousarray(
        np.concatenate([cell_idx, sub_idx], axis=1)
    )
    change = np.empty(n, bool)
    change[0] = True
    change[1:] = np.any(keys[1:] != keys[:-1], axis=1)
    bad = np.zeros(n, bool)
    xb = winner[1:] != change[1:]
    bad[1:] |= xb
    bad[:-1] |= xb  # both sides of a bad boundary
    w = np.nonzero(winner)[0]
    if len(w) > 1:
        wk = keys[w]
        order = np.lexsort(wk.T[::-1])
        wks = wk[order]
        dup = np.all(wks[1:] == wks[:-1], axis=1)
        if dup.any():
            dup_rows = np.concatenate(
                [w[order[1:][dup]], w[order[:-1][dup]]]
            )
            bad[dup_rows] = True
    if not bad.any():
        return suspect
    kb = keys.view(f"V{keys.dtype.itemsize * keys.shape[1]}").reshape(-1)
    mark = np.isin(kb, np.unique(kb[bad]))
    return suspect | mark


def collect_dedup(handle: dict, positions: np.ndarray, cell_size,
                  sub_cell_size):
    """Block on a dispatched pass and rebuild the per-row data host-side."""
    n = handle["n"]
    with stage("d2h_wait"):
        packed = packed_host(handle)  # rows [0, n): padding sorts last
    with stage("host_rebuild"):
        perm = packed & ((1 << 29) - 1)
        winner = (packed >> 30) & 1 == 1
        suspect = (packed >> 29) & 1 == 1

        pos_s = np.asarray(positions[:n], np.float32)[perm]
        cell_idx, sub_idx, dist, next_cell_idx = host_keys_full(
            pos_s, cell_size, sub_cell_size
        )
        suspect = audit_device_runs(winner, suspect, cell_idx, sub_idx)
        winner = resolve_suspects_host(
            perm, winner, cell_idx, sub_idx, dist, suspect
        )
    return perm, winner, cell_idx, sub_idx, dist, next_cell_idx


def dedup_batch_host(positions: np.ndarray, cell_size, sub_cell_size,
                     n_valid: int | None = None, *, device):
    """Pad, run the light device pass, rebuild row data on the host.

    ``positions`` rows [0, n_valid) are real; the rest is padding.
    Hash-collision runs are corrected exactly via
    :func:`resolve_suspects_host`.

    NOTE: rows come back grouped by *hash* order — same cell contiguous
    (up to cell-hash collisions, which the suspect mask also flags), but
    cells in hash order, not index order.
    """
    handle = dispatch_dedup(positions, cell_size, sub_cell_size, n_valid,
                            device=device)
    return collect_dedup(handle, positions, cell_size, sub_cell_size)
