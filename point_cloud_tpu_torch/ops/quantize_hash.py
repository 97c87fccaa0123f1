"""B2, the dedup pass's quantize-and-hash front end, fused into ``sort4``:
the wrappers of the Hopper kernels in ``csrc/quantize_hash.cu``.

Counterpart of the front half of the reference's fused pass
(``point_cloud_tpu/ops/dedup.py`` ``hex_keys`` :184-225, ``_mix`` /
``_hash_cols`` :168-181, the masking and sort of ``_hash_sort``
:228-260, and the gather of ``_dedup_resident_body`` :428-452). Per row
it computes the four int32 columns of the pass's sort: cell hash
(padding ``i32::MAX``), slot hash (padding 0), distance bits (padding
``i32::MAX``) and arrival, and returns them sorted.

- :func:`quantize_sort4` and :func:`quantize_sort4_resident` return what
  ``sort4`` of those columns returns: B2 is the load stage of ``sort4``'s
  tile kernel (``quantize_tile``), followed by ``sort4``'s merge passes,
  so the columns never reach memory unsorted. The conversion passes
  (``ops.dedup``) and the owner cascade's two hash sorts call them.
- Every wrapper checks device, dtype, shape and contiguity first and
  raises on what the kernel does not take, on either device; on the card
  it also checks the sort's length, as ``sort4`` does.
- On a CUDA tensor they launch their kernels or raise. There is no
  fallback.
- On a CPU tensor they run the plain versions,
  :func:`~point_cloud_tpu_torch.ops.dedup.quantize_sort4_reference` and
  :func:`~point_cloud_tpu_torch.ops.dedup.quantize_sort4_resident_reference`
  (B2's plain version followed by ``sort4_reference``; kept beside the
  pass they were split from and imported at the call, since ``ops.dedup``
  imports this module).

``launches`` counts the calls that launched the fused front end (its
tile kernel and ``sort4``'s merges; ``ops.sort.launches`` counts
``sort4``'s own calls only), ``launches_by_n`` splits them by length and
``gather_launches_by_n`` counts the gather mode's among them.
:func:`division_mismatches` and :func:`division_sweep` run the card's
checks of the division helper that the kernel and B3 use
(``csrc/hex_keys.cuh``).
"""

from __future__ import annotations

import threading

import torch

from . import sort
from .runtime import f32_arg, load_kernels

launches = 0
launches_by_n: dict[int, int] = {}
gather_launches_by_n: dict[int, int] = {}
_count_lock = threading.Lock()  # the pipelined converter runs passes from 3 threads

_I32_MAX = 2**31 - 1


def _check_rows(name, t, dtype, device, width=None):
    """``t`` must be contiguous ``dtype`` rows on ``device``: 1-D, or
    ``(rows, width)``."""
    rows = t.shape[0] if t.dim() else -1
    shape = (rows,) if width is None else (rows, width)
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"quantize_hash: {name} must be contiguous {dtype} of shape "
            f"{'(rows,)' if width is None else f'(rows, {width})'} on "
            f"{device}, not {t.dtype} {tuple(t.shape)} on {t.device}")


def _device(t, name) -> torch.device:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"quantize_hash runs on cuda (kernel) or cpu "
                         f"(plain), not {t.device} ({name})")
    return t.device


def _direct_args(positions, valid, cell_size, sub_cell_radius):
    """(device, n, cell size, radius) of checked (N, 3) positions and
    their (N,) valid mask."""
    device = _device(positions, "positions")
    n = positions.shape[0]
    _check_rows("positions", positions, torch.float32, device, 3)
    _check_rows("valid", valid, torch.bool, device)
    if valid.shape[0] != n or n < 1:
        raise ValueError("quantize_hash: valid and positions must have the "
                         "same number of rows, at least one")
    return (device, n, f32_arg(cell_size, device),
            f32_arg(sub_cell_radius, device))


def _gather_args(resident, src_packed, extras, cell_size, sub_cell_radius):
    """(device, n, cell size, radius) of a checked gather: ``src_packed``
    into ``resident`` and ``extras``."""
    device = _device(src_packed, "src_packed")
    _check_rows("src_packed", src_packed, torch.int32, device)
    _check_rows("resident", resident, torch.float32, device, 3)
    _check_rows("extras", extras, torch.float32, device, 3)
    if src_packed.shape[0] < 1 or resident.shape[0] < 1 \
            or extras.shape[0] < 1:
        raise ValueError("quantize_hash: src_packed, resident and extras "
                         "need a row each")
    return (device, src_packed.shape[0], f32_arg(cell_size, device),
            f32_arg(sub_cell_radius, device))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _optional_outputs(device, n, keys, gather_out):
    """The unsorted keys (cell_idx, sub_idx, dist) or three Nones, and the
    gathered positions or None."""
    extra = [None, None, None]
    if keys:
        extra = [torch.empty((n, 3), dtype=torch.int32, device=device),
                 torch.empty((n, 3), dtype=torch.int32, device=device),
                 torch.empty(n, dtype=torch.float32, device=device)]
    pos_out = (torch.empty((n, 3), dtype=torch.float32, device=device)
               if gather_out else None)
    return extra, pos_out


def _result(cols, extra, pos_out, keys, gather_out):
    result = tuple(cols)
    if keys:
        result += tuple(extra)
    if gather_out:
        result += (pos_out,)
    return result


def _launch(device, n, *, positions=None, valid=None, src=None,
                   resident=None, extras=None, cell_size, radius, keys=False,
                   gather_out=False):
    """The fused front end: ``quantize_tile``, then sort4's merge passes
    (``pc_quantize_sort4``)."""
    global launches
    sort.check_length(n)
    lib = load_kernels()
    # sorted columns and the merge passes' scratch, as ops.sort.sort4
    out = torch.empty((4, n), dtype=torch.int32, device=device)
    scratch = torch.empty_like(out)
    columns = [block.data_ptr() + 4 * n * i for block in (out, scratch)
               for i in range(4)]
    extra, pos_out = _optional_outputs(device, n, keys, gather_out)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.pc_quantize_sort4(
            _ptr(positions), _ptr(valid), _ptr(src), _ptr(resident),
            _ptr(extras), cell_size.data_ptr(), radius.data_ptr(), n,
            *columns, *(_ptr(t) for t in extra), _ptr(pos_out), stream)
    if rc != 0:
        raise RuntimeError(f"pc_quantize_sort4 launch failed: cudaError {rc}")
    with _count_lock:
        launches += 1
        launches_by_n[n] = launches_by_n.get(n, 0) + 1
        if gather_out:
            gather_launches_by_n[n] = gather_launches_by_n.get(n, 0) + 1
    return _result(out, extra, pos_out, keys, gather_out)


def quantize_sort4(positions, valid, cell_size, sub_cell_radius, *,
                   keys=False):
    """The pass's sort columns of ``(N, 3)`` f32 positions and their
    ``(N,)`` bool valid mask, sorted: ``(cell_hash, slot_hash, dist_bits,
    perm)``, perm the rows' arrival order, plus the unsorted ``(cell_idx,
    sub_idx, dist)`` (unmasked) when ``keys`` is set. On the card the
    length must be a power of two in [2^10, 2^30]."""
    device, n, cs, radius = _direct_args(positions, valid, cell_size,
                                         sub_cell_radius)
    if device.type == "cpu":
        from .dedup import quantize_sort4_reference

        return quantize_sort4_reference(positions, valid, cs, radius,
                                        keys=keys)
    return _launch(device, n, positions=positions, valid=valid,
                          cell_size=cs, radius=radius, keys=keys)


def quantize_sort4_resident(resident, src_packed, extras, cell_size,
                            sub_cell_radius):
    """Gather mode for a cascade level whose rows live on the device:
    ``src_packed`` >= 0 indexes the ``(R, 3)`` ``resident`` rows, < 0 is
    ``~index`` into the ``(M, 3)`` ``extras``, ``i32::MAX`` is padding
    (which reads resident row 0 and is masked). Returns ``(cell_hash,
    slot_hash, dist_bits, perm, positions)``: the gathered rows' sorted
    columns, then the gathered ``(N, 3)`` rows in their unsorted order.
    The kernel does not bound-check the indices: they come from the
    cascade's own bookkeeping."""
    device, n, cs, radius = _gather_args(resident, src_packed, extras,
                                         cell_size, sub_cell_radius)
    if device.type == "cpu":
        from .dedup import quantize_sort4_resident_reference

        return quantize_sort4_resident_reference(resident, src_packed,
                                                 extras, cs, radius)
    return _launch(device, n, src=src_packed, resident=resident,
                          extras=extras, cell_size=cs, radius=radius,
                          gather_out=True)


def division_mismatches(cell_sizes, radii, device="cuda"):
    """The card's check of ``hex_keys.cuh``'s division helper: for each
    (cell size, radius) pair and each of its five divisors (cell size,
    radius * sqrt3, -radius * sqrt3, radius, 3, rounded as the kernels
    round them), every one of the 2^32 f32 bit patterns is divided by the
    helper's fast quotient and by ``__fdiv_rn``. Returns ``(mismatches,
    first, taken)``, three ``(pairs, 5)`` int64 tensors on the CPU: how
    many quotients the fast path took differ in their bits, the smallest
    numerator bit pattern that does (-1: none), and how many numerators
    the fast path took (the kernels divide the others with ``__fdiv_rn``
    itself). Runs only on a CUDA device: it checks the card's arithmetic
    against the card's own division, so the CPU has nothing to check."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"division_mismatches runs on a CUDA device, "
                         f"not {device}")
    cs = torch.tensor(cell_sizes, dtype=torch.float32, device=device)
    rad = torch.tensor(radii, dtype=torch.float32, device=device)
    if cs.dim() != 1 or cs.shape != rad.shape or cs.shape[0] < 1:
        raise ValueError("division_mismatches: one radius a cell size")
    count = cs.shape[0]
    bad = torch.zeros(5 * count, dtype=torch.int64, device=device)
    taken = torch.zeros_like(bad)
    first = torch.full((5 * count,), -1, dtype=torch.int32, device=device)
    lib = load_kernels()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.pc_division_check(cs.data_ptr(), rad.data_ptr(), count,
                                   bad.data_ptr(), first.data_ptr(),
                                   taken.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"pc_division_check launch failed: cudaError {rc}")
    first = first.cpu().to(torch.int64) & 0xFFFFFFFF  # the u32 patterns
    first[first == 0xFFFFFFFF] = -1
    return (bad.cpu().view(count, 5), first.view(count, 5),
            taken.cpu().view(count, 5))


SWEEP_CHUNK = 1 << 15  # divisors a launch: about a quarter second each


def division_sweep(first=0, stride=1, count=1 << 23, device="cuda"):
    """The card's check that ``hex_keys.cuh``'s division helper is
    ``__fdiv_rn`` for every operand it takes: for ``count`` divisor
    significands ``first + j * stride`` (b in [1, 2)), every numerator
    significand (a in [1, 2)) is divided both ways; by scaling and sign
    symmetry these pairs stand for every numerator and divisor in the
    helper's range. Returns ``(mismatches, first)``: how many pairs differ
    in their bits, and the smallest such pair's ``(divisor bits,
    numerator bits)`` (None: none). Runs only on a CUDA device."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"division_sweep runs on a CUDA device, not {device}")
    if count < 1 or stride < 1 or first < 0 \
            or first + (count - 1) * stride >= 1 << 23:
        raise ValueError("division_sweep: significands must lie in "
                         "[0, 2^23)")
    bad = torch.zeros(1, dtype=torch.int64, device=device)
    first_bad = torch.full((1,), -1, dtype=torch.int64, device=device)
    lib = load_kernels()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for j in range(0, count, SWEEP_CHUNK):
            rc = lib.pc_division_sweep(
                first + j * stride, stride, min(SWEEP_CHUNK, count - j),
                bad.data_ptr(), first_bad.data_ptr(), stream)
            if rc != 0:
                raise RuntimeError(f"pc_division_sweep launch failed: "
                                   f"cudaError {rc}")
    mismatches, pair = int(bad.item()), int(first_bad.item())
    if mismatches == 0:
        return 0, None
    pair &= (1 << 64) - 1
    return mismatches, (pair >> 32, pair & 0xFFFFFFFF)
