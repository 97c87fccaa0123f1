"""B2, the dedup pass's quantize-and-hash front end: the wrapper of the
Hopper kernel in ``csrc/quantize_hash.cu``.

Counterpart of the front half of the reference's fused pass
(``point_cloud_tpu/ops/dedup.py`` ``hex_keys`` :184-225, ``_mix`` /
``_hash_cols`` :168-181, the masking of ``_hash_sort`` :228-260, and the
gather of ``_dedup_resident_body`` :428-452). Per row it writes the four
int32 columns ``sort4`` takes: cell hash (padding ``i32::MAX``), slot
hash (padding 0), distance bits (padding ``i32::MAX``) and arrival.

- Both check device, dtype, shape and contiguity first and raise on
  what the kernel does not take, on either device.
- On a CUDA tensor :func:`quantize_hash` and :func:`quantize_hash_resident`
  launch the kernel (one launch a call) or raise. There is no fallback.
- On a CPU tensor they run the plain versions, ``ops.dedup``'s
  :func:`~point_cloud_tpu_torch.ops.dedup.quantize_hash_reference` and
  :func:`~point_cloud_tpu_torch.ops.dedup.resident_rows_reference` (kept
  beside the pass they were split from; imported at the call, since
  ``ops.dedup`` imports this module).

``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import threading

import torch

from .runtime import f32_arg, load_kernels

launches = 0
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


def _launch(device, n, *, positions=None, valid=None, src=None, resident=None,
            extras=None, cell_size, radius, keys=False, gather_out=False):
    global launches
    if n < 1 or n > _I32_MAX:
        raise ValueError(f"quantize_hash kernel takes 1..2^31-1 rows, got {n}")
    lib = load_kernels()
    cols = torch.empty((4, n), dtype=torch.int32, device=device)
    out = list(cols)
    extra = [None, None, None]
    if keys:
        extra = [torch.empty((n, 3), dtype=torch.int32, device=device),
                 torch.empty((n, 3), dtype=torch.int32, device=device),
                 torch.empty(n, dtype=torch.float32, device=device)]
    pos_out = (torch.empty((n, 3), dtype=torch.float32, device=device)
               if gather_out else None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.pc_quantize_hash(
            ptr(positions), ptr(valid), ptr(src), ptr(resident), ptr(extras),
            cell_size.data_ptr(), radius.data_ptr(), n,
            *(c.data_ptr() for c in out), *(ptr(t) for t in extra),
            ptr(pos_out), stream)
    if rc != 0:
        raise RuntimeError(f"pc_quantize_hash launch failed: cudaError {rc}")
    with _count_lock:
        launches += 1
    result = tuple(out)
    if keys:
        result += tuple(extra)
    if gather_out:
        result += (pos_out,)
    return result


def _device(t, name) -> torch.device:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"quantize_hash runs on cuda (kernel) or cpu "
                         f"(plain), not {t.device} ({name})")
    return t.device


def quantize_hash(positions, valid, cell_size, sub_cell_radius, *,
                  keys=False):
    """``(cell_hash, slot_hash, dist_bits, arrival)`` of ``(N, 3)`` f32
    positions and their ``(N,)`` bool valid mask, plus ``(cell_idx,
    sub_idx, dist)`` (unmasked) when ``keys`` is set."""
    device = _device(positions, "positions")
    n = positions.shape[0]
    _check_rows("positions", positions, torch.float32, device, 3)
    _check_rows("valid", valid, torch.bool, device)
    if valid.shape[0] != n or n < 1:
        raise ValueError("quantize_hash: valid and positions must have the "
                         "same number of rows, at least one")
    cs = f32_arg(cell_size, device)
    radius = f32_arg(sub_cell_radius, device)
    if device.type == "cpu":
        from .dedup import quantize_hash_reference

        return quantize_hash_reference(positions, valid, cs, radius,
                                       keys=keys)
    return _launch(device, n, positions=positions, valid=valid,
                   cell_size=cs, radius=radius, keys=keys)


def quantize_hash_resident(resident, src_packed, extras, cell_size,
                           sub_cell_radius):
    """Gather mode for a cascade level whose rows live on the device:
    ``src_packed`` >= 0 indexes the ``(R, 3)`` ``resident`` rows, < 0 is
    ``~index`` into the ``(M, 3)`` ``extras``, ``i32::MAX`` is padding
    (which reads resident row 0 and is masked). Returns ``(cell_hash,
    slot_hash, dist_bits, arrival, positions)``, the last the gathered
    ``(N, 3)`` rows. The kernel does not bound-check the indices: they come
    from the cascade's own bookkeeping."""
    device = _device(src_packed, "src_packed")
    _check_rows("src_packed", src_packed, torch.int32, device)
    _check_rows("resident", resident, torch.float32, device, 3)
    _check_rows("extras", extras, torch.float32, device, 3)
    if src_packed.shape[0] < 1 or resident.shape[0] < 1 \
            or extras.shape[0] < 1:
        raise ValueError("quantize_hash: src_packed, resident and extras "
                         "need a row each")
    cs = f32_arg(cell_size, device)
    radius = f32_arg(sub_cell_radius, device)
    if device.type == "cpu":
        from .dedup import quantize_hash_reference, resident_rows_reference

        positions, valid = resident_rows_reference(resident, src_packed,
                                                   extras)
        return quantize_hash_reference(positions, valid, cs,
                                       radius) + (positions,)
    return _launch(device, src_packed.shape[0], src=src_packed,
                   resident=resident, extras=extras, cell_size=cs,
                   radius=radius, gather_out=True)
