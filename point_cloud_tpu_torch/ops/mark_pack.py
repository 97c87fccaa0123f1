"""B3, the dedup pass's mark/audit/pack back end: the wrapper of the
Hopper kernel in ``csrc/mark_pack.cu``.

Counterpart of the back half of the reference's fused light pass
(``point_cloud_tpu/ops/dedup.py`` ``_dedup_light_body`` :351-422 with
``_near_tie_mask`` :51-81). From the columns ``sort4`` left and the
positions ``perm`` indexes, it writes ``perm | winner << 30 | suspect <<
29`` per sorted row: winners are the first rows of their (cell hash,
slot hash) runs, and a run is suspect where two of its adjacent rows
differ in their true keys or nearly tie in distance.

- It checks device, dtype, shape and contiguity first and raises on
  what the kernel does not take, on either device.
- On a CUDA tensor :func:`mark_pack` launches the kernel (one call: a
  4-byte memset and two kernels, ``mark_pack_tiles`` and
  ``mark_pack_resolve``) or raises. There is no fallback.
- On a CPU tensor it runs the plain version, ``ops.dedup``'s
  :func:`~point_cloud_tpu_torch.ops.dedup.mark_pack_reference` (kept
  beside the pass it was split from; imported at the call, since
  ``ops.dedup`` imports this module).

``launches`` counts the wrapper's kernel calls.
"""

from __future__ import annotations

import threading

import torch

from .runtime import f32_arg, load_kernels

launches = 0
_count_lock = threading.Lock()  # the pipelined converter runs passes from 3 threads

TILE_ROWS = 512  # rows a block of mark_pack_tiles takes (csrc/mark_pack.cu)
MAX_ROWS = 1 << 29  # perm must fit below the flag bits


def _check(cols, positions):
    device = cols[0].device
    n = cols[0].shape[0] if cols[0].dim() else -1
    for name, c in zip(("ch_s", "sh_s", "db_s", "perm"), cols):
        if c.device != device or c.dtype != torch.int32 or c.dim() != 1 \
                or c.shape[0] != n:
            raise ValueError(f"mark_pack: {name} must be a 1-D int32 column "
                             f"of {n} rows on {device}")
        if not c.is_contiguous():
            raise ValueError(f"mark_pack: {name} must be contiguous")
    if positions.device != device or positions.dtype != torch.float32 \
            or positions.dim() != 2 or positions.shape[1] != 3 \
            or positions.shape[0] < 1:
        raise ValueError(f"mark_pack: positions must be (rows, 3) float32 "
                         f"on {device}")
    if not positions.is_contiguous():
        raise ValueError("mark_pack: positions must be contiguous")
    if n < 1 or n > MAX_ROWS:
        raise ValueError(f"mark_pack kernel takes 1..2^29 rows, got {n}")
    return device, n


def mark_pack(ch_s, sh_s, db_s, perm, positions, cell_size, sub_cell_radius):
    """The packed i32 rows of the sorted columns; ``perm`` indexes the
    ``(M, 3)`` f32 ``positions`` (the kernel trusts it to)."""
    global launches
    if ch_s.device.type not in ("cuda", "cpu"):
        raise ValueError(f"mark_pack runs on cuda (kernel) or cpu (plain), "
                         f"not {ch_s.device}")
    cols = (ch_s, sh_s, db_s, perm)
    device, n = _check(cols, positions)
    cs = f32_arg(cell_size, device)
    radius = f32_arg(sub_cell_radius, device)
    if device.type == "cpu":
        from .dedup import mark_pack_reference

        return mark_pack_reference(*cols, positions, cs, radius)
    lib = load_kernels()
    tiles = -(-n // TILE_ROWS)
    out = torch.empty(n, dtype=torch.int32, device=device)
    # per tile a summary and a carry, then the last-block ticket
    scratch = torch.empty(2 * tiles + 1, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.pc_mark_pack(*(c.data_ptr() for c in cols),
                              positions.data_ptr(), cs.data_ptr(),
                              radius.data_ptr(), n, out.data_ptr(),
                              scratch.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"pc_mark_pack launch failed: cudaError {rc}")
    with _count_lock:
        launches += 1
    return out
