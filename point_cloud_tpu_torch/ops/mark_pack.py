"""B3, the dedup pass's mark/audit/pack back end: the wrapper of the
Hopper kernel in ``csrc/mark_pack.cu``.

Counterpart of the back half of the reference's fused light pass
(``point_cloud_tpu/ops/dedup.py`` ``_dedup_light_body`` :351-422 with
``_near_tie_mask`` :51-81) and of the owner cascade's
``_winner_and_suspect`` flags. From the columns ``sort4`` left and the
positions ``perm`` indexes, it writes ``perm | winner << 30 | suspect <<
29`` per sorted row: winners are the first rows of their (cell hash,
slot hash) runs, and a run is suspect where two of its adjacent rows
differ in their true keys or nearly tie in distance.

- It checks device, dtype, shape and contiguity first and raises on
  what the kernel does not take, on either device.
- On a CUDA tensor :func:`mark_pack` launches the kernel (one call: one
  launch of ``mark_pack_kernel``, no memset) or raises. There is no
  fallback.
- On a CPU tensor it runs the plain version, ``ops.dedup``'s
  :func:`~point_cloud_tpu_torch.ops.dedup.mark_pack_reference` (kept
  beside the pass it was split from; imported at the call, since
  ``ops.dedup`` imports this module).

The kernel spreads each run's flags across tiles with a chained scan: a
tile counter and one status word a tile, in a scratch kept for each
(device, stream) and zeroed once when it is made. Calls on one stream
run in order, so a call's tiles start the counter where the call before
left it (``base``) and tag their status words with a number no earlier
call used (``epoch``). Passes on other streams get scratches of their
own; one lock keeps each stream's bookkeeping in the order its launches
are queued (the pipelined converter runs passes from three threads).

``launches`` counts the wrapper's kernel calls.
"""

from __future__ import annotations

import threading

import torch

from .runtime import f32_arg, load_kernels

launches = 0

TILE_ROWS = 1024  # rows a block of mark_pack_kernel takes (csrc/mark_pack.cu)
MAX_ROWS = 1 << 29  # perm must fit below the flag bits
MAX_TILES = MAX_ROWS // TILE_ROWS
_EPOCHS = (1 << 32) - 1  # a call's tag runs 1..2^32-1: a zeroed word has none


class _Scratch:
    """A stream's tile status words, then its tile counter (the low half of
    the last word), zeroed once; and where its next call starts."""

    def __init__(self, device):
        self.words = torch.zeros(MAX_TILES + 1, dtype=torch.int64,
                                 device=device)
        self.base = 0  # the counter's value when the next call starts
        self.epoch = 0  # the last call's tag

    def take(self, tiles: int) -> tuple[int, int]:
        """(base, epoch) of a call of ``tiles`` tiles, and advance both."""
        base = self.base
        self.base = (base + tiles) & 0xFFFFFFFF
        self.epoch = self.epoch % _EPOCHS + 1
        return base, self.epoch


_scratch: dict = {}  # (device index, stream handle) -> _Scratch
_lock = threading.Lock()  # the scratches and ``launches``


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
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        key = (stream.device_index, stream.cuda_stream)
        with _lock:
            scratch = _scratch.get(key)
            if scratch is None:
                scratch = _scratch[key] = _Scratch(device)
            base, epoch = scratch.take(tiles)
            words = scratch.words.data_ptr()
            rc = lib.pc_mark_pack(*(c.data_ptr() for c in cols),
                                  positions.data_ptr(), cs.data_ptr(),
                                  radius.data_ptr(), n, out.data_ptr(),
                                  words, MAX_TILES, words + 8 * MAX_TILES,
                                  base, epoch, stream.cuda_stream)
            if rc != 0:
                del _scratch[key]  # its counter's value is unknown now
                raise RuntimeError(
                    f"pc_mark_pack launch failed: cudaError {rc}")
            launches += 1
    return out
