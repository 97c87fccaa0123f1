"""Four-column lexicographic sort: the Hopper kernel and its plain twin.

Counterpart of ``point_cloud_tpu/ops/sort_pallas.py`` (``pallas_sort4``,
:340-352), whose plain twin in the reference is ``ops/bitonic.py``.
:func:`sort4` sorts four equal-length int32 columns ascending in signed
lexicographic order; the result equals ``np.lexsort((k4, k3, k2, k1))``
for any input (rows that compare equal are equal, so stability cannot
show). The dedup pass passes a unique fourth column, the arrival iota.

- On a CUDA tensor it launches the hand-written kernel in
  ``csrc/sort4.cu`` (a merge sort: see the note there) or raises.
  There is no fallback: an input the kernel does not take is an error.
  The kernel needs a power-of-two length in [2^10, 2^30]; every caller
  pads to a pow2 bucket >= 2^15.
- On a CPU tensor it runs :func:`sort4_reference`, the plain version.

``launches`` counts the kernel's launches (one per :func:`sort4` call on
the card), so a run can show that its main path went through the kernel;
``launches_by_n`` splits that count by column length. The fused front
end of ``ops.quantize_hash``, whose tile kernel is this sort's with B2 as
its loader, counts its own calls there.
"""

from __future__ import annotations

import threading

import torch

from .runtime import load_kernels

launches = 0
launches_by_n: dict[int, int] = {}
_count_lock = threading.Lock()  # the pipelined converter sorts from 3 threads


def sort4_reference(k1, k2, k3, k4):
    """Plain version: four stable sorts, least-significant column first."""
    perm = torch.arange(k1.shape[0], device=k1.device)
    for col in (k4, k3, k2, k1):
        idx = torch.sort(col[perm], stable=True).indices
        perm = perm[idx]
    return k1[perm], k2[perm], k3[perm], k4[perm]


def check_length(n: int) -> None:
    """The kernel's lengths: a power of two in [2^10, 2^30]."""
    if n < 1024 or n & (n - 1) or n > 1 << 30:
        raise ValueError(f"sort4 kernel needs a pow2 length in [2^10, 2^30], got {n}")


def _check_kernel_args(cols) -> int:
    n = cols[0].shape[0]
    for c in cols:
        if c.dtype != torch.int32 or c.dim() != 1 or c.shape[0] != n:
            raise ValueError("sort4 takes four 1-D int32 columns of one length")
        if not c.is_contiguous():
            raise ValueError("sort4 takes contiguous columns")
        if c.device != cols[0].device:
            raise ValueError("sort4 columns must share one device")
    check_length(n)
    return n


def sort4(k1, k2, k3, k4):
    """Sort rows (k1, k2, k3, k4) ascending; returns the sorted columns."""
    global launches
    device = k1.device
    if device.type == "cpu":
        return sort4_reference(k1, k2, k3, k4)
    if device.type != "cuda":
        raise ValueError(f"sort4 runs on cuda (kernel) or cpu (plain), not {device}")
    cols = (k1, k2, k3, k4)
    n = _check_kernel_args(cols)
    lib = load_kernels()
    # the four output columns are the rows of one block, and the passes
    # ping-pong between it and a scratch block of the same shape
    out = torch.empty((4, n), dtype=torch.int32, device=device)
    scratch = torch.empty_like(out)
    columns = [block.data_ptr() + 4 * n * i for block in (out, scratch)
               for i in range(4)]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.pc_sort4(*(c.data_ptr() for c in cols), *columns, n, stream)
    if rc != 0:
        raise RuntimeError(f"pc_sort4 launch failed: cudaError {rc}")
    with _count_lock:
        launches += 1
        launches_by_n[n] = launches_by_n.get(n, 0) + 1
    return tuple(out)
