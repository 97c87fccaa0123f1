"""Mesh-sharded dedup: the shard-local stage of the multi-device
conversion (counterpart of parallel/dedup.py).

The batch shards across the mesh's data axis and each shard runs the
port's dedup pass (``ops/dedup.dedup_pass``: the hash sort through
``sort4``, the winner flags and the collision audit) over its own rows;
the batch's bounding box and valid-point count reduce over the shards
with ``pmin``/``pmax``/``psum`` (parallel/mesh.py).

Correctness of two-stage dedup (shard-local stage A, then a merge pass
over the shard winners): argmin over a (cell, slot) group is associative,
so reducing shard-local winners in a second pass yields exactly the
global winner set; every non-winner is a cascade point, identical to the
single-pass outcome. Arrival-order ties stay exact because rows keep
their global arrival index through both stages.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.hex import f32_scalar
from ..ops.dedup import dedup_pass, pad_to_bucket, resolve_suspects_host
from .mesh import Mesh, pmax, pmin, psum

_BIG = float(np.float32(3.4e38))


def shard_rows(mesh: Mesh, n: int) -> int:
    """The padded batch length: a pow2 bucket of at least 1024 rows a
    shard (parallel/dedup.py:85-88), so every shard's slice is a power of
    two for any mesh width."""
    n_pad = pad_to_bucket(max(n, 1), minimum=1024 * mesh.size)
    if n_pad % mesh.size:
        n_pad += mesh.size - (n_pad % mesh.size)
    return n_pad


def shard_slices(mesh: Mesh, array: np.ndarray) -> list:
    """``array``'s equal row slices, slice ``s`` on shard ``s``'s device."""
    ss = len(array) // mesh.size
    return [torch.as_tensor(np.ascontiguousarray(array[s * ss:(s + 1) * ss]),
                            device=dev)
            for s, dev in enumerate(mesh.devices)]


def _stage_a_local(positions, valid, cell_size, sub_cell_radius,
                   next_cell_size):
    """Per-shard body (parallel/dedup.py:30-52): the dedup pass over the
    local rows plus the local bounding box and count."""
    out = dedup_pass(positions, valid, cell_size, sub_cell_radius,
                     next_cell_size)
    local_min = torch.where(valid[:, None], positions, _BIG).amin(dim=0)
    local_max = torch.where(valid[:, None], positions, -_BIG).amax(dim=0)
    return out, local_min, local_max, valid.sum(dtype=torch.int32)


class ShardedDedup:
    """The sharded stage-A pass over a mesh (parallel/dedup.py:78-177)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.n = mesh.size

    def __call__(self, positions: np.ndarray, cell_size, sub_cell_size):
        """Shard-local dedup; returns per-row NumPy arrays + batch
        reductions (all length N_pad, ``valid`` masking real rows and
        ``global_arrival`` giving each sorted row's index into the
        input), with the reference's keys."""
        n = len(positions)
        n_pad = shard_rows(self.mesh, n)
        pos_pad = np.zeros((n_pad, 3), np.float32)
        pos_pad[:n] = positions
        valid = np.zeros(n_pad, bool)
        valid[:n] = True
        cell_size = np.float32(cell_size)
        radius = np.float32(sub_cell_size) / np.float32(2.0)
        next_size = cell_size / np.float32(2.0)

        def body(s, pos, val):
            dev = pos.device
            return _stage_a_local(pos, val, f32_scalar(cell_size, dev),
                                  f32_scalar(radius, dev),
                                  f32_scalar(next_size, dev))

        shards = self.mesh.map(body, shard_slices(self.mesh, pos_pad),
                               shard_slices(self.mesh, valid))
        bbox_min = pmin([s[1] for s in shards])[0]
        bbox_max = pmax([s[2] for s in shards])[0]
        count = psum([s[3] for s in shards])[0]

        def cat(i):
            return np.concatenate([s[0][i].cpu().numpy() for s in shards])

        perm, winner, valid_s, cell_idx, sub_idx, dist, next_idx, suspect = (
            cat(i) for i in range(8))
        shard_size = n_pad // self.n
        if suspect.any():
            for s in range(self.n):
                sl = slice(s * shard_size, (s + 1) * shard_size)
                winner[sl] = resolve_suspects_host(
                    perm[sl], winner[sl], cell_idx[sl], sub_idx[sl],
                    dist[sl], suspect[sl])
        shard_of = np.repeat(np.arange(self.n), shard_size)
        return {
            "global_arrival": perm + shard_of * shard_size,
            "winner": winner,
            "valid": valid_s,
            "cell_idx": cell_idx,
            "sub_idx": sub_idx,
            "next_idx": next_idx,
            "bbox_min": bbox_min.cpu().numpy(),
            "bbox_max": bbox_max.cpu().numpy(),
            "count": int(count),
        }
