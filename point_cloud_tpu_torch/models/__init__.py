"""Pipeline registry of the port (counterpart of models/__init__.py).

- ``conversion`` — the port's full dedup pass (ops/dedup.py
  :func:`~point_cloud_tpu_torch.ops.dedup.dedup_pass`): quantize -> hash
  -> the Hopper sort kernel -> mark, audit, regroup.
- ``frame`` — the fused cull and LOD pass of the frame (render/kernel.py
  :func:`~point_cloud_tpu_torch.render.kernel.cull_lod_pass`): the LOD
  walk over the loaded-cells hash, then the cull kernel.

``models.synth`` holds the synthetic LiDAR-like cloud of the chip smoke.
"""

from __future__ import annotations

import numpy as np

PIPELINES = ("conversion", "frame")


def get_pipeline(name: str, n: int = 1 << 16, seed: int = 0,
                 device="cuda"):
    """``(fn, args)`` for a named pipeline on ``device``; ``fn(*args)``
    runs it. The inputs are the reference's (models/__init__.py:31-49)."""
    from ..ops.runtime import resolve_device

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    if name == "conversion":
        import torch

        from ..core.hex import f32_scalar
        from ..ops.dedup import dedup_pass

        positions = torch.as_tensor(
            rng.uniform(-100, 100, (n, 3)).astype(np.float32), device=device
        )
        args = (
            positions,
            torch.ones(n, dtype=torch.bool, device=device),
            f32_scalar(1000.0, device),
            f32_scalar(1000.0 / 96.0 / 2.0, device),
            f32_scalar(500.0, device),
        )
        return dedup_pass, args
    if name == "frame":
        import torch

        from ..render.camera import Camera
        from ..render.kernel import (
            MAX_HIERARCHIES, build_loaded_cells_hash, cull_lod_pass,
        )

        cam = Camera()
        positions = rng.uniform(-400, 400, (n, 3)).astype(np.float32)
        table = np.unique(
            rng.integers(-4, 4, (2000, 4)).astype(np.int32), axis=0
        )
        cell_sizes = np.asarray(
            [1000.0 / 2**h for h in range(MAX_HIERARCHIES)], np.float32
        )

        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=device)

        args = (
            dev(positions),
            torch.zeros(n, dtype=torch.int32, device=device),
            torch.ones(n, dtype=torch.bool, device=device),
            dev(cam.view_matrix().astype(np.float32)),
            dev(cam.projection_matrix().astype(np.float32)),
            dev(np.asarray(cam.transform.translation, np.float32)),
            dev(cell_sizes),
            dev(cell_sizes / np.float32(96.0)),
            dev(build_loaded_cells_hash(table)),
            torch.full((MAX_HIERARCHIES,), 1e9, dtype=torch.float32,
                        device=device),
            False,
            0,
        )

        def frame_fn(positions, point_hierarchy, valid, view, projection,
                     cam_pos, cell_sizes, spacings, loaded_hash,
                     far_distances, size_by_distance, max_hierarchy):
            return cull_lod_pass(
                positions, point_hierarchy, valid, view, projection,
                cam_pos, cell_sizes, spacings, 6, loaded_hash,
                far_distances, size_by_distance, max_hierarchy,
            )

        return frame_fn, args
    raise KeyError(f"unknown pipeline {name!r}; one of {PIPELINES}")
