"""Pipeline registry of the port (counterpart of models/__init__.py).

- ``conversion`` — the port's full dedup pass (ops/dedup.py
  :func:`~point_cloud_tpu_torch.ops.dedup.dedup_pass`): quantize -> hash
  -> the Hopper sort kernel -> mark, audit, regroup.
- ``frame`` — the render pipeline, not ported yet (ROADMAP.md).

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
        raise NotImplementedError(
            "the frame pipeline is not ported yet (ROADMAP.md, A, next 3)"
        )
    raise KeyError(f"unknown pipeline {name!r}; one of {PIPELINES}")
