"""Per-hierarchy streaming frustums.

Copy of the reference's ``render/frustums.py``: ``tests/test_torch_render.py``
holds its results equal to the reference's.

Capability parity with the reference (reference:
src/plugins/cell/frustums.rs:52-101): for each hierarchy ``h`` the camera
frustum is copied with the far plane pulled in to
``near + min(cell_size(h) * scale, far)`` and the far corners recomputed;
the scale defaults to 2.0 within [1, 5] (frustums.rs:13-25). Coarse
hierarchies therefore stream in across the whole view distance while fine
ones only stream near the camera.
"""

from __future__ import annotations

import numpy as np

from ..core.metadata import Metadata
from .camera import Frustum, PerspectiveProjection, _corner_quad
from .transform import Transform

SCALE_MIN = 1.0
SCALE_MAX = 5.0
SCALE_DEFAULT = 2.0


def update_streaming_frustums(
    metadata: Metadata,
    transform: Transform,
    projection: PerspectiveProjection,
    frustum: Frustum,
    scale: float = SCALE_DEFAULT,
) -> list[Frustum]:
    """One pulled-in frustum per hierarchy (frustums.rs:79-99)."""
    forward = transform.forward()
    far_normal = frustum.planes[1, :3]

    result = []
    for hierarchy in range(metadata.hierarchies):
        cell_size = metadata.config.cell_size(hierarchy)
        far_distance = projection.near + min(
            float(cell_size) * scale, projection.far
        )
        center_far = transform.translation + np.float32(far_distance) * forward

        new_projection = projection.copy()
        new_projection.far = far_distance
        far_corners = _corner_quad(transform, new_projection, far_distance)

        planes = frustum.planes.copy()
        planes[1] = [*far_normal, np.dot(center_far, far_normal)]
        result.append(Frustum(frustum.near.copy(), far_corners, planes))
    return result
