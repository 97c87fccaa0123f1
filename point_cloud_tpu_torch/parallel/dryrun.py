"""One mesh conversion step and one mesh frame on tiny shapes
(counterpart of ``dryrun_multichip`` in the repo's ``__graft_entry__.py``).

    python -c "from point_cloud_tpu_torch.parallel.dryrun import \\
        dryrun_multichip; dryrun_multichip(4, device='cpu')"

``dryrun_multichip(n)`` converts a small random batch through
:class:`~.mesh_converter.MeshConverter` on an ``n``-shard mesh with the
owner-sharded pass forced for every level, checks the point count, then
renders one 64x64 frame of the store through
:class:`~point_cloud_tpu_torch.render.parallel.MeshPointRenderer` on the
same mesh. ``devices`` overrides the mesh's device list (four shards on
one card: ``[torch.device("cuda:0")] * 4``).
"""

from __future__ import annotations

import tempfile
from pathlib import Path

import numpy as np


def dryrun_multichip(n_devices: int, device="cuda", devices=None) -> dict:
    """Run the step and the frame; returns the frame's stats."""
    from ..core.cell import Cell
    from ..core.metadata import Metadata
    from ..core.point import PointBatch
    from ..render.camera import Camera
    from ..render.frustums import update_streaming_frustums
    from ..render.parallel import MeshPointRenderer
    from ..render.renderer import RenderSettings
    from ..render.streaming import CellStreamer
    from .mesh import make_mesh
    from .mesh_converter import MeshConverter

    mesh = make_mesh(n_devices, strict=True, device=device, devices=devices)
    rng = np.random.default_rng(1)
    n = max(2048, 256 * n_devices)
    batch = PointBatch(
        rng.uniform(-200, 200, (n, 3)).astype(np.float32),
        rng.integers(0, 256, (n, 4)).astype(np.uint8),
    )
    with tempfile.TemporaryDirectory() as tmp:
        converter = MeshConverter(Metadata(), tmp, mesh=mesh,
                                  min_mesh_rows=0)
        converter.add_points_batch(batch)
        converter.close()
        assert converter.metadata.number_of_points == n

        store = Path(tmp)
        metadata = Metadata.from_path(store / "metadata.json")
        cam = Camera()
        cam.projection.far = metadata.config.max_cell_size * 5.0
        cam.look_at_aabb(metadata.bounding_box)

        def loader(cell_id):
            path = store / cell_id.path()
            return Cell.from_path(path) if path.exists() else None

        streamer = CellStreamer(metadata, loader=loader)
        frustums = update_streaming_frustums(
            metadata, cam.transform, cam.projection, cam.frustum())
        streamer.update(frustums, cam.transform)
        for _ in range(100):
            if not streamer.fill_load_slots():
                break
        renderer = MeshPointRenderer(
            metadata, mesh, settings=RenderSettings(width=64, height=64))
        rgb, depth, stats = renderer.render(streamer, cam, frustums)
        assert rgb.shape == (64, 64, 3)
        assert stats["points_visible"] >= 0
    return stats
