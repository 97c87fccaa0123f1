"""Renderer of the port: camera math, the streaming control plane and the
frame path (counterpart of render/__init__.py).

The host modules (``camera``, ``transform``, ``frustums``, ``fly_cam``,
``streaming``, ``lines``) are copies of the reference's. The frame path is
PyTorch around two hand-written CUDA kernels: the cull and classify pass
(``kernel.cull_classify``, ``csrc/cull.cu``) and the splat raster of a
bucket (``splat.splat_raster_segments``, ``csrc/splat.cu``), driven by
``renderer.PointRenderer``.
"""

from .camera import Camera, Frustum, PerspectiveProjection  # noqa: F401
from .transform import Transform  # noqa: F401
