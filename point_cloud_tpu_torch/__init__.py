"""point_cloud_tpu_torch — the PyTorch/CUDA port of point_cloud_tpu.

The JAX package (``point_cloud_tpu``) stays the reference. This package
re-implements its device code in PyTorch, with every Pallas kernel
replaced by a kernel written by hand for Hopper (``csrc/``), and mirrors
the reference's module paths so each counterpart is easy to find:

- ``ops.runtime``  — explicit device choice and the lazy nvcc build,
- ``core.hex``     — torch twins of the ``jax_*`` hex functions,
- ``ops.sort``     — the four-column lexicographic sort (``csrc/sort4.cu``),
- ``ops.dedup``    — the device half of the dedup pass,
- ``convert.*``    — the ``--device-native`` converter and the CLI,
- ``models``       — the ``conversion`` pipeline.

The JAX-free host layers of the reference (store format, readers, the C++
engine, the host converters, stage timers) are imported, never copied:
a second store-format implementation would drift. Nothing here imports
``jax``.
"""

__version__ = "0.1.0"
