"""point_cloud_tpu_torch — the PyTorch/CUDA port of point_cloud_tpu.

The JAX package (``point_cloud_tpu``) stays the reference. This package
re-implements its device code in PyTorch, with every Pallas kernel
replaced by a kernel written by hand for Hopper (``csrc/``), and mirrors
the reference's module paths so each counterpart is easy to find:

- ``ops.runtime``  — explicit device choice and the lazy nvcc build,
- ``core.hex``     — the NumPy hex math and its ``torch_*`` twins,
- ``ops.sort``     — the four-column lexicographic sort (``csrc/sort4.cu``),
- ``ops.dedup``    — the dedup pass: device half and NumPy host half,
- ``convert.*``    — the ``--device`` and ``--device-native`` converters
  and the CLI,
- ``models``       — the ``conversion`` pipeline and the synthetic cloud,
- ``render``, ``viewer`` — the frame path (``csrc/cull.cu``,
  ``csrc/splat.cu``), the headless viewer, its Tk window and in-app
  converter,
- ``serve``        — the store server; ``validate``, ``export`` — the
  store's host tools.

The port carries its own copies of the reference's host layer (store
format in ``core/``, readers in ``io/``, the C++ engine's binding in
``native/``, the host converters, stage timers), held equal to the
reference's by the ``tests/test_torch_*.py`` parity tests. It imports
nothing of ``point_cloud_tpu`` and never ``jax``; the C++ sources in the
repo-root ``native/`` are built into its own ``_build/``.
"""

__version__ = "0.1.0"
