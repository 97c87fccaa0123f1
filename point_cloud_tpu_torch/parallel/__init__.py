"""Multi-device conversion and launch (counterpart of parallel/).

- ``mesh``: :class:`~.mesh.Mesh` (one process drives every shard, as
  under JAX's ``shard_map``), :func:`~.mesh.make_mesh` and the
  collectives ``pmin``/``pmax``/``psum``/``all_to_all``;
- ``dedup``: the shard-local dedup pass with its batch reductions;
- ``owner_cascade``: the owner-sharded pass (stage A, the slot-owner
  exchange, stage B; ``sort4`` four times a shard and level);
- ``mesh_converter``: :class:`~.mesh_converter.MeshConverter`, the CLI's
  ``--mesh``;
- ``multihost``, ``launch``: one worker per process on a gloo process
  group, the CLI's ``--multihost``;
- ``dryrun``: one mesh conversion step and one mesh frame.
"""

from .mesh import Mesh, make_mesh  # noqa: F401
