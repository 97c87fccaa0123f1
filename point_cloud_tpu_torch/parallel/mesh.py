"""The device mesh and its collectives (counterpart of parallel/mesh.py).

The reference runs its multi-device programs under JAX's ``shard_map``:
one process drives every device of a ``jax.sharding.Mesh``, the body
runs once per shard, and ``jax.lax.pmin``/``pmax``/``psum``/
``all_to_all`` exchange data between the shards. The port keeps that
model without ``torch.distributed``:

- :class:`Mesh` is an axis name and a list of ``torch.device``s, one per
  shard. A device may repeat: ``Mesh([torch.device("cuda:0")] * 4)`` is
  a four-shard mesh on one card, whose shards run one after another on
  that card's stream. This is the port's version of JAX's
  ``--xla_force_host_platform_device_count``: the way to run an N-way
  mesh, its exchange and its merges, without N devices.
- A shard body is a plain function that runs once per shard on that
  shard's device and takes the shard index (``jax.lax.axis_index``):
  :meth:`Mesh.map`.
- :func:`pmin`, :func:`pmax`, :func:`psum` and :func:`all_to_all` take
  the list of per-shard tensors and return one list again, each entry on
  its shard's device.

``torch.distributed`` comes in only where the reference uses
``jax.distributed``: the multi-host launch (``parallel/launch.py``).
"""

from __future__ import annotations

import logging

import torch

log = logging.getLogger(__name__)

CPU_SHARDS = 8  # logical CPU shards of make_mesh(device="cpu")


class Mesh:
    """A 1-D mesh: ``devices[s]`` holds shard ``s``."""

    def __init__(self, devices, axis: str = "data"):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_names = (axis,)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct_devices(self) -> list:
        """The mesh's devices, each once, in shard order."""
        return list(dict.fromkeys(self.devices))

    def map(self, body, *args) -> list:
        """``[body(s, *(a[s] for a in args)) for each shard s]``: the shard
        body runs once per shard, under its device."""
        out = []
        for s, dev in enumerate(self.devices):
            if dev.type == "cuda":
                with torch.cuda.device(dev):
                    out.append(body(s, *(a[s] for a in args)))
            else:
                out.append(body(s, *(a[s] for a in args)))
        return out

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, {self.axis_names[0]!r})"


def _device_list(device: str) -> list:
    from ..ops.runtime import resolve_device

    dev = resolve_device(device)  # raises for a missing card
    if dev.type == "cpu":
        return [torch.device("cpu")] * CPU_SHARDS
    if dev.index is not None:
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: int | None = None, axis: str = "data",
              strict: bool = False, local: bool = False, *, device="cuda",
              devices=None) -> Mesh:
    """A 1-D data-parallel mesh over the first ``n_devices`` devices
    (parallel/mesh.py:15-53).

    The devices are ``devices`` when given, else ``cuda:0`` to
    ``cuda:{device_count() - 1}`` for ``device="cuda"`` (raises without a
    card), or eight logical CPU shards for ``device="cpu"`` (the
    counterpart of the reference tests' eight virtual CPU devices). When
    fewer than ``n_devices`` exist the mesh degrades to all of them with a
    warning (the width only changes how batches shard, not what they
    compute); ``strict=True`` raises instead. ``local`` is the reference's
    flag for a multi-host worker's own devices; one process of the port
    only ever sees its own, so it changes nothing.
    """
    del local
    pool = ([torch.device(d) for d in devices] if devices is not None
            else _device_list(device))
    if n_devices is None or n_devices == 0:
        n_devices = len(pool)
    if n_devices > len(pool):
        if strict:
            raise ValueError(
                f"requested {n_devices} devices, only {len(pool)} available")
        log.warning("requested %d devices, only %d available; using %d",
                    n_devices, len(pool), len(pool))
        n_devices = len(pool)
    return Mesh(pool[:n_devices], axis)


# --- collectives over a list of per-shard tensors -------------------------


def _reduce(xs, op):
    """``op`` folded over the shards on the first one's device, the result
    copied back to each shard's device."""
    acc = xs[0]
    for x in xs[1:]:
        acc = op(acc, x.to(acc.device))
    return [acc if x.device == acc.device else acc.to(x.device) for x in xs]


def pmin(xs) -> list:
    """``jax.lax.pmin``: the elementwise minimum over the shards."""
    return _reduce(xs, torch.minimum)


def pmax(xs) -> list:
    """``jax.lax.pmax``: the elementwise maximum over the shards."""
    return _reduce(xs, torch.maximum)


def psum(xs) -> list:
    """``jax.lax.psum``: the elementwise sum over the shards."""
    return _reduce(xs, torch.add)


def all_to_all(xs) -> list:
    """``jax.lax.all_to_all(x, axis, 0, 0, tiled=True)``: shard ``s``
    splits its tensor into ``n`` equal blocks along axis 0 and sends
    block ``d`` to shard ``d``; shard ``d`` receives the blocks of shards
    0..n-1 concatenated along axis 0, in shard order."""
    n = len(xs)
    rows = xs[0].shape[0]
    if rows % n or any(x.shape != xs[0].shape for x in xs):
        raise ValueError(
            f"all_to_all: {n} shards need equal shapes whose axis 0 "
            f"divides by {n}")
    blocks = [x.reshape(n, rows // n, *x.shape[1:]) for x in xs]
    return [torch.cat([blocks[s][d].to(xs[d].device) for s in range(n)])
            for d in range(n)]
