"""Multi-host launch layer: process-group init, per-worker conversion,
rank-0 merge (counterpart of parallel/launch.py).

The control flow is the reference's, on ``torch.distributed`` where the
reference uses ``jax.distributed``:

1. every process calls :func:`initialize_distributed` (one coordinator,
   ``num_processes`` workers: ``init_process_group`` with the gloo back
   end at ``tcp://<coordinator address>``, the world size and the rank),
2. each process converts its deterministic file shard into a private
   staging store with its own devices
   (:func:`point_cloud_tpu_torch.parallel.multihost.convert_sharded`),
3. everyone meets at a barrier (``torch.distributed.barrier``),
4. rank 0 merges the staging stores into the destination
   (:func:`point_cloud_tpu_torch.parallel.multihost.merge_stores` — pure
   host I/O through the own-format reader), and
5. everyone meets again, so no worker exits while rank 0 still reads its
   staging store.

Gloo, not NCCL: the barriers carry no tensor data, the workers may share
one card (NCCL refuses two ranks on one GPU), and gloo runs on hosts
without one. The collaborators are injectable: tests drive the full
control flow in one process with a recording ``distributed`` stub and a
recording ``barrier`` (tests/test_torch_launch.py).

Invocation (every worker runs the same command)::

    PCT_NUM_PROCESSES=2 PCT_PROCESS_ID=$RANK \\
    PCT_COORDINATOR_ADDRESS=localhost:29512 \\
    python -m point_cloud_tpu_torch.convert.cli --multihost \\
        --device-native -o /data/store -d /data/clouds

With only a coordinator address set, identity comes from torch's own
environment (``init_method="env://"``: ``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``).
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from pathlib import Path

from .multihost import convert_sharded, merge_stores

log = logging.getLogger(__name__)

# env names, first hit wins: PCT_* (ours) then the conventional JAX names
_ENV_NUM = ("PCT_NUM_PROCESSES", "JAX_NUM_PROCESSES", "NUM_PROCESSES")
_ENV_PID = ("PCT_PROCESS_ID", "JAX_PROCESS_ID", "PROCESS_ID")
_ENV_COORD = (
    "PCT_COORDINATOR_ADDRESS",
    "JAX_COORDINATOR_ADDRESS",
    "COORDINATOR_ADDRESS",
)


def _pick(env, names, default=None):
    for name in names:
        value = env.get(name)
        if value not in (None, ""):
            return value
    return default


@dataclass(frozen=True)
class LaunchConfig:
    """Worker identity for one process of a multi-host run."""

    num_processes: int = 1
    process_id: int = 0
    coordinator_address: str | None = None
    # True when identity came from the environment (process_id/num were
    # explicit); False means "identity from torch's env:// variables"
    explicit: bool = True

    def __post_init__(self):
        if self.num_processes < 1:
            raise ValueError("num_processes must be >= 1")
        if not 0 <= self.process_id < self.num_processes:
            raise ValueError(
                f"process_id {self.process_id} out of range "
                f"[0, {self.num_processes})"
            )
        if (
            self.explicit
            and self.num_processes > 1
            and not self.coordinator_address
        ):
            raise ValueError(
                "multi-process launch needs a coordinator address "
                "(PCT_COORDINATOR_ADDRESS=host:port)"
            )

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0

    @classmethod
    def from_env(cls, env=None) -> "LaunchConfig":
        """Derive worker identity from the environment.

        With none of the variables set this is a single-process config
        (``num_processes=1``) — the CLI path stays usable on one host.
        With only a coordinator address set, identity is deferred to the
        process group's ``env://`` initialization (``explicit=False``).
        """
        env = os.environ if env is None else env
        num = _pick(env, _ENV_NUM)
        pid = _pick(env, _ENV_PID)
        coord = _pick(env, _ENV_COORD)
        if num is None and pid is None:
            if coord is None:
                return cls()
            # coordinator known, identity from the launcher's environment
            return cls(
                num_processes=2,  # placeholder > 1: "multi, auto-detected"
                process_id=0,
                coordinator_address=coord,
                explicit=False,
            )
        if num is None or pid is None:
            raise ValueError(
                "set both PCT_NUM_PROCESSES and PCT_PROCESS_ID (or neither)"
            )
        return cls(
            num_processes=int(num),
            process_id=int(pid),
            coordinator_address=coord,
        )


class TorchDistributed:
    """``jax.distributed.initialize``'s interface on ``torch.distributed``:
    a gloo process group at ``tcp://<coordinator_address>`` with the given
    world size and rank, or from torch's environment (``env://``) when
    only the coordinator address is known."""

    def __init__(self, timeout_s: float | None = None):
        self.timeout_s = timeout_s

    def initialize(self, coordinator_address=None, num_processes=None,
                   process_id=None):
        import datetime

        import torch.distributed as dist

        kwargs = {}
        if self.timeout_s is not None:
            kwargs["timeout"] = datetime.timedelta(seconds=self.timeout_s)
        if num_processes is None:
            dist.init_process_group(backend="gloo", init_method="env://",
                                    **kwargs)
        else:
            dist.init_process_group(
                backend="gloo", init_method=f"tcp://{coordinator_address}",
                world_size=num_processes, rank=process_id, **kwargs)


def initialize_distributed(config: LaunchConfig, distributed=None) -> bool:
    """Bring up the process group for multi-process configs.

    Single-process configs are a no-op (returns False). ``distributed``
    defaults to :class:`TorchDistributed`; tests inject a recorder.
    """
    if config.num_processes <= 1:
        return False
    if distributed is None:
        distributed = TorchDistributed()
    if config.explicit:
        distributed.initialize(
            coordinator_address=config.coordinator_address,
            num_processes=config.num_processes,
            process_id=config.process_id,
        )
    else:
        # identity from the environment of the launcher
        distributed.initialize(
            coordinator_address=config.coordinator_address
        )
    return True


def _device_barrier(name: str) -> None:
    """Default barrier: ``torch.distributed.barrier`` over the process
    group (``name`` labels it in logs only)."""
    import torch.distributed as dist

    log.debug("barrier %s", name)
    dist.barrier()


def resolved_identity(config: LaunchConfig) -> tuple[int, int]:
    """(process_id, num_processes) after initialization.

    Explicit configs answer from the config; auto-detected ones ask the
    process group (valid only after ``initialize_distributed``).
    """
    if config.explicit:
        return config.process_id, config.num_processes
    import torch.distributed as dist

    return dist.get_rank(), dist.get_world_size()


def run_multihost(
    paths,
    output,
    config: LaunchConfig | None = None,
    converter_factory=None,
    batch_size=None,
    cache_size=None,
    distributed=None,
    barrier=None,
    keep_staging: bool = False,
) -> Path:
    """Full multi-host conversion for *this* worker.

    Every process calls this with the same ``paths``/``output``; the file
    shard, staging store, and merge responsibility are derived from the
    config. Returns the merged ``output`` store on rank 0 and this
    worker's staging store path on other ranks (which rank 0 deletes
    after the merge unless ``keep_staging``, so non-zero ranks must not
    dereference the returned path past the final barrier without it).
    Single-process configs degenerate to a plain staged conversion plus
    merge — the same code path, no process group.
    """
    config = config or LaunchConfig.from_env()
    initialized = initialize_distributed(config, distributed)
    if barrier is None:
        barrier = _device_barrier if initialized else (lambda name: None)
    process_id, num_processes = resolved_identity(config)

    output = Path(output)
    staging = output / "_staging"
    log.info(
        "multihost worker %d/%d converting its shard -> %s",
        process_id, num_processes, staging / f"worker_{process_id}",
    )
    store = convert_sharded(
        paths,
        staging,
        process_id,
        num_processes,
        converter_factory=converter_factory,
        batch_size=batch_size,
        cache_size=cache_size,
    )
    barrier("pct:multihost:converted")

    if process_id == 0:
        sources = []
        for i in range(num_processes):
            candidate = staging / f"worker_{i}"
            if (candidate / "metadata.json").exists():
                sources.append(candidate)
            else:
                # empty shard (fewer files than workers) — nothing staged
                log.info("worker %d staged no store (empty shard)", i)
        log.info("rank 0 merging %d staging stores -> %s",
                 len(sources), output)
        merge_stores(
            sources, output, converter_factory=converter_factory,
            batch_size=batch_size, cache_size=cache_size,
        )
        if not keep_staging:
            import shutil

            shutil.rmtree(staging, ignore_errors=True)
    # workers must not exit while rank 0 still reads their staging stores
    barrier("pct:multihost:merged")
    if initialized and distributed is None:
        import torch.distributed as dist

        dist.destroy_process_group()  # the group this call brought up
    return output if process_id == 0 else store
