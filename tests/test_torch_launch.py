"""The port's multi-host launch layer (parallel/launch.py).

The reference's cases on the port's module: a recording ``distributed``
stub and a recording barrier drive the full control flow — shard,
convert, barrier, rank-0 merge — in one process. Besides them:
``LaunchConfig.from_env`` against the reference's over a table of
environments, one real two-process gloo process group with its barrier
on localhost, and two CLI workers converting through it.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from point_cloud_tpu_torch.core.cell import Cell
from point_cloud_tpu_torch.core.metadata import Metadata
from point_cloud_tpu_torch.core.point import PointBatch
from point_cloud_tpu_torch.io.ply import write_ply
from point_cloud_tpu_torch.parallel.launch import (
    LaunchConfig,
    TorchDistributed,
    initialize_distributed,
    run_multihost,
)

REPO = Path(__file__).resolve().parent.parent
ENV_NAMES = (
    "PCT_NUM_PROCESSES", "PCT_PROCESS_ID", "PCT_COORDINATOR_ADDRESS",
    "JAX_NUM_PROCESSES", "JAX_PROCESS_ID", "JAX_COORDINATOR_ADDRESS",
    "COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
)

class RecordingDistributed:
    def __init__(self):
        self.calls = []

    def initialize(self, **kwargs):
        self.calls.append(kwargs)


class TestLaunchConfig:
    def test_default_is_single_process(self):
        config = LaunchConfig.from_env(env={})
        assert config.num_processes == 1
        assert config.process_id == 0
        assert config.is_coordinator

    def test_explicit_pct_vars(self):
        config = LaunchConfig.from_env(env={
            "PCT_NUM_PROCESSES": "4",
            "PCT_PROCESS_ID": "2",
            "PCT_COORDINATOR_ADDRESS": "host0:8476",
        })
        assert config.num_processes == 4
        assert config.process_id == 2
        assert config.coordinator_address == "host0:8476"
        assert config.explicit
        assert not config.is_coordinator

    def test_jax_names_are_fallbacks(self):
        config = LaunchConfig.from_env(env={
            "JAX_NUM_PROCESSES": "2",
            "JAX_PROCESS_ID": "1",
            "COORDINATOR_ADDRESS": "c:1",
        })
        assert (config.num_processes, config.process_id) == (2, 1)
        assert config.coordinator_address == "c:1"

    def test_pct_wins_over_jax(self):
        config = LaunchConfig.from_env(env={
            "PCT_NUM_PROCESSES": "3",
            "JAX_NUM_PROCESSES": "8",
            "PCT_PROCESS_ID": "0",
            "PCT_COORDINATOR_ADDRESS": "a:1",
            "COORDINATOR_ADDRESS": "b:2",
        })
        assert config.num_processes == 3
        assert config.coordinator_address == "a:1"

    def test_coordinator_only_defers_identity(self):
        config = LaunchConfig.from_env(env={
            "PCT_COORDINATOR_ADDRESS": "host0:8476",
        })
        assert not config.explicit
        assert config.num_processes > 1

    def test_half_identity_rejected(self):
        with pytest.raises(ValueError, match="both"):
            LaunchConfig.from_env(env={"PCT_NUM_PROCESSES": "2"})

    def test_pid_out_of_range(self):
        with pytest.raises(ValueError, match="out of range"):
            LaunchConfig(num_processes=2, process_id=2,
                         coordinator_address="c:1")

    def test_multi_needs_coordinator(self):
        with pytest.raises(ValueError, match="coordinator"):
            LaunchConfig(num_processes=2, process_id=0)


class TestInitialize:
    def test_single_process_is_noop(self):
        rec = RecordingDistributed()
        assert not initialize_distributed(LaunchConfig(), distributed=rec)
        assert rec.calls == []

    def test_explicit_triple_passed_through(self):
        rec = RecordingDistributed()
        config = LaunchConfig(num_processes=4, process_id=3,
                              coordinator_address="host0:8476")
        assert initialize_distributed(config, distributed=rec)
        assert rec.calls == [{
            "coordinator_address": "host0:8476",
            "num_processes": 4,
            "process_id": 3,
        }]

    def test_auto_detect_passes_coordinator_only(self):
        rec = RecordingDistributed()
        config = LaunchConfig.from_env(
            env={"PCT_COORDINATOR_ADDRESS": "host0:8476"}
        )
        assert initialize_distributed(config, distributed=rec)
        assert rec.calls == [{"coordinator_address": "host0:8476"}]


def random_batch(n, seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-80, 80, (n, 3)).astype(np.float32)
    col = rng.integers(0, 256, (n, 4), dtype=np.uint8)
    col[:, 3] = 255
    return PointBatch(pos, col)


def store_point_count(store):
    metadata = Metadata.from_path(store / "metadata.json")
    total = 0
    for h in range(metadata.hierarchies):
        hdir = store / f"h_{h}"
        if hdir.exists():
            for p in hdir.iterdir():
                total += Cell.from_path(p).total_number_of_points
    return metadata, total


class TestRunMultihost:
    def _make_files(self, tmp_path, n_files=4, n_points=1_500):
        files = []
        for i in range(n_files):
            f = tmp_path / f"cloud{i}.ply"
            write_ply(f, random_batch(n_points, seed=200 + i))
            files.append(f)
        return files

    def test_two_worker_flow(self, tmp_path):
        """Both workers' call sequence, driven sequentially: rank 1 first
        (no merge duty), then rank 0 (merges after its own shard). On a
        pod the converted-barrier provides exactly this ordering."""
        files = self._make_files(tmp_path)
        out = tmp_path / "store"
        barriers = {0: [], 1: []}
        rec = {0: RecordingDistributed(), 1: RecordingDistributed()}

        def config(pid):
            return LaunchConfig(num_processes=2, process_id=pid,
                                coordinator_address="localhost:9999")

        for pid in (1, 0):
            staged = run_multihost(
                files, out, config=config(pid),
                batch_size=1_000,
                distributed=rec[pid],
                barrier=barriers[pid].append,
                keep_staging=True,
            )
            assert (staged / "metadata.json").exists()
            # rank 0 returns the merged output; other ranks their staging
            # store (rank 0 deletes staging unless keep_staging)
            expect = out if pid == 0 else out / "_staging" / f"worker_{pid}"
            assert staged == expect

        for pid in (0, 1):
            # every worker initialized the process group and hit both
            # barriers in order
            assert rec[pid].calls == [{
                "coordinator_address": "localhost:9999",
                "num_processes": 2,
                "process_id": pid,
            }]
            assert barriers[pid] == [
                "pct:multihost:converted", "pct:multihost:merged",
            ]

        # the merged store holds exactly the union multiset of points
        direct = tmp_path / "direct"
        from point_cloud_tpu_torch.convert.converter import convert_from_paths

        convert_from_paths(files, direct, batch_size=1_000)
        _, merged_total = store_point_count(out)
        _, direct_total = store_point_count(direct)
        assert merged_total == direct_total > 0

    def test_staging_cleaned_by_default(self, tmp_path):
        files = self._make_files(tmp_path, n_files=2)
        out = tmp_path / "store"
        run_multihost(files, out, config=LaunchConfig(),
                      batch_size=1_000, barrier=lambda name: None)
        assert not (out / "_staging").exists()
        _, total = store_point_count(out)
        assert total > 0

    def test_more_workers_than_files(self, tmp_path):
        """Workers with empty shards stage an empty store; the merge must
        not fail on them."""
        files = self._make_files(tmp_path, n_files=1)
        out = tmp_path / "store"

        def config(pid):
            return LaunchConfig(num_processes=3, process_id=pid,
                                coordinator_address="c:1")

        for pid in (2, 1, 0):
            run_multihost(
                files, out, config=config(pid), batch_size=1_000,
                distributed=RecordingDistributed(),
                barrier=lambda name: None, keep_staging=True,
            )
        _, total = store_point_count(out)
        assert total == 1_500


class TestCliMultihost:
    def test_single_process_cli(self, tmp_path, monkeypatch):
        """--multihost without pod env vars degrades to one worker and
        still produces the store at -o."""
        for name in (
            "PCT_NUM_PROCESSES", "PCT_PROCESS_ID",
            "PCT_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
            "JAX_PROCESS_ID", "JAX_COORDINATOR_ADDRESS",
            "COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
        ):
            monkeypatch.delenv(name, raising=False)
        f = tmp_path / "cloud.ply"
        write_ply(f, random_batch(1_000, seed=77))
        out = tmp_path / "store"

        from point_cloud_tpu_torch.convert.cli import main

        assert main(["-o", str(out), "-f", str(f), "--multihost"]) == 0
        _, total = store_point_count(out)
        assert total == 1_000


ENVS = [
    {},
    {"PCT_NUM_PROCESSES": "4", "PCT_PROCESS_ID": "2",
     "PCT_COORDINATOR_ADDRESS": "host0:8476"},
    {"JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": "1",
     "COORDINATOR_ADDRESS": "c:1"},
    {"NUM_PROCESSES": "3", "PROCESS_ID": "0", "JAX_COORDINATOR_ADDRESS": "j:2"},
    {"PCT_NUM_PROCESSES": "3", "JAX_NUM_PROCESSES": "8",
     "PCT_PROCESS_ID": "0", "PCT_COORDINATOR_ADDRESS": "a:1",
     "COORDINATOR_ADDRESS": "b:2"},
    {"PCT_COORDINATOR_ADDRESS": "host0:8476"},
    {"PCT_NUM_PROCESSES": "1", "PCT_PROCESS_ID": "0"},
    {"PCT_NUM_PROCESSES": "", "PCT_PROCESS_ID": "", "NUM_PROCESSES": "2",
     "PROCESS_ID": "1", "COORDINATOR_ADDRESS": "c:9"},
    {"PCT_NUM_PROCESSES": "2"},
    {"PCT_PROCESS_ID": "1"},
    {"PCT_NUM_PROCESSES": "2", "PCT_PROCESS_ID": "2",
     "PCT_COORDINATOR_ADDRESS": "c:1"},
    {"PCT_NUM_PROCESSES": "2", "PCT_PROCESS_ID": "0"},
    {"PCT_NUM_PROCESSES": "0", "PCT_PROCESS_ID": "0"},
]


@pytest.mark.parametrize("env", ENVS, ids=range(len(ENVS)))
def test_from_env_agrees_with_reference(env):
    """Same config, or the same error, as the reference's from_env."""
    from point_cloud_tpu.parallel.launch import LaunchConfig as RConfig

    def outcome(cls):
        try:
            c = cls.from_env(env=dict(env))
        except ValueError as err:
            return ("error", str(err))
        return (c.num_processes, c.process_id, c.coordinator_address,
                c.explicit, c.is_coordinator)

    assert outcome(LaunchConfig) == outcome(RConfig)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker_env(rank: int, port: int) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in ENV_NAMES}
    env.update(PCT_NUM_PROCESSES="2", PCT_PROCESS_ID=str(rank),
               PCT_COORDINATOR_ADDRESS=f"localhost:{port}",
               PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return env


def run_workers(args, timeout: float):
    port = free_port()
    procs = [subprocess.Popen(args, cwd=REPO, env=worker_env(rank, port),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for rank in (0, 1)]
    out = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=timeout)
            out.append((p.returncode, stdout, stderr))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def test_two_process_gloo_group_and_barrier():
    """Two processes bring up a gloo group on localhost through
    initialize_distributed (a 60 s group timeout), meet at the default
    barrier twice and read their identity back."""
    code = (
        "import torch.distributed as dist\n"
        "from point_cloud_tpu_torch.parallel import launch\n"
        "config = launch.LaunchConfig.from_env()\n"
        "assert launch.initialize_distributed(\n"
        "    config, launch.TorchDistributed(timeout_s=60))\n"
        "launch._device_barrier('a')\n"
        "launch._device_barrier('b')\n"
        "print(dist.get_backend(), dist.get_rank(), dist.get_world_size())\n"
        "dist.destroy_process_group()\n"
    )
    results = run_workers([sys.executable, "-c", code], timeout=120)
    for rank, (rc, stdout, stderr) in enumerate(results):
        assert rc == 0, stderr[-2000:]
        assert stdout.split() == ["gloo", str(rank), "2"]


def test_two_cli_workers_merge_the_multiset(tmp_path):
    """Two ``--multihost --native`` CLI workers on one gloo group: rank 0's
    merged store holds the point multiset of one conversion of the same
    files."""
    from point_cloud_tpu_torch.convert.converter import convert_from_paths
    from test_torch_multihost import point_multiset_rows

    files = []
    for i in range(4):
        f = tmp_path / f"cloud{i}.ply"
        write_ply(f, random_batch(2_500, seed=400 + i))
        files.append(f)
    out = tmp_path / "merged"
    results = run_workers(
        [sys.executable, "-m", "point_cloud_tpu_torch.convert.cli",
         "--multihost", "--native", "--batch-size", "2000", "-o", str(out),
         "-f", *map(str, files)], timeout=300)
    for rc, _, stderr in results:
        assert rc == 0, stderr[-2000:]
    assert not (out / "_staging").exists()
    single = tmp_path / "single"
    convert_from_paths(files, single, batch_size=2_000)
    np.testing.assert_array_equal(point_multiset_rows(out),
                                  point_multiset_rows(single))
    assert Metadata.from_path(out / "metadata.json").number_of_points == 10_000


def test_torch_distributed_adapter_records_its_arguments(monkeypatch):
    """TorchDistributed maps the reference's initialize() onto
    init_process_group: tcp:// with world size and rank, or env://."""
    import torch.distributed as dist

    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: calls.append(kw))
    TorchDistributed().initialize(coordinator_address="h:1",
                                  num_processes=3, process_id=2)
    TorchDistributed().initialize(coordinator_address="h:1")
    assert calls == [
        {"backend": "gloo", "init_method": "tcp://h:1", "world_size": 3,
         "rank": 2},
        {"backend": "gloo", "init_method": "env://"},
    ]
