"""The port's device converters against the host oracle.

``NativeDeviceConverter`` / ``NativeDevicePipelined`` (``--device-native``)
and ``DeviceConverter`` / ``PipelinedConverter`` (``--device``) of
point_cloud_tpu_torch, run on ``device="cpu"`` (the plain versions of
their kernels), must write stores byte-identical to the reference's host
``Converter`` at the same batch schedule — the pattern of
tests/test_native_engine.py::TestNativeDeviceParity and
tests/test_device_converter.py. One case runs ``--device`` on the card
(``cuda`` marker; it skips without one):
``PCT_TEST_PLATFORM=gpu python -m pytest tests/test_torch_converter.py -m cuda``.
"""

import dataclasses
import functools
import json
import zlib

import numpy as np
import pytest
import torch

from point_cloud_tpu.convert.converter import (
    Converter, convert_from_paths, load_metadata,
)
from point_cloud_tpu.core.metadata import Metadata, MetadataConfig
from point_cloud_tpu.core.point import PointBatch
from point_cloud_tpu_torch.convert import device as tdev
from point_cloud_tpu_torch.convert import native_device as tnd
from point_cloud_tpu_torch.convert import pipelined as tpip
from point_cloud_tpu_torch.ops import dedup as td


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's torch work: the test workers
    share the machine's cores, and torch's parallel regions wait at a
    barrier for every thread, so a descheduled thread stalls each small
    op (three 64x64 CPU frames took 90 s at 8 threads beside six busy
    processes on 8 cores, 0.4 s at one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

CLASSES = {
    "serial": tnd.NativeDeviceConverter,
    "pipelined": tnd.NativeDevicePipelined,
    "device": tdev.DeviceConverter,
    "device_pipelined": tpip.PipelinedConverter,
}


def random_batch(n, seed=0, lo=-100, hi=100):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    col = rng.integers(0, 256, (n, 4), dtype=np.uint8)
    col[:, 3] = 255
    return PointBatch(pos, col)


def store_files(store_dir):
    return {
        str(p.relative_to(store_dir)): p.read_bytes()
        for p in sorted(store_dir.rglob("*")) if p.is_file()
    }


def assert_stores_equal(a, b):
    fa, fb = store_files(a), store_files(b)
    assert fa and set(fa) == set(fb)
    for name, data in fa.items():
        assert fb[name] == data, f"mismatch in {name}"


def port_converter(kind, metadata, *args, **kwargs):
    """The port's converter on the CPU, given the reference's Metadata
    (handed over as its JSON text, as a reopened store would be: the two
    packages' classes are distinct)."""
    from point_cloud_tpu_torch.core.metadata import Metadata as PortMetadata
    from point_cloud_tpu_torch.native import hex_lockstep_ok, load_native

    if load_native() is None or not hex_lockstep_ok():
        pytest.skip("no C++ toolchain for the engine")
    return CLASSES[kind](PortMetadata.loads(metadata.dumps()), *args,
                         device="cpu", **kwargs)


def convert(factory, out, batch, step, **kwargs):
    with factory(load_metadata(out), out, **kwargs) as conv:
        for i in range(0, len(batch), step):
            conv.add_points_batch(batch[i : i + step])


@pytest.fixture(params=[0, None], ids=["all_device_levels", "default"])
def threshold(request, monkeypatch):
    """0 sends every level through the device pass; None keeps the
    default, exercising the engine's native tail."""
    if request.param is not None:
        monkeypatch.setattr(tnd, "HOST_CASCADE_THRESHOLD", request.param)
        monkeypatch.setattr(tdev, "HOST_CASCADE_THRESHOLD", request.param)
    return request.param


@pytest.mark.parametrize("kind", sorted(CLASSES))
@pytest.mark.parametrize(
    "name,n,kwargs,config",
    [
        ("sparse", 10_000, dict(lo=-300, hi=300), MetadataConfig()),
        ("dense", 30_000, dict(lo=-2, hi=2), MetadataConfig()),
        ("overflow", 5_000, dict(lo=-0.5, hi=0.5),
         MetadataConfig(cell_point_overflow_limit=40)),
    ],
)
def test_store_byte_identical_to_host(tmp_path, threshold, kind, name, n,
                                      kwargs, config):
    batch = random_batch(n, seed=zlib.crc32(name.encode()), **kwargs)
    with Converter(Metadata(config=dataclasses.replace(config)),
                   tmp_path / "host") as conv:
        for i in range(0, n, 4_000):
            conv.add_points_batch(batch[i : i + 4_000])
    with port_converter(kind, Metadata(config=dataclasses.replace(config)),
                        tmp_path / "port") as conv:
        for i in range(0, n, 4_000):
            conv.add_points_batch(batch[i : i + 4_000])
    assert_stores_equal(tmp_path / "host", tmp_path / "port")


@pytest.mark.parametrize("kind", sorted(CLASSES))
def test_tiny_cache_spill_byte_identical(tmp_path, threshold, kind):
    batch = random_batch(20_000, seed=99, lo=-300, hi=300)
    convert(Converter, tmp_path / "host", batch, 4_000, cache_size=2)
    convert(functools.partial(port_converter, kind), tmp_path / "port",
            batch, 4_000, cache_size=2)
    assert_stores_equal(tmp_path / "host", tmp_path / "port")


@pytest.mark.parametrize("kind", sorted(CLASSES))
def test_forced_collision_suspects_byte_identical(tmp_path, monkeypatch,
                                                  kind):
    """1-bit hashes: every level carries suspect rows, which the engine
    (or the NumPy host half) re-dedups exactly."""
    n = 8_000
    batch = random_batch(n, seed=77, lo=-3, hi=3)
    convert(Converter, tmp_path / "host", batch, 3_000)
    orig = td._hash_cols
    monkeypatch.setattr(td, "_hash_cols",
                        lambda cols, primes: orig(cols, primes) & 1)
    monkeypatch.setattr(tnd, "HOST_CASCADE_THRESHOLD", 0)
    monkeypatch.setattr(tdev, "HOST_CASCADE_THRESHOLD", 0)
    convert(functools.partial(port_converter, kind), tmp_path / "port",
            batch, 3_000)
    assert_stores_equal(tmp_path / "host", tmp_path / "port")


def test_incremental_merge_parity(tmp_path, threshold):
    a = random_batch(5_000, seed=21)
    b = random_batch(5_000, seed=22, lo=-150, hi=150)
    for factory, d in [(Converter, "host"),
                       (functools.partial(port_converter, "serial"), "port")]:
        convert(factory, tmp_path / d, a, 5_000)
        convert(factory, tmp_path / d, b, 5_000)
    assert_stores_equal(tmp_path / "host", tmp_path / "port")


def test_reference_store_then_port_merge(tmp_path, monkeypatch):
    """State carried across packages: the JAX NativeDeviceConverter
    writes batch A, the port merges batch B into the same store."""
    from point_cloud_tpu.convert import native_device as jnd

    monkeypatch.setattr(jnd, "HOST_CASCADE_THRESHOLD", 0)
    monkeypatch.setattr(tnd, "HOST_CASCADE_THRESHOLD", 0)
    a = random_batch(6_000, seed=31, lo=-50, hi=50)
    b = random_batch(6_000, seed=32, lo=-80, hi=80)
    convert(Converter, tmp_path / "host", a, 3_000)
    convert(Converter, tmp_path / "host", b, 3_000)
    convert(jnd.NativeDeviceConverter, tmp_path / "mixed", a, 3_000)
    convert(functools.partial(port_converter, "pipelined"),
            tmp_path / "mixed", b, 3_000)
    assert_stores_equal(tmp_path / "host", tmp_path / "mixed")


def test_prefetch_read_ahead_loop(tmp_path, threshold):
    """convert_from_paths drives prefetch (read-ahead batches): the port's
    converters must pick the dispatched level-0 passes up."""
    from point_cloud_tpu.io.ply import write_ply

    batch = random_batch(12_000, seed=77, lo=-200, hi=200)
    src = tmp_path / "cloud.ply"
    write_ply(src, batch)
    convert_from_paths([src], tmp_path / "host", batch_size=3_000)
    for kind in sorted(CLASSES):
        convert_from_paths(
            [src], tmp_path / kind, batch_size=3_000,
            converter_factory=functools.partial(port_converter, kind),
        )
        assert_stores_equal(tmp_path / "host", tmp_path / kind)


def test_cuda_converter_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the CPU-only refusal")
    for cls in CLASSES.values():
        with pytest.raises(RuntimeError, match="cuda"):
            cls(Metadata(), tmp_path / "store")  # device defaults to cuda
    assert not (tmp_path / "store").exists()


@pytest.mark.parametrize("kind", ["device", "device_pipelined"])
def test_incremental_merge_parity_device_converters(tmp_path, threshold,
                                                    kind):
    a = random_batch(5_000, seed=23)
    b = random_batch(5_000, seed=24, lo=-150, hi=150)
    for factory, d in [(Converter, "host"),
                       (functools.partial(port_converter, kind), "port")]:
        convert(factory, tmp_path / d, a, 2_500)
        convert(factory, tmp_path / d, b, 2_500)
    assert_stores_equal(tmp_path / "host", tmp_path / "port")


@pytest.mark.parametrize("port_first", [False, True],
                         ids=["reference_then_port", "port_then_reference"])
def test_reference_device_store_then_port_merge(tmp_path, monkeypatch,
                                                port_first):
    """State carried across packages, both ways: the JAX DeviceConverter
    (CPU backend) and the port's PipelinedConverter each write one batch
    set into the same store."""
    from point_cloud_tpu.convert import device as jdev

    monkeypatch.setattr(jdev, "HOST_CASCADE_THRESHOLD", 0)
    monkeypatch.setattr(tdev, "HOST_CASCADE_THRESHOLD", 0)
    a = random_batch(6_000, seed=33, lo=-40, hi=40)
    b = random_batch(6_000, seed=34, lo=-60, hi=60)
    convert(Converter, tmp_path / "host", a, 3_000)
    convert(Converter, tmp_path / "host", b, 3_000)
    writers = [jdev.DeviceConverter,
               functools.partial(port_converter, "device_pipelined")]
    if port_first:
        writers.reverse()
    convert(writers[0], tmp_path / "mixed", a, 3_000)
    convert(writers[1], tmp_path / "mixed", b, 3_000)
    assert_stores_equal(tmp_path / "host", tmp_path / "mixed")


def test_pipelined_matches_reference_pipelined(tmp_path):
    """The port's PipelinedConverter against the reference's own, on the
    JAX CPU backend, at the same batch schedule."""
    from point_cloud_tpu.convert.pipelined import PipelinedConverter

    batch = random_batch(16_000, seed=41, lo=-5, hi=5)
    convert(PipelinedConverter, tmp_path / "reference", batch, 4_000)
    convert(functools.partial(port_converter, "device_pipelined"),
            tmp_path / "port", batch, 4_000)
    assert_stores_equal(tmp_path / "reference", tmp_path / "port")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: --device runs the sort4 kernel")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cli_device_on_card(tmp_path, cuda_device, capsys):
    """--device on the card: the same store as the host engine, through
    the sort4 kernel, at sorted lengths of at least the 2^15 bucket."""
    from point_cloud_tpu_torch.convert import cli
    from point_cloud_tpu_torch.io.ply import write_ply
    from point_cloud_tpu_torch.ops import sort

    batch = random_batch(60_000, seed=51, lo=-60, hi=60)
    src = tmp_path / "cloud.ply"
    write_ply(src, batch)
    common = ["--batch-size", "20000", "-f", str(src)]
    # the counts are the process's: earlier tests may have sorted already
    before = dict(sort.launches_by_n)
    assert cli.main(["--device", "--profile", "-o", str(tmp_path / "card"),
                     *common]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["points"] == 60_000
    sorted_now = [n for n, c in sort.launches_by_n.items()
                  if c > before.get(n, 0)]
    assert sorted_now and min(sorted_now) >= 1 << 15
    assert cli.main(["--native", "-o", str(tmp_path / "host"), *common]) == 0
    assert_stores_equal(tmp_path / "host", tmp_path / "card")
