"""The port's multi-device conversion against the reference's.

The reference's mesh runs on the eight virtual CPU devices of
tests/conftest.py; the port's on logical CPU shards
(``make_mesh(device="cpu")``), where ``sort4`` runs its plain version.
Stores are held byte-identical to the port's host ``Converter`` and to
the reference's ``MeshConverter``; the owner-sharded pass's packed
outputs bit for bit against the reference's. One class runs on the card
(``cuda`` marker; it skips without one).
"""

import numpy as np
import pytest
import torch

from point_cloud_tpu.core.metadata import Metadata as JMetadata
from point_cloud_tpu_torch.convert import device as tdev
from point_cloud_tpu_torch.convert.converter import Converter
from point_cloud_tpu_torch.core.metadata import Metadata, MetadataConfig
from point_cloud_tpu_torch.core.point import PointBatch
from point_cloud_tpu_torch.parallel import mesh as tmesh
from point_cloud_tpu_torch.parallel import owner_cascade as toc
from point_cloud_tpu_torch.parallel.dedup import ShardedDedup
from point_cloud_tpu_torch.parallel.mesh_converter import (
    MeshConverter, make_mesh_converter_factory,
)



@pytest.fixture
def ref():
    """The reference's parallel package, on the eight virtual CPU devices
    (imported here: the card's machine runs only the ``cuda`` cases and
    has no JAX)."""
    import jax

    from point_cloud_tpu.parallel import (
        dedup, mesh, mesh_converter, owner_cascade,
    )

    if len(jax.devices()) < 8:
        pytest.skip("needs the eight virtual CPU devices")
    return dedup, mesh, mesh_converter, owner_cascade


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's torch work: the test workers
    share the machine's cores, and torch's parallel regions wait at a
    barrier for every thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cpu_mesh(n):
    return tmesh.make_mesh(n, device="cpu")


def random_batch(n, seed=0, lo=-100, hi=100):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    col = rng.integers(0, 256, (n, 4), dtype=np.uint8)
    col[:, 3] = 255
    return PointBatch(pos, col)


def store_files(store_dir):
    return {
        str(p.relative_to(store_dir)): p.read_bytes()
        for p in sorted(store_dir.rglob("*"))
        if p.is_file()
    }


def assert_stores_identical(a_dir, b_dir):
    a, b = store_files(a_dir), store_files(b_dir)
    assert a and set(a) == set(b)
    for name, data in a.items():
        assert b[name] == data, f"mismatch in {name}"


def host_store(path, *batches):
    with Converter(Metadata(), path) as conv:
        for b in batches:
            conv.add_points_batch(b)
    return path


def mesh_store(path, n_devices, *batches, **kwargs):
    with MeshConverter(Metadata(), path, mesh=cpu_mesh(n_devices),
                       **kwargs) as conv:
        for b in batches:
            conv.add_points_batch(b)
    return conv


def level_sizes():
    config = MetadataConfig()
    cs = config.cell_size(0)
    return cs, config.sub_cell_size(cs)


# --- the mesh and its collectives -----------------------------------------


@pytest.mark.parametrize("n", [1, 3, 8])
def test_reductions_equal_numpy(n):
    rng = np.random.default_rng(n)
    xs = [rng.normal(size=(5, 3)).astype(np.float32) for _ in range(n)]
    shards = [torch.from_numpy(x) for x in xs]
    for op, ref in ((tmesh.pmin, np.min), (tmesh.pmax, np.max),
                    (tmesh.psum, np.sum)):
        out = op(shards)
        assert len(out) == n
        for o in out:
            np.testing.assert_allclose(o.numpy(), ref(np.stack(xs), axis=0),
                                       rtol=0, atol=1e-6 if op is
                                       tmesh.psum else 0)
    counts = [torch.tensor(i + 1, dtype=torch.int32) for i in range(n)]
    assert int(tmesh.psum(counts)[0]) == n * (n + 1) // 2


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8])
def test_all_to_all_tiled(n):
    """Shard s's block d lands on shard d at position s (split and concat
    on axis 0), for pow2 and non-pow2 widths and a trailing axis."""
    cap = 4
    xs = [np.arange(n * cap * 3, dtype=np.int32).reshape(n * cap, 3)
          + 1000 * s for s in range(n)]
    out = tmesh.all_to_all([torch.from_numpy(x) for x in xs])
    for d in range(n):
        expect = np.concatenate([xs[s][d * cap:(d + 1) * cap]
                                 for s in range(n)])
        np.testing.assert_array_equal(out[d].numpy(), expect)
    with pytest.raises(ValueError, match="all_to_all"):
        tmesh.all_to_all([torch.zeros(7)] * 2)


def test_make_mesh_degrades_or_raises(caplog):
    mesh = tmesh.make_mesh(device="cpu")
    assert mesh.size == tmesh.CPU_SHARDS and mesh.axis_names == ("data",)
    assert tmesh.make_mesh(3, device="cpu").size == 3
    assert tmesh.make_mesh(0, device="cpu").size == tmesh.CPU_SHARDS
    assert tmesh.make_mesh(16, device="cpu").size == tmesh.CPU_SHARDS
    assert "only 8 available" in caplog.text
    with pytest.raises(ValueError, match="requested 16"):
        tmesh.make_mesh(16, strict=True, device="cpu")
    four = tmesh.make_mesh(devices=["cpu"] * 4, axis="x")
    assert four.size == 4 and four.axis_names == ("x",)
    assert four.distinct_devices == [torch.device("cpu")]
    assert four.map(lambda s, x: s * x, [10] * 4) == [0, 10, 20, 30]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tmesh.make_mesh(2)


# --- stage A: the sharded dedup -------------------------------------------


def test_sharded_dedup_matches_reference(ref):
    """Bounding box, count and the winner rows equal the reference's
    sharded pass on the same input."""
    jdedup, jmesh, _, _ = ref
    batch = random_batch(20_000, seed=31)
    cs, sub = level_sizes()
    ref = jdedup.ShardedDedup(jmesh.make_mesh(8))(batch.positions, cs, sub)
    out = ShardedDedup(cpu_mesh(8))(batch.positions, cs, sub)
    assert out["count"] == ref["count"] == 20_000
    np.testing.assert_array_equal(out["bbox_min"], batch.positions.min(0))
    np.testing.assert_array_equal(out["bbox_max"], batch.positions.max(0))
    np.testing.assert_array_equal(out["bbox_min"], ref["bbox_min"])
    np.testing.assert_array_equal(out["bbox_max"], ref["bbox_max"])
    for key in ("global_arrival", "winner", "valid", "cell_idx", "sub_idx",
                "next_idx"):
        np.testing.assert_array_equal(out[key], ref[key], err_msg=key)


# --- the owner-sharded pass -----------------------------------------------


@pytest.mark.parametrize("n_devices,n,lo,hi,capacity", [
    (8, 20_000, -200, 200, None),
    (3, 10_000, -300, 300, None),
    (8, 20_000, -200, 200, 1),
    (2, 5_000, -3, 3, None),
])
def test_owner_pass_packed_bit_equal(ref, n_devices, n, lo, hi, capacity):
    """a_packed and b_packed equal the reference's bit for bit: perm,
    spill, suspect and winner bits of stage A, arrival, suspect and winner
    bits of stage B (the last case flags near-ties, and still agrees)."""
    rng = np.random.default_rng(n_devices)
    pos = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    cs, sub = level_sizes()
    _, jmesh, _, joc = ref
    ref = joc.OwnerShardedPass(jmesh.make_mesh(n_devices),
                               capacity=capacity)(pos, cs, sub)
    out = toc.OwnerShardedPass(cpu_mesh(n_devices), capacity=capacity)(
        pos, cs, sub)
    for key in ("n", "n_pad", "shard_size", "capacity", "stage_b_pad"):
        assert out[key] == ref[key], key
    np.testing.assert_array_equal(out["a_packed"], ref["a_packed"])
    np.testing.assert_array_equal(out["b_packed"], ref["b_packed"])


def test_owner_pass_sort_lengths(monkeypatch):
    """Four sorts a shard and level (stage A's hash sort, the routing
    sort, stage B's two; the two hash sorts through the fused front end
    ``quantize_sort4``), every length a pow2 of at least 1024."""
    from point_cloud_tpu_torch.ops import dedup as tdedup

    seen = []
    real, real_front = toc.sort4, tdedup.quantize_sort4

    def spy(*cols):
        seen.append(cols[0].shape[0])
        return real(*cols)

    def front_spy(positions, *args, **kwargs):
        seen.append(positions.shape[0])
        return real_front(positions, *args, **kwargs)

    monkeypatch.setattr(toc, "sort4", spy)
    monkeypatch.setattr(toc, "quantize_sort4", front_spy)
    monkeypatch.setattr(tdedup, "quantize_sort4", front_spy)
    for n_devices in (1, 3, 8):
        seen.clear()
        pos = random_batch(3_000, seed=n_devices).positions
        toc.OwnerShardedPass(cpu_mesh(n_devices))(pos, *level_sizes())
        assert len(seen) == 4 * n_devices
        assert all(m >= 1024 and m & (m - 1) == 0 for m in seen)


class TestOwnerPackLimits:
    def test_in_range_ok(self):
        toc._check_pack_limits(1 << 28, (1 << 29) - 2)
        toc._check_pack_limits(1024, 8192)

    def test_overflow_rejected(self):
        with pytest.raises(ValueError, match="owner-sharded pass limit"):
            toc._check_pack_limits((1 << 28) + 1, 1 << 20)
        with pytest.raises(ValueError, match="owner-sharded pass limit"):
            toc._check_pack_limits(1 << 20, (1 << 29) - 1)


# --- MeshConverter stores -------------------------------------------------


@pytest.mark.parametrize("n_devices", [1, 2, 3, 8])
def test_mesh_store_matches_host_and_reference(ref, tmp_path, n_devices,
                                               monkeypatch):
    """Every level sharded (the host-tail threshold lowered in both
    packages, so levels of 4096 rows and more go through the mesh; the
    points crowd one h_0 cell, so four levels cascade through it): the
    port's store equals its host Converter's and the reference's
    MeshConverter's, file for file."""
    from point_cloud_tpu.convert import device as jdev

    monkeypatch.setattr(tdev, "HOST_CASCADE_THRESHOLD", 1 << 12)
    monkeypatch.setattr(jdev, "HOST_CASCADE_THRESHOLD", 1 << 12)
    batch = random_batch(24_000, seed=44, lo=1, hi=40)
    host_store(tmp_path / "host", batch)
    levels = []
    real = toc.OwnerShardedPass.__call__

    def spy(self, positions, *args):
        levels.append(len(positions))
        return real(self, positions, *args)

    monkeypatch.setattr(toc.OwnerShardedPass, "__call__", spy)
    conv = mesh_store(tmp_path / "port", n_devices, batch, min_mesh_rows=0)
    assert conv.owner_pass.n == n_devices
    assert len(levels) == 4
    with ref[2].MeshConverter(JMetadata(), tmp_path / "ref",
                              n_devices=n_devices, min_mesh_rows=0) as conv:
        conv.add_points_batch(batch)
    assert_stores_identical(tmp_path / "host", tmp_path / "port")
    assert_stores_identical(tmp_path / "ref", tmp_path / "port")


@pytest.mark.parametrize("n,lo,hi", [(40_000, -200, 200), (60_000, -3, 3)])
def test_store_byte_identical_to_host(tmp_path, n, lo, hi):
    batch = random_batch(n, seed=33, lo=lo, hi=hi)
    host_store(tmp_path / "host", batch)
    mesh_store(tmp_path / "mesh", 8, batch)
    assert_stores_identical(tmp_path / "host", tmp_path / "mesh")


@pytest.mark.parametrize("n_devices", [3, 5])
def test_non_pow2_mesh_byte_identical(tmp_path, n_devices):
    """Non-pow2 widths: non-pow2 stage-B lengths padded to pow2 sorts."""
    batch = random_batch(30_000, seed=44, lo=-60, hi=60)
    host_store(tmp_path / "host", batch)
    mesh_store(tmp_path / "mesh", n_devices, batch, min_mesh_rows=0)
    assert_stores_identical(tmp_path / "host", tmp_path / "mesh")


def test_forced_spill_sideband(tmp_path):
    """capacity=1 starves every routing bucket, so almost all winners
    spill into the exact host sideband."""
    batch = random_batch(20_000, seed=35, lo=-50, hi=50)
    host_store(tmp_path / "host", batch)
    conv = mesh_store(tmp_path / "mesh", 8, batch, min_mesh_rows=0,
                      capacity=1)
    assert conv.sideband_spilled > 1000  # the spill path ran
    assert_stores_identical(tmp_path / "host", tmp_path / "mesh")


def test_arrival_ties_across_shards(tmp_path):
    """Duplicate positions in different shards: the earliest global
    arrival wins, as the host oracle decides."""
    rng = np.random.default_rng(36)
    base = rng.uniform(-10, 10, (4_000, 3)).astype(np.float32)
    pos = np.tile(base, (4, 1))
    col = rng.integers(0, 256, (16_000, 4), dtype=np.uint8)
    batch = PointBatch(pos, col)
    host_store(tmp_path / "host", batch)
    mesh_store(tmp_path / "mesh", 8, batch, min_mesh_rows=0)
    assert_stores_identical(tmp_path / "host", tmp_path / "mesh")


def test_incremental_merge(tmp_path):
    b1 = random_batch(20_000, seed=37, lo=-40, hi=40)
    b2 = random_batch(20_000, seed=38, lo=-40, hi=40)
    host_store(tmp_path / "host", b1, b2)
    mesh_store(tmp_path / "mesh", 8, b1, b2, min_mesh_rows=0)
    assert_stores_identical(tmp_path / "host", tmp_path / "mesh")


def test_small_levels_run_on_the_first_device(tmp_path):
    """Below min_mesh_rows a level runs the single-device pass on the
    mesh's first device; the store is unchanged."""
    batch = random_batch(20_000, seed=39, lo=-30, hi=30)
    host_store(tmp_path / "host", batch)
    conv = mesh_store(tmp_path / "mesh", 4, batch, min_mesh_rows=1 << 20)
    assert conv.device == torch.device("cpu")
    assert conv.sideband_spilled == conv.sideband_suspect == 0
    assert_stores_identical(tmp_path / "host", tmp_path / "mesh")


def test_factory_needs_a_card_or_runs_on_cpu(tmp_path):
    batch = random_batch(20_000, seed=40, lo=-30, hi=30)
    factory = make_mesh_converter_factory(3, device="cpu")
    with factory(Metadata(), tmp_path / "mesh") as conv:
        assert conv.mesh.size == 3
        conv.add_points_batch(batch)
    host_store(tmp_path / "host", batch)
    assert_stores_identical(tmp_path / "host", tmp_path / "mesh")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            make_mesh_converter_factory(2)(Metadata(), tmp_path / "no")
        assert not (tmp_path / "no").exists()


# --- reference fault 1: a loser whose key has no clean winner -------------


def drop_one_winner(out):
    """Turn stage B's first clean winner into a loser: its slot is left
    with no clean device winner."""
    b = out["b_packed"].copy()
    clean = (((b & toc.WINNER_BIT) != 0) & ((b & toc.SUSPECT_BIT) == 0)
             & ((b & toc.ARR_MASK) != 0))
    row = int(np.nonzero(clean)[0][0])
    b[row] &= ~toc.WINNER_BIT
    return {**out, "b_packed": b}


def test_loser_without_clean_winner_reaches_sideband(ref, tmp_path,
                                                    monkeypatch):
    """A crafted b_packed whose one slot lost its only winner: the port's
    audit routes that slot's losers through the exact sideband, so the
    store still equals the host Converter's; the reference's audit keeps
    them losers, and its store differs."""
    _, _, jmc, joc = ref
    batch = random_batch(20_000, seed=45, lo=-200, hi=200)
    host_store(tmp_path / "host", batch)

    def tampered(cls):
        real = cls.__call__
        calls = []

        def call(self, *args):
            out = real(self, *args)
            calls.append(1)
            return drop_one_winner(out) if len(calls) == 1 else out

        return call

    monkeypatch.setattr(toc.OwnerShardedPass, "__call__",
                        tampered(toc.OwnerShardedPass))
    monkeypatch.setattr(joc.OwnerShardedPass, "__call__",
                        tampered(joc.OwnerShardedPass))
    conv = mesh_store(tmp_path / "port", 8, batch, min_mesh_rows=0)
    assert conv.sideband_suspect >= 1
    assert_stores_identical(tmp_path / "host", tmp_path / "port")
    with jmc.MeshConverter(JMetadata(), tmp_path / "ref", n_devices=8,
                           min_mesh_rows=0) as conv:
        conv.add_points_batch(batch)
    assert store_files(tmp_path / "ref") != store_files(tmp_path / "host")


def test_resolve_sideband_matches_reference(ref):
    """The host resolution is the reference's: the same demoted winners,
    sideband winners and sideband losers, duplicate winner keys too."""
    rng = np.random.default_rng(46)
    w, s = 50, 40
    w_keys = (rng.integers(0, 3, (w, 3)).astype(np.int32),
              rng.integers(0, 3, (w, 3)).astype(np.int32),
              rng.random(w).astype(np.float32), None)
    s_keys = (rng.integers(0, 3, (s, 3)).astype(np.int32),
              rng.integers(0, 3, (s, 3)).astype(np.int32),
              rng.random(s).astype(np.float32), None)
    w_arr = rng.permutation(1000)[:w]
    s_arr = rng.permutation(1000)[:s] + 1000
    from point_cloud_tpu_torch.parallel.mesh_converter import resolve_sideband

    keep, side_win, side_lose = resolve_sideband(s_arr, s_keys, w_arr,
                                                 w_keys)
    r_keep, r_win, r_lose = ref[2].resolve_sideband(s_arr, s_keys, w_arr,
                                                    w_keys)
    np.testing.assert_array_equal(keep, r_keep)
    assert not keep.all() and len(side_win) and len(side_lose)
    # the winners' order follows the slot numbering, which differs
    np.testing.assert_array_equal(np.sort(side_win), np.sort(r_win))
    np.testing.assert_array_equal(side_lose, r_lose)


# --- on the card ----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the mesh sorts through sort4")
    return torch.device("cuda:0")


@pytest.mark.cuda
def test_owner_pass_on_card_equals_cpu(cuda_device):
    """Four shards on one card: the packed outputs equal the CPU mesh's,
    and every shard sorted four times: its two hash sorts through the
    fused front end, its routing and arrival sorts through sort4."""
    from point_cloud_tpu_torch.ops import quantize_hash, sort

    pos = random_batch(200_000, seed=47, lo=-300, hi=300).positions
    cs, sub = level_sizes()
    before = (sort.launches, quantize_hash.launches)
    card = toc.OwnerShardedPass(tmesh.make_mesh(
        devices=[cuda_device] * 4))(pos, cs, sub)
    assert (sort.launches - before[0],
            quantize_hash.launches - before[1]) == (8, 8)
    cpu = toc.OwnerShardedPass(cpu_mesh(4))(pos, cs, sub)
    np.testing.assert_array_equal(card["a_packed"], cpu["a_packed"])
    np.testing.assert_array_equal(card["b_packed"], cpu["b_packed"])


@pytest.mark.cuda
@pytest.mark.parametrize("capacity", [None, 1])
def test_mesh_store_on_card(tmp_path, cuda_device, capacity):
    batch = random_batch(120_000, seed=48, lo=-40, hi=40)
    host_store(tmp_path / "host", batch)
    with MeshConverter(Metadata(), tmp_path / "mesh",
                       mesh=tmesh.make_mesh(devices=[cuda_device] * 4),
                       capacity=capacity) as conv:
        conv.add_points_batch(batch)
    assert_stores_identical(tmp_path / "host", tmp_path / "mesh")
