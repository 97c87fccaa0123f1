"""The port's multi-host build (parallel/multihost.py): shard, staging
stores, cell-level merge. The reference's cases on the port's modules,
and merged stores byte-identical to what the reference's
``merge_stores`` makes of the same staging stores."""

import numpy as np
import pytest

from point_cloud_tpu_torch.core.cell import Cell
from point_cloud_tpu_torch.core.metadata import Metadata
from point_cloud_tpu_torch.core.point import PointBatch
from point_cloud_tpu_torch.io.ply import write_ply
from point_cloud_tpu_torch.parallel.multihost import (
    convert_sharded,
    merge_stores,
    worker_file_shard,
)

def random_batch(n, seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-80, 80, (n, 3)).astype(np.float32)
    col = rng.integers(0, 256, (n, 4), dtype=np.uint8)
    col[:, 3] = 255
    return PointBatch(pos, col)


def region_batch(n, seed, lo, hi):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    col = rng.integers(0, 256, (n, 4), dtype=np.uint8)
    col[:, 3] = 255
    return PointBatch(pos, col)


def build_store(tmp, name, batch):
    from point_cloud_tpu_torch.convert.converter import Converter

    out = tmp / name
    with Converter(Metadata(), out) as conv:
        conv.add_points_batch(batch)
    return out


def cell_files(store):
    return sorted(store.rglob("c_*.bin"))


def point_multiset_rows(store):
    metadata = Metadata.from_path(store / "metadata.json")
    recs = []
    for h in range(metadata.hierarchies):
        hdir = store / f"h_{h}"
        if not hdir.exists():
            continue
        for p in sorted(hdir.iterdir()):
            pts = Cell.from_path(p).all_points()
            if len(pts):
                recs.append(np.concatenate(
                    [pts.positions.view(np.uint8).reshape(len(pts), 12),
                     pts.colors], axis=1
                ))
    allr = np.concatenate(recs)
    order = np.lexsort(tuple(allr[:, i] for i in range(15, -1, -1)))
    return allr[order]


def store_point_count(store):
    metadata = Metadata.from_path(store / "metadata.json")
    total = 0
    for h in range(metadata.hierarchies):
        hdir = store / f"h_{h}"
        if hdir.exists():
            for p in hdir.iterdir():
                total += Cell.from_path(p).total_number_of_points
    return metadata, total


class TestMultiHost:
    def test_shard_partition_is_complete_and_disjoint(self, tmp_path):
        paths = [tmp_path / f"f{i}.ply" for i in range(7)]
        shards = [worker_file_shard(paths, i, 3) for i in range(3)]
        all_files = sorted(p for s in shards for p in s)
        assert all_files == sorted(paths)
        assert sum(len(s) for s in shards) == 7

    def test_sharded_build_and_merge(self, tmp_path):
        # 4 input files, 2 workers, tree-merged into one store
        batches = [random_batch(2_000, seed=60 + i) for i in range(4)]
        files = []
        for i, b in enumerate(batches):
            f = tmp_path / f"cloud{i}.ply"
            write_ply(f, b)
            files.append(f)

        staging = tmp_path / "staging"
        stores = [
            convert_sharded(files, staging, w, 2, batch_size=3_000)
            for w in range(2)
        ]
        for s in stores:
            assert (s / "metadata.json").exists()

        dest = tmp_path / "final"
        merge_stores(stores, dest, batch_size=3_000)
        metadata, total = store_point_count(dest)
        assert metadata.number_of_points == 8_000
        assert total == 8_000
        # merged bbox covers all points
        all_pos = np.concatenate([b.positions for b in batches])
        np.testing.assert_array_equal(
            metadata.bounding_box.min, all_pos.min(axis=0)
        )
        np.testing.assert_array_equal(
            metadata.bounding_box.max, all_pos.max(axis=0)
        )

    def test_merge_is_resumable(self, tmp_path):
        a = random_batch(1_500, seed=70)
        b = random_batch(1_500, seed=71)
        fa, fb = tmp_path / "a.ply", tmp_path / "b.ply"
        write_ply(fa, a)
        write_ply(fb, b)
        sa = convert_sharded([fa, fb], tmp_path / "st", 0, 2)
        sb = convert_sharded([fa, fb], tmp_path / "st", 1, 2)
        dest = tmp_path / "final"
        merge_stores([sa], dest)  # "crash" between merges
        merge_stores([sb], dest)  # resume with the second store
        metadata, total = store_point_count(dest)
        assert metadata.number_of_points == 3_000
        assert total == 3_000

    def test_merged_points_equal_single_host(self, tmp_path):
        """The merged store holds exactly the point multiset a single-host
        conversion of the same files produces (byte-identity of the stores
        is NOT expected — overflow flush timing is batch-dependent; see
        parallel/multihost.py docstring)."""
        from point_cloud_tpu_torch.convert.converter import convert_from_paths

        batches = [random_batch(2_500, seed=80 + i) for i in range(4)]
        files = []
        for i, b in enumerate(batches):
            f = tmp_path / f"cloud{i}.ply"
            write_ply(f, b)
            files.append(f)

        # 2-worker shard + merge
        staging = tmp_path / "staging"
        stores = [
            convert_sharded(files, staging, w, 2, batch_size=2_000)
            for w in range(2)
        ]
        merged = tmp_path / "merged"
        merge_stores(stores, merged, batch_size=2_000)

        # single-host conversion of the same files
        single = tmp_path / "single"
        convert_from_paths(files, single, batch_size=2_000)

        def point_multiset(store):
            metadata = Metadata.from_path(store / "metadata.json")
            recs = []
            for h in range(metadata.hierarchies):
                hdir = store / f"h_{h}"
                if not hdir.exists():
                    continue
                for p in sorted(hdir.iterdir()):
                    pts = Cell.from_path(p).all_points()
                    recs.append(np.concatenate(
                        [pts.positions.view(np.uint8).reshape(len(pts), 12),
                         pts.colors], axis=1
                    ))
            allr = np.concatenate(recs)
            order = np.lexsort(tuple(allr[:, i] for i in range(15, -1, -1)))
            return allr[order]

        a = point_multiset(merged)
        b = point_multiset(single)
        assert len(a) == len(b) == 10_000
        np.testing.assert_array_equal(a, b)

        ma = Metadata.from_path(merged / "metadata.json")
        mb = Metadata.from_path(single / "metadata.json")
        assert ma.number_of_points == mb.number_of_points
        np.testing.assert_array_equal(
            ma.bounding_box.min, mb.bounding_box.min
        )
        np.testing.assert_array_equal(
            ma.bounding_box.max, mb.bounding_box.max
        )


class TestCellLevelMerge:
    """The cone-disjoint fast path (VERDICT r3 #5): cells in cones touched
    by one input copy verbatim; only overlapping cones re-dedup."""

    def test_disjoint_stores_copy_verbatim(self, tmp_path):
        a = region_batch(3_000, 90, 0, 400)
        b = region_batch(3_000, 91, 2_000, 2_400)
        sa = build_store(tmp_path, "sa", a)
        sb = build_store(tmp_path, "sb", b)
        dest = tmp_path / "merged"
        merge_stores([sa, sb], dest)

        # every cell file is a verbatim copy of its source twin
        src_bytes = {
            p.relative_to(s): p.read_bytes()
            for s in (sa, sb) for p in cell_files(s)
        }
        dst = {p.relative_to(dest): p.read_bytes() for p in cell_files(dest)}
        assert dst == src_bytes

        metadata = Metadata.from_path(dest / "metadata.json")
        assert metadata.number_of_points == 6_000
        all_pos = np.concatenate([a.positions, b.positions])
        np.testing.assert_array_equal(
            metadata.bounding_box.min, all_pos.min(axis=0))
        np.testing.assert_array_equal(
            metadata.bounding_box.max, all_pos.max(axis=0))

        from point_cloud_tpu_torch.validate import validate_store
        report = validate_store(dest)
        assert report.ok, report.issues

    def test_partial_overlap_multiset_and_fsck(self, tmp_path):
        # dense: force multi-hierarchy cascades inside the overlap
        a = region_batch(6_000, 92, 0, 90)       # cones around origin
        b = region_batch(6_000, 93, 60, 1_060)   # overlaps a, extends out
        sa = build_store(tmp_path, "sa", a)
        sb = build_store(tmp_path, "sb", b)
        dest = tmp_path / "merged"
        merge_stores([sa, sb], dest)

        metadata = Metadata.from_path(dest / "metadata.json")
        assert metadata.number_of_points == 12_000

        # exact union multiset
        inputs = np.concatenate([
            np.concatenate(
                [x.positions.view(np.uint8).reshape(len(x), 12),
                 x.colors], axis=1)
            for x in (a, b)
        ])
        order = np.lexsort(tuple(inputs[:, i] for i in range(15, -1, -1)))
        np.testing.assert_array_equal(
            point_multiset_rows(dest), inputs[order])

        # cells of sb-only cones copied verbatim
        from point_cloud_tpu_torch.parallel.multihost import (
            _cone_of, _scan_store,
        )
        _, cells_a = _scan_store(sa)
        _, cells_b = _scan_store(sb)
        cones_a = {_cone_of(h, i) for h, i, _ in cells_a}
        solo = [(h, i, p) for h, i, p in cells_b
                if _cone_of(h, i) not in cones_a]
        assert solo, "fixture regression: no disjoint cone in sb"
        for h, i, p in solo:
            twin = dest / p.relative_to(sb)
            assert twin.read_bytes() == p.read_bytes()

        from point_cloud_tpu_torch.validate import validate_store
        report = validate_store(dest)
        assert report.ok, report.issues

    def test_merge_into_existing_dest_keeps_base_cells(self, tmp_path):
        a = region_batch(2_000, 94, 0, 300)
        b = region_batch(2_000, 95, 5_000, 5_300)
        dest = build_store(tmp_path, "dest", a)
        before = {p.relative_to(dest): p.read_bytes()
                  for p in cell_files(dest)}
        sb = build_store(tmp_path, "sb", b)
        merge_stores([sb], dest)

        after = {p.relative_to(dest): p.read_bytes()
                 for p in cell_files(dest)}
        for rel, data in before.items():  # base cells untouched
            assert after[rel] == data
        metadata = Metadata.from_path(dest / "metadata.json")
        assert metadata.number_of_points == 4_000

        from point_cloud_tpu_torch.validate import validate_store
        report = validate_store(dest)
        assert report.ok, report.issues

    def test_config_mismatch_rejected(self, tmp_path):
        from point_cloud_tpu_torch.convert.converter import Converter
        from point_cloud_tpu_torch.core.metadata import MetadataConfig

        sa = build_store(tmp_path, "sa", region_batch(500, 96, 0, 100))
        out = tmp_path / "sb"
        meta = Metadata()
        meta.config = MetadataConfig(max_cell_size=500.0)
        with Converter(meta, out) as conv:
            conv.add_points_batch(region_batch(500, 97, 0, 100))
        with pytest.raises(ValueError, match="different configs"):
            merge_stores([sa, out], tmp_path / "merged")


def store_bytes(store):
    return {str(p.relative_to(store)): p.read_bytes()
            for p in sorted(store.rglob("*")) if p.is_file()}


class TestAgainstReference:
    """The port's shard, staging conversion and merge against the
    reference's on the same files and staging stores."""

    def test_worker_file_shard_matches_reference(self, tmp_path):
        from point_cloud_tpu.parallel.multihost import (
            worker_file_shard as ref_shard,
        )

        paths = [tmp_path / f"f{i}.ply" for i in (3, 0, 6, 1, 5, 2, 4)]
        for n_workers in (1, 2, 3, 8):
            for w in range(n_workers):
                assert (worker_file_shard(paths, w, n_workers)
                        == ref_shard(paths, w, n_workers))
        with pytest.raises(ValueError, match="out of range"):
            worker_file_shard(paths, 2, 2)

    @pytest.mark.parametrize("lo_b,hi_b", [(-80, 80), (60, 1_060),
                                           (5_000, 5_300)])
    def test_merged_store_bytes_equal_reference(self, tmp_path, lo_b, hi_b):
        """Overlapping, partly overlapping and disjoint staging stores:
        the port's merge writes the reference merge's bytes, and its
        staging conversion the reference's."""
        from point_cloud_tpu.parallel.multihost import (
            convert_sharded as ref_convert, merge_stores as ref_merge,
        )

        files = []
        for i, (lo, hi) in enumerate([(-80, 80), (lo_b, hi_b),
                                      (-80, 80), (lo_b, hi_b)]):
            f = tmp_path / f"cloud{i}.ply"
            write_ply(f, region_batch(2_000, 300 + i, lo, hi))
            files.append(f)
        stores = [convert_sharded(files, tmp_path / "st", w, 2,
                                  batch_size=1_500) for w in range(2)]
        ref_stores = [ref_convert(files, tmp_path / "ref_st", w, 2,
                                  batch_size=1_500) for w in range(2)]
        for a, b in zip(stores, ref_stores):
            assert store_bytes(a) == store_bytes(b)
        merge_stores(stores, tmp_path / "port", batch_size=1_500)
        ref_merge(stores, tmp_path / "ref", batch_size=1_500)
        port, ref = store_bytes(tmp_path / "port"), store_bytes(
            tmp_path / "ref")
        assert port and port == ref

    def test_merge_with_native_factory_equals_host(self, tmp_path):
        """The merge's re-dedup through the port's C++ engine writes the
        host Converter's bytes."""
        from point_cloud_tpu_torch.convert.native import NativeConverter

        sa = build_store(tmp_path, "sa", region_batch(4_000, 98, 0, 90))
        sb = build_store(tmp_path, "sb", region_batch(4_000, 99, 60, 600))
        merge_stores([sa, sb], tmp_path / "host", batch_size=2_000)
        merge_stores([sa, sb], tmp_path / "native", batch_size=2_000,
                     converter_factory=NativeConverter)
        assert store_bytes(tmp_path / "host") == store_bytes(
            tmp_path / "native")
