"""The port's copy of the host layer against the reference's.

The port carries its own store format (``core/``), readers (``io/``), C++
engine binding (``native/``), host converters and synthetic cloud. Each
copy must give the reference's results: the same bytes for every cell,
metadata file and JSON value, the same arrays from every reader, the
same stores from the copied ``Converter`` and ``NativeConverter``.
Inputs are seeded numpy arrays at small sizes. One test holds the port's
atomic cell write under concurrent writers of one cell.
"""

import re
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from point_cloud_tpu import convert as rconvert
from point_cloud_tpu import io as rio
from point_cloud_tpu.convert import native as rnative
from point_cloud_tpu.core import cell as rcell
from point_cloud_tpu.core import json_compat as rjson
from point_cloud_tpu.core import metadata as rmeta
from point_cloud_tpu.core import point as rpoint
from point_cloud_tpu.io import las as rlas
from point_cloud_tpu.io import ply as rply
from point_cloud_tpu_torch import io as tio
from point_cloud_tpu_torch import native as tnative_lib
from point_cloud_tpu_torch.convert import converter as tconverter
from point_cloud_tpu_torch.convert import native as tnative
from point_cloud_tpu_torch.core import cell as tcell
from point_cloud_tpu_torch.core import json_compat as tjson
from point_cloud_tpu_torch.core import metadata as tmeta
from point_cloud_tpu_torch.core import point as tpoint

REPO = Path(__file__).resolve().parent.parent
LAZ_DATA = REPO / "tests" / "data" / "laz"


def cloud(n, seed, lo=-50.0, hi=50.0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    col = rng.integers(0, 256, (n, 4), dtype=np.uint8)
    return pos, col


def store_files(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def read_all(reader, step=777):
    batches = []
    while reader.remaining_points() > 0:
        batches.append(reader.get_batch(step))
    pos = np.concatenate([b.positions for b in batches])
    col = np.concatenate([b.colors for b in batches])
    return pos, col


def assert_same_reads(ref_reader, port_reader):
    assert port_reader.total_points() == ref_reader.total_points()
    rp, rc = read_all(ref_reader)
    pp, pc = read_all(port_reader)
    assert np.array_equal(pp.view(np.uint32), rp.view(np.uint32))
    assert np.array_equal(pc, rc)


# --- store format --------------------------------------------------------


def test_point_batch_bytes_match_reference():
    pos, col = cloud(5000, seed=1)
    pos[:3] = [[np.nan, -0.0, np.inf], [3.4e38, -1e-45, 0.0], [1, 2, 3]]
    ref = rpoint.PointBatch(pos, col).to_bytes()
    port = tpoint.PointBatch(pos, col)
    assert port.to_bytes() == ref
    back = tpoint.PointBatch.from_bytes(ref)
    assert np.array_equal(back.positions.view(np.uint32), pos.view(np.uint32))
    assert np.array_equal(back.colors, col)


CELL_CASES = {
    "sparse": dict(n=3000, lo=0.0, hi=1000.0, limit=5000),
    "dense": dict(n=6000, lo=0.0, hi=4.0, limit=5000),
    "overflow_flush": dict(n=6000, lo=0.0, hi=1.0, limit=40),
}


def fill_cell(mod_cell, mod_meta, mod_point, case, seed):
    """A hierarchy-0 cell after two batches, with its flushed groups."""
    config = mod_meta.MetadataConfig(
        cell_point_overflow_limit=case["limit"])
    size = config.cell_size(0)
    cell = mod_cell.Cell(mod_cell.CellId(0, (0, 0, 0)),
                         config.sub_cell_size(size), size,
                         config.cell_pos(np.zeros(3, np.int32), size))
    flushed = []
    for k in range(2):
        pos, col = cloud(case["n"], seed + k, case["lo"], case["hi"])
        losers = cell.add_points(mod_point.PointBatch(pos, col))
        next_idx = config.cell_index(losers.positions,
                                     config.cell_size(1))
        keys = sorted({tuple(r) for r in next_idx.tolist()})
        grouped = {key: losers[np.all(next_idx == key, axis=1)]
                   for key in keys}
        out = cell.add_points_in_overflow(grouped, config)
        flushed.append({key: out[key].to_bytes() for key in sorted(out)})
    return cell, flushed


@pytest.mark.parametrize("name", sorted(CELL_CASES))
def test_cell_codec_matches_reference(name):
    case = CELL_CASES[name]
    ref, ref_flushed = fill_cell(rcell, rmeta, rpoint, case, seed=11)
    port, port_flushed = fill_cell(tcell, tmeta, tpoint, case, seed=11)
    data = ref.to_bytes()
    assert port.to_bytes() == data
    assert port_flushed == ref_flushed
    # each package decodes the other's bytes to the same cell
    assert tcell.Cell.from_bytes(data).to_bytes() == data
    assert rcell.Cell.from_bytes(port.to_bytes()).to_bytes() == data


def origin_cell(limit=5_000):
    """An empty hierarchy-0 port cell at the origin, and its config."""
    config = tmeta.MetadataConfig(cell_point_overflow_limit=limit)
    size = config.cell_size(0)
    return config, tcell.Cell(tcell.CellId(0, (0, 0, 0)),
                              config.sub_cell_size(size), size,
                              config.cell_pos(np.zeros(3, np.int32), size))


def batch(n, seed, lo=0.0, hi=4.0):
    return tpoint.PointBatch(*cloud(n, seed, lo, hi))


def counted_cell(case):
    """A port cell brought along one path that builds or changes it; each
    case checks that its path ran."""
    if case == "from_bytes":
        cell, _ = fill_cell(tcell, tmeta, tpoint, CELL_CASES["sparse"], 5)
        cell = tcell.Cell.from_bytes(cell.to_bytes())
        assert cell.number_of_points and cell.number_of_overflow_points
        return cell
    if case == "displacements":
        _, cell = origin_cell()
        for seed in (3, 4):
            cell.add_points(batch(4_000, seed, hi=200.0))
        assert any(not seg.valid.all() for seg in cell._segments)
        return cell
    if case == "overflow":
        config, cell = origin_cell(limit=40)
        cell.add_points(batch(500, 6))
        staged = [{(0, 0, 0): 10, (1, 0, 0): 50, (2, 0, 0): 30},
                  {(0, 0, 0): 10, (1, 0, 0): 5, (2, 0, 0): 20}]
        for k, groups in enumerate(staged):
            cell.add_points_in_overflow(
                {key: batch(n, 100 * k + key[0]) for key, n in groups.items()},
                config)
        # (0,0,0) staged then appended; (1,0,0) tombstoned at once;
        # (2,0,0) staged, then flushed and tombstoned
        assert len(cell.overflow[(0, 0, 0)].chunks) == 2
        assert cell.overflow[(1, 0, 0)] is None
        assert cell.overflow[(2, 0, 0)] is None
        return cell
    if case == "compact":
        _, cell = origin_cell()
        for seed in range(tcell._MAX_SEGMENTS + 1):
            cell.add_points(batch(300, 20 + seed, hi=200.0))
        assert len(cell._segments) == 1 and cell._segments[0].valid.all()
        return cell
    assert case == "out_of_range"
    _, cell = origin_cell()
    for seed in (7, 8):
        cell.add_points(batch(200, seed, 1e8, 1e8 + 1e6))
    cell.add_points(batch(200, 9))
    assert cell._out_of_range
    return cell


@pytest.mark.parametrize("case", ["from_bytes", "displacements", "overflow",
                                  "compact", "out_of_range"])
def test_cell_counters_count_its_points(case):
    """The header counters the renderer's gather reads in O(1) count every
    point ``all_points()`` returns."""
    cell = counted_cell(case)
    n = cell.number_of_points + cell.number_of_overflow_points
    assert n == len(cell.all_points()) > 0


@pytest.mark.parametrize("case", ["from_bytes", "displacements", "overflow",
                                  "compact", "out_of_range"])
def test_cell_point_columns_are_all_points(case):
    """The renderer's read of a cell's positions and colors gives the
    arrays ``all_points()`` gives, in its order."""
    cell = counted_cell(case)
    positions, colors = cell.point_columns()
    points = cell.all_points()
    assert np.array_equal(np.concatenate(positions), points.positions)
    assert np.array_equal(np.concatenate(colors), points.colors)


def test_gather_leaves_out_a_cell_of_tombstones():
    """A cell whose overflow holds only tombstones has no point: the
    gather leaves it out by its counters."""
    from types import SimpleNamespace

    from point_cloud_tpu_torch.render.camera import Camera
    from point_cloud_tpu_torch.render.renderer import PointRenderer

    config, tomb = origin_cell(limit=40)
    tomb.add_points_in_overflow({(0, 0, 0): batch(50, 1)}, config)
    assert tomb.overflow == {(0, 0, 0): None}
    assert len(tomb.all_points()) == 0
    _, full = origin_cell()
    full.id = tcell.CellId(0, (1, 0, 0))
    full.add_points(batch(100, 2))
    renderer = PointRenderer(tmeta.Metadata(), device="cpu")
    streamer = SimpleNamespace(loaded={tomb.id: tomb, full.id: full})
    gathered = renderer.gather_points(streamer, Camera())
    assert [c[3] for c in gathered] == [full]


METADATA_BOXES = [
    ([-1.5, 0.1, -0.0], [2.25, 1e-7, 3.4e38]),
    ([1e-45, -1e20, 123456.79], [7.0, 1e20, 123456.8]),
    ([-299.95236, -0.3, 5.0], [299.99805, 0.3333333, 40.0]),
]


@pytest.mark.parametrize("box", range(len(METADATA_BOXES)))
def test_metadata_json_matches_reference(tmp_path, box):
    lo, hi = (np.asarray(v, np.float32) for v in METADATA_BOXES[box])
    fields = dict(number_of_points=12345 + box, hierarchies=3 + box,
                  name=f"cloud \"{box}\"\n")
    config = dict(cell_point_overflow_limit=40 * (box + 1),
                  sub_grid_dimension=96 + box, max_cell_size=1000.0 / 3)
    ref = rmeta.Metadata(bounding_box=rmeta.Aabb(lo, hi),
                         config=rmeta.MetadataConfig(**config), **fields)
    port = tmeta.Metadata(bounding_box=tmeta.Aabb(lo, hi),
                          config=tmeta.MetadataConfig(**config), **fields)
    text = ref.dumps()
    assert port.dumps() == text
    port.write_to_path(tmp_path / "metadata.json")
    assert (tmp_path / "metadata.json").read_text() == text
    assert tmeta.Metadata.loads(text).dumps() == text
    assert tmeta.Metadata.from_path(tmp_path / "metadata.json").dumps() == text


@pytest.mark.parametrize("value", [
    0.1, 1e-7, 3.4e38, -0.0, 1e21, 1e-45, 123456.789, 2.0**60, float("nan"),
])
def test_json_compat_matches_reference(value):
    doc = {"f64": value, "list": [value, -value, 1, "aé\n"],
           "nested": {"empty": [], "obj": {}}}
    assert tjson.dumps_pretty(doc) == rjson.dumps_pretty(doc)
    assert tjson.format_f32(value) == rjson.format_f32(value)
    assert tjson.format_f64(value) == rjson.format_f64(value)
    f32 = {"v": tjson.F32(np.float32(value))}
    assert tjson.dumps_pretty(f32) == rjson.dumps_pretty(
        {"v": rjson.F32(np.float32(value))})


# --- readers -------------------------------------------------------------


@pytest.mark.parametrize("encoding", ["binary_little_endian",
                                      "binary_big_endian", "ascii"])
@pytest.mark.parametrize("color,double_pos", [(True, False), (False, False),
                                              (True, True)])
def test_ply_reader_and_writer_match_reference(tmp_path, encoding, color,
                                               double_pos):
    from point_cloud_tpu_torch.io import ply as tply

    pos, col = cloud(3000, seed=4)
    ref_path, port_path = tmp_path / "ref.ply", tmp_path / "port.ply"
    rply.write_ply(ref_path, rpoint.PointBatch(pos, col), encoding, color,
                   double_pos)
    tply.write_ply(port_path, tpoint.PointBatch(pos, col), encoding, color,
                   double_pos)
    assert port_path.read_bytes() == ref_path.read_bytes()
    assert_same_reads(rio.get_batched_point_reader(ref_path),
                      tio.get_batched_point_reader(ref_path))


@pytest.mark.parametrize("point_format", [0, 1, 2, 3, 6, 7, 8])
def test_las_writer_and_reader_match_reference(tmp_path, point_format):
    from point_cloud_tpu_torch.io import las as tlas

    pos, col = cloud(2500, seed=5, lo=-300.0, hi=300.0)
    ref_path, port_path = tmp_path / "ref.las", tmp_path / "port.las"
    rlas.write_las(ref_path, rpoint.PointBatch(pos, col), point_format)
    tlas.write_las(port_path, tpoint.PointBatch(pos, col), point_format)
    assert port_path.read_bytes() == ref_path.read_bytes()
    assert_same_reads(rio.get_batched_point_reader(ref_path),
                      tio.get_batched_point_reader(ref_path))


@pytest.mark.parametrize(
    "name", sorted(p.name for p in LAZ_DATA.glob("*.la[sz]")))
def test_las_laz_fixtures_read_as_reference(name):
    """The LAS/LAZ fixtures (LAZ through the port's build of the codec)."""
    if name.endswith(".laz") and tnative_lib.load_native() is None:
        pytest.skip("no C++ toolchain for the LASzip codec")
    path = LAZ_DATA / name
    assert_same_reads(rio.get_batched_point_reader(path),
                      tio.get_batched_point_reader(path))


def test_own_store_reader_matches_reference(tmp_path):
    pos, col = cloud(20_000, seed=6, lo=-3.0, hi=3.0)
    with rconvert.Converter(rmeta.Metadata(), tmp_path / "store") as conv:
        conv.add_points_batch(rpoint.PointBatch(pos, col))
    meta = tmp_path / "store" / "metadata.json"
    assert_same_reads(rio.get_batched_point_reader(meta),
                      tio.get_batched_point_reader(meta))


# --- host converters -------------------------------------------------------


@pytest.mark.parametrize("which", ["Converter", "NativeConverter"])
def test_copied_converters_match_reference(tmp_path, which):
    if which == "NativeConverter" and tnative_lib.load_native() is None:
        pytest.skip("no C++ toolchain for the engine")
    pos, col = cloud(30_000, seed=7, lo=-20.0, hi=20.0)
    src = tmp_path / "cloud.ply"
    rply.write_ply(src, rpoint.PointBatch(pos, col))
    ref_factory = {"Converter": rconvert.Converter,
                   "NativeConverter": rnative.NativeConverter}[which]
    port_factory = {"Converter": tconverter.Converter,
                    "NativeConverter": tnative.NativeConverter}[which]
    for _ in range(2):  # the second pass merges into the existing store
        rconvert.convert_from_paths([src], tmp_path / "ref", batch_size=7000,
                                    cache_size=8,
                                    converter_factory=ref_factory)
        tconverter.convert_from_paths([src], tmp_path / "port",
                                      batch_size=7000, cache_size=8,
                                      converter_factory=port_factory)
    ref = store_files(tmp_path / "ref")
    assert len(ref) > 3 and store_files(tmp_path / "port") == ref


def test_native_library_is_the_ports_own_build():
    lib = tnative_lib.load_native()
    if lib is None:
        pytest.skip("no C++ toolchain for the engine")
    path = Path(lib._name)
    assert path.parent == REPO / "point_cloud_tpu_torch" / "_build"
    assert re.fullmatch(r"libpcnative_[0-9a-f]{16}\.so", path.name)
    assert tnative_lib.hex_lockstep_ok()


def test_synth_cloud_matches_bench():
    sys.path.insert(0, str(REPO))
    from bench import synth_cloud as bench_synth_cloud
    from point_cloud_tpu_torch.models.synth import synth_cloud

    for n, seed in [(1000, 0), (4097, 3)]:
        got, ref = synth_cloud(n, seed), bench_synth_cloud(n, seed)
        assert got.dtype == np.float32 and got.shape == (n, 3)
        assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))


# --- atomic cell writes ------------------------------------------------------


def test_concurrent_cell_writers_leave_a_complete_cell(tmp_path):
    """Writers of one cell race; the file on disk is always one writer's
    complete bytes (the reference's fixed ``{path}.tmp`` lets one writer
    publish another's half-written file), and no temp file is left."""
    cells = []
    for k in range(6):
        cell, _ = fill_cell(tcell, tmeta, tpoint,
                            dict(n=2000 + 500 * k, lo=0.0, hi=1000.0,
                                 limit=5000), seed=20 + k)
        cells.append(cell)
    complete = {cell.to_bytes() for cell in cells}
    assert len(complete) == len(cells)
    path = tmp_path / "c_0_0_0.bin"
    errors = []
    start = threading.Barrier(len(cells))

    def writer(cell):
        try:
            start.wait(timeout=30)
            for _ in range(30):
                cell.write_to_path(path)
                if path.read_bytes() not in complete:
                    errors.append("torn cell file")
        except Exception as err:  # reported by the main thread
            errors.append(repr(err))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=writer, args=(c,)) for c in cells]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert path.read_bytes() in complete
    assert [p.name for p in tmp_path.iterdir()] == [path.name]
