"""The harness: cells resolve by name, inputs come from the seed at the
configured sizes, the metric arithmetic, and the import rules."""

from __future__ import annotations

import ast
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest

from bench_port import gen, spec, stats
from bench_port.runners import orbit
from bench_port.run import FORBIDDEN_MODULES, forbidden_imports
from conftest import small_config

HERE = Path(spec.__file__).resolve().parent


def test_every_cell_resolves_by_name(bench):
    cells = {w["name"] for w in bench["workloads"]}
    for w in bench["workloads"]:
        cfg = spec.config(bench, w["config"])
        assert cfg["name"] == w["config"]
        mix = spec.traffic(w["traffic"])
        assert hasattr(spec.runner(mix), "run")
        e2e = spec.metrics_for(bench, w["name"], traced=False)
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2
        per_layer = spec.metrics_for(bench, w["name"], traced=True)
        assert per_layer and {m["moves"] for m in per_layer} <= names
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]))
        assert set(m.get("workloads", [])) <= cells
    for m in bench["per_layer"]:
        moved = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
        assert set(m.get("workloads", [])) <= \
            set(moved.get("workloads", cells))


def test_benchmark_file_shape():
    bench = spec.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["bench_port"]
    for c in bench["configs"]:
        assert (spec.ROOT / c["file"]).is_file()
        assert c["file"].startswith("bench_port/")
    assert all(w["chips"] == 1 for w in bench["workloads"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in bench["end_to_end"])


def test_aerial_tile_is_deterministic_and_sized(bench):
    scene = spec.config(bench, "aerial_ql1")["scene"]
    a = gen.input_fields(scene, 2**33 + 5, 1)
    b = gen.input_fields(scene, 2**33 + 5, 1)
    c = gen.input_fields(scene, 2**33 + 6, 1)
    assert len(a["raw"]) == gen.input_points(scene) == 9_608_000
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert not np.array_equal(a["raw"], c["raw"])
    # QL1 counts pulses: one first or single return each, 8 a square metre
    first = (a["returns"] & 0x0F) == 1
    assert int(first.sum()) == 8 * 1000 * 1000
    assert int((a["returns"] == 0x32).sum()) == 804_000
    assert int((a["returns"] == 0x33).sum()) == 804_000
    pos, _ = gen.decoded(scene, a)
    assert pos.min(axis=0)[0] >= -500 and pos.max(axis=0)[0] < 500


def test_a_block_of_tiles_decodes_in_order(bench):
    scene = dict(spec.config(bench, "aerial_ql1")["scene"], tile_m=40.0)
    pos, col = gen.decoded_inputs(scene, 11, [0, 1, 3])
    parts = [gen.decoded(scene, gen.input_fields(scene, 11, i))
             for i in (0, 1, 3)]
    assert len(pos) == 3 * gen.input_points(scene) == 3 * 15_373
    np.testing.assert_array_equal(pos, np.concatenate([p for p, _ in parts]))
    np.testing.assert_array_equal(col, np.concatenate([c for _, c in parts]))
    steps = pos.astype(np.float64) / 0.01  # on the LAS scale's grid
    assert np.abs(steps - steps.round()).max() < 1e-2


# sha256 of the small scene's tiles (fields by name: name, dtype, shape,
# bytes): the aerial inputs every recorded measurement was taken on, which
# a change to the harness must leave byte for byte
AERIAL_SHA256 = {
    (7, 0): "82070cbe05185bcc230174be88dc3983e84c3cbdbb529929e163b3af615fa65e",
    (7, 3): "297a873e6a64eb153f6ae5d2a5191224c143ef6e409df2f1c94073299b74e26c",
    (2**33 + 5, 0):
        "4a1f0868c506e625be251b40c7006b2ea5c4df5395d4cc5de11c228231378b9e",
    (2**33 + 5, 3):
        "01f66e9828fd9fbb3b2720bfa59abb4ff89f9a4eaa2a5ade787403d2776f3c2e",
}


def _sha256(fields: dict) -> str:
    h = hashlib.sha256()
    for name in sorted(fields):
        a = np.ascontiguousarray(fields[name])
        h.update(f"{name}:{a.dtype.str}:{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("seed,tile", sorted(AERIAL_SHA256))
def test_aerial_tiles_keep_their_bytes(bench, seed, tile):
    cfg = small_config(bench, "aerial_ql1")
    fields = gen.input_fields(cfg["scene"], seed, tile)
    assert _sha256(fields) == AERIAL_SHA256[seed, tile]


def test_every_scene_provides_the_interface(bench):
    kinds = sorted(p.stem for p in (HERE / "scenes").glob("*.py"))
    assert "aerial_tiles" in kinds
    for kind in kinds:
        module = spec.scene(kind)
        for name in ("fields", "decoded", "points", "small"):
            assert callable(getattr(module, name, None)), (kind, name)
    for c in bench["configs"]:
        cfg = spec.config(bench, c["name"])
        assert cfg["scene"]["kind"] in kinds
        cut = small_config(bench, c["name"])
        assert cut["metadata"] == cfg["metadata"]
        assert cut["scene"]["kind"] == cfg["scene"]["kind"]
        assert gen.input_points(cut["scene"]) < \
            gen.input_points(cfg["scene"])


def test_an_unknown_scene_kind_names_its_file():
    with pytest.raises(ValueError, match=r"bench_port/scenes/no_such\.py"):
        gen.input_fields({"kind": "no_such"}, 1, 0)


def test_the_checks_run_over_every_orbit_cell(monkeypatch):
    from test_bench_port_checks import CELLS, orbit_cells

    assert "aerial_ql1.orbit" in CELLS
    # a second orbit cell joins the checks by its entry alone; a cell of
    # another runner does not, since the faults break the orbit's renderer
    runners = {"orbit": "orbit", "slow_orbit": "orbit", "convert": "convert"}
    monkeypatch.setattr(spec, "traffic",
                        lambda name: {"runner": runners[name]})
    bench = {"workloads": [
        {"name": "a.orbit", "traffic": "orbit"},
        {"name": "a.convert", "traffic": "convert"},
        {"name": "b.slow_orbit", "traffic": "slow_orbit"},
    ]}
    assert orbit_cells(bench) == ["a.orbit", "b.slow_orbit"]


def test_p95_is_the_nearest_rank():
    values = [5.0, 1.0, 9.0, 3.0, 7.0, 2.0, 8.0, 4.0, 6.0, 10.0] * 2
    # 20 values: the 19th smallest (ceil(0.95 * 20) = 19) is 10
    assert stats.p95(values) == 10.0
    assert stats.p95(list(range(1, 101))) == 95
    assert stats.p95([]) is None


def test_rates_take_all_work_over_all_time():
    run = {"window": (2.0, 4.5), "frames": 10}
    assert spec.reader("frame_ms")(run) == pytest.approx(250.0)


def test_roofline_counts_bytes_and_operations():
    trace = {"busy_s": 1e-6, "window_s": 1e-3}
    expect = 100.0 * max(16_000 / 3.35e12, 5e6 / 67e12) / 1e-6
    assert stats.roofline_pct(16_000, 5e6, trace) == pytest.approx(expect)
    assert stats.idle_pct(trace) == pytest.approx(99.9)
    assert stats.roofline_pct(0, 0, trace) is None
    # a frame of 100 rows in, one bucket ranked into (1, 5) with 10 and 20
    landings = [([(0, (1, 5), 3, "excl")], np.array([30, 10, 20]))]
    done = [(0.0, {"points_in": 100})]
    w = orbit._frame_work(done, landings, 8, 4)
    frags = 10 * 1 + 20 * 25
    assert w["bytes"] == 66 * 100 + 11 * 32 + 28 * 30 + 16 * min(frags, 32)
    assert w["ops"] == orbit.K1_OPS_PER_ROW * 100 + \
        orbit.K2_OPS_PER_FRAGMENT * frags


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_nothing_imports_jax_or_the_jax_package():
    banned = FORBIDDEN_MODULES | {"bench", "chip_smoke"}
    for path in HERE.rglob("*.py"):
        assert not _imports(path) & banned, path
    yardstick = [HERE / "gen.py", *(HERE / "reference").rglob("*.py"),
                 *(HERE / "scenes").rglob("*.py")]
    for path in yardstick:
        assert "point_cloud_tpu_torch" not in _imports(path), path


def test_forbidden_names_compare_whole(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "point_cloud_tpu_torch_x",
                        types.ModuleType("point_cloud_tpu_torch_x"))
    assert "point_cloud_tpu" not in forbidden_imports()
    monkeypatch.setitem(sys.modules, "point_cloud_tpu.core",
                        types.ModuleType("point_cloud_tpu.core"))
    assert forbidden_imports() == ["point_cloud_tpu"]


def test_traffic_files_are_data(bench):
    for w in bench["workloads"]:
        path = HERE / "traffic" / f"{w['traffic']}.json"
        mix = json.loads(path.read_text())
        assert (HERE / "runners" / f"{mix['runner']}.py").is_file()
        assert mix["limits"]
