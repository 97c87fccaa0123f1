"""The checks that decide ``correct``: sound runs of the program pass them,
the control (the reference in bfloat16 in the program's place) fails
them, and so does a run whose timed path is broken underneath."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bench_port import calibrate, spec
from bench_port.reference import frame as ref_frame
from bench_port.reference import hexgrid
from bench_port.reference import store as ref_store
from bench_port.run import run_cell
from conftest import small_config, small_mix

CPU = torch.device("cpu")


def orbit_cells(bench: dict) -> list[str]:
    """The cells whose traffic mix the orbit runner runs: the broken-path
    faults below break that runner's renderer; a later runner brings its
    own."""
    return [w["name"] for w in bench["workloads"]
            if spec.traffic(w["traffic"])["runner"] == "orbit"]


CELLS = orbit_cells(spec.load_benchmark())


def _config(bench, workload):
    return small_config(bench, spec.cell(bench, workload)["config"])


def _run(bench, workload, seed=2**31 + 17, seconds=1.5):
    cfg = _config(bench, workload)
    return run_cell(workload, seed, seconds, False, CPU, bench=bench,
                    config=cfg, mix=small_mix(bench, workload))[0]


def test_store_writer_equals_a_one_batch_conversion(tmp_path):
    from point_cloud_tpu_torch.convert.converter import Converter
    from point_cloud_tpu_torch.core.metadata import Metadata, MetadataConfig
    from point_cloud_tpu_torch.core.point import PointBatch

    rng = np.random.default_rng(1)
    pos = np.concatenate([rng.uniform(-30, 30, (6000, 3)),
                          rng.normal(0, 3, (6000, 3))]).astype(np.float32)
    col = rng.integers(0, 256, (12000, 4)).astype(np.uint8)
    cfg = {"cell_point_overflow_limit": 50, "sub_grid_dimension": 8,
           "max_cell_size": 64.0}
    with Converter(Metadata(config=MetadataConfig(50, 8, 64.0)),
                   tmp_path / "a") as conv:
        conv.add_points_batch(PointBatch(pos, col))
    ref_store.build_store(tmp_path / "b", pos, col, cfg, CPU)
    a = sorted(p.relative_to(tmp_path / "a")
               for p in (tmp_path / "a").rglob("*.bin"))
    b = sorted(p.relative_to(tmp_path / "b")
               for p in (tmp_path / "b").rglob("*.bin"))
    assert a == b and len(a) > 20
    for rel in a:
        assert (tmp_path / "a" / rel).read_bytes() == \
            (tmp_path / "b" / rel).read_bytes()


@pytest.mark.parametrize("workload", CELLS)
def test_sound_runs_pass_and_the_control_fails(bench, workload):
    result = _run(bench, workload)
    assert result["correct"], result["compared"]
    assert result["attempted"] > 0
    cfg = _config(bench, workload)
    control = calibrate.control(workload, 5, CPU, cfg,
                                small_mix(bench, workload), frames=2,
                                bench=bench)
    limits = small_mix(bench, workload)["limits"]
    assert any(v > limits[k] for k, v in control.items()), control


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_frame_is_not_correct(bench, monkeypatch, workload, fault):
    from point_cloud_tpu_torch.render import renderer

    cls = renderer.PointRenderer
    if fault == "unchanged":  # every frame after the first repeats it
        finish = cls.render_finish
        first = {}

        def stale(self, handle):
            out = finish(self, handle)
            return first.setdefault(id(self), out)

        monkeypatch.setattr(cls, "render_finish", stale)
    elif fault == "half":
        gather = cls.gather_points
        monkeypatch.setattr(cls, "gather_points",
                            lambda self, s, c: gather(self, s, c)[::2])
    else:
        finish = cls.render_finish

        def altered(self, handle):
            rgb, depth, stats = finish(self, handle)
            rgb = rgb.copy()
            rgb[::9, ::9] ^= 0x20
            return rgb, depth, stats

        monkeypatch.setattr(cls, "render_finish", altered)
    assert not _run(bench, workload)["correct"]


@pytest.mark.cuda
def test_reference_frame_is_the_same_on_the_card(bench, cuda_device,
                                                 tmp_path):
    from bench_port import gen
    from bench_port.reference import view as ref_view

    cfg = small_config(bench, "aerial_ql1")
    pos, col = gen.decoded(cfg["scene"],
                           gen.input_fields(cfg["scene"], 3, 0))
    meta = ref_store.build_store(tmp_path / "s", pos, col, cfg["metadata"],
                                 cuda_device)
    cells = ref_frame.CellFiles(tmp_path / "s")
    lo = np.asarray(meta["bounding_box"]["min"], np.float32)
    hi = np.asarray(meta["bounding_box"]["max"], np.float32)
    center = (lo + hi) / np.float32(2.0)
    pose = ref_view.Pose.looking_at(center + np.float32([150, 90, 120]),
                                    center)
    visible = [c for c in ref_view.visible_cells(meta, pose, 16 / 9, 5000.0)
               if cells.exists(*c)]
    a = ref_frame.render(cells, visible, meta, pose, 320, 180, CPU)
    b = ref_frame.render(cells, visible, meta, pose, 320, 180, cuda_device)
    np.testing.assert_array_equal(a, b)
    p = torch.as_tensor(pos)
    for dev in (CPU, cuda_device):
        slot, dist = hexgrid.slots_and_dist(p.to(dev), np.float32(0.37))
        if dev == CPU:
            want = (slot, dist)
        else:
            assert torch.equal(slot.cpu(), want[0])
            assert torch.equal(dist.cpu(), want[1])
