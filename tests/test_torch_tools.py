"""The port's host tools against the reference's, on the same inputs.

- ``validate_store``: the same report on a sound store and on each
  corruption of tests/test_validate.py, and the same CLI exit codes.
- ``export_store``: PLY (binary and ascii), LAS at every point format the
  reference writes, and LAZ, byte-identical to the reference's files; the
  same refusals.
- ``EventBus`` and ``InputState``: the same results for the same calls.
- ``InteractiveConverter``: a run leaves a store byte-identical to the
  reference's run at the same batch size, with the same per-file states
  (finished, failed, no_reader); its live feed renders in the port's
  ``Viewer`` on the CPU while the conversion runs, like the reference's
  (tests/test_viewer.py).
"""

import shutil
import struct
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from point_cloud_tpu.convert.converter import Converter
from point_cloud_tpu.core.metadata import Metadata
from point_cloud_tpu.core.point import PointBatch
from point_cloud_tpu.io.ply import write_ply


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


def batch(n, seed, lo=-200.0, hi=200.0):
    rng = np.random.default_rng(seed)
    colors = rng.integers(0, 256, (n, 4), dtype=np.uint8)
    colors[:, 3] = 255
    return PointBatch(rng.uniform(lo, hi, (n, 3)).astype(np.float32), colors)


def store_bytes(root: Path) -> dict:
    """Every file of a store directory, by relative path."""
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.fixture(scope="module")
def sound_store(tmp_path_factory):
    out = tmp_path_factory.mktemp("tools") / "store"
    with Converter(Metadata(), out) as conv:
        conv.add_points_batch(batch(20_000, seed=8))
    return out


# --- validate -------------------------------------------------------------


def first_cell(store):
    return sorted((store / "h_0").glob("c_*.bin"))[0]


def corrupt_counter(store):
    path = first_cell(store)
    data = bytearray(path.read_bytes())
    struct.pack_into("<I", data, 16, struct.unpack_from("<I", data, 16)[0] + 5)
    path.write_bytes(bytes(data))


def corrupt_point(store):
    path = first_cell(store)
    data = bytearray(path.read_bytes())
    struct.pack_into("<f", data, 48, 1e7)
    path.write_bytes(bytes(data))


CORRUPTIONS = {
    "sound": lambda store: None,
    "counter": corrupt_counter,
    "misplaced": lambda store: shutil.move(first_cell(store),
                                           store / "h_0" / "c_40_40_40.bin"),
    "truncated": lambda store: first_cell(store).write_bytes(
        first_cell(store).read_bytes()[:37]),
    "foreign_point": corrupt_point,
    "orphan": lambda store: (store / "h_0" / "notes.txt").write_text("hi"),
    "junk": lambda store: first_cell(store).write_bytes(b"junk"),
    "extra_hierarchy": lambda store: shutil.copytree(store / "h_0",
                                                     store / "h_9"),
    "metadata_count": lambda store: (store / "metadata.json").write_text(
        (store / "metadata.json").read_text().replace(
            '"number_of_points": 20000', '"number_of_points": 20001')),
}


@pytest.mark.parametrize("case", sorted(CORRUPTIONS))
def test_validate_report_matches_reference(tmp_path, sound_store, case,
                                           capsys):
    from point_cloud_tpu.validate import main as rmain
    from point_cloud_tpu.validate import validate_store as rvalidate
    from point_cloud_tpu_torch.validate import main as tmain
    from point_cloud_tpu_torch.validate import validate_store as tvalidate

    store = tmp_path / "store"
    shutil.copytree(sound_store, store)
    CORRUPTIONS[case](store)
    ref, port = rvalidate(store), tvalidate(store)
    assert vars(port) == vars(ref)
    assert port.ok == (case == "sound")
    capsys.readouterr()
    codes = [rmain([str(store)]), capsys.readouterr(),
             tmain([str(store)]), capsys.readouterr()]
    assert codes[0] == codes[2] == (0 if case == "sound" else 1)
    assert codes[1] == codes[3]


def test_validate_missing_store_like_reference(tmp_path):
    from point_cloud_tpu.validate import main as rmain
    from point_cloud_tpu_torch.validate import main as tmain
    from point_cloud_tpu_torch.validate import validate_store

    with pytest.raises(FileNotFoundError):
        validate_store(tmp_path)
    assert rmain([str(tmp_path)]) == tmain([str(tmp_path)]) == 2


# --- export ---------------------------------------------------------------

EXPORTS = ([("ply", dict(encoding="binary_little_endian")),
            ("ply", dict(encoding="ascii"))]
           + [("las", dict(point_format=f)) for f in (0, 1, 2, 3, 6, 7, 8)]
           + [("laz", dict(point_format=2)), ("laz", dict(point_format=3)),
              ("las", dict(point_format=3, scale=(0.01, 0.02, 0.005)))])


@pytest.mark.parametrize("fmt,kw", EXPORTS,
                         ids=[f"{f}-{'-'.join(map(str, k.values()))}"
                              for f, k in EXPORTS])
def test_export_bytes_match_reference(tmp_path, sound_store, fmt, kw):
    from point_cloud_tpu.export import export_store as rexport
    from point_cloud_tpu_torch.export import export_store as texport

    outs = [tmp_path / f"ref.{fmt}", tmp_path / f"port.{fmt}"]
    written = [export(sound_store, out, batch_size=3_000, **kw)
               for export, out in zip((rexport, texport), outs)]
    assert written[0] == written[1] == 20_000
    assert outs[0].read_bytes() == outs[1].read_bytes()


@pytest.mark.parametrize("bad", [
    dict(fmt="xyz"), dict(point_format=5), dict(scale=(0.0, 1.0, 1.0)),
    dict(scale=(1e-9,) * 3)])
def test_export_refusals_match_reference(tmp_path, sound_store, bad):
    from point_cloud_tpu.export import export_store as rexport
    from point_cloud_tpu_torch.export import export_store as texport

    errors = []
    for export in (rexport, texport):
        out = tmp_path / "keep.las"
        out.write_bytes(b"precious")
        with pytest.raises(ValueError) as err:
            export(sound_store, out, **bad)
        assert out.read_bytes() == b"precious"
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def test_export_cli_matches_reference(tmp_path, sound_store):
    from point_cloud_tpu.export import main as rmain
    from point_cloud_tpu_torch.export import main as tmain

    for main, name in ((rmain, "ref.las"), (tmain, "port.las")):
        assert main([str(sound_store / "metadata.json"), str(tmp_path / name),
                     "--point-format", "1", "--scale", "0.01"]) == 0
    assert ((tmp_path / "ref.las").read_bytes()
            == (tmp_path / "port.las").read_bytes())


# --- EventBus and InputState ----------------------------------------------


def test_event_bus_matches_reference():
    from point_cloud_tpu.utils.events import EventBus as RBus
    from point_cloud_tpu_torch.utils.events import EventBus as TBus

    class Load(tuple):
        pass

    def run(bus):
        out = []
        bus.send(1)
        bus.dispatch("a", 2, Load((3,)), "b")
        out += [bus.peek(int), bus.peek(str), bus.drain(int), bus.drain(int)]
        bus.send(5.5)
        out += [bus.drain(Load), bus.drain(str), bus.peek(float)]
        bus.clear()
        out += [bus.drain(float), bus.drain(bytes)]
        return out

    assert run(TBus()) == run(RBus())


INPUT_SCRIPT = [
    ("key_down", "W"), ("key_down", "d"), ("sample",),
    ("cursor_moved", 10.0, 5.0), ("cursor_moved", 14.5, 2.0),
    ("button_down", "Right"), ("wheel", 2.0), ("wheel", -0.5), ("sample",),
    ("key_down", "shift"), ("key_up", "w"), ("key_down", "s"),
    ("cursor_moved", 4.0, 9.0), ("sample",), ("sample",),
    ("key_down", "space"), ("key_down", "a"), ("button_up", "right"),
    ("key_up", "D"), ("sample",),
]


def test_input_state_samples_match_reference():
    import dataclasses

    from point_cloud_tpu.viewer.input import InputState as RInput
    from point_cloud_tpu_torch.viewer.input import InputState as TInput

    samples = []
    for state in (RInput(), TInput()):
        out = []
        for op, *args in INPUT_SCRIPT:
            if op == "sample":
                out.append(dataclasses.astuple(state.sample()))
            else:
                getattr(state, op)(*args)
        samples.append(out)
    assert samples[0] == samples[1]
    assert len({s[3] for s in samples[1]}) > 1  # the cursor moved


# --- InteractiveConverter -------------------------------------------------


def interactive_run(module, files, out, batch_size, viewer=None):
    conv = module.InteractiveConverter(viewer=viewer, batch_size=batch_size)
    conv.choose_files(files)
    conv.save_at(out)
    conv.start()
    for _ in range(20_000):
        conv.update()
        if conv.state == module.ConversionState.FINISHED:
            break
    assert conv.state == module.ConversionState.FINISHED
    conv.flush()
    return [(f.path.name, f.state, f.total, f.remaining, f.error is None)
            for f in conv.progress()]


@pytest.mark.parametrize("batch_size", [10_000, 23_456])
def test_interactive_store_matches_reference(tmp_path, batch_size,
                                             monkeypatch):
    """Two files (the second overlapping the first's cloud), a bad file and
    a file without a reader: the same store, byte for byte, and the same
    per-file states as the reference's converter. A RAM cache of 4 cells
    makes the auto-save evictions write cells back mid-run."""
    from point_cloud_tpu.viewer import interactive as rint
    from point_cloud_tpu_torch.viewer import interactive as tint

    for module in (rint, tint):
        monkeypatch.setattr(module, "RAM_CACHE_LRU", 4)

    write_ply(tmp_path / "a.ply", batch(60_000, seed=15))
    write_ply(tmp_path / "b.ply", batch(25_000, seed=16, lo=-50, hi=50))
    (tmp_path / "bad.ply").write_bytes(b"not a ply at all")
    files = [tmp_path / name for name in ("a.ply", "bad.ply", "b.ply",
                                          "skip.xyz")]
    states = [interactive_run(module, files, tmp_path / name, batch_size)
              for module, name in ((rint, "ref"), (tint, "port"))]
    assert states[0] == states[1]
    assert [s[1] for s in states[1]] == ["finished", "failed", "finished",
                                         "no_reader"]
    ref, port = store_bytes(tmp_path / "ref"), store_bytes(tmp_path / "port")
    assert len(ref) > 8 and ref.keys() == port.keys()
    assert all(ref[k] == port[k] for k in ref)


def test_interactive_stop_and_new_cloud_match_reference(tmp_path):
    """Stop mid-run, resume, then a new cloud in the same converter: the
    same metadata at each step."""
    from point_cloud_tpu.viewer import interactive as rint
    from point_cloud_tpu_torch.viewer import interactive as tint

    write_ply(tmp_path / "c.ply", batch(30_000, seed=18))
    seen = []
    for module in (rint, tint):
        conv = module.InteractiveConverter(batch_size=10_000)
        conv.choose_files([tmp_path / "c.ply"])
        conv.start()
        for _ in range(3):
            conv.update()
        conv.stop()
        paused = conv.metadata.dumps()
        for _ in range(20):
            conv.update()
        assert conv.metadata.dumps() == paused
        conv.start()
        for _ in range(20_000):
            conv.update()
            if conv.state == module.ConversionState.FINISHED:
                break
        done = conv.metadata.dumps()
        conv.new_cloud()
        seen.append((paused, done, conv.metadata.dumps(), conv.state.name,
                     conv.files))
    assert seen[0] == seen[1]


def test_live_feed_renders_in_port_viewer_like_reference(tmp_path):
    """The converter feeds a live ``Viewer`` (tests/test_viewer.py): frames
    rendered during the conversion follow the cells as they grow, and the
    last one sees every point. The port's viewer on the CPU renders what
    the reference's does: the same points in, the Frames contract."""
    from point_cloud_tpu.render.renderer import RenderSettings as RSettings
    from point_cloud_tpu.viewer import Viewer as RViewer
    from point_cloud_tpu.viewer import interactive as rint
    from point_cloud_tpu_torch.render.renderer import (
        RenderSettings as TSettings,
    )
    from point_cloud_tpu_torch.viewer import Viewer as TViewer
    from point_cloud_tpu_torch.viewer import interactive as tint

    write_ply(tmp_path / "c.ply", batch(30_000, seed=19, lo=-20, hi=20))
    runs = []
    for module, viewer in (
            (rint, RViewer(RSettings(width=64, height=64))),
            (tint, TViewer(TSettings(width=64, height=64), device="cpu"))):
        try:
            conv = module.InteractiveConverter(viewer=viewer,
                                               batch_size=10_000)
            conv.choose_files([tmp_path / "c.ply"])
            conv.start()
            points_in = []
            for _ in range(5_000):
                conv.update()
                done = conv.state == module.ConversionState.FINISHED
                if viewer.stats()["cells"]["loaded"] > 0:
                    viewer.camera.look_at_aabb(conv.metadata.bounding_box)
                    rgb, depth, stats = viewer.render()
                    points_in.append(stats["points_in"])
                if done:
                    break
                time.sleep(0.001)  # yield to the batch-read thread
            assert conv.state == module.ConversionState.FINISHED
            assert points_in and points_in[-1] == 30_000
            assert (depth < 1.0).sum() > 0
            runs.append((rgb, stats["points_visible"],
                         viewer.stats()["cells"]))
        finally:
            viewer.close()
    (rgb_r, vis_r, cells_r), (rgb_t, vis_t, cells_t) = runs
    assert cells_r == cells_t and vis_r == vis_t
    assert (rgb_r == rgb_t).all(axis=2).mean() >= 0.999
