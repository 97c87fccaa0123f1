"""The port's window layer (point_cloud_tpu_torch/viewer/window.py), headless.

The reference's cases (tests/test_window.py) on the port's ``WindowLoop``,
driven by a scripted ``FakeBackend`` with the port's ``Viewer`` on the CPU:
frames render and blit, WASD moves the camera, right-drag rotates, the
wheel sets the speed, a resize reconfigures the surface, a close request
ends the loop; the hotkeys flip the runtime settings once a press (Tk and
X11 auto-repeat filtered); the file dialogs drive the in-app converter and
the exporter, and a backend without dialogs makes them no-ops. Events that
move the camera must move it exactly as the reference's loop does.
"""

import threading
import time

import numpy as np
import pytest
import torch

from point_cloud_tpu_torch.core.metadata import Metadata
from point_cloud_tpu_torch.core.point import PointBatch
from point_cloud_tpu_torch.render.renderer import RenderSettings
from point_cloud_tpu_torch.viewer.app import Viewer
from point_cloud_tpu_torch.viewer.interactive import ConversionState
from point_cloud_tpu_torch.viewer.window import (
    WindowEvent,
    WindowLoop,
    filter_auto_repeat,
    rgb_to_ppm,
    run_window,
    translate_button,
    translate_keysym,
)


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


class FakeBackend:
    """Scripted backend: hands out queued event batches, records blits and
    titles, and answers the native dialogs it was given answers for."""

    def __init__(self, batches=None, **answers):
        self.batches = list(batches or [])
        self.blits, self.titles, self.dialog_calls = [], [], []
        self.alive = True
        self.closed = False
        for name, answer in answers.items():
            setattr(self, name, self._dialog(name, answer))

    def _dialog(self, name, answer):
        def ask(title, *filetypes):
            self.dialog_calls.append((name, title, *filetypes))
            return answer
        return ask

    def poll_events(self):
        return self.batches.pop(0) if self.batches else []

    def blit(self, rgb):
        self.blits.append(np.asarray(rgb))

    def set_title(self, title):
        self.titles.append(title)

    def close(self):
        self.closed = True
        self.alive = False


@pytest.fixture
def viewer():
    v = Viewer(RenderSettings(width=64, height=48), device="cpu")
    yield v
    v.close()


def press(loop, key):
    loop.apply_event(WindowEvent("key_down", key=key))
    loop.apply_event(WindowEvent("key_up", key=key))


def make_store(path, n, seed):
    from point_cloud_tpu_torch.convert.converter import Converter

    rng = np.random.default_rng(seed)
    with Converter(Metadata(), path) as conv:
        conv.add_points_batch(PointBatch(
            rng.uniform(-20, 20, (n, 3)).astype(np.float32),
            rng.integers(0, 256, (n, 4), dtype=np.uint8)))
    return path


def test_translations_and_ppm():
    assert [translate_keysym(k) for k in ("Shift_L", "Shift_R", "space",
                                          "W")] == ["shift", "shift",
                                                    "space", "w"]
    assert [translate_button(b) for b in (1, 3, 9)] == ["left", "right", None]
    rgb = np.arange(2 * 3 * 3, dtype=np.uint8).reshape(2, 3, 3)
    data = rgb_to_ppm(rgb)
    assert data == b"P6 3 2 255\n" + rgb.tobytes()


def test_loop_renders_and_blits(viewer):
    backend = FakeBackend()
    assert WindowLoop(viewer, backend).run(max_frames=2) == 2
    assert len(backend.blits) == 2
    assert backend.blits[0].shape == (48, 64, 3)
    assert backend.blits[0].dtype == np.uint8


CAMERA_SCRIPTS = {
    "wasd": ([[WindowEvent("key_down", key="w")]], 2, "translation"),
    "right_drag": ([[WindowEvent("button_down", button="right"),
                     WindowEvent("cursor", x=10, y=10)],
                    [WindowEvent("cursor", x=60, y=30)]], 3, "rotation"),
    "wheel": ([[WindowEvent("button_down", button="right"),
                WindowEvent("wheel", steps=3.0)]], 1, "speed"),
}


class Ticks:
    """A clock for a window module: 1/30 s a reading."""

    def __init__(self):
        self.now = 0.0

    def monotonic(self):
        self.now += 1.0 / 30.0
        return self.now


@pytest.mark.parametrize("script", sorted(CAMERA_SCRIPTS))
def test_events_move_the_camera_like_reference(script, monkeypatch):
    """The same event script moves the port's fly cam exactly as it moves
    the reference's (each loop's clock pinned: dt is the wall clock's)."""
    from point_cloud_tpu.render.renderer import RenderSettings as RSettings
    from point_cloud_tpu.viewer.app import Viewer as RViewer
    from point_cloud_tpu.viewer import window as rwindow
    from point_cloud_tpu_torch.viewer import window as twindow

    batches, frames, what = CAMERA_SCRIPTS[script]
    poses = []
    for module, v in (
            (rwindow, RViewer(RSettings(width=32, height=24))),
            (twindow, Viewer(RenderSettings(width=32, height=24),
                             device="cpu"))):
        try:
            start = (np.array(v.camera.transform.translation),
                     np.array(v.camera.transform.rotation), v.fly_cam.speed)
            loop = module.WindowLoop(v, FakeBackend(
                [[module.WindowEvent(**vars(e)) for e in b] for b in batches]))
            monkeypatch.setattr(module, "time", Ticks())
            assert loop.run(max_frames=frames) == frames
            poses.append((np.array(v.camera.transform.translation),
                          np.array(v.camera.transform.rotation),
                          v.fly_cam.speed))
        finally:
            v.close()
    index = {"translation": 0, "rotation": 1, "speed": 2}[what]
    assert not np.allclose(start[index], poses[1][index])
    for ref, port in zip(*poses):
        assert np.array_equal(ref, port)


def test_resize_reconfigures_surface(viewer):
    backend = FakeBackend([[WindowEvent("resize", x=80, y=40)]])
    WindowLoop(viewer, backend).run(max_frames=1)
    assert (viewer.settings.width, viewer.settings.height) == (80, 40)
    assert backend.blits[-1].shape == (40, 80, 3)
    assert viewer.camera.projection.aspect_ratio == pytest.approx(2.0)


def test_close_request_exits_loop(viewer):
    loop = WindowLoop(viewer, FakeBackend([[], [WindowEvent("close")], []]))
    assert loop.run(max_frames=10) == 1  # one frame before the close landed
    assert not loop.running


def test_run_window_with_store(tmp_path):
    """run_window on a store (its metadata.json or its directory) on the
    CPU: frames stream the store in and blit, over a device mesh too."""
    store = make_store(tmp_path / "store", 2000, 11)
    backend = FakeBackend()
    assert run_window(str(store / "metadata.json"), width=64, height=48,
                      max_frames=3, backend=backend, device="cpu") == 3
    assert backend.closed
    assert backend.blits[-1].shape == (48, 64, 3)
    assert (backend.blits[-1] != backend.blits[-1][0, 0]).any()
    assert run_window(str(store), width=64, height=48, max_frames=1,
                      backend=FakeBackend(), device="cpu") == 1
    mesh = FakeBackend()
    assert run_window(str(store), width=64, height=48, max_frames=2,
                      backend=mesh, mesh_devices=8, device="cpu") == 2
    assert mesh.blits[-1].shape == (48, 64, 3)
    assert (mesh.blits[-1] != mesh.blits[-1][0, 0]).any()


def test_window_cli_refuses_mesh_and_needs_a_card(tmp_path):
    """The window's CLI renders on the card, ``--mesh`` too: on a
    CPU-only host both are refused for want of a card."""
    from point_cloud_tpu_torch.viewer.window import main

    store = make_store(tmp_path / "store", 200, 12)
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the CPU-only refusal")
    with pytest.raises(RuntimeError, match="cuda"):
        run_window(str(store), max_frames=1, backend=FakeBackend())
    with pytest.raises(RuntimeError, match="cuda"):
        main([str(store), "--mesh", "1", "--frames", "1"])


TOGGLES = [("v", "settings", "voronoi"),
           ("o", "settings", "size_by_distance"),
           ("b", "debug", "show_bounding_box"),
           ("g", "debug", "show_cell_grid"),
           ("x", "debug", "show_streaming_rects"),
           ("p", None, "stream_enabled")]


@pytest.mark.parametrize("key,where,attr", TOGGLES)
def test_hotkey_toggles_runtime_setting(viewer, key, where, attr):
    """Each toggle hotkey flips its setting once a press, back on the next
    press (ui.rs:122-146, debug.rs:21-36)."""
    owner = viewer if where is None else getattr(viewer, where)
    loop = WindowLoop(viewer, FakeBackend())
    before = getattr(owner, attr)
    press(loop, key)
    assert getattr(owner, attr) is (not before)
    press(loop, key)
    assert getattr(owner, attr) is before


def test_frustum_scale_and_hierarchy_hotkeys(viewer):
    loop = WindowLoop(viewer, FakeBackend())
    assert viewer.debug.frozen_frustum is None
    press(loop, "c")
    assert viewer.debug.show_frustum
    assert viewer.debug.frozen_frustum is not None
    press(loop, "c")
    assert not viewer.debug.show_frustum
    press(loop, "n")
    assert viewer.debug.show_plane_normals
    start = viewer.streaming_scale
    press(loop, "bracketright")
    assert viewer.streaming_scale == start + 0.5
    for key, end in (("bracketleft", 1.0), ("bracketright", 5.0)):
        for _ in range(20):
            press(loop, key)
        assert viewer.streaming_scale == end
    press(loop, "2")
    assert 2 in viewer.settings.hidden_hierarchies
    press(loop, "2")
    assert 2 not in viewer.settings.hidden_hierarchies


def test_hotkey_autorepeat_does_not_flicker(viewer):
    loop = WindowLoop(viewer, FakeBackend())
    for _ in range(3):  # a press and two Tk auto-repeats
        loop.apply_event(WindowEvent("key_down", key="p"))
    assert not viewer.stream_enabled
    loop.apply_event(WindowEvent("key_up", key="p"))
    loop.apply_event(WindowEvent("key_down", key="p"))
    assert viewer.stream_enabled


def up(k, t):
    return WindowEvent("key_up", key=k, time_ms=t)


def down(k, t):
    return WindowEvent("key_down", key=k, time_ms=t)


MOVE = WindowEvent("cursor", x=1, y=2)
REPEATS = [
    ([up("p", 10), down("p", 10), MOVE, up("p", 40), down("p", 40)], [MOVE]),
    ([up("p", 10), down("p", 11), up("p", 50)],
     [up("p", 10), down("p", 11), up("p", 50)]),
    ([WindowEvent("key_up", key="p"), WindowEvent("key_down", key="p")],
     [WindowEvent("key_up", key="p"), WindowEvent("key_down", key="p")]),
    ([up("w", 10), down("s", 10), down("w", 10)], [down("s", 10)]),
]


@pytest.mark.parametrize("events,kept", REPEATS)
def test_x11_auto_repeat_pairs_filtered(events, kept):
    """X11 repeat pairs (one timestamp) drop; real releases, events
    without timestamps and other keys' events stay; as the reference's."""
    from point_cloud_tpu.viewer import window as rwindow

    assert filter_auto_repeat(list(events)) == kept
    ref = rwindow.filter_auto_repeat(
        [rwindow.WindowEvent(**vars(e)) for e in events])
    assert [vars(e) for e in ref] == [vars(e) for e in kept]


X11_SCRIPTS = {
    # a held hotkey: one toggle, held across the repeat batch; a real
    # release is held back one poll; a fresh press toggles again
    "held": ([[down("p", 100)],
              [up("p", 500), down("p", 500), up("p", 530), down("p", 530)],
              [up("p", 900)], [], [down("p", 1500)]],
             [(False, True), (False, True), (False, True), (False, False),
              (True, True)]),
    # a repeat pair split across two polls still cancels
    "split": ([[down("p", 100)], [up("p", 500)], [down("p", 500)], []],
              [(False, True), (False, True), (False, True), (False, True)]),
}


@pytest.mark.parametrize("script", sorted(X11_SCRIPTS))
def test_x11_auto_repeat_does_not_flicker_toggle(viewer, script):
    batches, after_steps = X11_SCRIPTS[script]
    loop = WindowLoop(viewer, FakeBackend(batches))
    for stream_enabled, held in after_steps:
        loop.step()
        assert viewer.stream_enabled is stream_enabled
        assert ("p" in loop.input.pressed_keys) is held


def write_ply(path, n=512, seed=7):
    from point_cloud_tpu_torch.io.ply import write_ply as write

    rng = np.random.default_rng(seed)
    colors = rng.integers(0, 256, (n, 4), dtype=np.uint8)
    colors[:, 3] = 255
    write(path, PointBatch(rng.uniform(-40, 40, (n, 3)).astype(np.float32),
                           colors))


def test_window_converter_flow(tmp_path, viewer):
    """Choose files (f), save-at (u), start (t): a real store, cells
    published live into the renderer, the store flushed when the loop
    ends, and t stops a run; byte-identical to the reference's window run
    of the same script."""
    from point_cloud_tpu.render.renderer import RenderSettings as RSettings
    from point_cloud_tpu.viewer.app import Viewer as RViewer
    from point_cloud_tpu.viewer import window as rwindow

    ply = tmp_path / "cloud.ply"
    write_ply(ply)
    stores = []
    for module, v, name in (
            (rwindow, RViewer(RSettings(width=32, height=24)), "ref"),
            (None, viewer, "port")):
        store = tmp_path / name
        loop_cls = WindowLoop if module is None else module.WindowLoop
        event = WindowEvent if module is None else module.WindowEvent
        backend = FakeBackend(ask_open_files=[str(ply)],
                              ask_directory=str(store))
        loop = loop_cls(v, backend)
        for key in ("f", "u", "t"):
            loop.apply_event(event("key_down", key=key))
            loop.apply_event(event("key_up", key=key))
        assert [f.path for f in loop.converter.progress()] == [ply]
        assert loop.converter.auto_save
        assert loop.converter.state.name == "CONVERTING"
        for _ in range(200):
            if not loop.step() or loop.converter.state.name == "FINISHED":
                break
        assert loop.converter.state.name == "FINISHED"
        loop.running = False
        loop.run()  # ends at once and flushes the store
        assert v.streamer.loaded
        loop.apply_event(event("key_down", key="t"))
        assert loop.converter.state.name != "CONVERTING"
        if module is not None:
            v.close()
        meta = Metadata.loads((store / "metadata.json").read_text())
        assert meta.number_of_points == 512
        stores.append({p.relative_to(store): p.read_bytes()
                       for p in sorted(store.rglob("*")) if p.is_file()})
    assert stores[0] == stores[1] and len(stores[1]) > 1
    assert isinstance(loop.converter.state, ConversionState)


def test_window_open_store_dialog(tmp_path, viewer):
    store = make_store(tmp_path / "store", 256, 3)
    backend = FakeBackend(ask_open_file=str(store / "metadata.json"))
    WindowLoop(viewer, backend).apply_event(WindowEvent("key_down", key="m"))
    assert viewer.metadata.number_of_points == 256
    assert backend.dialog_calls[0][0] == "ask_open_file"


def join_exports(timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        workers = [t for t in threading.enumerate() if t.name == "pct-export"]
        if not workers:
            return
        workers[0].join(0.05)
    raise AssertionError("the export thread did not finish")


def test_window_export_hotkey(tmp_path, viewer):
    """'e' exports the open store through the save dialog, off the event
    loop: the same bytes as the port's export_store of that store."""
    from point_cloud_tpu_torch.export import export_store

    store = make_store(tmp_path / "store", 300, 5)
    out = tmp_path / "exported.ply"
    loop = WindowLoop(viewer, FakeBackend(
        ask_open_file=str(store / "metadata.json"), ask_save_file=str(out)))
    press(loop, "m")
    loop.apply_event(WindowEvent("key_down", key="e"))
    join_exports()
    export_store(store, tmp_path / "direct.ply")
    assert out.read_bytes() == (tmp_path / "direct.ply").read_bytes()


@pytest.mark.parametrize("before", [(), ("m", "k")])
def test_window_export_refused_without_a_local_store(tmp_path, viewer,
                                                     before):
    """'e' with no store open, or after 'k' (a new cloud no longer backed
    by the opened store), asks no dialog and writes nothing."""
    store = make_store(tmp_path / "store", 64, 6)
    out = tmp_path / "x.ply"
    backend = FakeBackend(ask_open_file=str(store / "metadata.json"),
                          ask_save_file=str(out))
    loop = WindowLoop(viewer, backend)
    for key in before:
        press(loop, key)
    loop.apply_event(WindowEvent("key_down", key="e"))
    join_exports()
    assert not out.exists()
    assert "ask_save_file" not in [c[0] for c in backend.dialog_calls]


def test_window_dialog_hotkeys_safe_without_dialogs(viewer):
    loop = WindowLoop(viewer, FakeBackend())
    for key in ("m", "f", "u", "t", "k", "e"):
        press(loop, key)
    assert loop.viewer.metadata.number_of_points == 0
