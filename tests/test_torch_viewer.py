"""The port's headless viewer (point_cloud_tpu_torch/viewer/) against the
reference's.

The copied modules (thread pool, sources, asset manager, line overlays,
PNG writer) give the reference's results on the same inputs. The port's
``Viewer`` on the CPU streams a store like the reference's ``Viewer``,
moves its camera the same way under the same input, draws the same
overlays, and renders the frame of the JAX viewer within the frame
tolerance of tests/test_torch_render.py (XLA:CPU's fma contraction:
>= 99.9% of the pixels equal). ``render_orbit`` writes the same frames
within that tolerance; ``render_pipelined`` gives ``render``'s frames.
"""

import time

import numpy as np
import pytest
import torch

from point_cloud_tpu.convert.converter import Converter
from point_cloud_tpu.core.metadata import Metadata as RMetadata
from point_cloud_tpu.core.point import PointBatch as RPointBatch
from point_cloud_tpu.render.renderer import RenderSettings as RSettings
from point_cloud_tpu.viewer import Viewer as RViewer
from point_cloud_tpu.viewer import ViewerInput as RInput
from point_cloud_tpu_torch.render.renderer import RenderSettings as TSettings
from point_cloud_tpu_torch.viewer import Viewer as TViewer
from point_cloud_tpu_torch.viewer import ViewerInput as TInput


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


def make_store(path, n=20_000, seed=14):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-50, 50, (n, 3)).astype(np.float32)
    col = rng.integers(0, 256, (n, 4), dtype=np.uint8)
    with Converter(RMetadata(), path) as conv:
        conv.add_points_batch(RPointBatch(pos, col))
    return path / "metadata.json"


def pump(viewer, frames=400):
    """Update until streaming goes idle."""
    for _ in range(frames):
        viewer.update()
        s = viewer.streamer
        if not s.loading and len(s.should_load) == 0:
            return
        time.sleep(0.002)
    raise AssertionError("streaming did not settle")


def viewers(metadata_path, width=128, height=96):
    ref = RViewer(RSettings(width=width, height=height))
    port = TViewer(TSettings(width=width, height=height), device="cpu")
    for v in (ref, port):
        v.load_metadata(metadata_path)
        pump(v)
    return ref, port


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    return make_store(tmp_path_factory.mktemp("store"))


def loaded_keys(viewer):
    return sorted((c.hierarchy, tuple(c.index)) for c in viewer.streamer.loaded)


def close_frames(a, b):
    same = (a == b).all(axis=2)
    return same.mean() >= 0.999


def test_viewer_streams_and_renders_like_reference(store):
    ref, port = viewers(store)
    try:
        rs, ts = ref.stats(), port.stats()
        for key in ("metadata", "cells", "points"):
            assert rs[key] == ts[key], key
        assert loaded_keys(ref) == loaded_keys(port)
        assert np.array_equal(ref.camera.view_matrix(),
                              port.camera.view_matrix())
        rgb_r, depth_r, stats_r = ref.render()
        rgb_t, depth_t, stats_t = port.render()
        assert rgb_t.shape == (96, 128, 3) and rgb_t.dtype == np.uint8
        assert close_frames(rgb_r, rgb_t)
        assert stats_t["points_visible"] == stats_r["points_visible"] > 0
        same = (rgb_r == rgb_t).all(axis=2)
        assert np.abs(depth_r - depth_t)[same].max() <= 1e-6
    finally:
        ref.close()
        port.close()


def test_viewer_input_moves_camera_like_reference(store):
    ref, port = viewers(store)
    try:
        for inputs in ((RInput(forward=1.0, right=0.5, ascend=-0.2),
                        TInput(forward=1.0, right=0.5, ascend=-0.2)),
                       (RInput(cursor_delta=(14.0, -6.0), wheel=1.0,
                               looking=True),
                        TInput(cursor_delta=(14.0, -6.0), wheel=1.0,
                               looking=True))):
            ref.update(0.05, inputs[0])
            port.update(0.05, inputs[1])
            assert np.array_equal(ref.camera.transform.compute_matrix(),
                                  port.camera.transform.compute_matrix())
        pump(ref)
        pump(port)
        assert loaded_keys(ref) == loaded_keys(port)
    finally:
        ref.close()
        port.close()


def test_debug_overlays_match_reference(store):
    """The line overlays (render/lines.py, copied) drawn on one image."""
    ref, port = viewers(store)
    try:
        for v in (ref, port):
            v.debug.show_bounding_box = True
            v.debug.show_cell_grid = True
            v.debug.show_streaming_rects = True
            v.freeze_frustum()
            v.debug.show_plane_normals = True
            # the cell grid draws in load-completion order, which the two
            # thread pools need not share: one order for both
            v.streamer.loaded = dict(sorted(
                v.streamer.loaded.items(),
                key=lambda kv: (kv[0].hierarchy, tuple(kv[0].index))))
        base = np.full((96, 128, 3), 41, np.uint8)
        got = port._apply_overlays(base, port.camera.view_projection_matrix(),
                                   port._frustums)
        want = ref._apply_overlays(base, ref.camera.view_projection_matrix(),
                                   ref._frustums)
        assert np.array_equal(got, want)
        assert (got != base).any()
    finally:
        ref.close()
        port.close()


def test_render_orbit_matches_reference(tmp_path, store):
    from point_cloud_tpu.viewer.offscreen import render_orbit as rorbit
    from point_cloud_tpu_torch.viewer.offscreen import render_orbit as torbit

    ref = RViewer(RSettings(width=64, height=48))
    port = TViewer(TSettings(width=64, height=48), device="cpu")
    try:
        frames = []
        for v, orbit, out in ((ref, rorbit, "ref"), (port, torbit, "port")):
            v.load_metadata(store)
            frames.append(orbit(v, tmp_path / out, n_frames=2))
        assert [p.name for p in frames[0]] == [p.name for p in frames[1]]
        for a, b in zip(*frames):
            assert a.read_bytes()[:8] == b.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
        # the frames themselves, rendered again at the last orbit camera
        assert close_frames(ref.render()[0], port.render()[0])
    finally:
        ref.close()
        port.close()


def test_viewer_pipelined_matches_render(store):
    port = TViewer(TSettings(width=96, height=72), device="cpu")
    try:
        port.load_metadata(store)
        pump(port)
        sync = port.render()
        assert port.render_pipelined() is None
        piped = port.render_pipelined()
        last = port.render_flush()
        assert port.render_flush() is None
        for out in (piped, last):
            assert np.array_equal(out[0], sync[0])
            assert np.array_equal(out[1], sync[1])
            assert out[2] == sync[2]
    finally:
        port.close()


def test_viewer_needs_a_card_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the CPU-only refusal")
    with pytest.raises(RuntimeError, match="cuda"):
        TViewer()


@pytest.mark.parametrize("kind", ["u8", "float", "gray"])
def test_write_png_bytes_match_reference(tmp_path, kind):
    from point_cloud_tpu.viewer.offscreen import write_png as rwrite
    from point_cloud_tpu_torch.viewer.offscreen import write_png as twrite

    rng = np.random.default_rng(9)
    image = {"u8": rng.integers(0, 256, (13, 17, 3), dtype=np.uint8),
             "float": rng.uniform(-0.1, 1.1, (13, 17, 3)).astype(np.float32),
             "gray": rng.integers(0, 256, (13, 17), dtype=np.uint8)}[kind]
    rwrite(tmp_path / "r.png", image)
    twrite(tmp_path / "t.png", image)
    assert (tmp_path / "r.png").read_bytes() == (tmp_path / "t.png").read_bytes()


def test_asset_manager_and_sources_load_like_reference(store):
    """Cells through the copied AssetManager, Directory and ThreadPool:
    the same events and the same cells as the reference's."""
    from point_cloud_tpu.core.cell import Cell as RCell
    from point_cloud_tpu.core.cell import CellId as RCellId
    from point_cloud_tpu.utils.assets import AssetManager as RAssets
    from point_cloud_tpu.utils.source import Directory as RDirectory
    from point_cloud_tpu.utils.thread_pool import ThreadPool as RPool
    from point_cloud_tpu_torch.core.cell import Cell as TCell
    from point_cloud_tpu_torch.core.cell import CellId as TCellId
    from point_cloud_tpu_torch.utils.assets import AssetManager as TAssets
    from point_cloud_tpu_torch.utils.source import Directory as TDirectory
    from point_cloud_tpu_torch.utils.thread_pool import ThreadPool as TPool

    root = store.parent
    ids = sorted((p.relative_to(root) for p in root.rglob("*.bin")),
                 key=str)[:6]
    assert ids
    results = []
    for assets_cls, dir_cls, pool_cls, cell_cls, id_cls in (
            (RAssets, RDirectory, RPool, RCell, RCellId),
            (TAssets, TDirectory, TPool, TCell, TCellId)):
        pool = pool_cls(2)
        assets = assets_cls(parse=cell_cls.from_bytes,
                            serialize=lambda c: c.to_bytes(), pool=pool)
        directory = dir_cls(root)
        for i, rel in enumerate(ids):
            assets.load(i, directory.join(str(rel)))
        assets.load(99, directory.join("missing/cell.bin"))
        events = []
        deadline = time.time() + 30
        while len(events) < len(ids) + 1 and time.time() < deadline:
            assets.wait_for_completion(timeout=0.05)
            events += [(e.id, e.kind.name, type(e.error).__name__)
                       for e in assets.poll_events()]
        cells = [assets.get(i).to_bytes() for i in range(len(ids))]
        assets.close()
        pool.close()
        results.append((sorted(events), cells))
    assert results[0] == results[1]
    assert any(kind == "ERROR" for _, kind, _ in results[0][0])
