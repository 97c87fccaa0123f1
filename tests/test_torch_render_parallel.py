"""The port's mesh-sharded frame against its single-device plain raster
arm and against the reference's ``MeshPointRenderer``.

The port's mesh runs on logical CPU shards (``make_mesh(device="cpu")``),
where K1 and K2 run their plain versions; the reference's on the eight
virtual CPU devices of tests/conftest.py. Port mesh frames must equal the
port's single-device plain arm (``compact_raster``, ``megakernel`` and
``classing`` off) bit for bit; against the reference's mesh frames they
meet the Frames contract (>= 99.9% equal pixels, depth within 1e-6 where
equal). One case runs on the card (``cuda`` marker).
"""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from point_cloud_tpu_torch.parallel.mesh import make_mesh
from point_cloud_tpu_torch.render import splat as tsplat
from point_cloud_tpu_torch.render.parallel import (
    MeshPointRenderer, merge_framebuffers,
)
from point_cloud_tpu_torch.render.renderer import PointRenderer
from point_cloud_tpu_torch.render.renderer import RenderSettings as TSettings
from torch_arm_frames import (
    SCENES, Scene, make_store, port_camera, streamed,
)

W, H = 96, 64



@pytest.fixture
def jax8():
    """The eight virtual CPU devices of the reference's mesh (JAX imported
    here: the card's machine runs only the ``cuda`` case and has none)."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs the eight virtual CPU devices")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's torch work: the test workers
    share the machine's cores, and torch's parallel regions wait at a
    barrier for every thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def corridor(tmp_path_factory):
    """The reference's mesh-frame scene (test_render_parallel.py:24-60): a
    corridor whose cells span several distance buckets from the camera."""
    scene = Scene(tmp_path_factory.mktemp("corridor"), "corridor")
    cam = port_camera(scene.cam)
    streamer, frustums = streamed(scene.tmeta, scene.path, cam, port=True)
    return scene, cam, streamer, frustums


def plain_settings(**kw):
    """The single-device arm the mesh body mirrors: one footprint raster
    of every kept row a bucket."""
    return TSettings(width=W, height=H, compact_raster=False,
                     megakernel=False, classing=False, transfer_depth=True,
                     **kw)


def mesh_frame(scene, n_shards, settings=None, paused=False):
    _, cam, streamer, frustums = scene
    r = MeshPointRenderer(scene[0].tmeta, make_mesh(n_shards, device="cpu"),
                          settings=settings or plain_settings())
    out = r.render(streamer, cam, frustums, paused=paused)
    return out, r.framebuffer.point_id.clone()


def single_frame(scene, settings=None, paused=False):
    _, cam, streamer, frustums = scene
    r = PointRenderer(scene[0].tmeta, settings or plain_settings(),
                      device="cpu")
    out = r.render(streamer, cam, frustums, paused=paused)
    return out, r.framebuffer.point_id.clone()


def assert_same_frame(a, b):
    (rgb_a, d_a, s_a), ids_a = a
    (rgb_b, d_b, s_b), ids_b = b
    assert s_a["points_visible"] == s_b["points_visible"]
    np.testing.assert_array_equal(rgb_a, rgb_b)
    np.testing.assert_array_equal(d_a, d_b)
    assert torch.equal(ids_a, ids_b)


@pytest.mark.parametrize("occlusion", [True, False])
def test_image_identical_to_single_device(corridor, occlusion):
    settings = plain_settings(occlusion=occlusion)
    single = single_frame(corridor, settings)
    # more than one bucket: the inter-bucket depth merge is exercised
    assert single[0][2]["buckets"] > 1
    mesh = mesh_frame(corridor, 8, plain_settings(occlusion=occlusion))
    assert_same_frame(mesh, single)
    assert mesh[0][2]["points_visible"] > 0
    assert (mesh[0][1] < 1.0).sum() > 50  # the frame is covered


@pytest.mark.parametrize("occlusion", [True, False])
def test_frames_contract_against_reference_mesh(jax8, corridor, occlusion):
    from point_cloud_tpu.parallel.mesh import make_mesh as jmake_mesh
    from point_cloud_tpu.render.parallel import MeshPointRenderer as JMesh
    from point_cloud_tpu.render.renderer import RenderSettings as RSettings

    scene = corridor[0]
    rstreamer, rfrustums = streamed(scene.meta, scene.path, scene.cam,
                                    port=False)
    ref = JMesh(scene.meta, jmake_mesh(8), settings=RSettings(
        width=W, height=H, compact_raster=False, megakernel=False,
        classing=False, transfer_depth=True, occlusion=occlusion))
    rgb_r, d_r, s_r = ref.render(rstreamer, scene.cam, rfrustums)
    (rgb_t, d_t, s_t), _ = mesh_frame(corridor, 8,
                                      plain_settings(occlusion=occlusion))
    same = (rgb_t == rgb_r).all(axis=2)
    assert same.mean() >= 0.999, same.mean()
    assert np.abs(d_t - d_r)[same].max() <= 1e-6
    assert s_t["points_visible"] == s_r["points_visible"] > 0


def test_hidden_hierarchies_and_pause(corridor):
    settings = plain_settings()
    settings.hidden_hierarchies = {0}
    single = single_frame(corridor, settings, paused=True)
    mesh = mesh_frame(corridor, 8, settings, paused=True)
    assert_same_frame(mesh, single)


def test_empty_loaded_set(corridor):
    from point_cloud_tpu_torch.render.streaming import CellStreamer

    scene, cam, _, frustums = corridor
    empty = CellStreamer(scene.tmeta, loader=lambda cid: None)
    r = MeshPointRenderer(scene.tmeta, make_mesh(8, device="cpu"),
                          settings=plain_settings())
    rgb, depth, stats = r.render(empty, cam, frustums)
    assert stats["points_visible"] == 0 and stats["cells"] == 0
    assert (depth == 1.0).all()
    assert (rgb == tsplat.CLEAR_COLOR_U8[0]).all()


def test_pipelined_matches_sync(corridor):
    """The double-buffered loop returns each frame one call late, with
    bytes identical to the synchronous render."""
    _, cam, streamer, frustums = corridor
    r = MeshPointRenderer(corridor[0].tmeta, make_mesh(4, device="cpu"),
                          settings=plain_settings())
    sync = r.render(streamer, cam, frustums)
    assert r.render_pipelined(streamer, cam, frustums) is None
    piped = r.render_pipelined(streamer, cam, frustums)
    flushed = r.render_flush()
    for got in (piped, flushed):
        np.testing.assert_array_equal(got[0], sync[0])
        np.testing.assert_array_equal(got[1], sync[1])
        assert got[2]["points_visible"] == sync[2]["points_visible"]
    assert r.render_flush() is None


def test_mesh_width_does_not_change_image(corridor):
    """1-, 2-, 3- and 8-shard meshes give the same bytes (incl. a non-pow2
    width, whose shards hold non-pow2 row counts)."""
    frames = [mesh_frame(corridor, n) for n in (1, 2, 3, 8)]
    for f in frames[1:]:
        assert_same_frame(f, frames[0])


def test_shards_on_a_repeated_device(corridor):
    """Four shards listed on one device render what four CPU shards do."""
    scene, cam, streamer, frustums = corridor
    r = MeshPointRenderer(scene.tmeta, make_mesh(devices=["cpu"] * 4),
                          settings=plain_settings())
    out = r.render(streamer, cam, frustums)
    assert_same_frame((out, r.framebuffer.point_id), mesh_frame(corridor, 4))


def test_merge_takes_min_depth_then_min_id():
    """The two-phase merge: the global minimum depth, and among the shards
    at that depth the smallest id; -0.0 and +0.0 are one depth."""
    d = [torch.tensor([0.5, 0.25, 1.0, 0.0], dtype=torch.float32),
         torch.tensor([0.5, 0.3, 1.0, -0.0], dtype=torch.float32),
         torch.tensor([0.7, 0.25, 1.0, 0.0], dtype=torch.float32)]
    i = [torch.tensor([9, 4, int(tsplat._NO_ID), 3], dtype=torch.int32),
         torch.tensor([7, 1, int(tsplat._NO_ID), 2], dtype=torch.int32),
         torch.tensor([1, 6, int(tsplat._NO_ID), 5], dtype=torch.int32)]
    fb = merge_framebuffers(d, i)[0]
    assert fb.depth.tolist() == [0.5, 0.25, 1.0, 0.0]
    assert fb.point_id.tolist() == [7, 4, int(tsplat._NO_ID), 2]


def test_viewer_mesh_devices_renders(tmp_path):
    """Viewer(mesh_devices=8) renders on the CPU, the same image as the
    single-device Viewer's plain arm."""
    from point_cloud_tpu_torch.viewer.app import Viewer

    make_store(tmp_path, SCENES["small"][0]())
    frames = []
    for mesh_devices in (0, 8):
        v = Viewer(plain_settings(), mesh_devices=mesh_devices,
                   device="cpu")
        v.load_metadata(tmp_path / "metadata.json")
        assert isinstance(v.renderer, MeshPointRenderer) == bool(
            mesh_devices)
        for _ in range(300):
            v.update(0.0)
            if not v.streamer.loading and not v.streamer.should_load:
                break
        frames.append(v.render())
        v.close()
    (rgb_1, depth_1, stats_1), (rgb_n, depth_n, stats_n) = frames
    assert stats_n["points_visible"] == stats_1["points_visible"] > 0
    np.testing.assert_array_equal(rgb_n, rgb_1)
    np.testing.assert_array_equal(depth_n, depth_1)


def test_serve_mesh_backend(tmp_path):
    """serve(..., mesh_devices=8) answers /render through the mesh
    renderer, on the CPU."""
    from point_cloud_tpu_torch.serve import serve

    make_store(tmp_path, SCENES["small"][0]())
    httpd = serve(tmp_path, host="127.0.0.1", port=0, width=64, height=48,
                  mesh_devices=8, device="cpu")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        server = httpd.registry.get(httpd.registry.default)
        assert isinstance(server.viewer.renderer, MeshPointRenderer)
        assert server.viewer.renderer.mesh.size == 8
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        with urllib.request.urlopen(f"{base}/render?yaw=0.3",
                                    timeout=180) as resp:
            body = resp.read()
        assert resp.status == 200
        assert body[:8] == b"\x89PNG\r\n\x1a\n"
        with urllib.request.urlopen(f"{base}/stats", timeout=60) as resp:
            assert json.loads(resp.read())["number_of_points"] == 5_000
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_dryrun_multichip_on_cpu():
    from point_cloud_tpu_torch.parallel.dryrun import dryrun_multichip

    stats = dryrun_multichip(4, device="cpu")
    assert stats["points_visible"] > 0


@pytest.mark.cuda
def test_mesh_frame_on_card_equals_cpu(corridor):
    """Four shards on one card: K1 and K2 launch once a shard and bucket,
    and the frame equals the CPU mesh frame."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 and K2 have no CPU mode")
    from point_cloud_tpu_torch.render import kernel

    scene, cam, streamer, frustums = corridor
    k1, k2 = kernel.launches, tsplat.launches
    r = MeshPointRenderer(scene.tmeta,
                          make_mesh(devices=[torch.device("cuda:0")] * 4),
                          settings=plain_settings())
    out = r.render(streamer, cam, frustums)
    buckets = out[2]["buckets"]
    assert kernel.launches - k1 == 4 * buckets
    assert tsplat.launches - k2 == 4 * buckets
    assert_same_frame((out, r.framebuffer.point_id.cpu()),
                      mesh_frame(corridor, 4))
