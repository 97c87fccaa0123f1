"""Scenes, frames and comparisons shared by the render-arm tests
(tests/test_torch_arms.py, tests/test_torch_fusion_sorted.py): the
reference's own test scenes (test_render_kernel.py:491, :547, :798) as
stores, a renderer of the port or of the reference driven over a list of
poses, the Frames contract and bit-for-bit identity. Not a test module."""

import copy

import numpy as np
import pytest
import torch

from point_cloud_tpu.render import camera as rcamera
from point_cloud_tpu_torch.core.cell import Cell as TCell
from point_cloud_tpu_torch.core.metadata import Metadata as TMetadata
from point_cloud_tpu_torch.render import camera as tcamera
from point_cloud_tpu_torch.render import splat as tsplat
from point_cloud_tpu_torch.render import transform as ttransform
from point_cloud_tpu_torch.render.renderer import PointRenderer as TRenderer
from point_cloud_tpu_torch.render.renderer import RenderSettings as TSettings

NO_ID = int(tsplat._NO_ID)
W, H = 96, 72


# --- scenes -----------------------------------------------------------------


def cube_points(seed, n):
    return np.random.default_rng(seed).uniform(-50, 50, (n, 3))


def corridor_points(seed=31, n=25_000):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-1600, 1600, n), rng.uniform(-200, 200, n),
                     rng.uniform(-200, 200, n)], axis=1)


def aabb_camera(meta, back=0.0):
    cam = rcamera.Camera()
    cam.projection.far = meta.config.max_cell_size * 5.0
    cam.look_at_aabb(meta.bounding_box)
    t = cam.transform
    center = np.asarray(meta.bounding_box.center(), np.float32)
    t.translation = t.translation + back * (t.translation - center)
    cam.transform = t
    return cam


def corridor_camera(meta):
    cam = rcamera.Camera()
    cam.projection.far = meta.config.max_cell_size * 5.0
    cam.transform.translation = np.array([-1400.0, 60.0, 90.0], np.float32)
    cam.transform.look_at(np.array([1500.0, 0.0, 0.0], np.float32),
                          np.array([0.0, 0.0, 1.0], np.float32))
    return cam


def turned(cam, meta, side: float):
    """``cam`` at the same spot turned to look ``side`` cloud widths
    beside the centre: the cells keep their distances (so their buckets),
    fewer of their points stay in view."""
    out = copy.deepcopy(cam)
    center = np.asarray(meta.bounding_box.center(), np.float32)
    extent = float(np.linalg.norm(meta.bounding_box.extends()))
    up = np.array([0.0, 0.0, 1.0], np.float32)
    right = np.cross(center - cam.transform.translation, up)
    right = (right / np.linalg.norm(right)).astype(np.float32)
    out.transform.look_at(center + side * extent * right, up)
    return out


# name: (points, camera); the reference's own test scenes
# (test_render_kernel.py:547, :798, :491), and one of near splats
SCENES = {
    "cube": (lambda: cube_points(17, 20_000), aabb_camera),
    "corridor": (corridor_points, corridor_camera),
    "small": (lambda: cube_points(41, 5_000),
              lambda meta: aabb_camera(meta, back=0.5)),
    # the camera inside the cube's box: splats 4-20 px in half-extent,
    # for the footprints above the ladder's 65 px
    "near": (lambda: cube_points(43, 1_500),
             lambda meta: aabb_camera(meta, back=-0.5)),
}


def make_store(path, pos, seed=0):
    from point_cloud_tpu.convert.converter import Converter
    from point_cloud_tpu.core.metadata import Metadata as RMetadata
    from point_cloud_tpu.core.point import PointBatch as RPointBatch

    rng = np.random.default_rng(seed)
    col = rng.integers(0, 256, (len(pos), 4), dtype=np.uint8)
    with Converter(RMetadata(), path) as conv:
        conv.add_points_batch(RPointBatch(pos.astype(np.float32), col))
    return RMetadata.from_path(path / "metadata.json")


def port_camera(ref):
    cam = tcamera.Camera()
    t = ref.transform
    cam.transform = ttransform.Transform(t.translation, t.rotation, t.scale)
    p = ref.projection
    cam.projection = tcamera.PerspectiveProjection(
        fov_y=p.fov_y, aspect_ratio=p.aspect_ratio, near=p.near, far=p.far)
    return cam


def streamed(meta, store, cam, port: bool):
    """A streamer with every cell in ``cam``'s view loaded, and the
    frustums, for the reference's or the port's modules."""
    if port:
        from point_cloud_tpu_torch.render.frustums import (
            update_streaming_frustums,
        )
        from point_cloud_tpu_torch.render.streaming import CellStreamer
        cell_cls = TCell
    else:
        from point_cloud_tpu.core.cell import Cell as RCell
        from point_cloud_tpu.render.frustums import update_streaming_frustums
        from point_cloud_tpu.render.streaming import CellStreamer
        cell_cls = RCell

    def loader(cell_id):
        path = store / cell_id.path()
        return cell_cls.from_path(path) if path.exists() else None

    streamer = CellStreamer(meta, loader=loader)
    frustums = update_streaming_frustums(meta, cam.transform, cam.projection,
                                         cam.frustum())
    streamer.update(frustums, cam.transform)
    for _ in range(400):
        if not streamer.fill_load_slots():
            break
    return streamer, frustums


class Scene:
    def __init__(self, path, name):
        points, camera = SCENES[name]
        self.path = path
        self.meta = make_store(path, points())
        self.tmeta = TMetadata.loads(self.meta.dumps())
        self.cam = camera(self.meta)
        # "turned": most of the cloud out of view, the same buckets
        self.cams = {"view": self.cam,
                     "turned": turned(self.cam, self.meta, 1.5)}


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    built = {}

    def get(name):
        if name not in built:
            built[name] = Scene(tmp_path_factory.mktemp(name), name)
        return built[name]

    return get


POSES = {"steady": ("view",) * 4, "twice": ("view",) * 2,
         "jump": ("turned", "turned", "view", "view"),
         "jump3": ("turned", "turned", "view")}


def render_frames(scene: Scene, settings: dict, port: bool, poses: tuple,
                  device="cpu"):
    """Frames of one renderer over ``poses``, the cells of the full view
    loaded: (rgb, depth, points_visible, landed counts, ids or None)."""
    if port:
        meta = scene.tmeta
        cams = {k: port_camera(c) for k, c in scene.cams.items()}
        renderer = TRenderer(meta, TSettings(width=W, height=H, **settings),
                             device=device)
    else:
        from point_cloud_tpu.render.renderer import (
            PointRenderer, RenderSettings,
        )

        meta, cams = scene.meta, scene.cams
        renderer = PointRenderer(meta, RenderSettings(width=W, height=H,
                                                      **settings))
    streamer, frustums = streamed(meta, scene.path, cams["view"], port)
    out = []
    for pose in poses:
        rgb, depth, stats = renderer.render(streamer, cams[pose], frustums)
        ids = renderer.framebuffer.point_id.cpu().clone() if port else None
        out.append((rgb, depth, stats["points_visible"],
                    dict(renderer._survivor_counts), ids))
    return out


@pytest.fixture(scope="module")
def frames(scenes):
    cache = {}

    def get(scene: str, settings: dict, port: bool, poses="steady"):
        key = (scene, tuple(sorted(settings.items())), port, poses)
        if key not in cache:
            cache[key] = render_frames(scenes(scene), settings, port,
                                       POSES[poses])
        return cache[key]

    return get


def assert_frames_contract(port, ref):
    """The Frames contract and the exact bookkeeping, frame by frame."""
    assert len(port) == len(ref)
    for i, ((rgb_t, d_t, vis_t, counts_t, _),
            (rgb_r, d_r, vis_r, counts_r, _)) in enumerate(zip(port, ref)):
        same = (rgb_t == rgb_r).all(axis=2)
        assert same.mean() >= 0.999, (i, same.mean())
        assert np.abs(d_t - d_r)[same].max() <= 1e-6, i
        assert vis_t == vis_r > 0, i
        assert counts_t == counts_r, i


def assert_identical(a, b, indices):
    """Frames ``indices`` of two runs equal bit for bit: rgb, depth, ids
    and visible points."""
    for i in indices:
        (rgb_a, d_a, vis_a, _, ids_a), (rgb_b, d_b, vis_b, _, ids_b) = (
            a[i], b[i])
        assert np.array_equal(rgb_a, rgb_b), i
        assert np.array_equal(d_a, d_b), i
        assert torch.equal(ids_a, ids_b), i
        assert vis_a == vis_b, i
