"""The port's frame fusion and sorted raster arms
(point_cloud_tpu_torch/render/renderer.py) against its per-bucket and
scatter arms and against the reference's same arm.

Scenes: the reference's corridor (test_render_kernel.py:798: 25,000
points in several distance buckets) for frame fusion, with chunked rungs
and at footprint 1; 5,000 points of the :491 cube seen from further away
for the sorted raster (``raster_mode="sorted"``, classing "auto" and
True: each bucket's fragments go through K3, ``sort4`` and K4, their
plain versions on the CPU; the reference's own sort is the bitonic
network); the cube of tests/test_torch_arms.py for the sorted raster
after a jump in visibility.

- **Port against port**: every frame of frame fusion equals the
  per-bucket frame bit for bit (rgb, depth, ids), across buckets and with
  the counts tail landed; every frame of the sorted raster equals the
  scatter frame of the same ladder, the first (no history) and the one
  after a jump (budgets clipped) included.
- **Port against the reference**: every frame meets the reference's same
  arm under the Frames contract, with equal ``points_visible`` and landed
  counts.
- The fused ``PACK_COUNTS`` fallback, a sorted frame's launches (one
  emission and one merge a bucket), and the all-culled sorted bucket
  (the reference's :491).

The ``cuda`` cases render every arm on the card against the CPU; here they
skip. On the card, without JAX: ``PCT_TEST_PLATFORM=gpu python -m pytest
tests/test_torch_fusion_sorted.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from point_cloud_tpu.render import camera as rcamera
from point_cloud_tpu_torch.render import kernel as tkernel
from point_cloud_tpu_torch.render import splat as tsplat
from point_cloud_tpu_torch.render.renderer import PointRenderer as TRenderer
from point_cloud_tpu_torch.render.renderer import RenderSettings as TSettings
from torch_arm_frames import (  # noqa: F401 (fixtures)
    NO_ID, POSES, W, H, assert_frames_contract, assert_identical, frames,
    port_camera, render_frames, scenes, streamed,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's torch work (the workers
    share the machine's cores; see tests/test_torch_render.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# name: (scene, settings, the port arm its frames equal, on which frames)
ARMS = {
    "fusion": ("corridor", dict(frame_fusion=True), {}, "every"),
    "fusion_footprint1": ("corridor", dict(footprint=1, frame_fusion=True),
                          dict(footprint=1), "every"),
    "sorted": ("small", dict(raster_mode="sorted"), dict(megakernel=False),
               "every"),
    "sorted_classing_true": ("small", dict(raster_mode="sorted",
                                           classing=True),
                             dict(megakernel=False, classing=True), "every"),
}


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_arm_meets_reference_every_frame(frames, arm):
    """Four frames at one pose, the first without history: the reference's
    same arm under the Frames contract, the same visible points and the
    same landed counts every frame."""
    scene, settings, _, _ = ARMS[arm]
    port = frames(scene, settings, True)
    assert_frames_contract(port, frames(scene, settings, False))
    assert (port[-1][4] != NO_ID).sum() > 1000


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_arm_equals_the_port_arm_it_promises(frames, arm):
    """Steady frames (2-4) equal the default arm's; every frame of frame
    fusion and of the sorted raster equals its per-bucket or scatter twin;
    the two full-footprint arms equal each other every frame."""
    scene, settings, twin, which = ARMS[arm]
    port = frames(scene, settings, True)
    assert_identical(port, frames(scene, twin, True),
                     range(4) if which == "every" else range(1, 4))


def test_sorted_ladder_really_ran(frames):
    """The small cube's splats fill overflow rungs, so "auto" switches the
    sorted ladder on from frame 2."""
    small = frames("small", dict(raster_mode="sorted"), True)[-1][3]
    assert any(v > 0 for (b, k), v in small.items() if k in (6, 7, 8, 9))


def test_sorted_frames_went_through_the_fragment_path(scenes, monkeypatch):
    """The sorted arm's first frame (no history) rasters through K2; from
    the second on (classing on) each bucket emits and merges its fragments
    once (K3 and K4, with ``sort4`` between; their plain versions here)
    and nothing goes through K2."""
    calls = []
    for name in ("emit_fragment_columns", "sorted_merge",
                 "splat_raster_segments"):
        real = getattr(tsplat, name)
        monkeypatch.setattr(tsplat, name, lambda *a, _r=real, _n=name, **k: (
            calls.append(_n), _r(*a, **k))[1])
    scene = scenes("small")
    renderer = TRenderer(scene.tmeta, TSettings(
        width=W, height=H, raster_mode="sorted", classing=True),
        device="cpu")
    cam = port_camera(scene.cam)
    streamer, frustums = streamed(scene.tmeta, scene.path, cam, True)
    per_frame = []
    for _ in range(2):
        calls.clear()
        stats = renderer.render(streamer, cam, frustums)[2]
        per_frame.append(list(calls))
    lit = sum(1 for (_, k), v in renderer._survivor_counts.items()
              if k == "a" and v > 0)  # buckets with kept rows
    assert per_frame[0] == ["splat_raster_segments"] * stats["buckets"]
    assert per_frame[1] == ["emit_fragment_columns", "sorted_merge"] * lit
    assert lit > 0


def test_sorted_after_a_jump_meets_reference(frames):
    """Two frames turned away from the cube (2,572 of its 20,000 points in
    view), then the full view, classing on: the class budgets sized on the
    turned frames drop rows of the jump frame's fragment lists. The port
    drops the reference's rows (the Frames contract, the same visible
    points and counts on every frame) and the sorted frames equal the
    scatter frames of the same ladder on every frame, the clipped one
    included; the jump frame differs from the default arm's."""
    settings = dict(raster_mode="sorted", classing=True)
    port = frames("cube", settings, True, "jump3")
    assert_frames_contract(port, frames("cube", settings, False, "jump3"))
    assert port[0][2] * 4 < port[2][2]
    assert_identical(port, frames("cube", dict(megakernel=False,
                                               classing=True), True,
                                  "jump3"), range(3))
    assert not np.array_equal(port[2][0],
                              frames("cube", {}, True, "jump3")[2][0])


def test_fusion_pack_overflow_falls_back(frames, scenes, monkeypatch):
    """More counts than the packed tail holds: frame fusion renders the
    same chains bucket by bucket and reads back synchronously
    (renderer.py:926-951); frames and visible points equal the packed
    path's."""
    packed = frames("corridor", dict(frame_fusion=True), True)
    monkeypatch.setattr(tsplat, "PACK_COUNTS", 3)
    assert_identical(render_frames(scenes("corridor"),
                                   dict(frame_fusion=True), True,
                                   POSES["steady"][:2]), packed, range(2))


def test_sorted_raster_survives_all_culled_bucket(scenes):
    """The reference's :491 case: counts land, then every splat culls; the
    frame after skips every class and draws the clear frame."""
    scene = scenes("small")
    away = rcamera.Camera()
    away.projection.far = scene.meta.config.max_cell_size * 5.0
    away.transform.translation = np.array([0.0, -500.0, 0.0], np.float32)
    away.transform.look_to(np.array([0.0, -1.0, 0.0], np.float32),
                           np.array([0.0, 0.0, 1.0], np.float32))
    scene.cams["away"] = away
    out = render_frames(scene, dict(raster_mode="sorted", classing=True,
                                    megakernel=False), True,
                        ("view", "away", "away"))
    assert out[0][2] > 0
    rgb, _, visible, counts, ids = out[-1]
    assert visible == 0 and (ids == NO_ID).all()
    assert (rgb == tsplat.CLEAR_COLOR_U8[0]).all()
    assert all(v == 0 for v in counts.values())


# --- the arms on the card -----------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the frame kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arm", sorted(ARMS))
def test_arm_on_card_matches_cpu(cuda_device, scenes, arm):
    """Every frame of each arm on the card equals the port's CPU frames:
    rgb, ids and visible points identical, depth by value."""
    scene, settings, _, _ = ARMS[arm]
    gpu = render_frames(scenes(scene), settings, True, POSES["steady"],
                        device="cuda")
    cpu = render_frames(scenes(scene), settings, True, POSES["steady"])
    assert_identical(gpu, cpu, range(4))
