"""The port's multi-dispatch and budget render arms
(point_cloud_tpu_torch/render/renderer.py) against its default arm and
against the reference's same arm, on the reference's cube scene
(test_render_kernel.py:547: 20,000 points, 96x72).

Arms: the multi-dispatch ladder (``megakernel=False`` with ``classing``
"auto", True and False, and without ``fused_compaction``), the
full-footprint raster (``compact_raster=False``) and the budget
megakernel (``chunked_raster=False``), per bucket and fused. On the CPU
every kernel runs its plain version.

- **Port against port**: the steady frames (2-4, after the counts land)
  equal the default arm's bit for bit (rgb, depth, ids); the fused budget
  frames equal the per-bucket budget frames every frame; the two
  full-footprint arms (``classing=False``, ``compact_raster=False``) clip
  splats wider than the footprint and equal each other every frame.
- **Port against the reference**: every frame, the first (no history)
  included, meets the reference's same arm under the Frames contract
  (>= 99.9% equal pixels, depth within 1e-6 where they agree), with equal
  ``points_visible`` and the same landed counts; so does the frame right
  after a jump in visibility, where budgets drop or spill rows: the port
  drops or spills the reference's rows, not others.
- The budget bucket pass against the reference's and the chunked one; the
  multi-dispatch ``PACK_COUNTS`` fallback; ``check_ported`` (only a
  footprint below 1 is refused); and the one
  case where the reference's "image-identical" fails: an overflow rung
  past the chunked megakernel's cap parts the default arm's frame from
  the uncapped ladder's.

The ``cuda`` cases render every arm on the card against the CPU; here they
skip. On the card, without JAX: ``PCT_TEST_PLATFORM=gpu python -m pytest
tests/test_torch_arms.py tests/test_torch_fusion_sorted.py -m cuda``.
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
    "multi_dispatch": ("cube", dict(megakernel=False), {}, "steady"),
    "classing_true": ("cube", dict(megakernel=False, classing=True), {},
                      "steady"),
    "cascade": ("cube", dict(megakernel=False, fused_compaction=False), {},
                "steady"),
    "classing_false": ("cube", dict(megakernel=False, classing=False),
                       dict(compact_raster=False), "every"),
    "no_compaction": ("cube", dict(compact_raster=False),
                      dict(megakernel=False, classing=False), "every"),
    "budget": ("cube", dict(chunked_raster=False), {}, "steady"),
    "fusion_budget": ("cube", dict(frame_fusion=True, chunked_raster=False),
                      dict(chunked_raster=False), "every"),
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


def test_classed_paths_really_ran(frames):
    """The cube's splats fill overflow rungs (so "auto" switches its
    ladder on from frame 2) and the full-footprint arms clip them: their
    steady frames differ from the default arm's."""
    counts = frames("cube", dict(megakernel=False), True)[-1][3]
    assert any(v > 0 for (b, k), v in counts.items() if k in (6, 7, 8, 9))
    default = frames("cube", {}, True)[-1]
    clipped = frames("cube", dict(compact_raster=False), True)[-1]
    assert not np.array_equal(default[0], clipped[0])


# name: (settings, the poses, the port arm whose frames it equals)
JUMP_ARMS = {
    "multi_dispatch": (dict(megakernel=False), "jump", {}),
    "cascade": (dict(megakernel=False, fused_compaction=False), "jump", {}),
    "budget": (dict(chunked_raster=False), "jump", {}),
}


@pytest.mark.parametrize("arm", sorted(JUMP_ARMS))
def test_arm_after_a_jump_meets_reference(frames, arm):
    """Two frames turned away from the cube (2,572 of its 20,000 points in
    view), then the full view: the budgets sized on the turned frames drop
    (multi-dispatch, sorted) or spill (budget megakernel) rows on the jump
    frame. The port drops and spills the reference's rows: the Frames
    contract, the same visible points and counts on every frame; the jump
    frame differs from the default arm's (rows were clipped) and the frame
    after it equals it. (The sorted arm's jump:
    tests/test_torch_fusion_sorted.py.)"""
    settings, poses, twin = JUMP_ARMS[arm]
    port = frames("cube", settings, True, poses)
    assert_frames_contract(port, frames("cube", settings, False, poses))
    assert port[0][2] * 4 < port[2][2]  # the jump: many more points
    default = frames("cube", {}, True, poses)
    assert not np.array_equal(port[2][0], default[2][0])
    if twin:
        assert_identical(port, frames("cube", twin, True, poses),
                         range(len(port)))
    else:
        assert_identical(port, default, [3])


def test_capped_rungs_part_the_chunked_arm_from_the_ladder(scenes,
                                                          monkeypatch):
    """The reference's arms are image-identical only while no overflow rung
    passes the chunked megakernel's cap: with a cap of one chunk the cube's
    6-9 px rungs pass it, the default arm draws their rows past the cap
    clipped through the footprint window, and its steady frame parts from
    the multi-dispatch arm's, which has no cap (at 1280x720 the real caps
    bind this way, chip_smoke.py phase 7)."""
    monkeypatch.setattr(tsplat, "RUNG_CAP_CHUNKS", 1)
    scene = scenes("cube")
    capped = render_frames(scene, {}, True, POSES["steady"][:2])
    ladder = render_frames(scene, dict(megakernel=False), True,
                           POSES["steady"][:2])
    counts = capped[-1][3]
    n = 1 << 15  # the cube's 20,000 points padded
    assert any(v > tsplat.rung_chunk_rows(k, n) for (_, k), v in
               counts.items() if isinstance(k, int) and k > 5)
    assert not np.array_equal(capped[-1][0], ladder[-1][0])
    monkeypatch.setattr(tsplat, "RUNG_CAP_CHUNKS", 64)
    assert_identical(render_frames(scene, {}, True, POSES["steady"][:2]),
                     ladder, [1])


def test_multi_dispatch_pack_overflow_falls_back(frames, scenes,
                                                 monkeypatch):
    """More counts than the packed tail holds: the multi-dispatch frame
    resolves and reads back synchronously (renderer.py:989-1005); frames
    and visible points equal the packed path's."""
    multi = frames("cube", dict(megakernel=False), True)
    monkeypatch.setattr(tsplat, "PACK_COUNTS", 3)
    assert_identical(render_frames(scenes("cube"), dict(megakernel=False),
                                   True, POSES["steady"][:2]), multi,
                     range(2))


# --- the budget bucket pass --------------------------------------------------


def chunk_bucket(n=1024, w=52, h=60):
    """The reference's synthetic bucket (test_render_kernel.py:1674-1707):
    every splat in the 9-px overflow rung at footprint 5."""
    cam = rcamera.Camera()
    rng = np.random.default_rng(77)
    pos = np.stack([rng.uniform(-4, 4, n), rng.uniform(28, 33, n),
                    rng.uniform(-4, 4, n)], axis=1).astype(np.float32)
    spacings = np.zeros(tkernel.MAX_HIERARCHIES, np.float32)
    spacings[0] = 1.45
    return dict(
        positions=pos, hier_base=np.zeros(n, np.int32),
        valid=np.ones(n, bool), point_id=np.arange(1, n + 1, dtype=np.int32),
        view=cam.view_matrix().astype(np.float32),
        projection=cam.projection_matrix().astype(np.float32),
        cam_pos=np.asarray(cam.transform.translation, np.float32),
        spacings=spacings,
        far_distances=np.zeros(tkernel.MAX_HIERARCHIES, np.float32)), (h, w)


ORDER = ("positions", "hier_base", "valid", "point_id", "view", "projection",
         "cam_pos", "spacings", "far_distances")


@pytest.mark.parametrize("budgets", ["ample", "spill"])
def test_budget_bucket_pass_matches_reference(budgets):
    """The budget arm of the bucket pass (splat.py:791-835): with ample
    budgets it equals the chunked arm word for word (the reference's
    :1709); with budgets that spill (the k=9 rung at 100 rows, the 3-px
    sub rung at 8, the footprint raster at 700 of its rows) it equals the
    spill composed by hand with the plain raster, word for word, and the
    reference's budget pass within the Frames contract, counts exact."""
    _, rsplat = jax_render()
    import jax.numpy as jnp

    arrays, (h, w) = chunk_bucket()
    n = len(arrays["positions"])
    overs, subs = (9, 17, 33, 65), (1, 3)
    rungs = subs + (5,) + overs
    t = {k: torch.as_tensor(v) for k, v in arrays.items()}
    thr = torch.tensor([k / 2 for k in rungs], dtype=torch.float32)
    args = [t[k] for k in ORDER] + [False, 0, thr]
    common = dict(height=h, width=w, footprint=5, voronoi=True,
                  use_occlusion=False, overflow_ks=overs, sub_ks=subs)
    if budgets == "ample":
        static = dict(out_size=n, overflow_rows=(n, 64, 64, 64),
                      sub_rows=(64, 64))
    else:
        static = dict(out_size=700, overflow_rows=(100, 64, 64, 64),
                      sub_rows=(64, 8))
    fb_b, vec_b = tsplat.render_bucket_pass(
        tsplat.make_framebuffer(h, w), *args, **common, **static,
        chunked=False)
    fb_c, vec_c = tsplat.render_bucket_pass(
        tsplat.make_framebuffer(h, w), *args, **common)
    assert torch.equal(vec_b, vec_c) and int(vec_b[4]) > 100
    if budgets == "ample":
        assert torch.equal(fb_b.packed, fb_c.packed)
    else:
        keep, _, vp, ndc, radius, _, rung = tkernel.cull_classify(
            *args[:3], *args[4:11], thr, w, h)
        rung = rung.numpy()
        parts, spill = [], np.zeros(n, bool)
        for j, (k, b) in enumerate(zip(rungs, (64, 8, None, 100, 64, 64,
                                               64))):
            rows = np.flatnonzero(rung == j)
            if b is None:
                spill[rows] = True
                continue
            parts.append((k, rows[:b]))
            spill[rows[b:]] = True
        parts.append((5, np.flatnonzero(spill)[:700]))
        assert spill.sum() > 700  # the footprint raster drops rows too
        manual = tsplat.make_framebuffer(h, w).packed
        for k, rows in parts:
            perm = np.concatenate([rows, np.zeros(n)]).astype(np.int32)
            tsplat.splat_raster_reference(
                manual, vp, ndc, radius, t["point_id"], torch.as_tensor(perm),
                torch.tensor([0], dtype=torch.int32),
                torch.tensor([len(rows)], dtype=torch.int32),
                t["projection"], h, w, k, True, 64)
        assert torch.equal(fb_b.packed, manual)
        assert not torch.equal(fb_b.packed, fb_c.packed)
    ref_fb, ref_vec = rsplat.render_bucket_pass(
        rsplat.make_framebuffer(h, w),
        *(jnp.asarray(arrays[k]) for k in ORDER), jnp.bool_(False),
        jnp.int32(0), depth=None, **common, **static, chunked=False)
    assert np.array_equal(vec_b.numpy(), np.asarray(ref_vec))
    same = fb_b.point_id.numpy() == np.asarray(ref_fb.point_id)
    assert same.mean() >= 0.999


def jax_render():
    from point_cloud_tpu.render import kernel, splat

    return kernel, splat


def test_only_a_footprint_below_one_is_refused():
    """check_ported takes every arm and every footprint from 1 up (129
    and 300 past the old kernels' 128-px windows) and refuses only a
    footprint below 1."""
    from point_cloud_tpu_torch.render.renderer import check_ported

    for settings in (dict(megakernel=False), dict(chunked_raster=False),
                     dict(compact_raster=False), dict(raster_mode="sorted"),
                     dict(frame_fusion=True),
                     dict(footprint=1, frame_fusion=True),
                     dict(footprint=128), dict(footprint=129),
                     dict(footprint=300, raster_mode="sorted")):
        check_ported(TSettings(**settings))
    for footprint in (0, -1):
        with pytest.raises(ValueError, match="footprint"):
            check_ported(TSettings(footprint=footprint))


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
