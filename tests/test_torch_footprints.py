"""Every footprint renders in the port, in every arm, as the reference
draws it: ladders of any length and windows wider than 128 px.

With default ``RenderSettings`` a footprint F gives a ladder of F - 1
sub-rungs, the footprint rung and the overflow rungs above it (29 to 31
rungs at F = 29, 129 at F = 129), and a bucket's raster table 33
segments at F = 29. K1 (``cull_classify``) takes any number of rungs, K2
(``splat_raster_segments``) any number of segments and any window, K3
(``emit_fragment_columns``) any number of classes and any window; the
renderer refuses only a footprint below 1; at footprint 1 it runs the
reference's arm (the multi-dispatch ladder, no megakernel).

On the CPU every kernel runs its plain version:

- the default arm against the JAX renderer at footprints 29, 31, 64 and
  129 under the Frames contract (``torch_arm_frames.assert_frames_contract``:
  >= 99.9% equal pixels, depth within 1e-6 where equal, the same visible
  points and landed counts). JAX's megakernel at 128 even sub-rungs takes
  longer to compile than this file may run, so both sides use
  ``even_sub_rungs=False`` there; the port's even ladder at 129 is held,
  bucket by bucket, against the NumPy oracle rasterizer of
  tests/test_torch_render.py, every row through its rung's window;
- the multi-dispatch, budget and sorted arms at 40 and 129 against the
  reference's same arm, a jump in visibility included;
- footprint 1 against the reference on every frame of the jump;
- K1's rung on ladders of 33 to 300 thresholds against the first-fit
  rule, a NaN ``rmax`` among them.

The ``cuda`` cases hold each kernel against its plain version on the
card at the sizes the old limits refused (33, 129 and 257 rungs; tables
of 33-300 segments with 129-, 200- and 257-px windows; more than 32
classes and windows above 128), and the renderer and the mesh renderer
at 29, 31 and 129 against the CPU, every arm. On the card, without JAX:
``PCT_TEST_PLATFORM=gpu python -m pytest tests/test_torch_footprints.py
-m cuda``.
"""

import numpy as np
import pytest
import torch

from point_cloud_tpu_torch.render import kernel as tkernel
from point_cloud_tpu_torch.render import splat as tsplat
from point_cloud_tpu_torch.render.renderer import RenderSettings as TSettings
from torch_arm_frames import (  # noqa: F401 (fixtures)
    NO_ID, POSES, W, H, assert_frames_contract, assert_identical, frames,
    render_frames, scenes,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's torch work (the workers
    share the machine's cores; see tests/test_torch_render.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def as_t(a, device="cpu"):
    return torch.as_tensor(np.ascontiguousarray(a), device=device)


def cull_rows(seed, n, device="cpu"):
    """K1's inputs (no occlusion) for ``n`` random points in front of the
    default camera, hierarchy 3's spacing NaN: its kept points have a NaN
    ``rmax``. Reuses the cull scene of tests/test_torch_render.py."""
    from test_torch_render import cull_scene

    arrays, _, (w, h) = cull_scene(seed, n=n)
    arrays["spacings"] = arrays["spacings"].copy()
    arrays["spacings"][3] = np.nan
    t = {k: as_t(v, device) for k, v in arrays.items()}
    return (t["positions"], t["hier_base"], t["valid"], t["view"],
            t["projection"], t["cam_pos"], t["spacings"],
            t["far_distances"], False, 3), (w, h)


def ladder_thresholds(n_rungs: int, device="cpu"):
    """k/2 of the default ladder of a footprint ``n_rungs``: 1..n_rungs."""
    return as_t(np.arange(1, n_rungs + 1, dtype=np.float32) / 2, device)


def first_fit(rmax, keep, thresholds):
    """The rung rule in NumPy: the first j < R - 1 with rmax <
    thresholds[j], else R - 1 (NaN fits none), -1 where not kept."""
    thr = np.asarray(thresholds)
    fits = rmax[:, None] < thr[None, :-1]
    rung = np.where(fits.any(axis=1), fits.argmax(axis=1), len(thr) - 1)
    return np.where(keep, rung, -1).astype(np.int32)


# --- K1: ladders of any length ------------------------------------------------


@pytest.mark.parametrize("n_rungs", [33, 64, 129, 300])
def test_cull_rung_on_long_ladders(n_rungs):
    """K1's rung (its plain version on the CPU) is the first fitting rung
    of ladders past the old 32-rung limit, NaN rmax to the catch-all."""
    args, (w, h) = cull_rows(7, 1 << 14)
    thr = ladder_thresholds(n_rungs)
    keep, _, _, _, _, rmax, rung = tkernel.cull_classify(*args, thr, w, h)
    want = first_fit(rmax.numpy(), keep.numpy(), thr.numpy())
    assert np.array_equal(rung.numpy(), want)
    nan_kept = keep.numpy() & np.isnan(rmax.numpy())
    assert nan_kept.sum() > 100
    assert (rung.numpy()[nan_kept] == n_rungs - 1).all()
    used = np.unique(rung.numpy()[keep.numpy()])
    assert len(used) > 20  # the rows spread over many rungs


# --- the renderer: every footprint, every arm ---------------------------------


ODD = dict(even_sub_rungs=False)


@pytest.mark.parametrize("scene,footprint", [
    ("small", 29), ("small", 31), ("near", 64), ("near", 129)])
def test_default_arm_meets_reference(frames, scene, footprint):
    """The default arm (the chunked megakernel) against the reference's at
    a ladder of odd sub-rungs: two frames (the arm keeps no history)
    under the Frames contract. On the near scene most splats fall in the
    footprint rung and are drawn through its 64- or 129-px window."""
    settings = dict(footprint=footprint, **ODD)
    port = frames(scene, settings, True, "twice")
    assert_frames_contract(port, frames(scene, settings, False, "twice"))
    assert (port[-1][4] != NO_ID).sum() > 500


def test_even_ladder_at_129_matches_numpy_oracle(scenes, monkeypatch):
    """Every bucket of the default arm's frame at footprint 129 (129 rungs:
    1..128 and the footprint), from its input plane, equals the NumPy
    oracle rasterizer with every kept row drawn through its rung's window,
    bit for bit; the rows spread over many rungs."""
    from test_torch_render import oracle_fragments, oracle_raster

    captured = []
    bucket_pass = tsplat.render_bucket_pass

    def capture(framebuffer, *args, **kw):
        fb_in = framebuffer.packed.clone()
        out = bucket_pass(framebuffer, *args, **kw)
        captured.append((fb_in, args, kw, out[0].packed.clone()))
        return out

    monkeypatch.setattr(tsplat, "render_bucket_pass", capture)
    render_frames(scenes("near"), dict(footprint=129), True, ("view",))
    assert captured
    spread = set()
    for fb_in, args, kw, fb_out in captured:
        (positions, hier_base, valid, ids, view, proj, cam_pos, spacings,
         fars, sbd, maxh, thresholds) = args
        rungs = kw["sub_ks"] + (129,) + kw["overflow_ks"]
        assert rungs == tuple(range(1, 130))
        h, w = kw["height"], kw["width"]
        plane_in = tsplat.Framebuffer(fb_in)
        depth = tsplat.framebuffer_depth(plane_in, h, w)
        keep, _, view_pos, ndc, radius, _, rung = (
            tkernel.cull_classify_reference(
                positions, hier_base, valid, view, proj, cam_pos, spacings,
                fars, sbd, maxh, thresholds, w, h, depth=depth,
                coarse=tkernel.coarse_depth_grid(depth)))
        frags = []
        for j in np.unique(rung.numpy()[keep.numpy()]):
            rows = np.flatnonzero(rung.numpy() == j)
            spread.add(int(j))
            frags.append(oracle_fragments(
                view_pos.numpy()[rows], ndc.numpy()[rows],
                radius.numpy()[rows], ids.numpy()[rows], proj.numpy(), h, w,
                rungs[j], kw["voronoi"]))
        want_d, want_i = oracle_raster(
            plane_in.depth.numpy(), plane_in.point_id.numpy().astype(np.int64),
            *(np.concatenate(parts) for parts in zip(*frags))) if frags else (
            plane_in.depth.numpy(), plane_in.point_id.numpy())
        got = tsplat.Framebuffer(fb_out)
        assert np.array_equal(got.point_id.numpy(), want_i)
        assert np.array_equal(got.depth.numpy().view(np.int32),
                              np.where(want_d == 0, 0, want_d)
                              .astype(np.float32).view(np.int32))
    assert len(spread) >= 20


# name: (scene, settings, footprint); each against the reference's same
# arm over the jump (two frames turned away, then the full view, whose
# budgets come from the turned frames). The
# sorted arm classes every splat (classing on): the near scene's 30 live
# classes of at least 1,024 slot rows each are too dear for the CPU here
JUMP_ARMS = {
    "multi_dispatch_40": ("small", dict(megakernel=False), 40),
    "multi_dispatch_129": ("near", dict(megakernel=False), 129),
    "budget_40": ("near", dict(chunked_raster=False, **ODD), 40),
    "budget_129": ("near", dict(chunked_raster=False, **ODD), 129),
    "sorted_40": ("small", dict(raster_mode="sorted", classing=True), 40),
    "sorted_129": ("small", dict(raster_mode="sorted", classing=True), 129),
}


@pytest.mark.parametrize("arm", sorted(JUMP_ARMS))
def test_arm_after_a_jump_meets_reference(frames, arm):
    scene, settings, footprint = JUMP_ARMS[arm]
    settings = dict(footprint=footprint, **settings)
    port = frames(scene, settings, True, "jump3")
    assert_frames_contract(port, frames(scene, settings, False, "jump3"))
    assert port[0][2] < port[-1][2]  # the jump: fewer points turned away


def test_footprint_one_meets_reference_every_frame_of_a_jump(frames):
    """Footprint 1 runs the reference's arm (multi-dispatch, a budget sized
    from the last frame): after the jump the budget drops the rows the
    reference drops, so every frame meets its frame."""
    port = frames("small", dict(footprint=1), True, "jump")
    assert_frames_contract(port, frames("small", dict(footprint=1), False,
                                        "jump"))
    assert port[0][2] < port[2][2]


def test_footprint_one_runs_no_megakernel(scenes, monkeypatch):
    """At footprint 1 no bucket goes through render_bucket_pass (the
    reference's ``s.footprint > 1``), with frame fusion on too."""
    def refuse(*args, **kw):
        raise AssertionError("the megakernel ran at footprint 1")

    monkeypatch.setattr(tsplat, "render_bucket_pass", refuse)
    for settings in (dict(footprint=1), dict(footprint=1, frame_fusion=True)):
        out = render_frames(scenes("small"), settings, True, ("view",) * 2)
        assert out[-1][2] > 0


# --- on the card ----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the frame kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_rungs", [33, 129, 257, 9000])
def test_cull_kernel_takes_long_ladders(cuda_device, n_rungs):
    """K1 against its plain version on the card, every output bit for bit,
    at ladders the old kernel refused (9,000 rungs: past its shared-memory
    copy, read from device memory)."""
    args, (w, h) = cull_rows(9, 1 << 15, cuda_device)
    thr = ladder_thresholds(n_rungs, cuda_device)
    before = tkernel.launches
    got = tkernel.cull_classify(*args, thr, w, h)
    ref = tkernel.cull_classify_reference(*args, thr, w, h)
    torch.cuda.synchronize()
    assert tkernel.launches == before + 1
    for g, r in zip(got, ref):
        if g.dtype == torch.float32:
            g, r = g.view(torch.int32), r.view(torch.int32)
        assert torch.equal(g, r)
    assert len(torch.unique(got[6])) > 20


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_raster_kernel_takes_long_tables_and_wide_windows(cuda_device, seed):
    """One K2 launch over a random table of 33 to 300 segments, windows up
    to 257 px (129, 200 and 257 among them), caps that bite and tails,
    against the plain loop on the card."""
    from test_torch_render import splat_rows

    w, h, n = 640, 360, 6000
    rng = np.random.default_rng(seed)
    n_rungs = int(rng.integers(20, 150))
    ks = [129, 200, 257] + [int(k) for k in rng.integers(1, 258,
                                                        n_rungs - 3)]
    view_pos, ndc, radius, ids, proj = splat_rows(seed, n, w, h, 40.0)
    rung = rng.integers(-1, n_rungs, n).astype(np.int32)
    dev = lambda x: as_t(x, cuda_device)
    perm, counts, offsets = tsplat.compact_classes(dev(rung), n_rungs)
    segments = []
    for j, k in enumerate(ks):
        cap = int(rng.choice([0, 5, 30, tsplat.NO_CAP]))
        segments.append(tsplat.Segment(k, j, cap, False))
        if rng.random() < 0.5 or len(segments) < 33:
            segments.append(tsplat.Segment(int(rng.choice(ks)), j, cap, True))
    segments = tuple(segments[i] for i in rng.permutation(len(segments)))
    assert 33 <= len(segments) <= 300
    args = [dev(x) for x in (view_pos, ndc, radius, ids)]
    fb_k = tsplat.make_framebuffer(h, w, cuda_device).packed
    fb_p = fb_k.clone()
    before = tsplat.launches
    tsplat.splat_raster_segments(fb_k, *args, perm, offsets, counts,
                                 dev(proj), h, w, segments, True)
    tsplat.splat_raster_segments_reference(
        fb_p, *args, perm, offsets, counts, dev(proj), h, w, segments, True)
    torch.cuda.synchronize()
    assert tsplat.launches == before + 1
    assert torch.equal(fb_k, fb_p)
    assert (fb_k != tsplat._CLEAR_WORD).sum() > 10_000


@pytest.mark.cuda
def test_fragment_kernel_takes_many_classes_and_wide_windows(cuda_device):
    """One K3 launch over 40 classes (windows to 257 px), against its plain
    version on the card, every column bit for bit."""
    from test_torch_render import splat_rows

    w, h, n = 640, 360, 3000
    rng = np.random.default_rng(4)
    view_pos, ndc, radius, ids, proj = splat_rows(4, n, w, h, 40.0)
    n_cls = 40
    rung = rng.integers(-1, n_cls, n).astype(np.int32)
    dev = lambda x: as_t(x, cuda_device)
    perm, counts, offsets = tsplat.compact_classes(dev(rung), n_cls)
    ks = [129, 200, 257] + [int(k) for k in rng.integers(1, 140, n_cls - 3)]
    classes = tuple(tsplat.FragmentClass(k, c, int(rng.integers(1, 12)))
                    for c, k in enumerate(ks))
    length = tsplat.fragment_total(classes) + 1000
    args = [dev(x) for x in (view_pos, ndc, radius, ids)]
    before = tsplat.fragment_launches
    got = tsplat.emit_fragment_columns(*args, perm, offsets, counts,
                                       dev(proj), h, w, classes, True, length)
    want = tsplat.emit_fragment_columns_reference(
        *args, perm, offsets, counts, dev(proj), h, w, classes, True, length)
    torch.cuda.synchronize()
    assert tsplat.fragment_launches == before + 1
    for g, r in zip(got, want):
        assert torch.equal(g, r)
    assert (got[0] != NO_ID).sum() > 10_000


# every arm of the renderer at the footprints the old kernels refused
CARD_ARMS = {
    "default": {},
    "multi_dispatch": dict(megakernel=False),
    "budget": dict(chunked_raster=False),
    "sorted": dict(raster_mode="sorted", classing=True),
    "fusion": dict(frame_fusion=True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("footprint", [29, 31, 129])
@pytest.mark.parametrize("arm", sorted(CARD_ARMS))
def test_arm_on_card_matches_cpu(cuda_device, scenes, arm, footprint):
    """Every frame of each arm on the card equals the port's CPU frames:
    rgb, ids and visible points identical, depth by value."""
    settings = dict(footprint=footprint, **CARD_ARMS[arm])
    gpu = render_frames(scenes("small"), settings, True, POSES["jump"],
                        device="cuda")
    cpu = render_frames(scenes("small"), settings, True, POSES["jump"])
    assert_identical(gpu, cpu, range(4))


@pytest.mark.cuda
@pytest.mark.parametrize("footprint", [29, 31, 129])
def test_mesh_on_card_matches_cpu(cuda_device, scenes, footprint):
    """The mesh renderer on four logical shards of the card equals the
    same mesh on the CPU and the single-device plain arm on the card."""
    from point_cloud_tpu_torch.parallel.mesh import make_mesh
    from point_cloud_tpu_torch.render.parallel import MeshPointRenderer
    from point_cloud_tpu_torch.render.renderer import PointRenderer
    from torch_arm_frames import port_camera, streamed

    scene = scenes("small")
    cam = port_camera(scene.cam)
    streamer, frustums = streamed(scene.tmeta, scene.path, cam, port=True)
    plain = TSettings(width=W, height=H, footprint=footprint,
                      compact_raster=False, megakernel=False, classing=False)
    outs = []
    card = torch.device("cuda", torch.cuda.current_device())
    for r in (MeshPointRenderer(scene.tmeta, make_mesh(devices=[card] * 4),
                                settings=plain),
              MeshPointRenderer(scene.tmeta, make_mesh(4, device="cpu"),
                                settings=plain),
              PointRenderer(scene.tmeta, plain, device="cuda")):
        rgb, depth, stats = r.render(streamer, cam, frustums)
        outs.append((rgb, depth, stats["points_visible"],
                     r.framebuffer.point_id.cpu()))
    for rgb, depth, vis, ids in outs[1:]:
        assert np.array_equal(rgb, outs[0][0])
        assert np.array_equal(depth, outs[0][1])
        assert vis == outs[0][2] > 0
        assert torch.equal(ids, outs[0][3])
