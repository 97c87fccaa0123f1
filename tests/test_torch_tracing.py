"""The port's tracing (point_cloud_tpu_torch/utils/tracing.py) and the
frame's spans and counters.

``StageTimer`` keeps each span as (name, t0, t1, thread id); ``count``
adds to the active timer's counters; with no timer installed both do
nothing. A ``Viewer`` frame on the CPU records
``render.gather``, ``render.upload``, ``render.dispatch``, ``render.wait``
and ``update.asset_wait`` inside the calls that made them, counts one
``render.bucket_hit`` or ``render.bucket_miss`` a bucket (and one
``render.cells_read`` a cell a miss reads), and renders the same bytes
with the timer installed as without it.
"""

import threading
import time
from contextlib import nullcontext

import numpy as np
import pytest
import torch

from point_cloud_tpu_torch.convert.converter import Converter
from point_cloud_tpu_torch.core.metadata import Metadata, MetadataConfig
from point_cloud_tpu_torch.core.point import PointBatch
from point_cloud_tpu_torch.render.renderer import RenderSettings
from point_cloud_tpu_torch.render.transform import Transform
from point_cloud_tpu_torch.utils import tracing
from point_cloud_tpu_torch.utils.tracing import StageTimer, count, stage
from point_cloud_tpu_torch.viewer import Viewer

RENDER_SPANS = ("render.gather", "render.upload", "render.dispatch",
                "render.wait")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread, as in test_torch_viewer.py: the test workers
    share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    path = tmp_path_factory.mktemp("store")
    rng = np.random.default_rng(14)
    pos = rng.uniform(-50, 50, (20_000, 3)).astype(np.float32)
    col = rng.integers(0, 256, (20_000, 4), dtype=np.uint8)
    # 32-unit cells: from 35 units away the cloud spans two distance
    # buckets
    with Converter(Metadata(config=MetadataConfig(500, 16, 32.0)),
                   path) as conv:
        conv.add_points_batch(PointBatch(pos, col))
    return path / "metadata.json"


def place(viewer, angle):
    """The camera 35 units from the cloud's centre, looking at it."""
    eye = np.array([35 * np.cos(angle), 35 * np.sin(angle), 10], np.float32)
    t = Transform.from_translation(eye)
    t.look_at(np.zeros(3, np.float32), np.array([0, 0, 1], np.float32))
    viewer.fly_cam.transform = t
    viewer._camera_dirty = True


def settle(viewer):
    for _ in range(400):
        viewer.update()
        s = viewer.streamer
        if not s.loading and len(s.should_load) == 0:
            return
        time.sleep(0.002)
    raise AssertionError("streaming did not settle")


def settled_viewer(store, **settings):
    viewer = Viewer(RenderSettings(width=96, height=64, **settings),
                    device="cpu")
    viewer.load_metadata(store)
    place(viewer, 0.0)
    try:
        settle(viewer)
    except AssertionError:
        viewer.close()
        raise
    return viewer


def inside(intervals, i, j) -> bool:
    """Span i lies in span j: the same thread, within its clock times."""
    _, t0, t1, tid = intervals[i]
    _, u0, u1, utid = intervals[j]
    return i != j and tid == utid and u0 <= t0 <= t1 <= u1


def test_intervals_nest_by_parent_on_one_thread():
    """Spans end inner first, and each lies in the spans open around it
    (its parent chain) by its clock times, and in no other."""
    with StageTimer() as t:
        with stage("a"):
            with stage("b"):
                with stage("c"):
                    pass
            with stage("b"):
                pass
        with stage("d"):
            pass
    iv = t.intervals
    assert [s[0] for s in iv] == ["c", "b", "b", "a", "d"]
    me = threading.get_ident()
    assert all(s[3] == me and s[1] <= s[2] for s in iv)
    around = {i: {j for j in range(len(iv)) if inside(iv, i, j)}
              for i in range(len(iv))}
    assert around == {0: {1, 3}, 1: {3}, 2: {3}, 3: set(), 4: set()}
    assert t.report()["b"]["count"] == 2


def test_worker_threads_fall_back_with_their_own_thread_id():
    ids = []

    def work():
        ids.append(threading.get_ident())
        with stage("worker"):
            with stage("inner"):
                count("worker.items", 3)

    with StageTimer() as t:
        with stage("main"):
            threads = [threading.Thread(target=work) for _ in range(4)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=30)
    assert not any(th.is_alive() for th in threads)
    iv = t.intervals
    workers = [i for i, s in enumerate(iv) if s[0] == "worker"]
    assert sorted(iv[i][3] for i in workers) == sorted(ids)
    assert threading.get_ident() not in ids
    main = next(i for i, s in enumerate(iv) if s[0] == "main")
    for i, s in enumerate(iv):
        if s[0] == "inner":  # in its own thread's worker span alone
            assert [iv[j][0] for j in range(len(iv))
                    if inside(iv, i, j)] == ["worker"]
        elif s[0] == "worker":  # on another thread than the main span
            assert not inside(iv, i, main)
    assert t.counters["worker.items"] == 12


@pytest.mark.parametrize("call", ["stage", "count"])
def test_off_without_a_timer(call):
    assert tracing._current_timer.get() is None
    assert tracing._global_timer is None
    if call == "stage":
        with stage("ignored"):
            with stage("nested"):
                pass
    else:
        count("ignored")
        count("ignored", 7)
    # a timer installed afterwards saw none of it
    with StageTimer() as t:
        pass
    assert t.intervals == [] and not t.counters and not t.totals


def test_report_carries_counters():
    """The counters in ``counters`` and in the summary after the stages;
    ``report`` keeps one row shape, a stage's."""
    with StageTimer() as t:
        with stage("s"):
            count("hits")
            count("hits", 2)
    assert dict(t.counters) == {"hits": 3}
    report = t.report()
    assert set(report) == {"s"}
    assert set(report["s"]) == {"total_s", "count", "mean_ms"}
    assert report["s"]["count"] == 1
    lines = t.summary().splitlines()
    assert lines[0].strip().startswith("s:")
    assert lines[1].strip() == "hits: x3"


def test_viewer_frame_spans_lie_in_the_call_that_made_them(store):
    viewer = settled_viewer(store)
    try:
        with StageTimer() as t:
            with stage("frame.render"):
                assert viewer.render_pipelined() is None
            place(viewer, 0.3)
            viewer.update()
            with stage("frame.render"):
                rgb, _, stats = viewer.render_pipelined()
            assert stats["buckets"] > 0 and rgb.any()
        viewer.render_flush()
        # the asset pool's wait, while a load is in flight
        viewer.load_metadata(store)
        place(viewer, 0.0)
        viewer.update()  # queues the loads of the fresh view
        assert viewer.streamer.loading
        viewer.cell_assets.has_completions = lambda: False
        with StageTimer() as waited:
            viewer.update()
        assert [s[0] for s in waited.intervals] == ["update.asset_wait"]
        iv = t.intervals
        frames = [i for i, s in enumerate(iv) if s[0] == "frame.render"]
        for name in ("render.gather", "render.dispatch"):
            for frame in frames:
                assert any(s[0] == name and inside(iv, i, frame)
                           for i, s in enumerate(iv)), (name, frame)
        waits = [i for i, s in enumerate(iv) if s[0] == "render.wait"]
        assert waits and all(inside(iv, i, frames[1]) for i in waits)
        assert all(any(inside(iv, i, f) for f in frames)
                   for i, s in enumerate(iv) if s[0] in RENDER_SPANS)
    finally:
        viewer.close()


def test_buckets_miss_at_a_new_pose_then_hit(store):
    viewer = settled_viewer(store)
    try:
        runs = []
        for _ in range(2):
            with StageTimer() as t:
                _, _, stats = viewer.render()
            runs.append((t, stats["buckets"], stats["cells"]))
        (first, buckets, cells), (second, again, _) = runs
        assert buckets == again > 0
        # the misses read each gathered cell once; the hits read none
        assert dict(first.counters) == {"render.bucket_miss": buckets,
                                        "render.cells_read": cells}
        assert dict(second.counters) == {"render.bucket_hit": buckets}
        assert "render.upload" in first.report()  # the misses' copies
        assert "render.upload" not in second.report()
    finally:
        viewer.close()


@pytest.mark.parametrize("settings", [
    {},  # the bucket megakernel, packed readback
    {"megakernel": False},  # the multi-dispatch ladder
    {"footprint": 64},  # more counts than the pack holds: synchronous
], ids=["megakernel", "multi_dispatch", "sync_readback"])
def test_frames_are_byte_identical_with_the_timer(store, settings):
    """Two viewers on one path of poses, one under the timer: the same
    frames, landed counts and stats (the arms' frames depend on the
    counts the frames before them landed, so each side keeps its own)."""
    plain, traced = (settled_viewer(store, **settings) for _ in range(2))
    t = StageTimer()  # installed around the traced side only
    try:
        outs = {False: [], True: []}
        for angle in (0.0, 0.4, 0.4, 1.3, 0.0):
            for on, viewer in ((False, plain), (True, traced)):
                with (t if on else nullcontext()):
                    place(viewer, angle)
                    settle(viewer)
                    outs[on].append(viewer.render_pipelined())
        for on, viewer in ((False, plain), (True, traced)):
            with (t if on else nullcontext()):
                outs[on].append(viewer.render_flush())
        assert "render.dispatch" in t.report() and t.counters
        assert plain.renderer._survivor_counts
        assert plain.renderer._survivor_counts == \
            traced.renderer._survivor_counts
        for a, b in zip(outs[False][1:], outs[True][1:], strict=True):
            (rgb_a, depth_a, stats_a), (rgb_b, depth_b, stats_b) = a, b
            assert rgb_a.tobytes() == rgb_b.tobytes()
            assert depth_a.tobytes() == depth_b.tobytes()
            assert stats_a == stats_b
        if settings.get("footprint") == 64:  # 66 counts a bucket
            assert min(o[2]["buckets"] for o in outs[True][1:]) >= 2
    finally:
        plain.close()
        traced.close()
