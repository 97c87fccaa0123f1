"""The port's store server (point_cloud_tpu_torch/serve.py) against the
reference's.

Both servers run on the same store, each on its own port, the port's on
the CPU (the plain versions of its kernels). For the same requests they
answer with the same status codes and the same JSON bodies (paths under
each server's own convert root compared relative to it): stats, settings
and the debug toggles, the store list, the in-app converter and its
status, uploads and store uploads with their 400, 403 and 413 cases,
exports byte for byte, static files and path escapes. ``/render`` PNGs,
decoded, meet the Frames contract (>= 99.9% equal pixels: XLA:CPU fuses
multiply-adds into fma, so the JAX frame is no IEEE reference) at
footprint 5 and footprint 1. The port's differences are tested on their
own: a store upload's total budget (HTTP 413 past it), ``--mesh``
refused, no start without a card.
"""

import json
import struct
import threading
import time
import urllib.error
import urllib.request
import zlib
from io import BytesIO
from urllib.parse import quote

import numpy as np
import pytest
import torch

from point_cloud_tpu import serve as rserve
from point_cloud_tpu.convert.converter import Converter
from point_cloud_tpu.core.metadata import Metadata
from point_cloud_tpu.core.point import PointBatch
from point_cloud_tpu.io.ply import write_ply
from point_cloud_tpu_torch import serve as tserve


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

W, H = 96, 64


def points(n, seed, lo, hi):
    rng = np.random.default_rng(seed)
    return PointBatch(rng.uniform(lo, hi, (n, 3)).astype(np.float32),
                      rng.integers(0, 256, (n, 4)).astype(np.uint8))


def convert(out, n, seed, lo=-40.0, hi=40.0):
    with Converter(Metadata(), out) as conv:
        conv.add_points_batch(points(n, seed, lo, hi))
    return out


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    return convert(tmp_path_factory.mktemp("servestore"), 15_000, 20)


class Server:
    """One running server: its base URL, its convert root, its module."""

    def __init__(self, module, store, root=None, **kw):
        self.module, self.root = module, root
        self.httpd = module.serve(store, host="127.0.0.1", port=0, width=W,
                                  height=H, convert_root=root, **kw)
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    @property
    def store_server(self):
        registry = self.httpd.registry
        return registry.get(registry.default)

    def ask(self, method, path, body=None):
        """(status, content type, body): JSON parsed, text decoded, both
        with this server's convert root written as <root>."""
        data = body if isinstance(body, bytes) or body is None else (
            json.dumps(body).encode())
        req = urllib.request.Request(self.url + path, data=data,
                                     method=method)
        try:
            with urllib.request.urlopen(req, timeout=300) as resp:
                status, headers, raw = resp.status, resp.headers, resp.read()
        except urllib.error.HTTPError as err:
            status, headers, raw = err.code, err.headers, err.read()
        ctype = headers["Content-Type"]
        if ctype == "application/json":
            return status, ctype, self._relative(json.loads(raw))
        if ctype == "text/plain":
            return status, ctype, self._relative(raw.decode())
        return status, ctype, raw

    def _relative(self, value):
        if isinstance(value, dict):
            return {k: self._relative(v) for k, v in value.items()}
        if isinstance(value, list):
            return [self._relative(v) for v in value]
        if isinstance(value, str) and self.root is not None:
            for root in (str(self.root.resolve()), str(self.root)):
                value = value.replace(root, "<root>")
        return value

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def both_answer(pair, method, path, body=None):
    """The two servers' answers to one request: equal; the port's."""
    ref, port = (s.ask(method, path, body) for s in pair)
    assert port[:2] == ref[:2], (path, ref, port)
    assert port[2] == ref[2], path
    return port


@pytest.fixture(scope="module")
def pair(store):
    servers = (Server(rserve, store), Server(tserve, store, device="cpu"))
    yield servers
    for s in servers:
        s.close()


def cell_name(store):
    return sorted((store / "h_0").iterdir())[0].name


REQUESTS = [
    ("GET", "/stats", None), ("GET", "/settings", None),
    ("GET", "/stores", None), ("GET", "/convert", None),
    ("GET", "/metadata.json", None), ("GET", "/h_0/{cell}", None),
    ("GET", "/h_0/c_999_999_999.bin", None),
    ("GET", "/h_0/..%2f..%2fetc%2fpasswd", None), ("GET", "/../x", None),
    ("GET", "/s/gamma/stats", None), ("GET", "/s/", None),
    ("GET", "/nothing/here", None),
    ("GET", "/render?yaw=sideways", None), ("GET", "/render?px=1&py=2", None),
    ("GET", "/render?dist=far", None),
    ("GET", "/export?format=xyz", None), ("GET", "/export?format=a%2Fb", None),
    ("GET", "/export?format=..%2F..%2Ftmp%2Fx", None),
    ("GET", "/export?format=.", None), ("GET", "/export?format=%2e%2e", None),
    ("GET", "/export?format=las&scale=0", None),
    ("GET", "/export?format=las&point_format=x", None),
    ("GET", "/export?format=las&point_format=5", None),
    ("GET", "/convert/files?dir=", None),
    ("GET", "/upload_store?name=x&path=metadata.json", None),
    ("POST", "/settings", {"footprint": 4}),
    ("POST", "/settings", {"debug": {"frozen_frustum": True}}),
    ("POST", "/settings", {"debug": {"nope": True}}),
    ("POST", "/settings", b"{not json"),
    ("POST", "/nothing", {}),
    ("POST", "/convert", {"action": "bogus"}),
    ("POST", "/convert", {"action": "choose", "files": ["a.ply"]}),
    ("POST", "/upload?filename=a.ply", b"x"),
    ("POST", "/upload_store?name=x&path=metadata.json", b"x"),
    ("POST", "/upload_store/finish?name=x", b""),
    ("POST", "/s/gamma/settings", {}),
    ("GET", "/convert", None),
]


@pytest.mark.parametrize("method,path,body", REQUESTS,
                         ids=[f"{m}{p}" for m, p, _ in REQUESTS])
def test_same_answers(pair, store, method, path, body):
    both_answer(pair, method, path.format(cell=cell_name(store)), body)


def test_static_files_and_index(pair, store):
    _, _, meta = both_answer(pair, "GET", "/metadata.json")
    assert meta == json.loads((store / "metadata.json").read_text())
    cell = cell_name(store)
    _, _, body = both_answer(pair, "GET", f"/h_0/{cell}")
    assert body == (store / "h_0" / cell).read_bytes()
    # the browser client: the reference's page but for the comment that
    # names the package
    pages = [s.ask("GET", "/")[2].decode() for s in pair]
    assert [p.split("-->", 1)[1] for p in pages][0] == (
        pages[1].split("-->", 1)[1])
    assert "point-cloud-tpu viewer" in pages[1] and "/render?" in pages[1]


def test_settings_round_trip(pair):
    patch = {"voronoi": False, "size_by_distance": True, "max_hierarchy": 2,
             "footprint": 7, "occlusion": False, "hidden_hierarchies": [1],
             "stream_enabled": False, "streaming_scale": 3.5,
             "fly_speed": 20000.0,
             "debug": {"show_bounding_box": True, "show_cell_grid": True}}
    status, _, after = both_answer(pair, "POST", "/settings", patch)
    assert status == 200 and after["footprint"] == 7
    assert after["fly_speed"] == 1000.0
    assert both_answer(pair, "GET", "/settings")[2] == after
    both_answer(pair, "POST", "/settings", {
        "voronoi": True, "size_by_distance": False, "max_hierarchy": 0,
        "footprint": 5, "occlusion": True, "hidden_hierarchies": [],
        "stream_enabled": True, "streaming_scale": 2.0, "fly_speed": 50.0,
        "debug": {"show_bounding_box": False, "show_cell_grid": False}})


def test_debug_toggles(pair):
    for body in ({"freeze_frustum": True},
                 {"debug": {"show_frustum": False}},
                 {"debug": {"show_frustum": True, "show_plane_normals": True,
                            "show_streaming_rects": True}}):
        both_answer(pair, "POST", "/settings", body)
    _, _, settings = both_answer(pair, "GET", "/settings")
    assert all(settings["debug"][k] for k in (
        "show_frustum", "show_plane_normals", "show_streaming_rects"))
    both_answer(pair, "POST", "/settings", {"debug": {
        "show_frustum": False, "show_plane_normals": False,
        "show_streaming_rects": False}})


def decode_png(data: bytes) -> np.ndarray:
    """An 8-bit RGB PNG of filter-0 rows (viewer/offscreen.write_png)."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, size = 8, b"", None
    while pos < len(data):
        (length,), tag = struct.unpack(">I", data[pos:pos + 4]), data[
            pos + 4:pos + 8]
        chunk = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            size = struct.unpack(">II", chunk[:8])
        elif tag == b"IDAT":
            idat += chunk
        pos += 12 + length
    w, h = size
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


def render_both(pair, query):
    """Both servers' PNG at one pose, decoded; their X-Camera echoes."""
    frames, echoes = [], []
    for s in pair:
        with urllib.request.urlopen(f"{s.url}/render?{query}",
                                    timeout=300) as resp:
            assert resp.status == 200
            echoes.append(resp.headers["X-Camera"])
            frames.append(decode_png(resp.read()))
    assert echoes[0] == echoes[1]
    return frames


@pytest.mark.parametrize("footprint", [5, 1])
def test_render_meets_frames_contract(pair, footprint):
    """Orbit and fly poses, and a per-request voronoi override, at each
    footprint: >= 99.9% of the pixels equal and the cloud on screen, on
    every frame (at footprint 1 both servers size the multi-dispatch
    arm's budget from the last frame, so they drop the same rows on the
    first frame after a jump in visibility)."""
    both_answer(pair, "POST", "/settings", {"footprint": footprint})
    try:
        for query in ("yaw=0.5&pitch=-0.5", "yaw=1.25&pitch=-0.5&dist=77.5",
                      "px=10.5&py=-20&pz=30&yaw=2.0&pitch=-0.1",
                      "yaw=0.3&voronoi=0"):
            ref, port = render_both(pair, query)
            assert port.shape == (H, W, 3)
            same = (ref == port).all(axis=2).mean()
            assert same >= 0.999, (query, same)
            assert (port != port[0, 0]).any(axis=2).sum() > 200, query
        _, _, settings = both_answer(pair, "GET", "/settings")
        assert settings["footprint"] == footprint and settings["voronoi"]
    finally:
        both_answer(pair, "POST", "/settings", {"footprint": 5})


def test_footprints_render_differently(pair):
    """Footprint 1 is its own arm: the same pose draws fewer pixels."""
    lit = []
    for fp in (5, 1):
        both_answer(pair, "POST", "/settings", {"footprint": fp})
        _, port = render_both(pair, "yaw=0.5&pitch=-0.5")
        lit.append(int((port != port[0, 0]).any(axis=2).sum()))
    both_answer(pair, "POST", "/settings", {"footprint": 5})
    assert lit[1] < lit[0]


@pytest.mark.parametrize("query", ["format=ply", "format=las&point_format=3",
                                   "format=laz"])
def test_export_bytes_match(pair, query):
    _, ctype, body = both_answer(pair, "GET", f"/export?{query}")
    assert ctype == "application/octet-stream" and len(body) > 10_000


def test_hostile_store_name_cannot_inject_headers(pair):
    dispositions = []
    for s in pair:
        server = s.store_server
        prev = server.metadata.name
        server.metadata.name = 'ev"il\r\nSet-Cookie: pwned=1\x7f'
        try:
            with urllib.request.urlopen(f"{s.url}/export?format=ply",
                                        timeout=300) as resp:
                assert resp.headers.get("Set-Cookie") is None
                dispositions.append(resp.headers["Content-Disposition"])
        finally:
            server.metadata.name = prev
    assert dispositions[0] == dispositions[1] == (
        'attachment; filename="evilSet-Cookie: pwned=1.ply"')


def test_voronoi_override_restored_on_early_exception(pair):
    server = pair[1].store_server
    v = server.viewer
    prev = v.settings.voronoi

    def fail():
        raise RuntimeError("streaming blew up")

    server._drain_streaming = fail
    try:
        with pytest.raises(RuntimeError):
            server.render_png(voronoi=not prev)
        assert v.settings.voronoi == prev
    finally:
        del server._drain_streaming


def test_remote_port_viewer_streams_over_http(pair):
    """A port Viewer on another machine streams cells from the port's
    server through UrlSource and renders them."""
    from point_cloud_tpu_torch.render.renderer import RenderSettings
    from point_cloud_tpu_torch.viewer import Viewer

    viewer = Viewer(RenderSettings(width=W, height=H), device="cpu")
    try:
        viewer.load_metadata(f"{pair[1].url}/metadata.json")
        assert viewer.metadata.number_of_points == 15_000
        for _ in range(400):
            viewer.update()
            if (not viewer.streamer.loading
                    and len(viewer.streamer.should_load) == 0
                    and not viewer.cell_assets._loading):
                break
            time.sleep(0.005)
        assert viewer.stats()["cells"]["loaded"] > 0
        _, depth, _ = viewer.render()
        assert (depth < 1.0).sum() > 0
    finally:
        viewer.close()


@pytest.fixture(scope="module")
def multi_pair(tmp_path_factory):
    root = tmp_path_factory.mktemp("stores")
    for name, seed in (("alpha", 1), ("beta", 2), ("my store #1", 4)):
        convert(root / name, 3_000, seed, -30.0, 30.0)
    (root / "not_a_store").mkdir()
    servers = (Server(rserve, root), Server(tserve, root, device="cpu"))
    yield servers
    for s in servers:
        s.close()


@pytest.mark.parametrize("path", [
    "/stores", "/s/beta/stats", "/s/beta/metadata.json", "/s/gamma/stats",
    "/metadata.json", f"/s/{quote('my store #1', safe='')}/stats",
    "/s/alpha/settings"])
def test_multi_store_answers(multi_pair, path):
    both_answer(multi_pair, "GET", path)


def test_mesh_is_refused(store):
    """``mesh_devices`` renders on the CPU through the mesh renderer (the
    same PNG as one device's plain raster arm would give is held in
    tests/test_torch_render_parallel.py); the CLI's ``--mesh`` is refused
    only for want of a card."""
    from point_cloud_tpu_torch.render.parallel import MeshPointRenderer

    srv = tserve.StoreServer(store, width=48, height=32, mesh_devices=2,
                             device="cpu")
    assert isinstance(srv.viewer.renderer, MeshPointRenderer)
    assert srv.viewer.renderer.mesh.size == 2
    assert srv.render_png(yaw=0.3)[:8] == b"\x89PNG\r\n\x1a\n"
    httpd = tserve.serve(store, port=0, mesh_devices=1, device="cpu")
    httpd.server_close()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tserve.main([str(store), "--mesh", "1", "--port", "0"])


def test_server_needs_a_card_unless_asked_for_the_cpu(store):
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the CPU-only refusal")
    with pytest.raises(RuntimeError, match="cuda"):
        tserve.serve(store, port=0)


# --- the converter, uploads and store uploads (a fresh pair a test) -------


@pytest.fixture()
def conv_pair(store, tmp_path):
    servers = []
    for module, name in ((rserve, "ref"), (tserve, "port")):
        root = tmp_path / name
        root.mkdir()
        write_ply(root / "cloud.ply", points(9_000, 44, -30.0, 30.0))
        (root / "out").mkdir()
        kw = {"device": "cpu"} if module is tserve else {}
        servers.append(Server(module, store, root=root, **kw))
    yield servers
    for s in servers:
        s.close()


def wait_finished(pair):
    deadline = time.time() + 300
    for s in pair:
        while time.time() < deadline:
            if s.ask("GET", "/convert")[2]["state"] == "finished":
                break
            time.sleep(0.1)
    return both_answer(pair, "GET", "/convert")[2]


def store_files(root):
    return {p.relative_to(root): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_http_conversion_matches_reference(conv_pair):
    """The converter over HTTP: the file list, the batch-size knob and its
    clamp, choose / save_at / start, the status while it runs and at the
    end, and the stores it writes, byte for byte."""
    _, _, files = both_answer(conv_pair, "GET", "/convert/files?dir=")
    assert "cloud.ply" in files["files"]
    for body in ({"action": "new_cloud"},
                 {"action": "batch_size", "value": 20_000},
                 {"action": "batch_size", "value": 1},
                 {"action": "batch_size", "value": 50_000},
                 {"action": "choose", "files": ["cloud.ply"]},
                 {"action": "save_at", "directory": "out"}):
        both_answer(conv_pair, "POST", "/convert", body)
    for s in conv_pair:
        assert s.ask("POST", "/convert", {"action": "start"})[0] == 200
    status = wait_finished(conv_pair)
    assert status["state"] == "finished"
    assert status["number_of_points"] == 9_000
    assert status["save_directory"] == "<root>/out"
    ref, port = (store_files(s.root / "out") for s in conv_pair)
    assert ref == port and len(port) > 1
    both_answer(conv_pair, "GET", "/stats")


@pytest.mark.parametrize("path", ["/convert/files?dir=../",
                                  "/convert/files?dir=out",
                                  "/convert/files?dir=nope"])
def test_convert_file_listing(conv_pair, path):
    both_answer(conv_pair, "POST", "/convert",
                {"action": "save_at", "directory": "out"})
    both_answer(conv_pair, "GET", path)


def test_uploads_match_reference(conv_pair, tmp_path, monkeypatch):
    """Raw uploads: uniquified names, path hygiene, the size cap (413),
    chunked append and the offset mismatch; then the upload converts."""
    from point_cloud_tpu.io.las import write_las

    src = tmp_path / "mine.las"
    write_las(src, points(4_000, 55, -20.0, 20.0))
    data = src.read_bytes()
    for _ in range(2):
        both_answer(conv_pair, "POST", "/upload?filename=mine.las", data)
    for path, body in (("/upload?filename=..%2F..%2Fevil.ply", b"x" * 16),
                       ("/upload?filename=a.exe", b"x"),
                       ("/upload?filename=", b"x"),
                       ("/upload?filename=x.ply&offset=-1", b"x"),
                       ("/upload?filename=ghost.ply&offset=7", b"zz")):
        both_answer(conv_pair, "POST", path, body)
    for module in (rserve, tserve):
        monkeypatch.setattr(module, "UPLOAD_LIMIT_BYTES", 64)
    both_answer(conv_pair, "POST", "/upload?filename=big.ply", b"x" * 65)
    both_answer(conv_pair, "POST", "/upload?filename=ok.ply", b"x" * 64)
    monkeypatch.undo()
    name = "chunky.ply"
    for off in range(0, 3072, 1024):
        _, _, body = both_answer(
            conv_pair, "POST", f"/upload?filename={name}&offset={off}",
            bytes(range(256)) * 4)
        name = body["path"].split("/")[-1]
    both_answer(conv_pair, "POST", f"/upload?filename={name}&offset=7", b"zz")
    for body in ({"action": "new_cloud"},
                 {"action": "choose", "files": ["uploads/mine.las"]},
                 {"action": "start"}):
        both_answer(conv_pair, "POST", "/convert", body)
    assert wait_finished(conv_pair)["number_of_points"] == 4_000


def upload_store(server, src, name, chunk=1024):
    for p in sorted(p for p in src.rglob("*") if p.is_file()):
        rel, data = p.relative_to(src).as_posix(), p.read_bytes()
        for off in range(0, max(len(data), 1), chunk):
            status = server.ask(
                "POST", f"/upload_store?name={quote(name)}"
                f"&path={quote(rel, safe='')}&offset={off}",
                data[off:off + chunk])[0]
            if status != 200:
                return status
    return 200


def test_store_uploads_match_reference(conv_pair, tmp_path):
    """Store upload: chunked files, the resume probe, finish and register,
    served and listed; bad paths and names, a shadowed local store, no
    metadata, and the fsck gate with its repair."""
    src = convert(tmp_path / "mystore", 3_000, 61, -25.0, 25.0)
    for s in conv_pair:
        assert upload_store(s, src, "uploaded") == 200
    cell = next((src / "h_0").glob("c_*.bin")).name
    for method, path, body in [
            ("GET", f"/upload_store?name=uploaded&path=h_0%2F{cell}", None),
            ("POST", "/upload_store/finish?name=uploaded", b""),
            ("GET", "/stores", None),
            ("GET", "/s/uploaded/metadata.json", None),
            ("GET", f"/s/uploaded/h_0/{cell}", None),
            ("GET", "/s/uploaded/stats", None),
            ("POST", "/upload_store?name=resume&path=metadata.json", b"{"),
            ("POST", "/upload_store?name=resume&path=metadata.json&offset=5",
             b"xx"),
            ("POST", "/upload_store?name=resume&path=metadata.json&offset=1",
             b"}"),
            ("GET", "/upload_store?name=resume&path=metadata.json", None),
            ("POST", "/upload_store?name=nometa&path=h_0%2Fc_0_0_0.bin",
             b"x" * 16),
            ("POST", "/upload_store/finish?name=nometa", b""),
            ("POST", "/upload_store?name=servestore0&path=metadata.json",
             b"{}"),
            ("POST", f"/upload_store?name=uploaded&path=h_0%2F{cell}",
             b"garbage-not-a-cell"),
            ("POST", "/upload_store/finish?name=uploaded", b""),
            ("GET", "/stores", None)]:
        both_answer(conv_pair, method, path, body)
    for bad in ("..%2Fmetadata.json", "h_0%2F..%2F..%2Fx.bin", "a.bin",
                "h_0%2Fc_0_0_0.txt", "metadata.json%2Fx",
                "h_x%2Fc_0_0_0.bin"):
        both_answer(conv_pair, "POST", f"/upload_store?name=ok&path={bad}",
                    b"x")
    for bad_name in ("..", ".hidden", "a%2Fb", ""):
        both_answer(conv_pair, "POST",
                    f"/upload_store?name={bad_name}&path=metadata.json", b"x")
    # "{}" is no metadata: the port refuses it (the reference's handler
    # raises and drops the connection)
    status, _, text = conv_pair[1].ask(
        "POST", "/upload_store/finish?name=resume", b"")
    assert status == 400 and "unreadable metadata.json" in text
    good = (src / "h_0" / cell).read_bytes()
    both_answer(conv_pair, "POST",
                f"/upload_store?name=uploaded&path=h_0%2F{cell}", good)
    _, _, fin = both_answer(conv_pair, "POST",
                            "/upload_store/finish?name=uploaded", b"")
    assert fin["registered"] and fin["number_of_points"] == 3_000


def test_store_upload_budget(conv_pair, tmp_path):
    """The port's fix of the reference: a store's uploaded files stay
    within a total budget. Under it the store registers; a file that would
    take the store past it gets 413, and the store is left as it was."""
    src = convert(tmp_path / "mystore", 3_000, 62, -25.0, 25.0)
    total = sum(p.stat().st_size for p in src.rglob("*") if p.is_file())
    port = conv_pair[1]
    registry = port.httpd.registry
    registry.store_upload_limit = total
    assert upload_store(port, src, "fits") == 200
    status, _, fin = port.ask("POST", "/upload_store/finish?name=fits", b"")
    assert status == 200 and fin["registered"]
    registry.store_upload_limit = total - 1
    assert upload_store(port, src, "over") == 413
    stored = port.root / "stores" / "over"
    assert sum(p.stat().st_size for p in stored.rglob("*")
               if p.is_file()) <= total - 1
    status, _, text = port.ask("POST", "/upload_store?name=over&path="
                               "metadata.json", b"x" * total)
    assert status == 413 and "budget" in text
    # the reference has no such budget: the same upload lands there
    assert upload_store(conv_pair[0], src, "over") == 200


def test_store_upload_budget_holds_under_concurrent_uploads(tmp_path):
    """Sixteen threads upload files to one store at once (more than the
    cores), with the interpreter switching often: the bytes on disk never
    pass the budget, and what was refused is exactly what did not fit."""
    import sys

    convert(tmp_path / "local", 500, 3)
    registry = tserve.StoreRegistry(tmp_path / "local",
                                    convert_root=tmp_path / "root",
                                    device="cpu", store_upload_limit=10_000)
    results = []

    def upload(i):
        body = BytesIO(bytes(1000))
        try:
            registry.save_store_file("crowd", f"h_0/c_{i}_0_0.bin", body,
                                     1000)
            results.append(True)
        except tserve.UploadTooLarge:
            results.append(False)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=upload, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    stored = sum(p.stat().st_size for p in
                 (tmp_path / "root" / "stores" / "crowd").rglob("*")
                 if p.is_file())
    assert results.count(True) == 10 and stored == 10_000
    assert registry._reserved == {}
