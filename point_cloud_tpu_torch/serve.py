"""Store server: serve a converted cloud over HTTP + remote render API.

The reference ships a WASM/WebGPU build whose viewer streams cells over
HTTP from any static host (reference: src/web.rs, src/plugins/asset/
source.rs URL loading, index.html). This server serves both halves:

- static store streaming — GET /metadata.json and /h_<n>/c_x_y_z.bin serve
  the raw files, so any :class:`~point_cloud_tpu_torch.utils.source.UrlSource`
  viewer (including another machine running :class:`Viewer`) streams cells
  exactly like the reference's web viewer does,
- server-side rendering — GET /render?yaw=..&pitch=..&dist=..&w=..&h=..
  returns a PNG rendered on this host's card: the frame kernels run next
  to the data and thin clients receive images.

Run: ``python -m point_cloud_tpu_torch.serve <store_dir> [--port 8080]``.

Port of the reference's ``serve.py``: every endpoint, status code and JSON
body is the reference's (``tests/test_torch_serve.py`` holds the two
servers' answers equal). Frames render through the port's ``Viewer`` on
``device`` (``"cuda"`` unless the caller asks for the CPU); without a card
the server raises at start-up; ``--mesh N`` (``mesh_devices``) renders
over a mesh of N of its devices (``render/parallel.py``). Unlike the
reference, a store upload has a total budget besides the per-file cap
(``STORE_UPLOAD_LIMIT_BYTES``): an upload that would take a store's files
past it gets HTTP 413.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import parse_qs, unquote, urlparse

import numpy as np


CONVERTIBLE_SUFFIXES = {".las", ".laz", ".ply"}  # + metadata.json (own)

# raw-body /upload size cap (browser bring-your-own-cloud path); the
# default — override per server with --upload-limit (serve CLI) or the
# env var. The cap bounds the FINAL file size (offset + chunk), so
# chunked uploads cannot creep past it one chunk at a time.
UPLOAD_LIMIT_BYTES = int(
    os.environ.get("PCT_UPLOAD_LIMIT_BYTES", str(1 << 28))  # 256 MiB
)

# store-upload whitelist: exactly the two file shapes a converted store
# holds (metadata.json + h_<n>/c_<x>_<y>_<z>.bin, core/cell.py path()).
# Anything else — traversal, extra dirs, stray files — is rejected.
_STORE_FILE_RE = re.compile(
    r"^(metadata\.json|h_\d{1,3}/c_-?\d{1,10}_-?\d{1,10}_-?\d{1,10}\.bin)$"
)
_STORE_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")


# total budget of one uploaded store's files (HTTP 413 past it): the
# per-file cap alone let a client fill the disk one file at a time
STORE_UPLOAD_LIMIT_BYTES = 1 << 34  # 16 GiB


class UploadTooLarge(ValueError):
    """Upload exceeds UPLOAD_LIMIT_BYTES or a store's upload budget (HTTP
    413)."""


def _receive_exact(target: Path, stream, length: int, offset: int) -> None:
    """Write exactly ``length`` body bytes at ``offset`` of ``target``.

    A short read (client hung up mid-chunk) truncates back to ``offset``
    so the upload stays resumable from the last complete chunk; a fresh
    upload (offset 0) is removed entirely."""
    mode = "r+b" if offset and target.exists() else "wb"
    try:
        with open(target, mode) as f:
            f.seek(offset)
            remaining = length
            while remaining > 0:
                chunk = stream.read(min(1 << 20, remaining))
                if not chunk:
                    raise ValueError(
                        "connection closed before the declared "
                        "Content-Length arrived"
                    )
                f.write(chunk)
                remaining -= len(chunk)
            f.truncate(offset + length)
    except Exception:
        if offset == 0:
            target.unlink(missing_ok=True)
        else:
            try:
                with open(target, "r+b") as f:
                    f.truncate(offset)
            except OSError:
                pass
        raise


class StoreServer:
    """One store's remote session: a full Viewer behind HTTP.

    Basing the server on :class:`~point_cloud_tpu_torch.viewer.app.Viewer`
    (instead of a bare renderer) puts the complete interactive surface —
    RenderSettings, DebugSettings, streaming pause/scale, the in-app
    converter — one JSON endpoint away, mirroring the reference's egui
    panel (src/plugins/render/ui.rs:122-146) for browser clients.
    """

    def __init__(self, store_dir, width=640, height=480,
                 convert_root=None, mesh_devices=0, upload_limit=None,
                 device="cuda"):
        from .render.renderer import RenderSettings
        from .viewer.app import Viewer

        self.store_dir = Path(store_dir)
        # None = resolve the module default at USE time (so a runtime
        # change to UPLOAD_LIMIT_BYTES applies to live servers)
        self.upload_limit = upload_limit
        self._render_lock = threading.Lock()
        # PNG frames need RGB only; skipping the f32 depth plane halves
        # the per-frame device->host traffic (renderer.RenderSettings)
        settings = RenderSettings(
            width=width, height=height, transfer_depth=False
        )
        self.viewer = Viewer(settings, mesh_devices=mesh_devices,
                             device=device)
        self.viewer.load_metadata(self.store_dir / "metadata.json")
        self.convert_root = Path(convert_root) if convert_root else None
        self._converter = None
        self._pump_thread = None

    @property
    def metadata(self):
        return self.viewer.metadata

    def _drain_streaming(self) -> None:
        """Pump the viewer until every queued cell load has settled (the
        synchronous server frame contract: a GET /render sees the full
        visible set)."""
        v = self.viewer
        for _ in range(10_000):
            v.update(0.0)
            if not v.streamer.loading and len(v.streamer.should_load) == 0:
                break
            if not v.stream_enabled:
                break  # paused: render what is loaded (cell.rs:89-99)

    def render_png(self, yaw=0.0, pitch=-0.4, dist=None,
                   voronoi=None, eye=None) -> bytes:
        """Stream the view's cells in and render one frame server-side.

        Two camera modes: orbit (default — yaw/pitch/dist around the
        cloud center) and fly (``eye`` = absolute camera position;
        yaw/pitch become the look direction — the reference's
        FlyCamController pose, fly_cam.rs:111-128)."""
        from .render.fly_cam import FlyCam
        from .viewer.offscreen import write_png

        with self._render_lock:
            v = self.viewer
            # per-request override only — persistent changes go through
            # POST /settings; without the restore one client's ?voronoi=0
            # would silently restyle every later param-less request
            prev_voronoi = v.settings.voronoi
            try:
                if voronoi is not None:
                    v.settings.voronoi = bool(voronoi)
                return self._render_png_locked(v, yaw, pitch, dist, eye)
            finally:
                v.settings.voronoi = prev_voronoi

    def _render_png_locked(self, v, yaw, pitch, dist, eye) -> bytes:
        from .render.fly_cam import FlyCam
        from .viewer.offscreen import write_png

        bbox = self.metadata.bounding_box
        center = bbox.center()
        up = np.array([0.0, 0.0, 1.0], np.float32)
        if eye is not None:
            pos = np.asarray(eye, np.float32)
            forward = np.array(
                [
                    np.cos(yaw) * np.cos(pitch),
                    np.sin(yaw) * np.cos(pitch),
                    np.sin(pitch),
                ],
                np.float32,
            )
            v.camera.transform.translation = pos
            v.camera.transform.look_at(pos + forward, up)
        else:
            extent = float(np.linalg.norm(bbox.extends()))
            d = dist if dist is not None else extent * 2.0
            pos = center + np.array(
                [
                    d * np.cos(yaw) * np.cos(pitch),
                    d * np.sin(yaw) * np.cos(pitch),
                    -d * np.sin(pitch),
                ],
                np.float32,
            )
            v.camera.transform.translation = pos.astype(np.float32)
            v.camera.transform.look_at(center, up)
        v.fly_cam = FlyCam.from_transform(v.camera.transform)
        v._camera_dirty = True
        self._drain_streaming()
        rgb, _, _ = v.render()
        buf = io.BytesIO()
        write_png(buf, rgb)
        return buf.getvalue()

    # --- settings surface (ui.rs:122-146 / debug.rs:21-36) ----------------

    def get_settings(self) -> dict:
        v = self.viewer
        s = v.settings
        d = v.debug
        return {
            "voronoi": s.voronoi,
            "size_by_distance": s.size_by_distance,
            "max_hierarchy": s.max_hierarchy,
            "footprint": s.footprint,
            "occlusion": s.occlusion,
            "hidden_hierarchies": sorted(s.hidden_hierarchies),
            "stream_enabled": v.stream_enabled,
            "streaming_scale": v.streaming_scale,
            "hierarchies": int(self.metadata.hierarchies),
            # camera section (reference camera.rs:193-204 position
            # readout + fly_cam.rs:168-183 speed slider)
            "camera_position": [
                float(x) for x in v.camera.transform.translation
            ],
            "fly_speed": float(v.fly_cam.speed),
            "debug": {
                "show_bounding_box": d.show_bounding_box,
                "show_frustum": d.show_frustum,
                "show_plane_normals": d.show_plane_normals,
                "show_cell_grid": d.show_cell_grid,
                "show_streaming_rects": d.show_streaming_rects,
            },
        }

    def apply_settings(self, payload: dict) -> dict:
        with self._render_lock:
            v = self.viewer
            s = v.settings
            for key in ("voronoi", "size_by_distance", "occlusion"):
                if key in payload:
                    setattr(s, key, bool(payload[key]))
            if "max_hierarchy" in payload:
                s.max_hierarchy = int(payload["max_hierarchy"])
            if "footprint" in payload:
                fp = int(payload["footprint"])
                if fp not in (1, 3, 5, 7, 9):
                    raise ValueError(f"footprint {fp} not in 1/3/5/7/9")
                s.footprint = fp
            if "hidden_hierarchies" in payload:
                s.hidden_hierarchies = {
                    int(h) for h in payload["hidden_hierarchies"]
                }
            if "stream_enabled" in payload:
                v.stream_enabled = bool(payload["stream_enabled"])
            if "fly_speed" in payload:
                from .render.fly_cam import SPEED_MAX, SPEED_MIN

                v.fly_cam.speed = float(
                    np.clip(float(payload["fly_speed"]),
                            SPEED_MIN, SPEED_MAX)
                )
            if "streaming_scale" in payload:
                v.streaming_scale = float(payload["streaming_scale"])
            d = v.debug
            for key, value in (payload.get("debug") or {}).items():
                if key == "show_frustum" and value and (
                    d.frozen_frustum is None
                ):
                    v.freeze_frustum()  # capture on first enable
                    continue
                if not hasattr(d, key) or key == "frozen_frustum":
                    raise ValueError(f"unknown debug toggle {key!r}")
                setattr(d, key, bool(value))
            if payload.get("freeze_frustum"):
                v.freeze_frustum()
            return self.get_settings()

    # --- in-app converter over HTTP (converter.rs:723-848) ----------------

    def _resolve_under_root(self, rel) -> Path:
        if self.convert_root is None:
            raise PermissionError(
                "server started without --convert-root; the converter "
                "endpoints are disabled"
            )
        target = (self.convert_root / str(rel)).resolve()
        root = self.convert_root.resolve()
        if root != target and root not in target.parents:
            raise PermissionError(f"{rel!r} escapes the convert root")
        return target

    def convert_files(self, rel_dir: str = "") -> dict:
        target = self._resolve_under_root(rel_dir)
        files = []
        for p in sorted(target.iterdir()) if target.is_dir() else []:
            if p.suffix.lower() in CONVERTIBLE_SUFFIXES or (
                p.name == "metadata.json"
            ):
                files.append(
                    str(p.relative_to(self.convert_root.resolve()))
                )
        return {"root": str(self.convert_root), "files": files}

    def _ensure_converter(self):
        if self._converter is None:
            from .viewer.interactive import InteractiveConverter

            self._converter = InteractiveConverter(self.viewer)
        return self._converter

    def _pump(self):
        import time

        from .viewer.interactive import ConversionState

        while True:
            with self._render_lock:
                conv = self._converter
                if conv is None or conv.state != ConversionState.CONVERTING:
                    if (
                        conv is not None
                        and conv.state == ConversionState.FINISHED
                        and conv.auto_save
                    ):
                        conv.flush()  # final RAM cells -> store files
                    return
                conv.update()
            time.sleep(0.002)  # frame-sliced, like the per-frame systems

    def convert_action(self, payload: dict) -> dict:
        action = payload.get("action")
        with self._render_lock:
            conv = self._ensure_converter()
            if action == "choose":
                paths = [
                    self._resolve_under_root(f)
                    for f in payload.get("files", [])
                ]
                conv.choose_files(paths)
            elif action == "new_cloud":
                conv.new_cloud()
            elif action == "save_at":
                conv.save_at(self._resolve_under_root(
                    payload.get("directory", "")
                ))
            elif action == "batch_size":
                conv.set_batch_size(payload.get("value", 0))
            elif action == "start":
                conv.start()
                # spawn the pump while still holding _render_lock:
                # concurrent start POSTs (the HTTP server is threaded)
                # would otherwise both observe a dead pump and spawn two,
                # double-running conv.update()/flush()
                if (
                    self._pump_thread is None
                    or not self._pump_thread.is_alive()
                ):
                    self._pump_thread = threading.Thread(
                        target=self._pump, daemon=True,
                        name="pct-convert-pump",
                    )
                    self._pump_thread.start()
            elif action == "stop":
                conv.stop()
            else:
                raise ValueError(f"unknown converter action {action!r}")
        return self.convert_status()

    def convert_status(self) -> dict:
        conv = self._converter
        if conv is None:
            return {"state": "not_started", "files": []}
        return {
            "state": conv.state.name.lower(),
            "auto_save": conv.auto_save,
            "batch_size": conv.batch_size,
            "save_directory": (
                str(conv.save_directory) if conv.save_directory else None
            ),
            "number_of_points": int(conv.metadata.number_of_points),
            "files": [
                {
                    "path": str(f.path),
                    "state": f.state,
                    "total": f.total,
                    "remaining": f.remaining,
                    "error": f.error,
                }
                for f in conv.files
            ],
        }

    def save_upload(self, filename: str, stream, length: int,
                    offset: int = 0) -> dict:
        """Receive one point-cloud upload (whole or one chunk) into
        ``convert_root/uploads/`` and return its convert-root-relative
        path, ready for a ``/convert action=choose`` — the
        bring-your-own-cloud path the reference serves with the browser
        File System Access API (src/web.rs:5-53, metadata.rs:444-491);
        a pure-server viewer restores it as upload -> convert -> view.

        Chunked/resumable (VERDICT r4 #7): ``offset`` > 0 appends this
        body at that byte offset of an EXISTING upload — the offset must
        equal the file's current size (append-only; a mismatch reports
        the current size so the client can resume from there, and a
        half-written chunk truncates back to the offset instead of
        destroying the earlier chunks). One POST per chunk keeps any
        single request small and gives the browser client real progress.
        The size cap applies to offset + length, so chunking cannot
        creep past it."""
        if self.convert_root is None:
            raise PermissionError(
                "server started without --convert-root; uploads are "
                "disabled"
            )
        # path hygiene: basename only, conservative charset, known
        # point-cloud suffix — a hostile filename cannot traverse or
        # smuggle metacharacters into the store
        name = Path(str(filename)).name
        name = re.sub(r"[^A-Za-z0-9._-]", "_", name).lstrip(".")
        suffix = Path(name).suffix.lower()
        if not name or suffix not in CONVERTIBLE_SUFFIXES:
            raise ValueError(
                f"filename must end in one of {sorted(CONVERTIBLE_SUFFIXES)}"
            )
        if length < 0:
            raise ValueError("Content-Length required")
        if offset < 0:
            raise ValueError("offset must be >= 0")
        limit = (
            self.upload_limit if self.upload_limit is not None
            else UPLOAD_LIMIT_BYTES
        )
        if offset + length > limit:
            raise UploadTooLarge(
                f"upload of {offset + length} bytes exceeds the "
                f"{limit} byte limit"
            )
        updir = self._resolve_under_root("uploads")
        updir.mkdir(parents=True, exist_ok=True)
        target = updir / name
        if offset == 0:
            n = 1
            while target.exists():  # never clobber an earlier upload
                target = updir / f"{Path(name).stem}_{n}{suffix}"
                n += 1
        else:
            # chunk continuation addresses the exact name the first
            # chunk's response returned — never a renamed sibling
            have = target.stat().st_size if target.exists() else None
            if have != offset:
                raise ValueError(
                    f"offset {offset} does not match the current upload "
                    f"size ({have if have is not None else 'no file'}); "
                    "resume from the reported size"
                )
        _receive_exact(target, stream, length, offset)
        rel = str(target.relative_to(self.convert_root.resolve()))
        return {"path": rel, "bytes": offset + length}

    def export_file(self, fmt: str, point_format: int = 2,
                    scale: float = 0.001):
        """Export this store to a temp file (LAS/LAZ/PLY); returns its
        Path. The HTTP handler streams and unlinks it — the browser's
        "take the cloud with you" path (no reference equivalent: the
        reference viewer can only read stores, never emit interchange
        files)."""
        import tempfile

        from .export import export_store

        tmp = tempfile.NamedTemporaryFile(
            suffix=f".{fmt}", delete=False
        )
        tmp.close()
        try:
            export_store(
                self.store_dir, tmp.name, fmt=fmt,
                point_format=point_format, scale=(scale,) * 3,
            )
        except Exception:
            Path(tmp.name).unlink(missing_ok=True)
            raise
        return Path(tmp.name)


class StoreRegistry:
    """One or many stores under a root directory.

    The reference picks a store with a native file dialog / web directory
    picker (src/plugins/metadata.rs:395-491); the server equivalent: point
    it at a directory of stores and the browser client offers a picker
    (`/stores` lists them, `/s/<name>/...` scopes every endpoint).
    """

    def __init__(self, root, width=640, height=480, convert_root=None,
                 mesh_devices=0, upload_limit=None, device="cuda",
                 store_upload_limit=None):
        from .ops.runtime import resolve_device

        self.root = Path(root)
        self._mesh_devices = mesh_devices
        self._width, self._height = width, height
        self._convert_root = convert_root
        # resolved here, so a server asked for a missing card fails at
        # start-up, not on its first request
        self._device = resolve_device(device)
        self.upload_limit = upload_limit  # None = module default at use
        self.store_upload_limit = store_upload_limit  # likewise
        self._servers: dict[str, StoreServer] = {}
        self._lock = threading.Lock()
        self._name_locks: dict[str, threading.Lock] = {}
        # bytes promised to uploads in flight: (store, path) -> final size
        self._reserved: dict[tuple[str, str], int] = {}
        if (self.root / "metadata.json").exists():
            self.names = [self.root.name or "store"]
            self._dirs = {self.names[0]: self.root}
        else:
            self._dirs = {
                p.name: p
                for p in sorted(self.root.iterdir())
                if (p / "metadata.json").exists()
            }
            self.names = list(self._dirs)
            if not self.names:
                raise FileNotFoundError(
                    f"{self.root} holds no store (no metadata.json in it "
                    "or any child directory)"
                )

    @property
    def default(self) -> str:
        return self.names[0]

    def get(self, name: str) -> "StoreServer | None":
        if name not in self._dirs:
            return None
        # ThreadingHTTPServer handlers race the lazy construction (the
        # client fires /stats and /render concurrently on first load).
        # Constructed servers return without locking, and construction
        # locks per store: a Viewer's start-up must not stall requests to
        # other stores.
        srv = self._servers.get(name)
        if srv is not None:
            return srv
        with self._lock:
            name_lock = self._name_locks.setdefault(name, threading.Lock())
        with name_lock:
            srv = self._servers.get(name)
            if srv is None:
                srv = StoreServer(
                    self._dirs[name], width=self._width,
                    height=self._height,
                    convert_root=self._convert_root,
                    mesh_devices=self._mesh_devices,
                    upload_limit=self.upload_limit, device=self._device,
                )
                self._servers[name] = srv
            return srv

    # --- browser store upload (closes SURVEY L9) --------------------------
    #
    # The reference opens an existing CONVERTED store from the browser
    # via the File System Access API and streams its cells client-side
    # (src/web.rs:5-53, src/plugins/metadata.rs:444-491). The
    # server-rendering equivalent: the browser posts the store's files
    # (metadata.json + h_*/c_*.bin) into the registry — chunked and
    # resumable per file — the server fsck-validates the result
    # (validate.py), registers it, and every /s/<name>/ endpoint serves
    # it like any local store.

    def _upload_store_dir(self, name: str, create: bool = False) -> Path:
        if self._convert_root is None:
            raise PermissionError(
                "server started without --convert-root; store uploads "
                "are disabled"
            )
        if not _STORE_NAME_RE.match(name or ""):
            raise ValueError(
                "store name must be 1-64 chars of [A-Za-z0-9._-], "
                "starting alphanumeric"
            )
        existing = self._dirs.get(name)
        target = (Path(self._convert_root) / "stores" / name).resolve()
        if existing is not None and Path(existing).resolve() != target:
            raise ValueError(
                f"store name {name!r} is taken by a local store"
            )
        if create:
            target.mkdir(parents=True, exist_ok=True)
        return target

    def save_store_file(self, name: str, rel: str, stream, length: int,
                        offset: int = 0) -> dict:
        """One store file (or one chunk of it) into the upload area.

        ``rel`` must match a store's exact file shapes (metadata.json or
        h_<n>/c_<x>_<y>_<z>.bin) — the whitelist, not a denylist, so
        traversal or stray files can never land. Chunk semantics match
        :meth:`StoreServer.save_upload` (append-only offset, truncate-on-
        short-read, cap on offset + length). The store's files, this one at
        offset + length and those of uploads still in flight at their
        promised sizes, stay within the store's upload budget
        (``store_upload_limit``, default STORE_UPLOAD_LIMIT_BYTES)."""
        if not _STORE_FILE_RE.match(rel or ""):
            raise ValueError(
                "path must be metadata.json or h_<n>/c_<x>_<y>_<z>.bin"
            )
        if length < 0:
            raise ValueError("Content-Length required")
        if offset < 0:
            raise ValueError("offset must be >= 0")
        limit = (
            self.upload_limit if self.upload_limit is not None
            else UPLOAD_LIMIT_BYTES
        )
        if offset + length > limit:
            raise UploadTooLarge(
                f"file of {offset + length} bytes exceeds the "
                f"{limit} byte limit"
            )
        store_dir = self._upload_store_dir(name, create=True)
        target = store_dir / rel
        target.parent.mkdir(parents=True, exist_ok=True)
        have = target.stat().st_size if target.exists() else None
        if offset == 0:
            pass  # a re-send of the first chunk restarts the file
        elif have != offset:
            raise ValueError(
                f"offset {offset} does not match the current size "
                f"({have if have is not None else 'no file'}); resume "
                "from the reported size"
            )
        key = (name, rel)
        self._reserve_upload(store_dir, key, offset + length)
        try:
            _receive_exact(target, stream, length, offset)
        finally:
            with self._lock:
                self._reserved.pop(key, None)
        return {"store": name, "path": rel, "bytes": offset + length}

    def _reserve_upload(self, store_dir: Path, key, size: int) -> None:
        """Promise ``size`` bytes to the upload of ``key`` = (store, path),
        or raise UploadTooLarge if the store's files would then exceed its
        budget: each file counts at its size on disk, or at its promised
        size while an upload to it is in flight."""
        budget = (
            self.store_upload_limit if self.store_upload_limit is not None
            else STORE_UPLOAD_LIMIT_BYTES
        )
        name = key[0]
        with self._lock:
            sizes = {
                p.relative_to(store_dir).as_posix(): p.stat().st_size
                for p in store_dir.rglob("*") if p.is_file()
            }
            sizes.update({rel: promised for (store, rel), promised
                          in self._reserved.items() if store == name})
            sizes[key[1]] = size
            total = sum(sizes.values())
            if total > budget:
                raise UploadTooLarge(
                    f"store {name!r} would hold {total} bytes, past its "
                    f"{budget} byte upload budget"
                )
            self._reserved[key] = size

    def store_file_status(self, name: str, rel: str) -> dict:
        """Resume support: the current byte count of one uploaded file
        (0 when absent) — the offset the client should continue from."""
        if not _STORE_FILE_RE.match(rel or ""):
            raise ValueError(
                "path must be metadata.json or h_<n>/c_<x>_<y>_<z>.bin"
            )
        store_dir = self._upload_store_dir(name)
        target = store_dir / rel
        size = target.stat().st_size if target.exists() else 0
        return {"store": name, "path": rel, "bytes": size}

    def finish_store_upload(self, name: str) -> dict:
        """Validate the uploaded store (full fsck) and register it.

        A store that fails any structural invariant is NOT registered —
        the issues come back in the error so the client can fix and
        re-upload just the bad files. An unreadable metadata.json is such
        a failure too (the reference's handler let its KeyError escape and
        dropped the connection)."""
        from .validate import validate_store

        store_dir = self._upload_store_dir(name)
        if not (store_dir / "metadata.json").exists():
            raise ValueError("upload has no metadata.json yet")
        try:
            report = validate_store(store_dir)
        except (KeyError, TypeError, ValueError) as err:
            raise ValueError(
                f"store failed validation: unreadable metadata.json "
                f"({type(err).__name__}: {err})") from err
        if report.issues:
            head = "; ".join(str(i) for i in report.issues[:5])
            more = len(report.issues) - 5
            raise ValueError(
                f"store failed validation ({len(report.issues)} issues): "
                + head + (f"; and {more} more" if more > 0 else "")
            )
        with self._lock:
            self._dirs[name] = store_dir
            if name not in self.names:
                self.names.append(name)
            # a re-upload replaces any live session on the old bytes
            self._servers.pop(name, None)
        meta = json.loads((store_dir / "metadata.json").read_text())
        return {
            "store": name,
            "registered": True,
            "number_of_points": meta.get("number_of_points"),
            "hierarchies": meta.get("hierarchies"),
        }


def make_handler(registry: StoreRegistry):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _send(self, code, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Access-Control-Allow-Origin", "*")
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            url = urlparse(self.path)
            path = url.path.lstrip("/")
            if path in ("upload_store", "upload_store/finish"):
                # registry-level (not store-scoped): a store upload
                # CREATES the store every /s/<name>/ route then serves
                qs = parse_qs(url.query)
                name = (qs.get("name") or [""])[0]
                try:
                    if path == "upload_store":
                        rel = (qs.get("path") or [""])[0]
                        offset = int((qs.get("offset") or ["0"])[0])
                        length = int(
                            self.headers.get("Content-Length", "-1")
                        )
                        body = registry.save_store_file(
                            name, rel, self.rfile, length, offset
                        )
                    else:
                        body = registry.finish_store_upload(name)
                except PermissionError as err:
                    self._send(403, str(err).encode(), "text/plain")
                    return
                except UploadTooLarge as err:
                    self._send(413, str(err).encode(), "text/plain")
                    return
                except (ValueError, OSError) as err:
                    self._send(400, str(err).encode(), "text/plain")
                    return
                self._send(
                    200, json.dumps(body).encode(), "application/json"
                )
                return
            store_name = registry.default
            if path.startswith("s/"):
                parts = path.split("/", 2)
                if len(parts) < 3:
                    self._send(404, b"not found", "text/plain")
                    return
                store_name, path = unquote(parts[1]), parts[2]
            server = registry.get(store_name)
            if server is None:
                self._send(404, f"no store {store_name!r}".encode(),
                           "text/plain")
                return
            if path == "upload":
                # raw binary body (no multipart): the browser client
                # POSTs the File object directly, curl uses
                # --data-binary; filename travels in the query string
                qs = parse_qs(url.query)
                filename = (qs.get("filename") or [""])[0]
                try:
                    offset = int((qs.get("offset") or ["0"])[0])
                    length = int(self.headers.get("Content-Length", "-1"))
                    body = server.save_upload(
                        filename, self.rfile, length, offset
                    )
                except PermissionError as err:
                    self._send(403, str(err).encode(), "text/plain")
                    return
                except UploadTooLarge as err:
                    self._send(413, str(err).encode(), "text/plain")
                    return
                except (ValueError, OSError) as err:
                    self._send(400, str(err).encode(), "text/plain")
                    return
                self._send(
                    200, json.dumps(body).encode(), "application/json"
                )
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(length) or b"{}")
            except (ValueError, json.JSONDecodeError) as err:
                self._send(400, f"bad JSON body: {err}".encode(),
                           "text/plain")
                return
            try:
                if path == "settings":
                    body = server.apply_settings(payload)
                elif path == "convert":
                    body = server.convert_action(payload)
                else:
                    self._send(404, b"not found", "text/plain")
                    return
            except PermissionError as err:
                self._send(403, str(err).encode(), "text/plain")
                return
            except (ValueError, KeyError, OSError) as err:
                self._send(400, str(err).encode(), "text/plain")
                return
            self._send(200, json.dumps(body).encode(), "application/json")

        def do_GET(self):
            url = urlparse(self.path)
            path = url.path.lstrip("/")
            if path == "upload_store":
                # resume probe: current byte count of one uploaded file
                qs = parse_qs(url.query)
                try:
                    body = registry.store_file_status(
                        (qs.get("name") or [""])[0],
                        (qs.get("path") or [""])[0],
                    )
                except PermissionError as err:
                    self._send(403, str(err).encode(), "text/plain")
                    return
                except (ValueError, OSError) as err:
                    self._send(400, str(err).encode(), "text/plain")
                    return
                self._send(200, json.dumps(body).encode(),
                           "application/json")
                return
            if path == "stores":
                self._send(
                    200,
                    json.dumps(
                        {"stores": registry.names,
                         "default": registry.default}
                    ).encode(),
                    "application/json",
                )
                return
            # store-scoped endpoints: /s/<name>/<rest> (the client
            # percent-encodes names, and browsers escape regardless)
            store_name = registry.default
            if path.startswith("s/"):
                parts = path.split("/", 2)
                if len(parts) < 3:
                    self._send(404, b"not found", "text/plain")
                    return
                store_name, path = unquote(parts[1]), parts[2]
            server = registry.get(store_name)
            if server is None:
                self._send(404, f"no store {store_name!r}".encode(),
                           "text/plain")
                return
            if path in ("", "index.html"):
                # the interactive client (reference: index.html + the
                # WASM viewer; here orbit/zoom drive /render server-side)
                page = (
                    Path(__file__).parent / "viewer" / "client.html"
                ).read_bytes()
                self._send(200, page, "text/html; charset=utf-8")
                return
            if path == "settings":
                self._send(
                    200, json.dumps(server.get_settings()).encode(),
                    "application/json",
                )
                return
            if path == "convert":
                self._send(
                    200, json.dumps(server.convert_status()).encode(),
                    "application/json",
                )
                return
            if path == "convert/files":
                q = parse_qs(url.query)
                try:
                    body = server.convert_files(q.get("dir", [""])[0])
                except PermissionError as err:
                    self._send(403, str(err).encode(), "text/plain")
                    return
                except OSError as err:
                    self._send(400, str(err).encode(), "text/plain")
                    return
                self._send(200, json.dumps(body).encode(),
                           "application/json")
                return
            if path == "stats":
                stats = {
                    "name": server.metadata.name,
                    "number_of_points": server.metadata.number_of_points,
                    "hierarchies": server.metadata.hierarchies,
                    "auto_distance": float(
                        np.linalg.norm(
                            server.metadata.bounding_box.extends()
                        ) * 2.0
                    ),
                    "center": [
                        float(v)
                        for v in server.metadata.bounding_box.center()
                    ],
                    "endpoints": ["/metadata.json", "/h_<n>/c_x_y_z.bin",
                                   "/render?yaw=&pitch=&dist=", "/stats",
                                   "/export?format=ply|las|laz"],
                }
                self._send(200, json.dumps(stats).encode(), "application/json")
                return
            if path == "export":
                q = parse_qs(url.query)
                fmt = q.get("format", ["ply"])[0].lower()
                if fmt not in ("ply", "las", "laz"):
                    # validate BEFORE the format string reaches a
                    # tempfile suffix: "a/b" would raise OSError there
                    # (no response) and "../x" would land outside tmp
                    self._send(400, f"bad format {fmt!r}".encode(),
                               "text/plain")
                    return
                try:
                    point_format = int(q.get("point_format", ["2"])[0])
                    scale = float(q.get("scale", ["0.001"])[0])
                except ValueError as err:
                    self._send(400, f"bad export parameter: {err}".encode(),
                               "text/plain")
                    return
                try:
                    tmp = server.export_file(
                        fmt, point_format=point_format, scale=scale
                    )
                except (ValueError, RuntimeError, OSError) as err:
                    self._send(400, str(err).encode(), "text/plain")
                    return
                try:
                    size = tmp.stat().st_size
                    self.send_response(200)
                    self.send_header(
                        "Content-Type", "application/octet-stream"
                    )
                    self.send_header("Content-Length", str(size))
                    # metadata.name comes from the (possibly hostile)
                    # store's metadata.json: strip quotes, backslashes
                    # and control chars so it cannot corrupt the header
                    # (response-header injection).
                    raw = server.metadata.name or "cloud"
                    safe = "".join(
                        c for c in raw
                        if c.isprintable() and c not in '"\\'
                    ).strip() or "cloud"
                    self.send_header(
                        "Content-Disposition",
                        f'attachment; filename="{safe}.{fmt}"',
                    )
                    self.send_header("Access-Control-Allow-Origin", "*")
                    self.end_headers()
                    with open(tmp, "rb") as f:
                        while True:
                            chunk = f.read(1 << 20)
                            if not chunk:
                                break
                            self.wfile.write(chunk)
                finally:
                    tmp.unlink(missing_ok=True)
                return
            if path == "render":
                q = parse_qs(url.query)
                try:
                    yaw = float(q.get("yaw", ["0"])[0])
                    pitch = float(q.get("pitch", ["-0.4"])[0])
                    dist = float(q["dist"][0]) if "dist" in q else None
                    has_eye = any(k in q for k in ("px", "py", "pz"))
                    eye = (
                        [float(q["px"][0]), float(q["py"][0]),
                         float(q["pz"][0])]
                        if has_eye  # any one present requires all three
                        else None
                    )
                    voronoi = (
                        q["voronoi"][0].lower()
                        not in ("0", "false", "no", "off")
                        if "voronoi" in q
                        else None
                    )
                except (ValueError, IndexError, KeyError) as err:
                    self._send(400, f"bad camera parameter: {err}".encode(),
                               "text/plain")
                    return
                try:
                    png = server.render_png(
                        yaw=yaw, pitch=pitch, dist=dist, voronoi=voronoi,
                        eye=eye,
                    )
                except Exception as err:  # pragma: no cover - defensive
                    self._send(500, str(err).encode(), "text/plain")
                    return
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.send_header("Content-Length", str(len(png)))
                self.send_header("Access-Control-Allow-Origin", "*")
                # camera round-trip echo (clients + tests confirm what
                # the server actually rendered)
                pose = (
                    f"fly eye=({eye[0]},{eye[1]},{eye[2]})"
                    if eye is not None
                    else f"orbit dist={'auto' if dist is None else dist}"
                )
                self.send_header(
                    "X-Camera", f"yaw={yaw} pitch={pitch} {pose}"
                )
                self.end_headers()
                self.wfile.write(png)
                return
            # static store files, escape-safe
            rel = Path(path)
            if rel.is_absolute() or ".." in rel.parts:
                self._send(403, b"forbidden", "text/plain")
                return
            target = server.store_dir / rel
            if not target.is_file():
                self._send(404, b"not found", "text/plain")
                return
            ctype = (
                "application/json" if target.suffix == ".json"
                else "application/octet-stream"
            )
            self._send(200, target.read_bytes(), ctype)

    return Handler


def serve(store_dir, host="127.0.0.1", port=8080, width=640, height=480,
          convert_root=None, mesh_devices=0, upload_limit=None,
          device="cuda", store_upload_limit=None):
    """Build and return the HTTP server (call serve_forever on it).

    ``store_dir`` may be one store (holds metadata.json) or a directory
    of stores (each child with a metadata.json gets served under
    ``/s/<name>/`` and the browser client shows a picker).
    ``convert_root`` (optional) enables the in-app converter endpoints,
    restricted to files under that directory. ``upload_limit`` caps any
    single uploaded file in bytes (default PCT_UPLOAD_LIMIT_BYTES),
    ``store_upload_limit`` the files of one uploaded store together
    (default STORE_UPLOAD_LIMIT_BYTES). Frames render on ``device``, over
    a mesh of ``mesh_devices`` of its devices when > 0."""
    registry = StoreRegistry(
        store_dir, width=width, height=height, convert_root=convert_root,
        mesh_devices=mesh_devices, upload_limit=upload_limit, device=device,
        store_upload_limit=store_upload_limit,
    )
    httpd = ThreadingHTTPServer((host, port), make_handler(registry))
    httpd.registry = registry  # exposed for tests/ops introspection
    return httpd


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="point-cloud-serve",
        description="Serve a converted point-cloud store over HTTP.",
    )
    parser.add_argument("store", type=Path)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--width", type=int, default=640)
    parser.add_argument("--height", type=int, default=480)
    parser.add_argument(
        "--convert-root", type=Path, default=None,
        help="enable the in-app converter endpoints for files under "
        "this directory (disabled otherwise)",
    )
    parser.add_argument(
        "--mesh", type=int, default=0, metavar="N",
        help="render frames data-parallel over an N-device mesh "
        "(0 = one device)",
    )
    parser.add_argument(
        "--upload-limit", type=int, default=None, metavar="BYTES",
        help="per-file upload size cap for /upload and /upload_store "
        "(default: PCT_UPLOAD_LIMIT_BYTES env or 256 MiB)",
    )
    parser.add_argument(
        "--store-upload-limit", type=int, default=None, metavar="BYTES",
        help="total size cap of one store's files under /upload_store "
        "(default 16 GiB)",
    )
    args = parser.parse_args(argv)
    # frames render on the card; without one this raises
    httpd = serve(args.store, args.host, args.port, args.width,
                  args.height, convert_root=args.convert_root,
                  mesh_devices=args.mesh, upload_limit=args.upload_limit,
                  store_upload_limit=args.store_upload_limit)
    print(f"serving {args.store} on http://{args.host}:{args.port}")
    httpd.serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
