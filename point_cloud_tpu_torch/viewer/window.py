"""Local window + event loop: the WinitPlugin equivalent.

Capability parity with the reference's window layer (reference:
src/plugins/winit.rs:56-161 — event-loop pump, RedrawRequested,
Resized, CloseRequested; window-event fan-out to the input plugin,
src/plugins/input.rs:13-154). The design is split in two:

- :class:`WindowLoop` owns the frame schedule — poll OS events, feed
  them to :class:`~point_cloud_tpu_torch.viewer.input.InputState`, run
  ``Viewer.update`` + ``Viewer.render``, hand the frame to the backend.
  It is backend-agnostic and fully testable headless (tests drive it
  with a :class:`FakeBackend`-style stub).
- :class:`TkBackend` is the real-OS implementation: a Tk window whose
  label blits frames via PPM-encoded ``PhotoImage`` (no image deps —
  Tk decodes P6 natively) and whose key/mouse bindings enqueue
  :class:`WindowEvent` records. It needs a display; everything above it
  does not. A different backend (SDL, web canvas) is one class.

All rendering stays in the device path — the window layer only moves
finished RGB frames and OS events, so it adds no device work.

Run it::

    python -m point_cloud_tpu_torch.viewer.window /path/to/store

Port of the reference's ``viewer/window.py``: ``tests/test_torch_window.py``
runs the reference's window cases on it. Frames render on the card unless
the caller passes ``device="cpu"``; ``--mesh N`` renders over a mesh of N
of its devices (``render/parallel.py``).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from .input import InputState

log = logging.getLogger(__name__)


@dataclass
class WindowEvent:
    """One OS window event, backend-normalized.

    ``kind``: key_down | key_up | button_down | button_up | cursor |
    wheel | resize | close. ``key``/``button`` use the InputState
    vocabulary ('w', 'shift', 'space'; 'left'/'middle'/'right');
    ``x, y`` carry cursor positions or resize extents; ``steps`` the
    wheel detents (+up).
    """

    kind: str
    key: str | None = None
    button: str | None = None
    x: float = 0.0
    y: float = 0.0
    steps: float = 0.0
    # backend event timestamp (ms) where available; key auto-repeat
    # detection needs it (X11 repeats arrive as KeyRelease+KeyPress
    # pairs sharing one timestamp)
    time_ms: int | None = None


def filter_auto_repeat(events: list[WindowEvent]) -> list[WindowEvent]:
    """Drop X11 key auto-repeat pairs from one poll batch.

    X11 (Tk has no detectable-auto-repeat mode) reports a held key as
    KeyRelease+KeyPress pairs sharing one server timestamp; left in, a
    held hotkey would flicker its toggle and a held movement key would
    stutter the pressed set. A key_up whose key's next key event is a
    key_down at the same (non-None) timestamp is such a pair — drop
    both. Events without timestamps (synthetic backends) pass through.
    """
    drop: set[int] = set()
    for i, ev in enumerate(events):
        if (ev.kind != "key_up" or ev.key is None or ev.time_ms is None
                or i in drop):
            continue
        for j in range(i + 1, len(events)):
            nxt = events[j]
            if nxt.key != ev.key or nxt.kind not in ("key_down", "key_up"):
                continue  # interleaved cursor/wheel/other-key events
            if nxt.kind == "key_down" and nxt.time_ms == ev.time_ms:
                drop.add(i)
                drop.add(j)
            break
    if not drop:
        return events
    return [ev for i, ev in enumerate(events) if i not in drop]


# Tk keysym -> InputState key vocabulary (input.py KEY_*). Only keys the
# viewer binds are mapped; everything else passes through lowercased so
# future bindings work unchanged.
_TK_KEYSYMS = {
    "shift_l": "shift",
    "shift_r": "shift",
    "space": "space",
}

_TK_BUTTONS = {1: "left", 2: "middle", 3: "right"}


def translate_keysym(keysym: str) -> str:
    """Tk keysym -> InputState key name ('Shift_L' -> 'shift')."""
    low = keysym.lower()
    return _TK_KEYSYMS.get(low, low)


def translate_button(num: int) -> str | None:
    """Tk button number -> InputState button name (1/2/3)."""
    return _TK_BUTTONS.get(int(num))


def rgb_to_ppm(rgb: np.ndarray) -> bytes:
    """(H, W, 3) u8 -> binary PPM (P6) bytes — Tk's dependency-free
    in-memory image format for PhotoImage(data=...)."""
    h, w = rgb.shape[:2]
    header = b"P6 %d %d 255\n" % (w, h)
    return header + np.ascontiguousarray(rgb, dtype=np.uint8).tobytes()


HOTKEY_HELP = """\
point_cloud_tpu_torch window hotkeys (the egui panel's runtime controls,
reference src/plugins/render/ui.rs:122-146, as key toggles):
  p        pause/resume streaming          v  voronoi / flat splats
  o        size-by-distance LOD override   x  streaming far-plane rects
  b        cloud bounding box              g  per-hierarchy cell grid
  c        freeze/clear frustum wireframe  n  frustum plane normals
  [ / ]    streaming-frustums scale -/+ (1..5)
  0-9      toggle hierarchy N point visibility
  m        open a store (metadata.json file dialog)
  f        choose files to convert (las/laz/ply/json)
  t        start/stop the in-app converter
  u        save-at: pick the store directory (enables auto-save)
  k        new point cloud (reset the in-app converter)
  e        export the open store to .las/.laz/.ply (save dialog)
  h        print this help
fly cam: WASD move, Space/Shift ascend/descend, hold RMB to look,
wheel (while looking) adjusts speed."""

# native file-dialog filters (the reference's rfd pickers:
# metadata.json only for stores, src/plugins/metadata.rs:395-442;
# las/laz/ply/json for conversion input, src/plugins/converter.rs:764-794)
STORE_FILETYPES = [("point cloud store", "metadata.json")]
CONVERT_FILETYPES = [("point clouds", "*.las *.laz *.ply *.json")]
EXPORT_FILETYPES = [("PLY", "*.ply"), ("LAS", "*.las"), ("LAZ", "*.laz")]


class WindowLoop:
    """The per-frame pump: events -> input sample -> update -> render ->
    blit. Mirrors the reference's event_loop closure (winit.rs:112-159):
    window events feed the input plugin, RedrawRequested runs the
    schedule, Resized reconfigures the surface, CloseRequested exits.

    Key toggles stand in for the reference's egui panel controls
    (ui.rs:122-146 / debug.rs:21-36) — the browser client has the full
    mouse UI; locally the same runtime state flips from the keyboard
    (``HOTKEY_HELP``).
    """

    def __init__(self, viewer, backend, input_state: InputState | None = None,
                 title: str = "point_cloud_tpu_torch"):
        self.viewer = viewer
        self.backend = backend
        self.input = input_state or InputState()
        self.title = title
        self.running = True
        self.frames = 0
        self._last = None  # previous frame timestamp for real dt
        self.converter = None  # in-app converter, created on first use
        # trailing timestamped key_up held back one poll: its matching
        # X11 auto-repeat key_down may arrive at the head of the NEXT
        # batch (repeat pair split across two polls)
        self._pending_key_up: WindowEvent | None = None

    # --- dialogs + in-app converter ------------------------------------------

    def _dialog(self, name: str, *args):
        """Ask the backend for a native dialog; None when the backend has
        none (headless stubs simply skip the action, like the reference's
        rfd picker returning None on cancel)."""
        fn = getattr(self.backend, name, None)
        return fn(*args) if fn is not None else None

    def _get_converter(self):
        if self.converter is None:
            from .interactive import InteractiveConverter

            self.converter = InteractiveConverter(self.viewer)
        return self.converter

    # --- hotkeys -------------------------------------------------------------

    def _apply_hotkey(self, key: str) -> None:
        v = self.viewer
        s = v.settings
        d = v.debug
        if key == "p":
            v.stream_enabled = not v.stream_enabled
        elif key == "v":
            s.voronoi = not s.voronoi
        elif key == "o":
            s.size_by_distance = not s.size_by_distance
        elif key == "x":
            d.show_streaming_rects = not d.show_streaming_rects
        elif key == "b":
            d.show_bounding_box = not d.show_bounding_box
        elif key == "g":
            d.show_cell_grid = not d.show_cell_grid
        elif key == "c":
            if d.show_frustum:
                d.show_frustum = False
            else:
                v.freeze_frustum()
        elif key == "n":
            if d.frozen_frustum is None:
                v.freeze_frustum()
            d.show_plane_normals = not d.show_plane_normals
        elif key in ("bracketleft", "["):
            v.streaming_scale = max(1.0, v.streaming_scale - 0.5)
        elif key in ("bracketright", "]"):
            v.streaming_scale = min(5.0, v.streaming_scale + 0.5)
        elif key.isdigit():
            h = int(key)
            hidden = s.hidden_hierarchies
            (hidden.discard if h in hidden else hidden.add)(h)
        elif key == "m":
            # open-store picker (metadata.rs:395-442 native rfd dialog)
            path = self._dialog(
                "ask_open_file", "Open point cloud store", STORE_FILETYPES
            )
            if path:
                v.load_metadata(path)
        elif key == "f":
            # choose-files (converter.rs:764-794 filter)
            paths = self._dialog(
                "ask_open_files", "Choose files to convert",
                CONVERT_FILETYPES,
            )
            if paths:
                self._get_converter().choose_files(paths)
        elif key == "t":
            # start/stop (converter.rs:740-757)
            from .interactive import ConversionState

            conv = self._get_converter()
            if conv.state == ConversionState.CONVERTING:
                conv.stop()
            else:
                conv.start()
        elif key == "u":
            # save-at: store directory + auto-save (converter.rs:641-721)
            directory = self._dialog("ask_directory", "Save store at")
            if directory:
                self._get_converter().save_at(directory)
        elif key == "k":
            self._get_converter().new_cloud()
        elif key == "e":
            # export the open store (no reference equivalent: its viewer
            # only reads stores; here the loop closes back to interchange)
            wd = v.working_directory
            root = getattr(wd, "root", None)
            if root is None or (isinstance(root, str) and "://" in root):
                log.warning("export: no local store open")
                return
            out = self._dialog(
                "ask_save_file", "Export point cloud as", EXPORT_FILETYPES
            )
            if out:
                import threading

                from ..export import export_store

                def run(store=Path(root), dst=out):
                    # off the event loop: a large store's export takes
                    # seconds and must not freeze the window; reads
                    # are store-file-only, safe next to streaming loads
                    try:
                        n = export_store(store, dst)
                        log.info("Exported %d points to %s", n, dst)
                    except Exception as err:
                        log.error("Export failed: %s", err)

                threading.Thread(
                    target=run, name="pct-export", daemon=True
                ).start()
        elif key == "h":
            print(HOTKEY_HELP)

    # --- event application -------------------------------------------------

    def apply_event(self, ev: WindowEvent) -> None:
        if ev.kind == "key_down" and ev.key:
            # toggles fire on the PRESS edge only: Tk auto-repeat
            # delivers held keys as repeated KeyPress events (Windows/
            # macOS), which would flicker a toggle while held. X11
            # repeats arrive as KeyRelease+KeyPress pairs instead —
            # filter_auto_repeat drops those before they reach here.
            if ev.key not in self.input.pressed_keys:
                self._apply_hotkey(ev.key)
            self.input.key_down(ev.key)
        elif ev.kind == "key_up" and ev.key:
            self.input.key_up(ev.key)
        elif ev.kind == "button_down" and ev.button:
            self.input.button_down(ev.button)
        elif ev.kind == "button_up" and ev.button:
            self.input.button_up(ev.button)
        elif ev.kind == "cursor":
            self.input.cursor_moved(ev.x, ev.y)
        elif ev.kind == "wheel":
            self.input.wheel(ev.steps)
        elif ev.kind == "resize":
            w, h = int(ev.x), int(ev.y)
            if (w, h) != (self.viewer.settings.width,
                          self.viewer.settings.height) and w > 0 and h > 0:
                # WindowResized (winit.rs:139-148): surface + camera
                # aspect + renderer reconfigure
                self.viewer.resize(w, h)
        elif ev.kind == "close":
            self.running = False

    # --- frame -------------------------------------------------------------

    def step(self) -> bool:
        """One frame; returns False when the loop should stop."""
        events = list(self.backend.poll_events())
        carried = self._pending_key_up
        if carried is not None:
            # re-enter last batch's held-back key_up so a repeat pair
            # split across two polls still cancels out
            events.insert(0, carried)
            self._pending_key_up = None
        events = filter_auto_repeat(events)
        if (events and events[-1].kind == "key_up"
                and events[-1] is not carried  # held at most one poll
                and events[-1].key is not None
                and events[-1].time_ms is not None):
            # hold a trailing timestamped key_up one poll (~1 frame):
            # if it was half of a split repeat pair the matching
            # key_down leads the next batch; a genuine release just
            # lands one frame later
            self._pending_key_up = events.pop()
        for ev in events:
            self.apply_event(ev)
        if not self.running or not self.backend.alive:
            return False

        now = time.monotonic()
        dt = (now - self._last) if self._last is not None else 1.0 / 60.0
        self._last = now

        self.viewer.update(dt=min(dt, 0.25), inputs=self.input.sample())
        if self.converter is not None:
            # one frame-slice of conversion work (the chained systems,
            # reference src/plugins/converter.rs:50-62) — cells publish
            # live into the renderer as they form
            self.converter.update()
        # double-buffered: this step dispatches frame k and blits frame
        # k-1 (Viewer.render_pipelined) — device chain overlaps the
        # previous frame's readback, one frame of display latency like
        # the reference's AutoVsync swapchain
        out = self.viewer.render_pipelined()
        if out is not None:
            self.backend.blit(np.asarray(out[0]))
        self.frames += 1
        fps = self.viewer.diagnostics.fps
        if fps:
            title = f"{self.title} — {fps:.1f} fps"
            progress = self._conversion_title()
            if progress:
                title += f" — {progress}"
            self.backend.set_title(title)
        return True

    def _conversion_title(self) -> str | None:
        """Per-file progress for the title bar (the egui progress list,
        converter.rs:796-848, folded into the one line of chrome Tk has)."""
        from .interactive import ConversionState

        conv = self.converter
        if conv is None or conv.state != ConversionState.CONVERTING:
            return None
        for status in conv.files:
            if status.state == "converting":
                done = status.total - status.remaining
                return f"converting {status.path.name} {done}/{status.total}"
        return "converting"

    def run(self, max_frames: int | None = None) -> int:
        """Pump frames until close (or ``max_frames``); returns the
        number of frames dispatched."""
        while self.step():
            if max_frames is not None and self.frames >= max_frames:
                break
        out = self.viewer.render_flush()  # drain the in-flight frame
        if out is not None and self.backend.alive:
            self.backend.blit(np.asarray(out[0]))
        if self.converter is not None:
            # exit flush: write every in-RAM cell + metadata, the asset
            # manager's save-on-exit (asset.rs:667-676)
            self.converter.flush()
        return self.frames


class TkBackend:
    """Tk window backend: binds key/mouse/resize events into a queue and
    blits frames through a PPM PhotoImage. Requires a display ($DISPLAY
    on X11); constructing it headless raises Tk's own TclError with a
    clear message.
    """

    def __init__(self, width: int, height: int,
                 title: str = "point_cloud_tpu_torch"):
        import tkinter

        self._tk = tkinter
        self.root = tkinter.Tk()
        self.root.title(title)
        self.root.geometry(f"{width}x{height}")
        self.label = tkinter.Label(self.root)
        self.label.pack(fill="both", expand=True)
        self._events: list[WindowEvent] = []
        self._photo = None
        self.alive = True

        r = self.root
        r.protocol("WM_DELETE_WINDOW", self._on_close)
        r.bind("<KeyPress>", self._on_key_down)
        r.bind("<KeyRelease>", self._on_key_up)
        r.bind("<ButtonPress>", self._on_button_down)
        r.bind("<ButtonRelease>", self._on_button_up)
        r.bind("<Motion>", self._on_motion)
        r.bind("<MouseWheel>", self._on_wheel)  # Windows/macOS
        r.bind("<Configure>", self._on_configure)
        self._size = (width, height)

    # --- Tk event handlers -> normalized queue -----------------------------

    def _on_close(self):
        self._events.append(WindowEvent("close"))
        self.alive = False
        self.root.destroy()

    def _on_key_down(self, e):
        self._events.append(
            WindowEvent("key_down", key=translate_keysym(e.keysym),
                        time_ms=getattr(e, "time", None))
        )

    def _on_key_up(self, e):
        self._events.append(
            WindowEvent("key_up", key=translate_keysym(e.keysym),
                        time_ms=getattr(e, "time", None))
        )

    def _on_button_down(self, e):
        if e.num in (4, 5):  # X11 wheel events arrive as buttons 4/5
            self._events.append(
                WindowEvent("wheel", steps=1.0 if e.num == 4 else -1.0)
            )
            return
        b = translate_button(e.num)
        if b:
            self._events.append(WindowEvent("button_down", button=b))

    def _on_button_up(self, e):
        if e.num in (4, 5):
            return
        b = translate_button(e.num)
        if b:
            self._events.append(WindowEvent("button_up", button=b))

    def _on_motion(self, e):
        self._events.append(WindowEvent("cursor", x=e.x, y=e.y))

    def _on_wheel(self, e):
        self._events.append(WindowEvent("wheel", steps=e.delta / 120.0))

    def _on_configure(self, e):
        if (e.width, e.height) != self._size:
            self._size = (e.width, e.height)
            self._events.append(
                WindowEvent("resize", x=e.width, y=e.height)
            )

    # --- native file dialogs (the reference's rfd pickers) -------------------

    def ask_open_file(self, title: str, filetypes) -> str | None:
        from tkinter import filedialog

        return filedialog.askopenfilename(
            parent=self.root, title=title, filetypes=filetypes
        ) or None

    def ask_open_files(self, title: str, filetypes) -> list[str]:
        from tkinter import filedialog

        return list(filedialog.askopenfilenames(
            parent=self.root, title=title, filetypes=filetypes
        ))

    def ask_directory(self, title: str) -> str | None:
        from tkinter import filedialog

        return filedialog.askdirectory(parent=self.root, title=title) or None

    def ask_save_file(self, title: str, filetypes) -> str | None:
        from tkinter import filedialog

        return filedialog.asksaveasfilename(
            parent=self.root, title=title, filetypes=filetypes,
            defaultextension=filetypes[0][1].lstrip("*"),
        ) or None

    # --- WindowBackend surface ---------------------------------------------

    def poll_events(self) -> list[WindowEvent]:
        if self.alive:
            try:
                self.root.update()  # pump Tk's event loop once
            except self._tk.TclError:
                self.alive = False
        out, self._events = self._events, []
        return out

    def blit(self, rgb: np.ndarray) -> None:
        if not self.alive:
            return
        self._photo = self._tk.PhotoImage(data=rgb_to_ppm(rgb))
        self.label.configure(image=self._photo)

    def set_title(self, title: str) -> None:
        if self.alive:
            self.root.title(title)

    def close(self) -> None:
        if self.alive:
            self.alive = False
            self.root.destroy()


def run_window(store: str, width: int = 960, height: int = 600,
               max_frames: int | None = None, backend=None,
               mesh_devices: int = 0, device="cuda") -> int:
    """Open a local window on a converted store and run the event loop.

    ``backend=None`` builds a :class:`TkBackend` (needs a display);
    tests pass a stub. Frames render on ``device``, over a mesh of
    ``mesh_devices`` of its devices when > 0. Returns the number of
    frames rendered.
    """
    from pathlib import Path

    from ..render.renderer import RenderSettings
    from .app import Viewer

    p = Path(store)
    if p.is_dir():  # accept the store directory or its metadata.json
        p = p / "metadata.json"

    settings = RenderSettings(width=width, height=height)
    viewer = Viewer(settings, mesh_devices=mesh_devices, device=device)
    viewer.load_metadata(p)
    backend = backend or TkBackend(width, height)
    loop = WindowLoop(viewer, backend)
    try:
        return loop.run(max_frames=max_frames)
    finally:
        backend.close()
        viewer.close()


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        description="Local point-cloud viewer window (Tk)"
    )
    p.add_argument("store", help="converted store directory (metadata.json)")
    p.add_argument("--width", type=int, default=960)
    p.add_argument("--height", type=int, default=600)
    p.add_argument("--frames", type=int, default=None,
                   help="exit after N frames (default: until closed)")
    p.add_argument("--mesh", type=int, default=0, metavar="N",
                   help="render data-parallel over an N-device mesh "
                   "(0 = one device)")
    args = p.parse_args(argv)
    # frames render on the card; without one this raises
    try:
        run_window(args.store, width=args.width, height=args.height,
                   max_frames=args.frames, mesh_devices=args.mesh)
    except Exception as err:  # headless host: say so instead of a Tk dump
        if "DISPLAY" in str(err) or "display" in str(err):
            p.error(
                "no display available for the Tk window "
                f"({err}); render headless instead: "
                "python -m point_cloud_tpu_torch.serve <store> (browser "
                "viewer) or viewer.offscreen.render_orbit (PNG frames)"
            )
        raise
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
