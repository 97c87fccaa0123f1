"""The benchmark's own spans, and the device trace of a measured window.

Spans are host-clock intervals the benchmark records around its calls
into the program's layers (``frame.update``, ``frame.render``, ...), from
any thread. With ``--trace 1`` the window also runs under
``torch.profiler``; :meth:`DeviceTrace.summary` merges the device's
kernel, copy and set intervals, measures how long the device was busy,
ranks device operations by time, and names each idle gap after the
benchmark span that was open in its middle.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import threading
import time


class Spans:
    """Named host-clock intervals, appended from any thread."""

    def __init__(self):
        self.items: list[tuple[str, float, float]] = []
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            with self._lock:
                self.items.append((name, t0, t1))

    def durations(self, name: str) -> list[float]:
        with self._lock:
            return [t1 - t0 for n, t0, t1 in self.items if n == name]


DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


class DeviceTrace:
    """``torch.profiler`` over the measured window (``enabled``), with an
    anchor that maps the host clock onto the trace's."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._prof = None
        self._anchor = None
        self.events = None

    def start(self) -> None:
        if not self.enabled:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        with record_function("bench.anchor"):
            self._anchor = time.perf_counter()
        torch.cuda.synchronize()

    def stop(self) -> None:
        """End the profile and keep its device events and the anchor."""
        if self._prof is None:
            return
        import torch

        torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        finally:
            os.unlink(path)
        self._prof = None
        events = data["traceEvents"] if isinstance(data, dict) else data
        anchor_ts = None
        device = []
        for e in events:
            if e.get("ph") != "X":
                continue
            if e.get("name") == "bench.anchor" and anchor_ts is None:
                anchor_ts = e["ts"] * 1e-6
            elif e.get("cat") in DEVICE_CATEGORIES:
                device.append((e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6,
                               e.get("name", "?")))
        if anchor_ts is None:
            raise RuntimeError("the device trace lost its anchor")
        shift = anchor_ts - self._anchor
        self.events = [(a - shift, b - shift, n) for a, b, n in device]

    def summary(self, t0: float, t1: float, spans: Spans) -> dict | None:
        """Busy seconds, window length, top device operations and longest
        idle gaps (named by the innermost open span) over [t0, t1] on the
        host clock; None without a trace."""
        if self.events is None:
            return None
        by_name: dict[str, float] = {}
        clipped = []
        for a, b, name in self.events:
            a, b = max(a, t0), min(b, t1)
            if b > a:
                clipped.append((a, b))
                by_name[name] = by_name.get(name, 0.0) + (b - a)
        clipped.sort()
        busy = 0.0
        gaps = []
        cursor = t0
        for a, b in clipped:
            if a > cursor:
                gaps.append((cursor, a))
            if b > cursor:
                busy += b - max(a, cursor)
                cursor = b
        if t1 > cursor:
            gaps.append((cursor, t1))
        named = []
        with spans._lock:
            items = list(spans.items)
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
            mid = (a + b) / 2
            open_spans = [(s0, n) for n, s0, s1 in items if s0 <= mid < s1]
            name = max(open_spans)[1] if open_spans else "outside_spans"
            named.append([name, b - a])
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        return {"busy_s": busy, "window_s": t1 - t0,
                "device_ops": [[n, s] for n, s in top],
                "idle_gaps": named}
