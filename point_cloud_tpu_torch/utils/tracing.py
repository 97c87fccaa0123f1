"""Tracing / profiling: per-stage wall timers.

Copy of the reference's ``utils/tracing.py``; its ``device_trace`` (a
``jax.profiler`` wrapper) runs on ``torch.profiler`` here.

The reference's only observability is an FPS readout and a wall-time log
(reference: bevy FrameTimeDiagnosticsPlugin read at
src/plugins/render/ui.rs:103-120; point-converter/src/lib.rs:15,56-59).
This subsystem goes further, as the TPU build needs real profiling:

- :class:`StageTimer` — named-stage accumulation with ``with timer("x")``;
  active timers install per-context (contextvars), so library code calls
  :func:`stage` unconditionally and pays nothing when no timer is active,
- throughput helpers (Mpts/s given points processed).
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from collections import defaultdict

_current_timer: contextvars.ContextVar["StageTimer | None"] = (
    contextvars.ContextVar("pct_stage_timer", default=None)
)
_global_timer: "StageTimer | None" = None  # worker threads fall back here


class StageTimer:
    def __init__(self):
        import threading

        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self._token = None
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.totals[name] += dt
                self.counts[name] += 1

    # --- installation --------------------------------------------------------

    def __enter__(self) -> "StageTimer":
        global _global_timer
        self._token = _current_timer.set(self)
        self._prev_global = _global_timer
        _global_timer = self  # contextvars don't reach executor threads
        return self

    def __exit__(self, *exc) -> None:
        global _global_timer
        _current_timer.reset(self._token)
        if _global_timer is self:
            _global_timer = self._prev_global

    # --- reporting ------------------------------------------------------------

    def report(self) -> dict[str, dict[str, float]]:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "count": self.counts[name],
                "mean_ms": round(
                    self.totals[name] / max(self.counts[name], 1) * 1e3, 3
                ),
            }
            for name in sorted(self.totals)
        }

    def summary(self, points: int | None = None) -> str:
        lines = []
        for name, row in self.report().items():
            lines.append(
                f"{name:>24}: {row['total_s']:8.3f}s "
                f"x{row['count']:<6} ({row['mean_ms']:.2f} ms avg)"
            )
        if points is not None:
            total = sum(self.totals.values())
            if total > 0:
                lines.append(
                    f"{'throughput':>24}: {points / total / 1e6:.3f} Mpts/s"
                )
        return "\n".join(lines)


@contextlib.contextmanager
def stage(name: str):
    """Time a stage on the context's active timer (no-op without one)."""
    timer = _current_timer.get() or _global_timer
    if timer is None:
        yield
    else:
        with timer(name):
            yield


@contextlib.contextmanager
def device_trace(log_dir):
    """Capture a device trace of the block into ``log_dir`` (created if
    missing) as a Chrome trace file, ``trace_<pid>_<n>.json``, readable
    by Perfetto or chrome://tracing: the CPU ops, and the CUDA kernels
    when a card is present (``torch.profiler``)."""
    import os
    from pathlib import Path

    import torch
    from torch.profiler import ProfilerActivity, profile

    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    n = len(list(out.glob(f"trace_{os.getpid()}_*.json")))
    prof.export_chrome_trace(str(out / f"trace_{os.getpid()}_{n}.json"))
