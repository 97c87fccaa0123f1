"""Tracing / profiling: per-stage wall timers, span intervals, counters.

Copy of the reference's ``utils/tracing.py``, with intervals and counters
added for the frame's spans.

The reference's only observability is an FPS readout and a wall-time log
(reference: bevy FrameTimeDiagnosticsPlugin read at
src/plugins/render/ui.rs:103-120; point-converter/src/lib.rs:15,56-59).
This subsystem goes further, as the TPU build needs real profiling:

- :class:`StageTimer` — named-stage accumulation with ``with timer("x")``;
  active timers install per-context (contextvars), so library code calls
  :func:`stage` and :func:`count` unconditionally and pays nothing when no
  timer is active; a timer also keeps every span as
  ``(name, t0, t1, thread id)`` on ``time.perf_counter()``, the clock a
  device trace can be anchored to,
- throughput helpers (Mpts/s given points processed).
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time
from collections import defaultdict

_current_timer: contextvars.ContextVar["StageTimer | None"] = (
    contextvars.ContextVar("pct_stage_timer", default=None)
)
_global_timer: "StageTimer | None" = None  # worker threads fall back here
_OFF = contextlib.nullcontext()  # stateless, so one serves every call


class StageTimer:
    """Totals and call counts by stage name, counters by name, and every
    span as ``(name, t0, t1, thread_id)`` in the order the spans ended.
    Intervals stay in memory until the caller reads them."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.counters: dict[str, int] = defaultdict(int)
        self.intervals: list[tuple[str, float, float, int]] = []
        self._token = None
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            with self._lock:
                self.totals[name] += t1 - t0
                self.counts[name] += 1
                self.intervals.append((name, t0, t1, threading.get_ident()))

    def add(self, name: str, n: int = 1) -> None:
        """Add ``n`` to the counter ``name``."""
        with self._lock:
            self.counters[name] += n

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
        """A row a stage; the counters stay in ``counters``."""
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
        for name in sorted(self.counters):
            lines.append(f"{name:>24}: x{self.counters[name]}")
        if points is not None:
            total = sum(self.totals.values())
            if total > 0:
                lines.append(
                    f"{'throughput':>24}: {points / total / 1e6:.3f} Mpts/s"
                )
        return "\n".join(lines)


def stage(name: str):
    """Time a stage on the context's active timer (no-op without one)."""
    timer = _current_timer.get() or _global_timer
    return _OFF if timer is None else timer(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the active timer's counter ``name`` (no-op without
    one)."""
    timer = _current_timer.get() or _global_timer
    if timer is not None:
        timer.add(name, n)
