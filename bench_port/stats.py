"""The yardstick's arithmetic: percentiles, rates, shares and the H100's
published peaks (NVIDIA H100 SXM data sheet, dense, at its 700 W limit)."""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def p95(values) -> float | None:
    """Nearest-rank 95th percentile: the ceil(0.95 n)-th smallest value."""
    values = sorted(values)
    if not values:
        return None
    return values[math.ceil(0.95 * len(values)) - 1]


def mean(values) -> float | None:
    values = list(values)
    return sum(values) / len(values) if values else None


def span_ms_per_frame(run: dict, name: str) -> float | None:
    """Milliseconds a frame that the program's span ``name`` took over the
    window; None in an untraced run, which keeps no program spans."""
    if run.get("program_counters") is None or not run["frames"]:
        return None
    return sum(run["spans"].durations(name)) * 1e3 / run["frames"]


def bound_s(bytes_moved: float, ops: float) -> float:
    """Least time the card needs: the larger of the byte and the f32
    operation bound."""
    return max(bytes_moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def roofline_pct(bytes_moved: float, ops: float, trace) -> float | None:
    """The bound time of the work as a share of the device's busy time;
    None without a trace or without device time."""
    if trace is None or trace["busy_s"] <= 0 or bytes_moved <= 0:
        return None
    return 100.0 * bound_s(bytes_moved, ops) / trace["busy_s"]


def idle_pct(trace) -> float | None:
    if trace is None or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
