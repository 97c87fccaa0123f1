"""The frames' bound time (K1 over the rows culled, K5 over the rows
ranked, K2 over the splat rows and pixels, at HBM rate or f32 peak) as a
share of the device's busy time in the traced window."""

from bench_port.stats import roofline_pct


def read(run):
    work = run.get("frame_work")
    if work is None:
        return None
    return roofline_pct(work["bytes"], work["ops"], run["trace"])
