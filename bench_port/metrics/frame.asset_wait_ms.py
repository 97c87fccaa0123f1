"""Mean time a frame Viewer.update blocks on the asset pool (program
span update.asset_wait)."""

from bench_port.stats import span_ms_per_frame


def read(run):
    return span_ms_per_frame(run, "update.asset_wait")
