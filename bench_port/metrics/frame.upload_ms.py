"""Mean time a frame of the renderer's cache-miss uploads (program span
render.upload: bucket arrays, loaded-cells hash, ids, colour table)."""

from bench_port.stats import span_ms_per_frame


def read(run):
    return span_ms_per_frame(run, "render.upload")
