"""Mean time a frame of queuing the device chain (program span
render.dispatch: LOD walk on a miss, bucket passes, pack, readback)."""

from bench_port.stats import span_ms_per_frame


def read(run):
    return span_ms_per_frame(run, "render.dispatch")
