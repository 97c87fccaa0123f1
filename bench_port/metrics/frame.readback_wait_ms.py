"""Mean time a frame render_finish waits for the readback's event
(program span render.wait)."""

from bench_port.stats import span_ms_per_frame


def read(run):
    return span_ms_per_frame(run, "render.wait")
