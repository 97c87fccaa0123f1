"""Mean time a frame of the renderer's walks over every loaded cell
(program span render.gather: loaded_cells_table and gather_points)."""

from bench_port.stats import span_ms_per_frame


def read(run):
    return span_ms_per_frame(run, "render.gather")
