"""95th percentile (nearest rank) of the intervals between the frames
render_pipelined returned."""

from bench_port.stats import p95


def read(run):
    v = p95(run["intervals"])
    return None if v is None else v * 1e3
