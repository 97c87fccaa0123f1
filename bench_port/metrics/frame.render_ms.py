"""Mean time of Viewer.render_pipelined a frame (benchmark span)."""

from bench_port.stats import mean


def read(run):
    m = mean(run["spans"].durations("frame.render"))
    return None if m is None else m * 1e3
