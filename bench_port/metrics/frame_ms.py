"""The window's wall time over the frames render_pipelined returned in it."""


def read(run):
    t0, t1 = run["window"]
    return (t1 - t0) * 1e3 / run["frames"]
