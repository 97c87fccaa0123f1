"""Cells a frame whose points the renderer read on a bucket-cache miss
(program counter render.cells_read over the window's frames; a steady
frame reads none). None in an untraced run, which keeps no counters."""


def read(run):
    counters = run.get("program_counters")
    if counters is None or not run["frames"]:
        return None
    return counters.get("render.cells_read", 0) / run["frames"]
