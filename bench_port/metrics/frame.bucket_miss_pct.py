"""Share of the window's buckets whose device arrays the renderer had to
build and upload (program counters render.bucket_miss over
render.bucket_hit + render.bucket_miss). None in an untraced run, which
keeps no counters."""


def read(run):
    counters = run.get("program_counters")
    if counters is None:
        return None
    miss = counters.get("render.bucket_miss", 0)
    total = miss + counters.get("render.bucket_hit", 0)
    return 100.0 * miss / total if total else None
