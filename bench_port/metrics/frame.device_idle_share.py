"""Share of the frame window in which no operation ran on the device."""

from bench_port.stats import idle_pct


def read(run):
    return idle_pct(run["trace"])
