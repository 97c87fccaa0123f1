"""What a traced run of the orbit reads beside the benchmark's own spans:
the program's spans and counters, whose seven readers return numbers,
and the set-up phases."""

from __future__ import annotations

import pytest
import torch

from bench_port import spec
from bench_port.run import run_cell
from conftest import small_config, small_mix

CPU = torch.device("cpu")
WORKLOAD = "aerial_ql1.orbit"
PROGRAM = ("frame.gather_ms", "frame.upload_ms", "frame.dispatch_ms",
           "frame.readback_wait_ms", "frame.asset_wait_ms",
           "frame.bucket_miss_pct", "frame.cells_read")
SETUP = ("setup.inputs_s", "setup.store_s", "setup.settle_s")


@pytest.fixture(scope="module")
def traced():
    bench = spec.load_benchmark()
    result, run = run_cell(WORKLOAD, 2**31 + 29, 1.5, True, CPU,
                           bench=bench,
                           config=small_config(bench, "aerial_ql1"),
                           mix=small_mix(bench, WORKLOAD))
    assert result["correct"], result["compared"]
    return result, run


def test_program_spans_feed_their_readers(traced):
    result, run = traced
    names = {name for name, _, _ in run["spans"].items}
    assert {"render.gather", "render.dispatch", "render.wait"} <= names
    t0, t1 = run["window"]
    assert all(t0 <= a <= b <= t1 for _, a, b in run["spans"].items)
    values = {name: spec.reader(name)(run) for name in PROGRAM}
    assert all(v is not None and v >= 0 for v in values.values()), values
    assert values["frame.gather_ms"] > 0
    # a bucket-cache miss reads its cells; a hit reads none
    counters = run["program_counters"]
    assert values["frame.cells_read"] == \
        counters.get("render.cells_read", 0) / run["frames"]
    assert (counters.get("render.bucket_miss", 0) > 0) == \
        (values["frame.cells_read"] > 0)
    assert spec.reader("frame.cells_read")(
        {"program_counters": {}, "frames": 4}) == 0
    assert set(PROGRAM) <= set(result["metrics"])
    # an untraced run keeps no program spans or counters: nothing to read
    untraced = {"program_counters": None, "frames": run["frames"],
                "spans": run["spans"]}
    assert all(spec.reader(name)(untraced) is None for name in PROGRAM)


def test_setup_phases_read_within_setup_s(traced):
    result, run = traced
    values = {name: spec.reader(name)(run) for name in SETUP}
    assert all(v is not None and v > 0 for v in values.values()), values
    assert set(SETUP) <= set(result["metrics"])
    assert sum(values.values()) <= run["setup_s"]
    # the phases are the runner's own steps, timed apart; the kernels'
    # build is one of its own (on the card), never the viewer's settling
    phases = dict(run["phases"])
    assert values["setup.settle_s"] == phases["settle"] + phases["warm"]
    assert "build" not in phases  # the CPU builds no kernels
