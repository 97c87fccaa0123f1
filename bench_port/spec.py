"""What a cell is: its entry in ``BENCHMARK.json`` and the files it names.

A cell ``<config>.<name>`` takes its configuration from
``configs/<config>.json``, its traffic mix from ``traffic/<traffic>.json``
(whose ``runner`` names the module of ``runners/`` that runs it) and each
metric from ``metrics/<metric>.py``, a reader with ``read(run)``; the
configuration's ``scene["kind"]`` names the module of ``scenes/`` that
draws its inputs (``gen.py``). Adding a deployment, a cell, a mix or a
metric adds files and entries; nothing here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(path: Path | None = None) -> dict:
    return json.loads((path or ROOT / "BENCHMARK.json").read_text())


def cell(bench: dict, workload: str) -> dict:
    for entry in bench["workloads"]:
        if entry["name"] == workload:
            return entry
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config(bench: dict, name: str) -> dict:
    for entry in bench["configs"]:
        if entry["name"] == name:
            return json.loads((ROOT / entry["file"]).read_text())
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def runner(mix: dict):
    return importlib.import_module(f"bench_port.runners.{mix['runner']}")


def scene(kind: str):
    """The module of ``scenes/<kind>.py``, which draws and decodes the
    inputs of every configuration whose scene is of that kind."""
    path = HERE / "scenes" / f"{kind}.py"
    if not path.is_file():
        raise ValueError(f"unknown scene kind {kind!r}: no file "
                         f"bench_port/scenes/{kind}.py")
    return importlib.import_module(f"bench_port.scenes.{kind}")


def metrics_for(bench: dict, workload: str, traced: bool) -> list[dict]:
    """The cell's end-to-end metrics (those whose ``workloads`` list names
    it, or that have none), or with ``traced`` its per-layer ones: those
    whose list names it, or that have none and move one of the cell's
    end-to-end metrics."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not traced:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def reader(name: str):
    """``read(run) -> float | None`` of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_port.metrics.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
