"""Run one cell of the port's benchmark once and print its result line.

    python3 -m bench_port.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell's configuration makes its inputs from the seed; its traffic mix
names the runner that sets up, warms, measures for ``--seconds`` and then
checks what the measured window produced against the plain reference in
``reference/``. The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` a ``breakdown``, and ``compared``, each number the check
compared beside its limit. Exit codes: 2 without enough CUDA devices, 3 if
JAX or the JAX package got imported, 1 on any other failure; a run that
is wrong still exits 0, with ``correct`` false.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
import time
import traceback
from pathlib import Path

FORBIDDEN_MODULES = frozenset({"jax", "jaxlib", "flax", "point_cloud_tpu"})


def process_age() -> float:
    """Seconds since this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


def forbidden_imports() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & FORBIDDEN_MODULES)


class Context:
    """What a runner gets: the run's arguments, the cell's files, a work
    directory under ``TMPDIR``, the spans and the device trace."""

    def __init__(self, workload, seed, seconds, traced, device, config, mix,
                 workdir):
        from .trace import DeviceTrace, Spans

        self.workload = workload
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.traced = bool(traced)
        self.device = device
        self.config = config
        self.mix = mix
        self.workdir = Path(workdir)
        self.spans = Spans()
        self.dtrace = DeviceTrace(self.traced and device.type == "cuda")
        self.setup_s = None
        self.phases = [("start", process_age())]

    @contextlib.contextmanager
    def phase(self, name: str):
        """Time one step of set-up, for the run's notes and the readers of
        ``setup.*`` (the run record's ``phases``: (name, seconds) pairs)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases.append((name, time.perf_counter() - t0))

    def start_window(self) -> float:
        """Close set-up: write what set-up wrote to disk (so that its
        write-back does not fall in the window), record ``setup_s``, start
        the trace, return t0."""
        with self.phase("sync"):
            os.sync()
        self.setup_s = process_age()
        self.dtrace.start()
        return time.perf_counter()

    def peak_bytes(self) -> int:
        import torch

        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             device, bench: dict | None = None, config: dict | None = None,
             mix: dict | None = None) -> tuple[dict, dict]:
    """Drive one run of ``workload`` on ``device`` (no look for a chip):
    returns (the result object, the runner's run record). ``config`` and
    ``mix`` replace the cell's files (the tests pass small copies)."""
    from . import spec

    bench = bench or spec.load_benchmark()
    entry = spec.cell(bench, workload)
    config = config or spec.config(bench, entry["config"])
    mix = mix or spec.traffic(entry["traffic"])
    workdir = tempfile.mkdtemp(prefix="bench_port_")
    try:
        ctx = Context(workload, seed, seconds, traced, device, config, mix,
                      workdir)
        run = spec.runner(mix).run(ctx)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    run["setup_s"] = ctx.setup_s
    run["phases"] = ctx.phases
    run.setdefault("notes", []).insert(0, "set-up: " + ", ".join(
        f"{name} {sec:.2f} s" for name, sec in ctx.phases))
    t0, t1 = run["window"]
    run["trace"] = ctx.dtrace.summary(t0, t1, ctx.spans)
    run["spans"] = ctx.spans
    metrics = {}
    for m in spec.metrics_for(bench, workload, traced):
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    compared = {name: {"value": float(v), "limit": float(lim)}
                for name, (v, lim) in run["compared"].items()}
    correct = (run["attempted"] > 0 and run["failed"] == 0
               and all(c["value"] <= c["limit"] for c in compared.values()))
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": _device_kind(device), "count": 1,
                   "memory_peak_bytes": run["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": run["attempted"],
              "failed": run["failed"], "metrics": metrics,
              "device": device_info}
    if run["trace"] is not None:
        device_info["busy_s"] = run["trace"]["busy_s"]
        device_info["window_s"] = run["trace"]["window_s"]
        result["breakdown"] = {"device_ops": run["trace"]["device_ops"],
                               "idle_gaps": run["trace"]["idle_gaps"]}
    result["compared"] = compared
    return result, run


def _device_kind(device) -> str:
    import torch

    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    try:
        import torch

        from . import spec

        bench = spec.load_benchmark()
        entry = spec.cell(bench, args.workload)
        count = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if count < entry["chips"]:
            print(f"{args.workload} needs {entry['chips']} CUDA device(s); "
                  f"this machine has {count}", file=sys.stderr)
            return 2
        result, run = run_cell(args.workload, args.seed, args.seconds,
                               bool(args.trace), torch.device("cuda", 0),
                               bench=bench)
    except Exception:
        traceback.print_exc()
        return 1
    found = forbidden_imports()
    if found:
        print(f"forbidden modules were imported: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for line in run.get("notes", []):
        print(line, file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"compared {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
