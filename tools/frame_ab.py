"""A/B of the frame paths between a parent commit's tree and this one, on
one CUDA card.

Converts ``chip_smoke.py`` phase 4's cloud (``synth_cloud(2^23,
seed=0)`` with its colors) with this tree's ``--native`` CLI, then renders
that store from each tree in the order parent, change, change, parent
(``--rounds`` times), each run a subprocess started in its tree's root
so that each tree builds and loads its own kernels: the ``chip_smoke.py``
phase 5c orbit at 1280x720 (``render`` ms a frame after the first, and
``render_pipelined`` ms a steady frame), one orbit frame's device time
under ``torch.profiler`` and a 640x480 ``StoreServer.render_png`` at
phase 6's first pose (ms a request after a warm one, without HTTP). The
first run of each tree is a warm-up (its builds), not timed. Every run's
served PNG must be byte-identical to the first run's; whether its orbit
PNGs are too is reported (the orbit streams cells while it moves). One
JSON line with every run's numbers and the card's ``nvidia-smi`` name and
power limit. Needs a card; imports neither ``jax`` nor
``point_cloud_tpu``. ``--parent`` is the root of a parent commit's tree:

    git archive <parent> | tar -x -C .chip_work/parent_tree
    python tools/frame_ab.py --parent .chip_work/parent_tree
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# one run in a tree's root: its chip_smoke.py helpers and its port
CHILD = r"""
import json, sys, time
from pathlib import Path
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from point_cloud_tpu_torch.render.renderer import RenderSettings
from point_cloud_tpu_torch.serve import StoreServer
from point_cloud_tpu_torch.viewer import Viewer
from point_cloud_tpu_torch.viewer.offscreen import render_orbit

store, out, frames = sys.argv[1], Path(sys.argv[2]), int(sys.argv[3])
viewer = Viewer(RenderSettings(width=cs.FRAME_W, height=cs.FRAME_H),
                device="cuda")
viewer.load_metadata(Path(store) / "metadata.json")
cs.settle(viewer)
render, times = viewer.render, []

def timed():
    t0 = time.perf_counter()
    got = render()
    times.append((time.perf_counter() - t0) * 1e3)
    return got

viewer.render = timed
render_orbit(viewer, out / "orbit", n_frames=frames)
viewer.render = render
viewer.render_pipelined()
torch.cuda.synchronize()
t0 = time.perf_counter()
done = sum(viewer.render_pipelined() is not None for _ in range(frames))
done += viewer.render_flush() is not None
pipelined = (time.perf_counter() - t0) * 1e3 / done
busy = cs.busy_share(torch, render)
viewer.close()
server = StoreServer(store, device="cuda")
png = server.render_png(yaw=0.5, pitch=-0.4)
served = []
for _ in range(frames):
    t0 = time.perf_counter()
    if server.render_png(yaw=0.5, pitch=-0.4) != png:
        raise AssertionError("one pose served two frames")
    served.append((time.perf_counter() - t0) * 1e3)
server.viewer.close()
(out / "served.png").write_bytes(png)
print(json.dumps({"render_ms": times, "pipelined_ms": pipelined,
                  "device_ms": busy["device_ms"], "served_ms": served}))
"""


def run(tree: Path, store: Path, out: Path, frames: int) -> dict:
    """One run of CHILD in ``tree``'s root; its JSON line."""
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, str(store), str(out), str(frames)],
        cwd=tree, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree} failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def same_pngs(a: Path, b: Path) -> bool:
    """Whether the directories hold the same PNG files, byte for byte."""
    names = sorted(p.relative_to(a) for p in a.rglob("*.png"))
    return bool(names) and names == sorted(
        p.relative_to(b) for p in b.rglob("*.png")) and all(
        (a / n).read_bytes() == (b / n).read_bytes() for n in names)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="the root of a parent commit's tree")
    ap.add_argument("--rounds", type=int, default=2,
                    help="times to run parent, change, change, parent")
    ap.add_argument("--frames", type=int, default=8)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("frame_ab: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from point_cloud_tpu_torch.core.point import PointBatch
    from point_cloud_tpu_torch.io.ply import write_ply
    from point_cloud_tpu_torch.models.synth import synth_cloud

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    trees = {"parent": args.parent.resolve(), "change": ROOT}
    order = ["parent", "change", "change", "parent"] * args.rounds
    with tempfile.TemporaryDirectory(prefix="frame_ab_") as tmp:
        tmp = Path(tmp)
        src = tmp / "cloud.ply"
        rng = np.random.default_rng(3)  # chip_smoke.py phase 4's colors
        write_ply(src, PointBatch(
            synth_cloud(cs.CLOUD_POINTS, seed=0),
            rng.integers(0, 256, (cs.CLOUD_POINTS, 4), dtype=np.uint8)))
        store = tmp / "store"
        cs.run_cli("--native", src, store)
        for name, tree in trees.items():  # the builds, untimed
            run(tree, store, tmp / f"warm-{name}", 2)
        runs = {name: [] for name in trees}
        orbit_identical = []
        first = tmp / "run-0"
        for i, name in enumerate(order):
            out = tmp / f"run-{i}"
            runs[name].append(run(trees[name], store, out, args.frames))
            if (out / "served.png").read_bytes() != (
                    first / "served.png").read_bytes():
                raise AssertionError(f"run {i} ({name}): the served PNG "
                                     "differs from the first run's")
            orbit_identical.append(same_pngs(first / "orbit", out / "orbit"))
    medians = {name: {
        "render_ms": [statistics.median(r["render_ms"][1:]) for r in rs],
        "pipelined_ms": [r["pipelined_ms"] for r in rs],
        "device_ms": [r["device_ms"] for r in rs],
        "served_ms": [statistics.median(r["served_ms"]) for r in rs]}
        for name, rs in runs.items()}
    cs.emit({"order": order, "frames": args.frames, "medians": medians,
             "runs": runs, "served_png_identical": True,
             "orbit_pngs_identical": orbit_identical, "device": smi})
    return 0


if __name__ == "__main__":
    sys.exit(main())
