"""Read the control of the orbit cell's check: the reference put in the
program's place, computed in bfloat16 (the precision below the float32
that the store and the frame state), at the cell's own size.

    python3 -m bench_port.calibrate --workload <name> --seed <n> [<n> ...]

The control renders the frames the check would compare (orbit poses from
the cell's start angle) in bfloat16 against float32 and prints one JSON
line a seed with the number the check compares. The limits in the
traffic mix lie between these readings and those of the program's own
runs.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from . import gen, spec
from .reference import frame as ref_frame
from .reference import store as ref_store
from .reference import view as ref_view

FRAMES = 6


def control(workload: str, seed: int, device, config=None, mix=None,
            frames: int = FRAMES, bench=None) -> dict:
    bench = bench or spec.load_benchmark()
    entry = spec.cell(bench, workload)
    config = config or spec.config(bench, entry["config"])
    mix = mix or spec.traffic(entry["traffic"])
    scene = config["scene"]
    with tempfile.TemporaryDirectory(prefix="bench_port_") as tmp:
        out = Path(tmp) / "store"
        pos, col = gen.decoded_inputs(scene, seed, mix["inputs"], device)
        meta = ref_store.build_store(out, pos, col, config["metadata"],
                                     device)
        cells = ref_frame.CellFiles(out)
        width, height = int(mix["width"]), int(mix["height"])
        far = float(config["metadata"]["max_cell_size"]) * 5.0
        worst = 0.0
        for pose in _poses(mix, meta, seed, frames):
            visible = [c for c in ref_view.visible_cells(
                meta, pose, width / height, far) if cells.exists(*c)]
            a = ref_frame.render(cells, visible, meta, pose, width, height,
                                 device)
            b = ref_frame.render(cells, visible, meta, pose, width, height,
                                 device, dtype=torch.bfloat16)
            worst = max(worst, 100.0 * float(np.any(a != b, -1).mean()))
        return {"frame_px_differ_pct": worst}


def _poses(mix, meta, seed, n):
    bmin = np.asarray(meta["bounding_box"]["min"], np.float32)
    bmax = np.asarray(meta["bounding_box"]["max"], np.float32)
    center = (bmin + bmax) / np.float32(2.0)
    extent = float(np.linalg.norm((bmax - bmin) / np.float32(2.0)))
    start = float(gen.rng_for(seed, 3).uniform(0.0, 2 * np.pi))
    out = []
    for k in range(n):
        a = start + k * np.deg2rad(mix["deg_per_frame"]) * 40
        eye = center + np.array([extent * mix["radius_extent"] * np.cos(a),
                                 extent * mix["radius_extent"] * np.sin(a),
                                 extent * mix["height_extent"]], np.float32)
        out.append(ref_view.Pose.looking_at(eye, center))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control reads at the cell's size on a CUDA device",
              file=sys.stderr)
        return 2
    for seed in args.seed:
        found = control(args.workload, seed, torch.device("cuda", 0))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": found}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
