"""A/B of the slice's conversions between a parent commit's tree and this
one, on one CUDA card.

Writes ``chip_smoke.py`` phase 4's cloud (``synth_cloud(2^23, seed=0)``
with its colors) as one PLY, then converts it with each ``--flags`` of
the port's CLI at batch 2^18 from each tree, in the order parent,
change, change, parent: each run a subprocess started in its tree's
root, with ``--profile``, so that each tree builds and loads its own
kernels and engine. The first conversion of each tree is a warm-up (its
builds), not timed. Every store must be byte-identical to the first
one's. One JSON line a flag: the wall times (``convert_s``), the
kernels' launch counts and the stage timers of each run, with the
card's ``nvidia-smi`` name and power limit. Needs a card; imports
neither ``jax`` nor ``point_cloud_tpu``. ``--parent`` is the root of a
parent commit's tree:

    git archive <parent> | tar -x -C .chip_work/parent_tree
    python tools/slice_ab.py --parent .chip_work/parent_tree
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def convert(tree: Path, flag: str, src: Path, out: Path, batch: int) -> dict:
    """One conversion through ``tree``'s CLI; its ``--profile`` line."""
    proc = subprocess.run(
        [sys.executable, "-m", "point_cloud_tpu_torch.convert.cli", flag,
         "--batch-size", str(batch), "--profile", "-o", str(out), "-f",
         str(src)], cwd=tree, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0 or "Failed converting" in proc.stderr:
        raise RuntimeError(f"{tree} {flag} failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="the root of a parent commit's tree")
    ap.add_argument("--flags", nargs="+", default=["--device",
                                                   "--device-native"])
    ap.add_argument("--batch-size", type=int, default=1 << 18)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("slice_ab: no CUDA card", file=sys.stderr)
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
    with tempfile.TemporaryDirectory(prefix="slice_ab_") as tmp:
        tmp = Path(tmp)
        src = tmp / "cloud.ply"
        rng = np.random.default_rng(3)  # chip_smoke.py phase 4's colors
        write_ply(src, PointBatch(
            synth_cloud(cs.CLOUD_POINTS, seed=0),
            rng.integers(0, 256, (cs.CLOUD_POINTS, 4), dtype=np.uint8)))
        for name, tree in trees.items():  # the builds, untimed
            convert(tree, args.flags[0], src, tmp / f"warm-{name}",
                    args.batch_size)
        for flag in args.flags:
            runs = {name: [] for name in trees}
            first = None
            for i, name in enumerate(["parent", "change", "change",
                                      "parent"]):
                out = tmp / f"{flag.strip('-')}-{i}"
                runs[name].append(convert(trees[name], flag, src, out,
                                          args.batch_size))
                if first is None:
                    first = out
                else:
                    cs.same_store(first, out, f"{name} {flag}")
            cs.emit({"flag": flag, "points": cs.CLOUD_POINTS,
                     "batch_size": args.batch_size,
                     "order": ["parent", "change", "change", "parent"],
                     "convert_s": {k: [r["convert_s"] for r in v]
                                   for k, v in runs.items()},
                     "launches": {k: [r["launches"] for r in v]
                                  for k, v in runs.items()},
                     "stages": {k: [r["stages"] for r in v]
                                for k, v in runs.items()},
                     "byte_identical": True, "device": smi})
    return 0


if __name__ == "__main__":
    sys.exit(main())
