"""Converter CLI of the port (counterpart of convert/cli.py).

Takes the reference's flags (:func:`build_parser`, a copy of the
reference's):

- ``--device``: the port's :class:`PipelinedConverter` on ``cuda`` — the
  device pass on the card, the per-cell LSM merge in NumPy on the host.
- ``--device-native``: the port's :class:`NativeDevicePipelined` on
  ``cuda`` — the device pass on the card, the C++ merge engine on the
  host.
- ``--native`` and the host default: the port's copies of the
  reference's ``NativeConverter`` and ``Converter``.
- ``--mesh N``: the port's :class:`MeshConverter` over a mesh of N of the
  card's devices (0 = every one): the owner-sharded pass on the mesh,
  the per-cell LSM merge in NumPy on the host.
- ``--multihost``: this process is one worker of a multi-host conversion
  (``parallel/launch.py``: identity from ``PCT_*``, gloo barriers, rank 0
  merges), converting with whichever backend the other flags pick.

``--device``, ``--device-native`` and ``--mesh`` fail without a card;
they never pick the CPU by themselves.

``--profile`` prints the per-stage summary on stderr and, as the last
line of stdout, one JSON object with the conversion's wall time, its
point count, the kernels' launch counts (in all, and by length) and the
per-stage times.

    python -m point_cloud_tpu_torch.convert.cli --device \\
        --batch-size 262144 -o STORE -f cloud.ply
"""

from __future__ import annotations

import argparse
import functools
import json
import logging
import os
import sys
import time
from pathlib import Path

from .converter import (
    DEFAULT_BATCH_SIZE, DEFAULT_CACHE_SIZE, Converter, convert_from_paths,
)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="point-converter",
        description=(
            "Point converter will convert your points to a format that the "
            "point cloud renderer can use. Currently supported file formats "
            "are las/laz and ply and the generated metadata.json."
        ),
    )
    parser.add_argument(
        "-o", "--output", metavar="DIR", type=Path, default=None,
        help="Output directory of the converted format. "
             "Will be created if it doesn't exist.",
    )
    parser.add_argument(
        "-d", "--directories", metavar="DIRS", type=Path, nargs="*",
        default=[], help="Directories with input files to convert.",
    )
    parser.add_argument(
        "-f", "--files", metavar="FILES", type=Path, nargs="*",
        default=[], help="Input files with the points to convert.",
    )
    def positive_int(text: str) -> int:
        value = int(text)
        if value < 1:
            raise argparse.ArgumentTypeError("must be >= 1")
        return value

    parser.add_argument(
        "--batch-size", type=positive_int, default=None,
        help="Points per conversion batch (defaults: 10000 host — the "
        "reference's lib.rs:32 — 2^18 device/native, 2^20 mesh). Store "
        "BYTES depend on the batch schedule (overflow groups stage "
        "per-batch canonical chunks, like the reference's arrival-order "
        "dependence), so pin the same --batch-size when byte-comparing "
        "stores across backends; every backend is byte-identical at "
        "equal batch size (tests/test_converter.py backend matrix).",
    )
    parser.add_argument(
        "--device", action="store_true",
        help="Run the dedup pipeline on the CUDA card (the port's "
             "PipelinedConverter).",
    )
    parser.add_argument(
        "--mesh", type=int, default=None, metavar="N",
        help="Shard conversion over an N-device mesh (0 = all devices).",
    )
    parser.add_argument(
        "--native", action="store_true",
        help="Run the whole cascade in the C++ engine (host-only, fastest "
             "when the accelerator link is thin; keeps all cells in RAM).",
    )
    parser.add_argument(
        "--device-native", action="store_true",
        help="Device dedup pass + C++ merge engine: the card's pipeline "
             "with the per-level host half running natively (see "
             "convert/native_device.py).",
    )
    parser.add_argument(
        "--cache-size", type=positive_int, default=None, metavar="N",
        help="Cells kept in RAM before evicting to disk (default 65536; "
             "the reference keeps 100, converter.rs:92 — results are "
             "identical at any size, only disk traffic changes).",
    )
    parser.add_argument(
        "--multihost", action="store_true",
        help="Multi-host launch: this process is one worker (identity "
             "from PCT_NUM_PROCESSES, PCT_PROCESS_ID and "
             "PCT_COORDINATOR_ADDRESS; none set = one worker).",
    )
    parser.add_argument(
        "--profile", action="store_true",
        help="Print a per-stage timing summary after conversion (stderr) "
             "and one JSON line of totals, launches and stages (stdout).",
    )
    parser.add_argument("-v", "--verbose", action="store_true")
    return parser


def kernel_launches() -> dict:
    """The conversion kernels' launch counts in this process (the
    ``--profile`` JSON's ``launches``)."""
    from ..ops import mark_pack, quantize_hash, sort

    return {"sort4": sort.launches, "quantize_sort4": quantize_hash.launches,
            "mark_pack": mark_pack.launches}


def launches_by_n() -> dict:
    """The sorts' launch counts by length in this process (the
    ``--profile`` JSON's ``launches_by_n``): ``sort4``'s, the fused front
    end's and, among those, its gather mode's."""
    from ..ops import quantize_hash, sort

    return {"sort4": sort.launches_by_n,
            "quantize_sort4": quantize_hash.launches_by_n,
            "quantize_sort4_gather": quantize_hash.gather_launches_by_n}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(levelname)s %(name)s: %(message)s",
    )
    log = logging.getLogger("point_cloud_tpu_torch.cli")

    files = list(args.files)
    for directory in args.directories:
        try:
            files.extend(sorted(directory.iterdir()))
        except OSError as err:
            log.error("Failed to read directory %s: %s", directory, err)
            return 1
    if not files:
        log.warning("Please provide some files or directories")
        return 0
    output = args.output if args.output is not None else Path(os.getcwd())

    factory = Converter
    batch_size = args.batch_size or DEFAULT_BATCH_SIZE
    if args.native:
        from .native import NativeConverter

        factory = NativeConverter
        batch_size = args.batch_size or 1 << 18
    elif args.device_native:
        from ..ops.runtime import resolve_device
        from .native_device import NativeDevicePipelined

        factory = functools.partial(NativeDevicePipelined,
                                    device=resolve_device("cuda"))
        batch_size = args.batch_size or 1 << 18
    elif args.mesh is not None:
        from ..ops.runtime import resolve_device
        from ..parallel.mesh_converter import make_mesh_converter_factory

        resolve_device("cuda")  # no card: raise before any store I/O
        factory = make_mesh_converter_factory(args.mesh,
                                              local=args.multihost)
        batch_size = args.batch_size or 1 << 20
    elif args.device:
        from ..ops.runtime import resolve_device
        from .pipelined import PipelinedConverter

        factory = functools.partial(PipelinedConverter,
                                    device=resolve_device("cuda"))
        batch_size = args.batch_size or 1 << 18

    cache_size = (
        args.cache_size if args.cache_size is not None else DEFAULT_CACHE_SIZE
    )
    if args.multihost:
        from ..parallel.launch import LaunchConfig, run_multihost

        config = LaunchConfig.from_env()
        log.info(
            "multihost launch: process %d of %d (coordinator %s)",
            config.process_id, config.num_processes,
            config.coordinator_address or "<env>",
        )
        t0 = time.perf_counter()
        run_multihost(files, output, config=config,
                      converter_factory=factory, batch_size=batch_size,
                      cache_size=cache_size)
        if args.profile:
            print(json.dumps({
                "multihost_s": time.perf_counter() - t0,
                "process_id": config.process_id,
                "num_processes": config.num_processes,
                "launches": kernel_launches(),
                "launches_by_n": launches_by_n(),
            }))
        return 0
    if not args.profile:
        convert_from_paths(files, output, batch_size=batch_size,
                           cache_size=cache_size, converter_factory=factory)
        return 0

    from ..utils.tracing import StageTimer

    with StageTimer() as timer:
        t0 = time.perf_counter()
        metadata = convert_from_paths(
            files, output, batch_size=batch_size, cache_size=cache_size,
            converter_factory=factory,
        )
        seconds = time.perf_counter() - t0
    print(timer.summary(points=metadata.number_of_points), file=sys.stderr)
    print(json.dumps({
        "convert_s": seconds,
        "points": metadata.number_of_points,
        "launches": kernel_launches(),
        "launches_by_n": launches_by_n(),
        "stages": timer.report(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
