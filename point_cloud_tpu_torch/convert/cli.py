"""Converter CLI of the port (counterpart of convert/cli.py).

Takes the reference's flags (its ``build_parser()``, JAX-free at import):

- ``--device-native``: the port's :class:`NativeDevicePipelined` on
  ``cuda`` — the device pass on the card, the C++ merge engine on the
  host. Without a card it fails; it never picks the CPU by itself.
- ``--native`` and the host default: the reference's JAX-free
  ``NativeConverter`` and ``Converter``.
- ``--device``, ``--mesh`` and ``--multihost`` are not ported yet and
  exit non-zero.

``--profile`` prints the per-stage summary on stderr and, as the last
line of stdout, one JSON object with the conversion's wall time, its
point count and the kernels' launch counts (in all, and by length).

    python -m point_cloud_tpu_torch.convert.cli --device-native \\
        --batch-size 262144 -o STORE -f cloud.ply
"""

from __future__ import annotations

import functools
import json
import logging
import os
import sys
import time
from pathlib import Path

from point_cloud_tpu.convert.cli import build_parser
from point_cloud_tpu.convert.converter import (
    DEFAULT_BATCH_SIZE, DEFAULT_CACHE_SIZE, Converter, convert_from_paths,
)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(levelname)s %(name)s: %(message)s",
    )
    log = logging.getLogger("point_cloud_tpu_torch.cli")

    if args.device or args.mesh is not None or args.multihost:
        flag = ("--device" if args.device else
                "--mesh" if args.mesh is not None else "--multihost")
        log.error("%s is not ported yet (ROADMAP.md); use --device-native "
                  "or --native", flag)
        return 2

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
        from point_cloud_tpu.convert.native import NativeConverter

        factory = NativeConverter
        batch_size = args.batch_size or 1 << 18
    elif args.device_native:
        from ..ops.runtime import resolve_device
        from .native_device import NativeDevicePipelined

        factory = functools.partial(
            NativeDevicePipelined, device=resolve_device("cuda")
        )
        batch_size = args.batch_size or 1 << 18

    cache_size = (
        args.cache_size if args.cache_size is not None else DEFAULT_CACHE_SIZE
    )
    if not args.profile:
        convert_from_paths(files, output, batch_size=batch_size,
                           cache_size=cache_size, converter_factory=factory)
        return 0

    from point_cloud_tpu.utils.tracing import StageTimer

    from ..ops import sort

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
        "launches": {"sort4": sort.launches},
        "launches_by_n": {"sort4": sort.launches_by_n},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
