"""Store exporter: converted cell store -> LAS / LAZ / PLY.

The reference only goes forward (interchange files -> store) and back
into itself (the own-format reader enables re-conversion,
reference: point-converter/src/converter/own.rs:16-87); a store's points
can never leave the toolchain. This exporter closes the loop: it streams
every stored point (grid points + staged overflow, exactly what
``PointCloudPointReader`` yields) back out as an interchange file, so a
cloud converted here can feed any external LAS/PLY consumer.

Memory model: LAS and PLY stream one batch at a time (constant RAM —
the headers carry the point count from ``metadata.json`` and, for LAS,
the quantization offset from the store bounding box, so nothing needs a
second pass). LAZ streams the uncompressed records to a temp .las the
same way, then re-frames it through the LASzip encoder
(``io/laz.convert_las_to_laz``; peak RAM = the .las byte size).

CLI::

    python -m point_cloud_tpu_torch.export <store> <out.{las,laz,ply}>
        [--point-format N] [--scale S] [--batch-size N] [--ascii]

Round-trip guarantees (tests/test_export.py): PLY positions/colors are
bit-exact; LAS/LAZ positions land within scale/2 per axis (i32
quantization) and colors are exact (u8 -> u16 by byte duplication, read
back by low-byte truncation).

Copy of the reference's ``export.py``: ``tests/test_torch_tools.py``
holds its results equal to the reference's.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from .core.metadata import Metadata
from .io.own import PointCloudPointReader

log = logging.getLogger(__name__)

_FORMATS = ("las", "laz", "ply")
DEFAULT_BATCH_SIZE = 1 << 20


def _resolve_store(store) -> Path:
    """Accept a store directory or its metadata.json path."""
    store = Path(store)
    if store.is_dir():
        store = store / "metadata.json"
    if not store.is_file():
        raise FileNotFoundError(f"no store metadata at {store}")
    return store


def _stream_las(reader, metadata: Metadata, out, point_format: int,
                scale, batch_size: int, progress=None) -> int:
    from .io.las import las_header_bytes, las_record_bytes

    n = int(metadata.number_of_points)
    # any offset <= the data minimum keeps raw i32 deltas positive-ish
    # and small; the store bbox min covers every stored point (it extends
    # over all *input* points, a superset after dedup)
    offset = np.asarray(
        metadata.bounding_box.min, np.float64
    )
    out.write(las_header_bytes(
        point_format, n, scale, offset,
        bbox_min=metadata.bounding_box.min,
        bbox_max=metadata.bounding_box.max,
    ))
    written = 0
    while True:
        batch = reader.get_batch(batch_size)
        if not len(batch):
            break
        out.write(las_record_bytes(
            batch, point_format, scale, offset, gps_base=written
        ))
        written += len(batch)
        if progress:
            progress(written)
    return written


def _stream_ply(reader, metadata: Metadata, out, encoding: str,
                batch_size: int, progress=None) -> int:
    from .io.ply import ply_header_bytes, ply_record_bytes

    n = int(metadata.number_of_points)
    out.write(ply_header_bytes(n, encoding=encoding))
    written = 0
    while True:
        batch = reader.get_batch(batch_size)
        if not len(batch):
            break
        out.write(ply_record_bytes(batch, encoding=encoding))
        written += len(batch)
        if progress:
            progress(written)
    return written


def export_store(store, out_path, fmt: str | None = None,
                 point_format: int = 2, scale=(0.001, 0.001, 0.001),
                 batch_size: int = DEFAULT_BATCH_SIZE,
                 encoding: str = "binary_little_endian",
                 progress=None) -> int:
    """Export every stored point to ``out_path``; returns points written.

    ``fmt`` defaults to the output suffix (las/laz/ply). ``point_format``
    and ``scale`` apply to las/laz; ``encoding`` applies to ply. The
    header point count comes from metadata.json, so a store whose cell
    files disagree with its metadata fails loudly (run
    ``python -m point_cloud_tpu_torch.validate`` on it) rather than writing a
    silently short file.
    """
    metadata_path = _resolve_store(store)
    out_path = Path(out_path)
    if fmt is None:
        fmt = out_path.suffix.lstrip(".").lower()
    if fmt not in _FORMATS:
        raise ValueError(f"fmt must be one of {_FORMATS}, got {fmt!r}")

    metadata = Metadata.from_path(metadata_path)
    n = int(metadata.number_of_points)

    # validate EVERYTHING before the output file is opened: a bad
    # parameter must never truncate an existing file at out_path
    if fmt in ("las", "laz"):
        from .io.las import _WRITE_RECORD_LEN

        if point_format not in _WRITE_RECORD_LEN:
            raise ValueError(
                f"LAS point_format must be one of "
                f"{sorted(_WRITE_RECORD_LEN)}, got {point_format}"
            )
        sc = np.asarray(scale, np.float64)
        if sc.shape != (3,) or not np.all(np.isfinite(sc)) or np.any(
            sc <= 0.0
        ):
            raise ValueError(f"scale must be 3 finite positives, got {scale}")
        # i32 quantization range: offset = bbox min, so the largest raw
        # value is (max - min) / scale per axis
        extent = (
            np.asarray(metadata.bounding_box.max, np.float64)
            - np.asarray(metadata.bounding_box.min, np.float64)
        )
        raw_max = np.round(extent / sc)
        if np.any(raw_max >= 2**31):
            raise ValueError(
                f"scale {scale} cannot represent the store extent "
                f"{extent} in i32 coordinates — raise --scale"
            )

    reader = PointCloudPointReader(metadata_path)

    try:
        if fmt == "ply":
            with open(out_path, "wb") as f:
                written = _stream_ply(
                    reader, metadata, f, encoding, batch_size, progress
                )
        elif fmt == "las":
            with open(out_path, "wb") as f:
                written = _stream_las(
                    reader, metadata, f, point_format, scale, batch_size,
                    progress,
                )
        else:  # laz: stream the .las form, then re-frame through the codec
            from .io.laz import convert_las_to_laz

            tmp = tempfile.NamedTemporaryFile(
                suffix=".las", delete=False, dir=out_path.parent
            )
            try:
                with tmp:
                    written = _stream_las(
                        reader, metadata, tmp, point_format, scale,
                        batch_size, progress,
                    )
                if written == n and reader.exhausted():
                    convert_las_to_laz(tmp.name, out_path)
            finally:
                os.unlink(tmp.name)
    except BaseException:
        # mid-stream failure: never leave a partial artifact whose
        # header promises n points
        out_path.unlink(missing_ok=True)
        raise

    if written != n or not reader.exhausted():
        # the header already promised n points: remove the bad file
        # instead of leaving a silently short (cells < metadata) or
        # silently truncated (cells > metadata) artifact
        out_path.unlink(missing_ok=True)
        detail = (
            f"store yielded {written} points"
            if written != n
            else "store cells hold more points than the metadata total"
        )
        raise RuntimeError(
            f"{detail} but metadata.json says {n} — run "
            f"`python -m point_cloud_tpu_torch.validate {metadata_path.parent}`"
        )
    return written


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m point_cloud_tpu_torch.export",
        description="Export a converted cell store to LAS, LAZ, or PLY.",
    )
    parser.add_argument("store", help="store directory or metadata.json")
    parser.add_argument("output", help="output file (.las/.laz/.ply)")
    parser.add_argument(
        "--format", choices=_FORMATS, default=None,
        help="output format (default: from the output suffix)",
    )
    parser.add_argument(
        "--point-format", type=int, default=2,
        help="LAS point record format (0-3, 6-8; default 2 = xyz+rgb)",
    )
    parser.add_argument(
        "--scale", type=float, default=0.001,
        help="LAS coordinate quantum per axis (default 0.001)",
    )
    parser.add_argument(
        "--batch-size", type=int, default=DEFAULT_BATCH_SIZE,
        help=f"points per streamed batch (default {DEFAULT_BATCH_SIZE})",
    )
    parser.add_argument(
        "--ascii", action="store_true",
        help="write ascii PLY instead of binary little-endian",
    )
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")
    last = [time.monotonic()]

    def progress(written):
        now = time.monotonic()
        if now - last[0] >= 5.0:  # converter CLI cadence (lib.rs:44-47)
            log.info("Exported %d points", written)
            last[0] = now

    t0 = time.monotonic()
    written = export_store(
        args.store, args.output, fmt=args.format,
        point_format=args.point_format,
        scale=(args.scale,) * 3, batch_size=args.batch_size,
        encoding="ascii" if args.ascii else "binary_little_endian",
        progress=progress,
    )
    log.info(
        "Exported %d points to %s in %d ms",
        written, args.output, int((time.monotonic() - t0) * 1e3),
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
