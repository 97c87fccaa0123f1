"""Store integrity validator:
``python -m point_cloud_tpu_torch.validate <store>``.

Walks a converted store (metadata.json + h_<n>/c_<x>_<y>_<z>.bin —
format per docs/FORMAT.md, reference cell.rs:155-229 / metadata.rs:51-57)
and verifies every structural invariant the converters maintain:

per cell file
  - the filename matches the header's (hierarchy, index),
  - the header grid scalars are the derived ones: size == cell_size(h),
    sub_cell_size == size / sub_grid_dimension, pos == cell_pos(index)
    (bitwise f32 — the same IEEE lockstep the converters guarantee),
  - counters reconcile: total == points + overflow, and each matches the
    actual record counts,
  - every stored point quantizes back into this cell
    (cell_index(pos, size) == index), at one point per hex slot,
  - every overflow point belongs to this cell AND to its group's
    next-hierarchy key (cell_index(pos, size/2) == group key),
  - all points are inside the metadata bounding box (winners and staged
    losers are subsets of the input, so containment is exact).

store level
  - sum of cell ``total`` counters == metadata.number_of_points (every
    input point lives in exactly one slot or one overflow buffer),
  - every hierarchy directory is within metadata.hierarchies,
  - no unparseable or orphan cell files.

The reference ships no equivalent; for production stores this is the
fsck. Exit code 0 = clean, 1 = issues found, 2 = unreadable store.

Copy of the reference's ``validate.py``: ``tests/test_torch_tools.py``
holds its results equal to the reference's.
"""

from __future__ import annotations

import re
import sys
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from .core.cell import Cell
from .core.hex import offset_from_world
from .core.metadata import FILE_NAME, EXTENSION, Metadata

_CELL_RE = re.compile(r"^c_(-?\d+)_(-?\d+)_(-?\d+)\.bin$")
_DIR_RE = re.compile(r"^h_(\d+)$")


@dataclass
class StoreReport:
    cells: int = 0
    points: int = 0            # grid (deduped) points
    overflow_points: int = 0   # staged losers
    hierarchies: set = field(default_factory=set)
    issues: list = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.issues

    def issue(self, where: str, what: str) -> None:
        self.issues.append(f"{where}: {what}")


def _check_cell(cell: Cell, h: int, idx, metadata: Metadata,
                report: StoreReport, where: str) -> None:
    config = metadata.config
    if cell.id.hierarchy != h or tuple(cell.id.index) != idx:
        report.issue(where, f"header id {cell.id.hierarchy}/"
                            f"{tuple(cell.id.index)} != filename {h}/{idx}")
        return

    # grid scalars must be the derived values, bitwise
    size = config.cell_size(h)
    sub = config.sub_cell_size(size)
    pos = config.cell_pos(np.asarray([idx], np.int32), size)[0]
    for name, got, want in (("size", cell.size, size),
                            ("sub_cell_size", cell.sub_cell_size, sub)):
        if np.float32(got).tobytes() != np.float32(want).tobytes():
            report.issue(where, f"header {name} {got!r} != derived {want!r}")
    if np.asarray(cell.pos, np.float32).tobytes() != pos.tobytes():
        report.issue(where, f"header pos {cell.pos} != derived {pos}")

    points = cell.points
    n_overflow = sum(
        len(buf) for buf in cell.overflow.values() if buf is not None
    )
    if cell.number_of_points != len(points):
        report.issue(where, f"points counter {cell.number_of_points} != "
                            f"{len(points)} stored")
    if cell.number_of_overflow_points != n_overflow:
        report.issue(
            where, f"overflow counter {cell.number_of_overflow_points} != "
                   f"{n_overflow} stored")
    if cell.total_number_of_points != (
        cell.number_of_points + cell.number_of_overflow_points
    ):
        report.issue(where, "total != points + overflow")

    bbox = metadata.bounding_box
    idx_arr = np.asarray(idx, np.int32)

    def check_points(batch, label, expect_next=None):
        if len(batch) == 0:
            return
        got_idx = config.cell_index(batch.positions, size)
        if not np.array_equal(got_idx, np.broadcast_to(
                idx_arr, got_idx.shape)):
            bad = int(np.any(got_idx != idx_arr, axis=1).sum())
            report.issue(where, f"{bad} {label} point(s) quantize outside "
                                "this cell")
        if expect_next is not None:
            next_idx = config.cell_index(
                batch.positions, size / np.float32(2.0)
            )
            want = np.asarray(expect_next, np.int32)
            if not np.array_equal(
                next_idx, np.broadcast_to(want, next_idx.shape)
            ):
                bad = int(np.any(next_idx != want, axis=1).sum())
                report.issue(where, f"{bad} point(s) in overflow group "
                                    f"{expect_next} key mismatch")
        lo = np.minimum.reduce(batch.positions)
        hi = np.maximum.reduce(batch.positions)
        if np.any(lo < bbox.min) or np.any(hi > bbox.max):
            report.issue(where, f"{label} points outside the metadata "
                                "bounding box")

    check_points(points, "grid")
    radius = np.float32(sub) / np.float32(2.0)
    if len(points):
        slots = offset_from_world(points.positions, radius)
        if len(np.unique(slots, axis=0)) != len(slots):
            report.issue(where, "duplicate hex slot among grid points")
    for key, buf in cell.overflow.items():
        if buf is not None and len(buf):
            check_points(buf.to_batch(), f"overflow{key}", expect_next=key)

    report.cells += 1
    report.points += len(points)
    report.overflow_points += n_overflow
    report.hierarchies.add(h)


def validate_store(store) -> StoreReport:
    """Validate every invariant of the store at ``store``; see module
    docstring. Raises FileNotFoundError when there is no metadata.json."""
    store = Path(store)
    metadata = Metadata.from_path(store / f"{FILE_NAME}.{EXTENSION}")
    report = StoreReport()

    for entry in sorted(store.iterdir()):
        if not entry.is_dir():
            continue
        m = _DIR_RE.match(entry.name)
        if m is None:
            continue  # unrelated directory: not part of the store format
        h = int(m.group(1))
        if h >= metadata.hierarchies:
            report.issue(entry.name, f"hierarchy dir beyond metadata count "
                                     f"{metadata.hierarchies}")
        for cell_path in sorted(entry.iterdir()):
            cm = _CELL_RE.match(cell_path.name)
            where = f"{entry.name}/{cell_path.name}"
            if cm is None:
                report.issue(where, "unexpected file in hierarchy dir")
                continue
            idx = tuple(int(cm.group(i)) for i in (1, 2, 3))
            try:
                cell = Cell.from_path(cell_path)
            except Exception as err:
                report.issue(where, f"unparseable cell file ({err})")
                continue
            _check_cell(cell, h, idx, metadata, report, where)

    total = report.points + report.overflow_points
    if total != metadata.number_of_points:
        report.issue(
            "metadata.json",
            f"number_of_points {metadata.number_of_points} != "
            f"{total} across cells ({report.points} grid + "
            f"{report.overflow_points} overflow)")
    return report


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m point_cloud_tpu_torch.validate",
        description="Verify a converted store's structural invariants "
                    "(see module docstring).",
    )
    parser.add_argument("store", help="store directory (holds metadata.json)")
    args = parser.parse_args(argv)
    try:
        report = validate_store(args.store)
    except FileNotFoundError as err:
        print(f"unreadable store: {err}", file=sys.stderr)
        return 2
    print(f"{report.cells} cells, {report.points:,} points + "
          f"{report.overflow_points:,} staged across "
          f"{len(report.hierarchies)} hierarchies")
    if report.ok:
        print("store OK")
        return 0
    for issue in report.issues[:50]:
        print(f"ISSUE {issue}", file=sys.stderr)
    if len(report.issues) > 50:
        print(f"... and {len(report.issues) - 50} more", file=sys.stderr)
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
