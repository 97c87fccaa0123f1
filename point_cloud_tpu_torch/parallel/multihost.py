"""Multi-host conversion: shard files across workers, merge the stores.

Host copy of the reference's ``parallel/multihost.py`` over the port's
converters (it imports no JAX in the reference either):

1. each worker converts its file shard into a private staging store
   (``worker_file_shard`` gives the deterministic partition,
   :func:`convert_sharded` takes any of the port's converter factories),
2. stores merge with :func:`merge_stores` — a CELL-LEVEL merge: the
   stores' spatial layout is owner-exclusive per cone (the octree column
   rooted at one ``h_0`` cell: cascades are position-local, so a cone is
   closed under the overflow cascade), so cones touched by exactly one
   input copy their cell files verbatim and only OVERLAPPING cones
   re-dedup through the incremental-merge contract (reference:
   point-converter/src/lib.rs:86-101 — the same mechanism that makes
   conversion resumable),
3. the destination store obeys exactly the single-host pipeline's rules
   (hex-dedup winners, overflow accounting, codec) and holds exactly the
   union point multiset of its inputs. It is NOT generally
   byte-identical to a from-scratch single-host conversion of the
   original files: overflow groups flush when a *batch* pushes them over
   the limit, so different shard boundaries buffer different tails (the
   reference's own incremental merge has the same property,
   lib.rs:86-101).

The launch layer (``parallel/launch.py``) runs one worker per process
and meets at ``torch.distributed`` barriers; the merge step is pure host
I/O and runs anywhere.
"""

from __future__ import annotations

import logging
import re
import shutil
import struct
from pathlib import Path

from ..convert.converter import convert_from_paths

log = logging.getLogger(__name__)

_CELL_RE = re.compile(r"^c_(-?\d+)_(-?\d+)_(-?\d+)\.bin$")
# header prefix: id (u32 h + 3xi32 index) + total/number/overflow u32s
# (core/cell.py _HEADER_STRUCT, cell.rs:280-298)
_CELL_COUNTS = struct.Struct("<IiiiIII")


def worker_file_shard(paths, worker_index: int, n_workers: int) -> list:
    """Deterministic round-robin file partition (size-agnostic)."""
    if not 0 <= worker_index < n_workers:
        raise ValueError("worker_index out of range")
    ordered = sorted(Path(p) for p in paths)
    return [p for i, p in enumerate(ordered) if i % n_workers == worker_index]


def convert_sharded(paths, staging_root, worker_index: int, n_workers: int,
                    converter_factory=None, batch_size=None,
                    cache_size=None) -> Path:
    """Convert this worker's shard into ``staging_root/worker_<i>``."""
    from ..convert.converter import (
        Converter, DEFAULT_BATCH_SIZE, DEFAULT_CACHE_SIZE,
    )

    shard = worker_file_shard(paths, worker_index, n_workers)
    out = Path(staging_root) / f"worker_{worker_index}"
    convert_from_paths(
        shard,
        out,
        batch_size=batch_size or DEFAULT_BATCH_SIZE,
        cache_size=cache_size or DEFAULT_CACHE_SIZE,
        converter_factory=converter_factory or Converter,
    )
    return out


def _scan_store(store: Path):
    """-> (metadata, [(hierarchy, index, path)]) in own-reader order
    (hierarchy ascending, sorted dir entries — io/own.py)."""
    from ..core.metadata import Metadata, hierarchy_string

    metadata = Metadata.from_path(store / "metadata.json")
    cells = []
    for h in range(metadata.hierarchies):
        hier_dir = store / hierarchy_string(h)
        if not hier_dir.is_dir():
            continue
        for path in sorted(hier_dir.iterdir()):
            m = _CELL_RE.match(path.name)
            if m is None:
                continue
            cells.append((h, tuple(int(g) for g in m.groups()), path))
    return metadata, cells


def _cone_of(hierarchy: int, index) -> tuple:
    """The h_0 ancestor cell index — the merge's independence unit.

    cell_size(h) = max_cell_size / 2^h, so a cell at hierarchy h lies
    inside exactly one h_0 cell: floor(index / 2^h) per axis (``>>`` is
    a floor shift for negative Python ints). Overflow cascades are
    position-local (a point's h+1 cell is inside its h cell), so the
    cone rooted at an h_0 cell is closed under the cascade."""
    return tuple(c >> hierarchy for c in index)


def _copy_or_link(src: Path, target: Path) -> None:
    """Verbatim cone transfer: hardlink when possible, byte copy
    otherwise (cross-device, exotic filesystems).

    Linking turns the merge's disjoint-cone bulk — by far its largest
    I/O term at scale (a binary merge tree re-copies every store
    once per level: 3x the full store for 8 workers) — into metadata
    operations. Safe because every cell writer in the tree REPLACES
    files atomically (native AsyncStoreWriter tmp+rename;
    Cell.write_to_path same contract), so a later mutation of either
    store breaks the link instead of corrupting the other side."""
    import os

    if target.exists():
        target.unlink()
    try:
        os.link(src, target)
    except OSError:
        shutil.copyfile(src, target)


def _cell_total_points(path: Path) -> int:
    """Points physically stored in a cell file (grid winners + staged
    overflow) from the 48-byte header — no point payload read."""
    with open(path, "rb") as f:
        head = f.read(_CELL_COUNTS.size)
    return _CELL_COUNTS.unpack(head)[4]


def merge_stores(sources, dest, converter_factory=None,
                 batch_size=None, cache_size=None) -> None:
    """Cell-level merge of converted stores into ``dest``.

    Cones (octree columns rooted at one h_0 cell, see :func:`_cone_of`)
    present in exactly ONE input — counting an existing ``dest`` store
    as an input — copy their cell files verbatim; only overlapping
    cones re-dedup, by feeding their points (source order, own-reader
    order within a source) through the incremental-merge contract
    (reference: point-converter/src/lib.rs:86-101). The merged multiset
    and metadata equal full re-conversion's; bytes equal it only per
    copied cone (documented batch-boundary dependence, module
    docstring). A crash mid-merge can leave ``dest`` partial (no/stale
    metadata.json) — rebuild ``dest`` from the sources, exactly as with
    re-conversion."""
    from ..convert.converter import (
        Converter, DEFAULT_BATCH_SIZE, DEFAULT_CACHE_SIZE,
    )
    from ..core.cell import Cell, CellId
    from ..core.metadata import Metadata
    from ..core.point import PointBatch

    sources = [Path(s) for s in sources]
    dest = Path(dest)
    for s in sources:
        if not (s / "metadata.json").exists():
            raise FileNotFoundError(s / "metadata.json")
    scans = [_scan_store(s) for s in sources]

    # an existing dest store participates as the merge base: its cones
    # count for conflict detection, its cells stay in place
    dest_scan = None
    if (dest / "metadata.json").exists():
        dest_scan = _scan_store(dest)

    configs = [m.config for m, _ in scans]
    if dest_scan is not None:
        configs.append(dest_scan[0].config)
    for c in configs[1:]:
        if c != configs[0]:
            raise ValueError(
                "cannot merge stores with different configs: "
                f"{c} vs {configs[0]}"
            )

    cone_owners: dict[tuple, set] = {}
    for si, (_, cells) in enumerate(scans):
        for h, idx, _ in cells:
            cone_owners.setdefault(_cone_of(h, idx), set()).add(si)
    if dest_scan is not None:
        for h, idx, _ in dest_scan[1]:
            cone_owners.setdefault(_cone_of(h, idx), set()).add("dest")
    conflicted = {k for k, v in cone_owners.items() if len(v) > 1}

    # ---- copy phase: disjoint cones move as verbatim files ----------
    metadata = dest_scan[0] if dest_scan is not None else Metadata()
    if dest_scan is None and scans:
        metadata.config = scans[0][0].config
    dest.mkdir(parents=True, exist_ok=True)
    copied_cells = 0
    copied_points = 0
    for _, cells in scans:
        for h, idx, path in cells:
            if _cone_of(h, idx) in conflicted:
                continue
            target = dest / CellId(h, idx).path()
            target.parent.mkdir(parents=True, exist_ok=True)
            _copy_or_link(path, target)
            copied_cells += 1
            copied_points += _cell_total_points(path)
            if metadata.hierarchies <= h:
                metadata.hierarchies = h + 1
    had_points = metadata.number_of_points > 0  # dest base non-empty
    metadata.number_of_points += copied_points
    if metadata.number_of_points > 0:
        # final bbox preset: the f32 min/max fold is order-independent,
        # so the union of the inputs' stored bboxes equals the fold over
        # every merged point — including the conflicted points the
        # converter adds below (their extends are no-ops afterwards)
        boxes = [m.bounding_box for m, _ in scans
                 if m.number_of_points > 0]
        if had_points:
            boxes.insert(0, metadata.bounding_box)
        if boxes:
            union = boxes[0].copy()
            for b in boxes[1:]:
                union.extend_aabb(b)
            metadata.bounding_box = union

    # ---- merge phase: only overlapping cones re-dedup ---------------
    n_fed = 0
    batch_size = batch_size or DEFAULT_BATCH_SIZE
    factory = converter_factory or Converter
    with factory(
        metadata, dest, cache_size=cache_size or DEFAULT_CACHE_SIZE
    ) as conv:
        pending: list[PointBatch] = []
        pending_n = 0

        def flush(final: bool = False) -> None:
            nonlocal pending, pending_n, n_fed
            merged = PointBatch.concat(pending)
            take = (
                len(merged) if final
                else (len(merged) // batch_size) * batch_size
            )
            for i in range(0, take, batch_size):
                conv.add_points_batch(merged[i : i + batch_size])
            n_fed += take
            rest = merged[take:]
            pending = [rest] if len(rest) else []
            pending_n = len(rest)

        for _, cells in scans:
            for h, idx, path in cells:
                if _cone_of(h, idx) not in conflicted:
                    continue
                points = Cell.from_path(path).all_points()
                if not len(points):
                    continue
                pending.append(points)
                pending_n += len(points)
                if pending_n >= batch_size:
                    flush()
            # remainder flushes at each source boundary, like the
            # reference's per-file batch loop (lib.rs:31-52)
            flush(final=True)
    log.info(
        "merge_stores: %d cells copied verbatim (%d pts), %d pts "
        "re-dedupped through %d conflicted cones",
        copied_cells, copied_points, n_fed, len(conflicted),
    )
