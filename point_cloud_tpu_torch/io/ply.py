"""PLY reader (from-scratch, vectorized NumPy).

Copy of the reference's ``io/ply.py``: ``tests/test_torch_host.py``
holds its results equal to the reference's.

Capability parity with the reference's PLY path (reference:
point-converter/src/converter/ply.rs + the ``PropertyAccess`` mapping at
point-converter/src/point.rs:56-131): the ``vertex`` element supplies
points; properties ``x``/``y``/``z`` are taken from float or double;
``red|r``/``green|g``/``blue|b``/``alpha|a`` from uchar; all other
property names/types are ignored and missing channels keep the default
``[0, 0, 0, 255]``.

Documented divergences from the reference (both intentional fixes):

1. ASCII files actually produce points. The reference parses each ASCII
   line but never pushes the result into the batch (ply.rs:43-51), so ASCII
   PLY silently converts to an empty cloud. We return the points.
2. Float color channels are interpreted as normalized [0, 1] and scaled by
   255 (the universal PLY convention). The reference computes
   ``(v / 255.0) as u8`` (point.rs:76-78), which truncates essentially every
   in-range value to 0.

Supported: ascii / binary_little_endian / binary_big_endian, arbitrary
element order, scalar properties of every PLY type, and list properties on
non-vertex elements (skipped). List properties on ``vertex`` itself are
rejected (no real-world writer does that).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from ..core.point import PointBatch
from . import BatchedPointReader

_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}

_XYZ = ("x", "y", "z")
_COLOR_ALIASES = {
    "red": 0, "r": 0,
    "green": 1, "g": 1,
    "blue": 2, "b": 2,
    "alpha": 3, "a": 3,
}


@dataclass
class PlyProperty:
    name: str
    dtype: str  # numpy kind string, no byte order
    is_list: bool = False
    count_dtype: str = ""


@dataclass
class PlyElement:
    name: str
    count: int
    properties: list[PlyProperty] = field(default_factory=list)

    @property
    def has_list(self) -> bool:
        return any(p.is_list for p in self.properties)


@dataclass
class PlyHeader:
    encoding: str  # "ascii" | "binary_little_endian" | "binary_big_endian"
    elements: list[PlyElement]
    data_start: int

    def element(self, name: str) -> PlyElement | None:
        for e in self.elements:
            if e.name == name:
                return e
        return None


def parse_header(f) -> PlyHeader:
    magic = f.readline()
    if magic.strip() != b"ply":
        raise ValueError("not a PLY file")
    encoding = None
    elements: list[PlyElement] = []
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unterminated PLY header")
        tokens = line.decode("ascii", errors="replace").split()
        if not tokens or tokens[0] == "comment" or tokens[0] == "obj_info":
            continue
        if tokens[0] == "format":
            encoding = tokens[1]
        elif tokens[0] == "element":
            elements.append(PlyElement(tokens[1], int(tokens[2])))
        elif tokens[0] == "property":
            if not elements:
                raise ValueError("property before element in PLY header")
            if tokens[1] == "list":
                elements[-1].properties.append(
                    PlyProperty(tokens[4], _TYPES[tokens[3]], True, _TYPES[tokens[2]])
                )
            else:
                elements[-1].properties.append(
                    PlyProperty(tokens[2], _TYPES[tokens[1]])
                )
        elif tokens[0] == "end_header":
            break
    if encoding not in ("ascii", "binary_little_endian", "binary_big_endian"):
        raise ValueError(f"unsupported PLY format {encoding!r}")
    return PlyHeader(encoding, elements, f.tell())


def _vertex_dtype(element: PlyElement, byte_order: str) -> np.dtype:
    return np.dtype(
        [(p.name, byte_order + p.dtype) for p in element.properties]
    )


class PlyPointReader(BatchedPointReader):
    def __init__(self, path):
        self.path = Path(path)
        self._file = open(self.path, "rb")
        self.header = parse_header(self._file)
        vertex = self.header.element("vertex")
        if vertex is None:
            raise ValueError("PLY file has no 'vertex' element")
        if vertex.has_list:
            raise ValueError("list properties on 'vertex' are unsupported")
        self._vertex = vertex
        self._read = 0
        self._binary = self.header.encoding != "ascii"
        order = ">" if self.header.encoding == "binary_big_endian" else "<"
        self._dtype = _vertex_dtype(vertex, order)
        self._skip_to_vertex_data()

    # --- element stream navigation ---------------------------------------

    def _skip_to_vertex_data(self) -> None:
        """Consume elements that precede ``vertex`` in the file."""
        for element in self.header.elements:
            if element.name == "vertex":
                return
            if not self._binary:
                for _ in range(element.count):
                    self._file.readline()
            elif not element.has_list:
                itemsize = _vertex_dtype(element, "<").itemsize
                self._file.seek(element.count * itemsize, 1)
            else:
                self._skip_binary_list_element(element)

    def _skip_binary_list_element(self, element: PlyElement) -> None:
        order = ">" if self.header.encoding == "binary_big_endian" else "<"
        for _ in range(element.count):
            for prop in element.properties:
                if prop.is_list:
                    cnt_dt = np.dtype(order + prop.count_dtype)
                    cnt = int(
                        np.frombuffer(self._file.read(cnt_dt.itemsize), cnt_dt)[0]
                    )
                    self._file.seek(cnt * np.dtype(prop.dtype).itemsize, 1)
                else:
                    self._file.seek(np.dtype(prop.dtype).itemsize, 1)

    # --- batch decode ------------------------------------------------------

    def _decode(self, rec: np.ndarray) -> PointBatch:
        n = len(rec)
        positions = np.zeros((n, 3), np.float32)
        colors = np.empty((n, 4), np.uint8)
        colors[:, :3] = 0
        colors[:, 3] = 255
        for prop in self._vertex.properties:
            name = prop.name
            if name in _XYZ:
                # float|double only (point.rs:63-88); others ignored
                if prop.dtype in ("f4", "f8"):
                    positions[:, _XYZ.index(name)] = rec[name].astype(np.float32)
            elif name in _COLOR_ALIASES:
                ch = _COLOR_ALIASES[name]
                if prop.dtype == "u1":
                    colors[:, ch] = rec[name]
                elif prop.dtype == "f4":
                    # normalized [0,1] -> u8 (divergence 2 in the docstring)
                    colors[:, ch] = np.clip(
                        np.round(rec[name].astype(np.float64) * 255.0), 0, 255
                    ).astype(np.uint8)
        return PointBatch(positions, colors)

    def get_batch(self, size: int) -> PointBatch:
        n = min(size, self.remaining_points())
        if n <= 0:
            return PointBatch.empty()
        if self._binary:
            raw = self._file.read(n * self._dtype.itemsize)
            rec = np.frombuffer(raw, dtype=self._dtype)
        else:
            names = [p.name for p in self._vertex.properties]
            rows = []
            got = 0
            while got < n:
                line = self._file.readline()
                if not line:
                    break
                tokens = line.split()
                if not tokens:
                    continue
                rows.append(tokens)
                got += 1
            table = np.asarray(rows, dtype=np.float64)
            rec = {}
            for i, prop in enumerate(self._vertex.properties):
                col = table[:, i] if len(rows) else np.empty(0, np.float64)
                rec[prop.name] = col.astype(np.dtype(prop.dtype))
            rec = _DictRecord(rec, got)
        self._read += len(rec)
        return self._decode(rec)

    def total_points(self) -> int:
        return self._vertex.count

    def remaining_points(self) -> int:
        return self.total_points() - self._read

    def close(self):
        self._file.close()


class _DictRecord(dict):
    """Duck-typed stand-in for a structured array (ascii path)."""

    def __init__(self, data: dict, n: int):
        super().__init__(data)
        self._n = n

    def __len__(self) -> int:
        return self._n


def ply_header_bytes(n: int, encoding: str = "binary_little_endian",
                     color: bool = True, double_pos: bool = False) -> bytes:
    """PLY header for ``n`` vertices (the streaming half of the writer)."""
    pos_t = "double" if double_pos else "float"
    lines = [
        "ply",
        f"format {encoding} 1.0",
        f"element vertex {n}",
        f"property {pos_t} x",
        f"property {pos_t} y",
        f"property {pos_t} z",
    ]
    if color:
        lines += [
            "property uchar red",
            "property uchar green",
            "property uchar blue",
            "property uchar alpha",
        ]
    lines.append("end_header")
    return ("\n".join(lines) + "\n").encode("ascii")


def ply_record_bytes(batch: PointBatch,
                     encoding: str = "binary_little_endian",
                     color: bool = True, double_pos: bool = False) -> bytes:
    """Vertex records for one batch (the streaming half of the writer)."""
    n = len(batch)
    pos = batch.positions.astype(np.float64 if double_pos else np.float32)
    if encoding == "ascii":
        rows = []
        for i in range(n):
            row = " ".join(repr(float(v)) for v in pos[i])
            if color:
                row += " " + " ".join(str(int(v)) for v in batch.colors[i])
            rows.append(row + "\n")
        return "".join(rows).encode("ascii")
    order = ">" if encoding == "binary_big_endian" else "<"
    fields = [("x", order + ("f8" if double_pos else "f4")),
              ("y", order + ("f8" if double_pos else "f4")),
              ("z", order + ("f8" if double_pos else "f4"))]
    if color:
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1"),
                   ("alpha", "u1")]
    rec = np.empty(n, dtype=np.dtype(fields))
    rec["x"], rec["y"], rec["z"] = pos[:, 0], pos[:, 1], pos[:, 2]
    if color:
        rec["red"] = batch.colors[:, 0]
        rec["green"] = batch.colors[:, 1]
        rec["blue"] = batch.colors[:, 2]
        rec["alpha"] = batch.colors[:, 3]
    return rec.tobytes()


def write_ply(path, batch: PointBatch, encoding: str = "binary_little_endian",
              color: bool = True, double_pos: bool = False) -> None:
    """Minimal PLY writer (test fixtures + export tool): one header + one
    record block (:func:`ply_header_bytes` / :func:`ply_record_bytes` are
    the streaming halves the store exporter composes per batch)."""
    with open(path, "wb") as f:
        f.write(ply_header_bytes(len(batch), encoding, color, double_pos))
        f.write(ply_record_bytes(batch, encoding, color, double_pos))
