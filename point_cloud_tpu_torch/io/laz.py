"""LAZ (laszip-compressed LAS) reader + writer.

Copy of the reference's ``io/laz.py``: ``tests/test_torch_host.py``
holds its results equal to the reference's.

Capability parity with the reference's LAZ path (reference:
point-converter/src/converter/las.rs:22-55, whose `las` crate enables the
`laz` feature): point data record formats 0-3 (LASzip 2.x pointwise
chunks) and the LAS 1.4 formats 6-10 (LASzip 3.x layered chunks), plus
trailing extra bytes. The entropy codecs live in native/pc_laszip.cpp
(FastAC arithmetic coder, IntegerCompressor; POINT10/GPSTIME11/RGB12/BYTE
v2 items and the layered POINT14/RGB14/RGBNIR14/WAVEPACKET14/BYTE14 v3
items); this module owns the container framing:

- the ``laszip encoded`` VLR (user id ``laszip encoded``, record 22204)
  carrying compressor/coder/chunk-size/item descriptors,
- the chunked point stream: an i64 chunk-table offset, then one
  independently coded chunk per ``chunk_size`` points (first point raw;
  layered chunks add per-layer byte counts + layer payloads),
- the chunk-size table (u32 version, u32 count, delta-coded sizes).

The writer exists so the test suite can round-trip .las <-> .laz without
a laszip binary in the environment; it doubles as an export tool.
"""

from __future__ import annotations

import struct
import ctypes
from pathlib import Path

import numpy as np

from ..core.point import PointBatch
from . import BatchedPointReader

LASZIP_USER_ID = b"laszip encoded\x00\x00"
LASZIP_RECORD_ID = 22204
CHUNK_SIZE_DEFAULT = 50_000

# LASzip item type codes
ITEM_BYTE = 0
ITEM_POINT10 = 6
ITEM_GPSTIME11 = 7
ITEM_RGB12 = 8
ITEM_POINT14 = 10
ITEM_RGB14 = 11
ITEM_RGBNIR14 = 12
ITEM_WAVEPACKET14 = 13
ITEM_BYTE14 = 14

_ITEM_SIZES = {ITEM_POINT10: 20, ITEM_GPSTIME11: 8, ITEM_RGB12: 6}
# items coded with the LASzip 3.x layered scheme (VLR compressor 3)
_V3_ITEMS = frozenset(
    (ITEM_POINT14, ITEM_RGB14, ITEM_RGBNIR14, ITEM_WAVEPACKET14,
     ITEM_BYTE14)
)


def items_for_point_format(point_format: int, record_length: int):
    """The LASzip item list for a LAS point record format (0-3, 6-10)."""
    if point_format in (0, 1, 2, 3):
        items = [(ITEM_POINT10, 20)]
        if point_format in (1, 3):
            items.append((ITEM_GPSTIME11, 8))
        if point_format in (2, 3):
            items.append((ITEM_RGB12, 6))
        extra_item = ITEM_BYTE
    elif point_format in (6, 7, 8, 9, 10):
        items = [(ITEM_POINT14, 30)]
        if point_format == 7:
            items.append((ITEM_RGB14, 6))
        if point_format in (8, 10):
            items.append((ITEM_RGBNIR14, 8))
        if point_format in (9, 10):
            items.append((ITEM_WAVEPACKET14, 29))
        extra_item = ITEM_BYTE14
    else:
        raise NotImplementedError(
            f"LAZ point format {point_format} not supported "
            "(formats 0-3 and 6-10)"
        )
    base = sum(size for _, size in items)
    if record_length > base:
        items.append((extra_item, record_length - base))
    elif record_length < base:
        raise ValueError(
            f"record length {record_length} below format "
            f"{point_format}'s minimum {base}"
        )
    return items


def items_are_layered(items) -> bool:
    """True when the item list uses the LASzip 3.x layered chunk scheme."""
    return any(t in _V3_ITEMS for t, *_ in items)


class LaszipVlr:
    """Parsed ``laszip encoded`` VLR payload."""

    def __init__(self, payload: bytes):
        (
            self.compressor,
            self.coder,
            self.version_major,
            self.version_minor,
            self.version_revision,
            self.options,
            self.chunk_size,
            self.n_special_evlrs,
            self.offset_special_evlrs,
            num_items,
        ) = struct.unpack_from("<HHBBHIIqqH", payload, 0)
        self.items = []
        off = 34
        for _ in range(num_items):
            t, size, version = struct.unpack_from("<HHH", payload, off)
            off += 6
            self.items.append((t, size, version))

    @staticmethod
    def build(items, chunk_size: int = CHUNK_SIZE_DEFAULT) -> bytes:
        layered = items_are_layered(items)
        head = struct.pack(
            "<HHBBHIIqqH",
            3 if layered else 2,  # compressor: layered / pointwise chunked
            0,  # coder: arithmetic
            3 if layered else 2, 4 if layered else 2, 0,  # laszip version
            0,  # options
            chunk_size,
            -1, -1,  # no special EVLRs
            len(items),
        )
        body = b"".join(
            struct.pack("<HHH", t, size, 3 if t in _V3_ITEMS else 2)
            for t, size in items
        )
        return head + body

    @property
    def layered(self) -> bool:
        return self.compressor == 3

    def validate(self):
        if self.compressor not in (2, 3):
            raise NotImplementedError(
                f"laszip compressor {self.compressor} not supported "
                "(pointwise-chunked and layered-chunked only)"
            )
        if self.coder != 0:
            raise NotImplementedError(
                f"laszip coder {self.coder} not supported"
            )
        for t, size, version in self.items:
            if self.compressor == 2:
                if t not in (ITEM_BYTE, ITEM_POINT10, ITEM_GPSTIME11,
                             ITEM_RGB12):
                    raise NotImplementedError(
                        f"laszip item type {t} not supported with "
                        "compressor 2 (point formats 0-3 + extra bytes)"
                    )
                if version != 2:
                    raise NotImplementedError(
                        f"laszip item version {version} not supported "
                        "(only v2)"
                    )
            else:
                if t not in _V3_ITEMS:
                    raise NotImplementedError(
                        f"laszip item type {t} not supported with "
                        "compressor 3 (point formats 6-10 + extra bytes)"
                    )
                if version != 3:
                    raise NotImplementedError(
                        f"laszip item version {version} not supported "
                        "with compressor 3 (only v3)"
                    )


def read_vlrs(f, header):
    """[(user_id, record_id, payload)] after the public header block."""
    f.seek(header.header_size)
    vlrs = []
    for _ in range(header.n_vlrs):
        head = f.read(54)
        if len(head) < 54:
            break
        user_id = head[2:18]
        (record_id,) = struct.unpack_from("<H", head, 18)
        (length,) = struct.unpack_from("<H", head, 20)
        vlrs.append((user_id, record_id, f.read(length)))
    return vlrs


def _native():
    from ..native import load_native

    lib = load_native()
    if lib is None:
        raise NotImplementedError(
            "LAZ support requires the native codec (no C++ toolchain "
            "found); decompress to .las first"
        )
    return lib


class LazChunkedStream:
    """Decode a LAZ point stream chunk by chunk."""

    def __init__(self, f, header, vlr: LaszipVlr):
        self._lib = _native()
        vlr.validate()
        self.header = header
        self.vlr = vlr
        self._f = f
        self.stride = sum(size for _, size, _ in vlr.items)
        if self.stride != header.point_record_length:
            raise ValueError(
                f"laszip items total {self.stride} B but the header "
                f"says {header.point_record_length} B per record"
            )
        self._types = np.array([t for t, _, _ in vlr.items], np.uint16)
        self._sizes = np.array([s for _, s, _ in vlr.items], np.uint16)

        f.seek(header.point_data_offset)
        (chunk_table_offset,) = struct.unpack("<q", f.read(8))
        self._chunks_start = header.point_data_offset + 8
        if chunk_table_offset == -1:
            # LASzip streaming-writer convention: a writer that could not
            # seek back leaves -1 here and appends the real chunk-table
            # offset as the file's last 8 bytes
            file_size = f.seek(0, 2)
            f.seek(-8, 2)
            (chunk_table_offset,) = struct.unpack("<q", f.read(8))
            if not (self._chunks_start <= chunk_table_offset
                    <= file_size - 8):
                raise ValueError(
                    "laszip chunk table offset invalid (streamed file "
                    "with a corrupt trailing offset)"
                )

        n = int(header.point_count)
        chunk_size = vlr.chunk_size or CHUNK_SIZE_DEFAULT
        self.chunk_points = [
            min(chunk_size, n - i) for i in range(0, n, chunk_size)
        ]
        n_chunks = len(self.chunk_points)

        f.seek(chunk_table_offset)
        version, n_chunks_stored = struct.unpack("<II", f.read(8))
        if version != 0:
            raise NotImplementedError(
                f"laszip chunk table version {version}"
            )
        if n_chunks_stored != n_chunks:
            raise ValueError(
                f"chunk table has {n_chunks_stored} entries, expected "
                f"{n_chunks} for {n} points at chunk size {chunk_size}"
            )
        table_bytes = f.read()
        sizes = np.zeros(n_chunks, np.uint32)
        rc = self._lib.pc_laz_decompress_chunk_table(
            table_bytes, len(table_bytes), n_chunks,
            sizes.ctypes.data_as(ctypes.c_void_p),
        )
        if rc < 0:
            raise ValueError("corrupt laszip chunk table")
        self.chunk_offsets = self._chunks_start + np.concatenate(
            [[0], np.cumsum(sizes.astype(np.int64))]
        )

    def decode_chunk(self, index: int) -> bytes:
        """Raw point records of one chunk."""
        n_pts = self.chunk_points[index]
        start = int(self.chunk_offsets[index])
        end = int(self.chunk_offsets[index + 1])
        self._f.seek(start)
        data = self._f.read(end - start)
        out = np.zeros(n_pts * self.stride, np.uint8)
        decompress = (
            self._lib.pc_laz14_decompress_chunk
            if self.vlr.layered
            else self._lib.pc_laz_decompress_chunk
        )
        rc = decompress(
            data, len(data),
            self._types.ctypes.data_as(ctypes.c_void_p),
            self._sizes.ctypes.data_as(ctypes.c_void_p),
            len(self._types), n_pts,
            out.ctypes.data_as(ctypes.c_void_p),
        )
        if rc < 0:
            raise ValueError(f"corrupt laszip chunk {index}")
        return out.tobytes()


class LazPointReader(BatchedPointReader):
    """Batched reader over a .laz file (drop-in for LasPointReader)."""

    def __init__(self, path):
        from .las import LasHeader, _record_dtype

        self.path = Path(path)
        self._file = open(self.path, "rb")
        head = self._file.read(375)
        self.header = LasHeader(head)
        vlrs = read_vlrs(self._file, self.header)
        payload = None
        for user_id, record_id, data in vlrs:
            if (user_id.rstrip(b"\x00") == LASZIP_USER_ID.rstrip(b"\x00")
                    and record_id == LASZIP_RECORD_ID):
                payload = data
        if payload is None:
            raise ValueError("compressed LAS without a laszip VLR")
        self._stream = LazChunkedStream(
            self._file, self.header, LaszipVlr(payload)
        )
        self._dtype = _record_dtype(self.header)
        self._read = 0
        self._chunk_index = 0
        # decoded-chunk queue with a consume offset: appending with += and
        # re-slicing would copy the whole accumulated buffer per batch
        self._chunks: list[bytes] = []
        self._buffered = 0
        self._consumed = 0  # bytes already taken from self._chunks[0]
        self._scale = self.header.scale
        self._offset = self.header.offset

    def get_batch(self, size: int) -> PointBatch:
        n = min(size, self.remaining_points())
        if n <= 0:
            return PointBatch.empty()
        stride = self._stream.stride
        while self._buffered < n * stride and (
            self._chunk_index < len(self._stream.chunk_points)
        ):
            chunk = self._stream.decode_chunk(self._chunk_index)
            self._chunk_index += 1
            self._chunks.append(chunk)
            self._buffered += len(chunk)
        take = min(n, self._buffered // stride)
        need = take * stride
        parts = []
        while need > 0:
            head = self._chunks[0]
            avail = len(head) - self._consumed
            if avail <= need:
                parts.append(head[self._consumed:])
                self._chunks.pop(0)
                self._consumed = 0
                need -= avail
                self._buffered -= avail
            else:
                parts.append(head[self._consumed : self._consumed + need])
                self._consumed += need
                self._buffered -= need
                need = 0
        raw = b"".join(parts)
        self._read += take
        return self._decode(raw)

    def _decode(self, raw: bytes) -> PointBatch:
        rec = np.frombuffer(raw, dtype=self._dtype)
        n = len(rec)
        raw_xyz = np.stack(
            [rec["x"], rec["y"], rec["z"]], axis=-1
        ).astype(np.float64)
        positions = (raw_xyz * self._scale + self._offset).astype(np.float32)
        colors = np.empty((n, 4), np.uint8)
        if "red" in rec.dtype.names:
            colors[:, 0] = rec["red"].astype(np.uint8)
            colors[:, 1] = rec["green"].astype(np.uint8)
            colors[:, 2] = rec["blue"].astype(np.uint8)
        else:
            colors[:, :3] = 0
        colors[:, 3] = 255
        return PointBatch(positions, colors)

    def total_points(self) -> int:
        return int(self.header.point_count)

    def remaining_points(self) -> int:
        return self.total_points() - self._read

    def close(self):
        self._file.close()


def compress_records(raw: bytes, n_points: int, items,
                     chunk_size: int = CHUNK_SIZE_DEFAULT):
    """Compress raw point records -> (chunk blobs, sizes table bytes)."""
    lib = _native()
    stride = sum(size for _, size in items)
    types = np.array([t for t, _ in items], np.uint16)
    sizes = np.array([s for _, s in items], np.uint16)
    compress = (
        lib.pc_laz14_compress_chunk if items_are_layered(items)
        else lib.pc_laz_compress_chunk
    )
    chunks = []
    for i in range(0, n_points, chunk_size):
        n = min(chunk_size, n_points - i)
        block = raw[i * stride : (i + n) * stride]
        cap = n * stride + 65536
        out = ctypes.create_string_buffer(cap)
        written = compress(
            block, n,
            types.ctypes.data_as(ctypes.c_void_p),
            sizes.ctypes.data_as(ctypes.c_void_p),
            len(types), out, cap,
        )
        if written < 0:
            raise ValueError("laszip compression failed")
        chunks.append(out.raw[:written])

    table_sizes = np.array([len(c) for c in chunks], np.uint32)
    cap = 16 * len(chunks) + 1024
    buf = ctypes.create_string_buffer(cap)
    written = lib.pc_laz_compress_chunk_table(
        table_sizes.ctypes.data_as(ctypes.c_void_p), len(chunks), buf, cap
    )
    if written < 0:
        raise ValueError("laszip chunk table compression failed")
    table = struct.pack("<II", 0, len(chunks)) + buf.raw[:written]
    return chunks, table


def write_laz(path, batch: PointBatch, point_format: int = 2,
              scale=(0.001, 0.001, 0.001),
              chunk_size: int = CHUNK_SIZE_DEFAULT) -> None:
    """Write a .laz file (any format io/las.write_las supports).

    Interoperability caveat: this codec round-trips against its own
    decoder (tests/test_laz.py) but is uncertified against external
    laszip implementations — no laszip-generated corpus is reachable in
    this environment (ROADMAP #5). Formats 6-10 use the LASzip 3.x
    layered scheme whose return-context tables here derive from the 2.x
    models; files written in those formats may not open in stock laszip
    until certified. Formats 0-3 follow the published 2.x pointwise
    scheme and carry lower risk.
    """
    from .las import write_las
    import io as _io
    import tempfile
    import os

    # reuse write_las to produce the uncompressed form, then re-frame
    tmp = tempfile.NamedTemporaryFile(suffix=".las", delete=False)
    tmp.close()
    try:
        write_las(tmp.name, batch, point_format=point_format, scale=scale)
        convert_las_to_laz(tmp.name, path, chunk_size=chunk_size)
    finally:
        os.unlink(tmp.name)


def convert_las_to_laz(las_path, laz_path,
                       chunk_size: int = CHUNK_SIZE_DEFAULT) -> None:
    """Losslessly re-frame a .las file as .laz (identical records).

    Same interoperability caveat as :func:`write_laz`: uncertified
    against external laszip readers (see ROADMAP #5).
    """
    from .las import LasHeader

    with open(las_path, "rb") as f:
        data = f.read()
    header = LasHeader(data[:375])
    if header.is_compressed:
        raise ValueError("input is already compressed")
    n = int(header.point_count)
    items = items_for_point_format(
        header.point_format, header.point_record_length
    )
    records = data[
        header.point_data_offset:
        header.point_data_offset + n * header.point_record_length
    ]
    chunks, table = compress_records(records, n, items, chunk_size)

    vlr_payload = LaszipVlr.build(items, chunk_size)
    vlr = (
        struct.pack("<H", 0)
        + LASZIP_USER_ID
        + struct.pack("<H", LASZIP_RECORD_ID)
        + struct.pack("<H", len(vlr_payload))
        + (b"laszip 3.4 (from-scratch)" if items_are_layered(items)
           else b"laszip 2.2 (from-scratch)").ljust(32, b"\x00")
        + vlr_payload
    )

    out_header = bytearray(data[: header.header_size])
    out_header[104] |= 0x80  # compressed-format marker
    struct.pack_into(
        "<I", out_header, 100, header.n_vlrs + 1
    )
    existing_vlrs = data[header.header_size : header.point_data_offset]
    point_data_offset = (
        header.header_size + len(existing_vlrs) + len(vlr)
    )
    struct.pack_into("<I", out_header, 96, point_data_offset)

    chunks_blob = b"".join(chunks)
    chunk_table_offset = point_data_offset + 8 + len(chunks_blob)
    with open(laz_path, "wb") as f:
        f.write(bytes(out_header))
        f.write(existing_vlrs)
        f.write(vlr)
        f.write(struct.pack("<q", chunk_table_offset))
        f.write(chunks_blob)
        f.write(table)


def convert_laz_to_las(laz_path, las_path) -> None:
    """Decompress a .laz file to .las (identical records)."""
    from .las import LasHeader

    with open(laz_path, "rb") as f:
        data = f.read(375)
        header = LasHeader(data)
        vlrs = read_vlrs(f, header)
        payload = None
        vlr_sizes = []
        for user_id, record_id, vdata in vlrs:
            if (user_id.rstrip(b"\x00") == LASZIP_USER_ID.rstrip(b"\x00")
                    and record_id == LASZIP_RECORD_ID):
                payload = vdata
            vlr_sizes.append(54 + len(vdata))
        if payload is None:
            raise ValueError("no laszip VLR")
        stream = LazChunkedStream(f, header, LaszipVlr(payload))
        records = b"".join(
            stream.decode_chunk(i) for i in range(len(stream.chunk_points))
        )
        f.seek(0)
        raw_head = bytearray(f.read(header.header_size))

    # drop the laszip VLR, clear the compression bit
    raw_head[104] &= 0x7F
    struct.pack_into("<I", raw_head, 100, header.n_vlrs - 1)
    out_vlrs = b""
    with open(laz_path, "rb") as f:
        f.seek(header.header_size)
        for user_id, record_id, vdata in vlrs:
            blob = f.read(54 + len(vdata))
            if not (
                user_id.rstrip(b"\x00") == LASZIP_USER_ID.rstrip(b"\x00")
                and record_id == LASZIP_RECORD_ID
            ):
                out_vlrs += blob
    struct.pack_into(
        "<I", raw_head, 96, header.header_size + len(out_vlrs)
    )
    with open(las_path, "wb") as f:
        f.write(bytes(raw_head))
        f.write(out_vlrs)
        f.write(records)
