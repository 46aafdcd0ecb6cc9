"""Parquet writer of the PyTorch port: columnar export for the file catalog.

Counterpart of ``presto_tpu/formats/parquet_writer.py``, ported as it is,
so the same pages give a byte-identical uncompressed file (GZIP writes the
time into its header, so two gzip files differ there and decode equal):

- a thrift compact-protocol writer for FileMetaData / PageHeader;
- PLAIN values for numerics and booleans, a dictionary page and
  RLE_DICTIONARY indices for varchar;
- RLE/bit-packed definition levels for nullable columns;
- data page v1, codecs UNCOMPRESSED / GZIP / ZSTD (``zstandard``, imported
  only when that codec is asked for);
- column-chunk statistics (min_value/max_value/null_count), which the file
  connector's row-group pruning reads.

``write_parquet`` takes the port's host pages (CPU tensors) through
``formats/pcol.compact_pages``. Types map as the reader maps them back:
BIGINT->INT64, INTEGER/SMALLINT->INT32, DOUBLE->DOUBLE, REAL->FLOAT,
BOOLEAN->BOOLEAN, DATE->INT32(DATE), DECIMAL(p<=18,s)->INT64(DECIMAL),
VARCHAR->BYTE_ARRAY(UTF8).
"""
from __future__ import annotations

import gzip
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..block import Dictionary, Page
from ..types import (DecimalType, Type, is_string)
from .parquet import (C_GZIP, C_UNCOMPRESSED, C_ZSTD, CT_DATE, CT_DECIMAL,
                      CT_INT_16, CT_TIMESTAMP_MILLIS, CT_UTF8, E_PLAIN, E_RLE,
                      E_RLE_DICTIONARY, MAGIC, PT_DATA, PT_DICTIONARY,
                      T_BOOLEAN, T_BYTE_ARRAY, T_DOUBLE, T_FLOAT, T_INT32,
                      T_INT64)

# thrift compact-protocol wire types
_CT_BOOL_TRUE, _CT_BOOL_FALSE, _CT_BYTE = 1, 2, 3
_CT_I16, _CT_I32, _CT_I64, _CT_DOUBLE = 4, 5, 6, 7
_CT_BINARY, _CT_LIST, _CT_STRUCT = 8, 9, 12

_PAGE_ROWS = 1 << 16          # values per data page
_ROW_GROUP_ROWS = 1 << 20     # rows per row group


class _TWriter:
    """Minimal thrift compact-protocol writer (the mirror of _TReader)."""

    __slots__ = ("out", "_last")

    def __init__(self):
        self.out = bytearray()
        self._last = [0]  # per-struct last-field-id stack; root struct open

    def varint(self, v: int) -> None:
        while True:
            b = v & 0x7F
            v >>= 7
            if v:
                self.out.append(b | 0x80)
            else:
                self.out.append(b)
                return

    def zigzag(self, v: int) -> None:
        self.varint((v << 1) ^ (v >> 63))

    def _field_header(self, fid: int, ctype: int) -> None:
        delta = fid - self._last[-1]
        if 0 < delta < 16:
            self.out.append((delta << 4) | ctype)
        else:
            self.out.append(ctype)
            self.zigzag(fid)
        self._last[-1] = fid

    def field_i32(self, fid: int, v: int) -> None:
        self._field_header(fid, _CT_I32)
        self.zigzag(v)

    def field_i64(self, fid: int, v: int) -> None:
        self._field_header(fid, _CT_I64)
        self.zigzag(v)

    def field_bool(self, fid: int, v: bool) -> None:
        self._field_header(fid, _CT_BOOL_TRUE if v else _CT_BOOL_FALSE)

    def field_binary(self, fid: int, data: bytes) -> None:
        self._field_header(fid, _CT_BINARY)
        self.varint(len(data))
        self.out += data

    def field_struct(self, fid: int) -> None:
        """Open a struct field; caller writes fields then struct_end()."""
        self._field_header(fid, _CT_STRUCT)
        self._last.append(0)

    def struct_end(self) -> None:
        self.out.append(0)
        self._last.pop()

    def field_list(self, fid: int, etype: int, size: int) -> None:
        self._field_header(fid, _CT_LIST)
        if size < 15:
            self.out.append((size << 4) | etype)
        else:
            self.out.append(0xF0 | etype)
            self.varint(size)

    def list_struct_begin(self) -> None:
        """Element of a list<struct>: structs carry their own id stack."""
        self._last.append(0)

    def bytes(self) -> bytes:
        return bytes(self.out)


# ---------------------------------------------------------------------------
# encoders
# ---------------------------------------------------------------------------

def _encode_varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def encode_rle_bitpacked(vals: np.ndarray, bit_width: int,
                         length_prefixed: bool) -> bytes:
    """RLE/bit-packed hybrid. Constant inputs get one RLE run; everything
    else one bit-packed run (groups of 8 values, LSB-first bit order) —
    both spec-legal, and the reader's _decode_rle_bitpacked round-trips
    either."""
    n = len(vals)
    if bit_width == 0 or n == 0:
        body = b""
    elif (vals == vals[0]).all():
        byte_width = (bit_width + 7) // 8
        body = (_encode_varint(n << 1)
                + int(vals[0]).to_bytes(byte_width, "little"))
    else:
        n_groups = (n + 7) // 8
        padded = np.zeros(n_groups * 8, dtype=np.int64)
        padded[:n] = vals
        bits = ((padded[:, None] >> np.arange(bit_width)) & 1).astype(np.uint8)
        body = (_encode_varint((n_groups << 1) | 1)
                + np.packbits(bits.reshape(-1), bitorder="little").tobytes())
    if length_prefixed:
        return struct.pack("<I", len(body)) + body
    return body


def _plain_encode(ptype: int, vals: np.ndarray) -> bytes:
    if ptype == T_INT32:
        return np.ascontiguousarray(vals.astype("<i4")).tobytes()
    if ptype == T_INT64:
        return np.ascontiguousarray(vals.astype("<i8")).tobytes()
    if ptype == T_FLOAT:
        return np.ascontiguousarray(vals.astype("<f4")).tobytes()
    if ptype == T_DOUBLE:
        return np.ascontiguousarray(vals.astype("<f8")).tobytes()
    if ptype == T_BOOLEAN:
        return np.packbits(vals.astype(bool), bitorder="little").tobytes()
    if ptype == T_BYTE_ARRAY:
        parts = []
        for v in vals:
            b = str(v).encode("utf-8")
            parts.append(struct.pack("<I", len(b)))
            parts.append(b)
        return b"".join(parts)
    raise NotImplementedError(f"parquet physical type {ptype}")


def _codec_id(codec: str) -> int:
    return {"uncompressed": C_UNCOMPRESSED, "none": C_UNCOMPRESSED,
            "gzip": C_GZIP, "zstd": C_ZSTD}[codec]


def _compress(codec_id: int, raw: bytes) -> bytes:
    if codec_id == C_GZIP:
        return gzip.compress(raw, 6)
    if codec_id == C_ZSTD:
        import zstandard

        return zstandard.ZstdCompressor().compress(raw)
    return raw


def _stat_bytes(ptype: int, v) -> bytes:
    if ptype == T_INT32:
        return struct.pack("<i", int(v))
    if ptype == T_INT64:
        return struct.pack("<q", int(v))
    if ptype == T_FLOAT:
        return struct.pack("<f", float(v))
    if ptype == T_DOUBLE:
        return struct.pack("<d", float(v))
    if ptype == T_BYTE_ARRAY:
        return str(v).encode("utf-8")
    if ptype == T_BOOLEAN:
        return b"\x01" if v else b"\x00"
    raise NotImplementedError(f"stats for parquet type {ptype}")


# ---------------------------------------------------------------------------
# schema mapping
# ---------------------------------------------------------------------------

def _physical(t: Type) -> Tuple[int, Optional[int], int, int]:
    """engine type -> (ptype, converted_type, scale, precision)."""
    if isinstance(t, DecimalType):
        if t.precision > 18:
            raise NotImplementedError(
                f"decimal({t.precision},{t.scale}) wider than 64 bits")
        return T_INT64, CT_DECIMAL, t.scale, t.precision
    if is_string(t):
        return T_BYTE_ARRAY, CT_UTF8, 0, 0
    name = t.name
    if name == "bigint":
        return T_INT64, None, 0, 0
    if name == "timestamp":  # engine timestamps are millis since epoch
        return T_INT64, CT_TIMESTAMP_MILLIS, 0, 0
    if name == "integer":
        return T_INT32, None, 0, 0
    if name == "smallint":
        return T_INT32, CT_INT_16, 0, 0
    if name == "double":
        return T_DOUBLE, None, 0, 0
    if name == "real":
        return T_FLOAT, None, 0, 0
    if name == "boolean":
        return T_BOOLEAN, None, 0, 0
    if name == "date":
        return T_INT32, CT_DATE, 0, 0
    raise NotImplementedError(f"cannot write type {t} to parquet")


def _write_page_header(page_type: int, uncomp: int, comp: int,
                       num_values: int, encoding: int) -> bytes:
    w = _TWriter()
    w.field_i32(1, page_type)
    w.field_i32(2, uncomp)
    w.field_i32(3, comp)
    if page_type == PT_DICTIONARY:
        w.field_struct(7)
        w.field_i32(1, num_values)
        w.field_i32(2, encoding)
        w.struct_end()
    else:
        w.field_struct(5)
        w.field_i32(1, num_values)
        w.field_i32(2, encoding)
        w.field_i32(3, E_RLE)   # definition_level_encoding
        w.field_i32(4, E_RLE)   # repetition_level_encoding
        w.struct_end()
    w.struct_end()  # PageHeader root
    return w.bytes()


class _ChunkResult:
    __slots__ = ("buf", "data_page_offset", "dict_page_offset", "encodings",
                 "num_values", "uncompressed", "min_v", "max_v", "null_count")

    def __init__(self):
        self.buf = bytearray()
        self.data_page_offset = 0
        self.dict_page_offset: Optional[int] = None
        self.encodings: List[int] = []
        self.num_values = 0
        self.uncompressed = 0
        self.min_v = None
        self.max_v = None
        self.null_count = 0


def _write_chunk(ptype: int, codec_id: int, values: np.ndarray,
                 nulls: Optional[np.ndarray], optional: bool,
                 dictionary: Optional[Dictionary]) -> _ChunkResult:
    """Encode one column of one row group into pages. `values` holds dict
    CODES when `dictionary` is given; null slots' values are ignored.

    `optional` is the WHOLE-COLUMN nullability: the schema declares one
    repetition per column, so every row group must carry def levels whenever
    any group has a null — a null-free group still writes (constant) levels."""
    res = _ChunkResult()
    res.num_values = len(values)
    if nulls is None and optional:
        nulls = np.zeros(len(values), dtype=bool)

    if dictionary is not None:
        dict_vals = [str(v) for v in dictionary.values]
        raw = _plain_encode(T_BYTE_ARRAY, np.asarray(dict_vals, dtype=object))
        comp = _compress(codec_id, raw)
        res.dict_page_offset = 0
        header = _write_page_header(PT_DICTIONARY, len(raw), len(comp),
                                    len(dict_vals), E_PLAIN)
        res.buf += header + comp
        res.uncompressed += len(header) + len(raw)
        bit_width = max(1, int(max(len(dict_vals) - 1, 1)).bit_length())
        value_encoding = E_RLE_DICTIONARY
        res.encodings = [E_RLE_DICTIONARY, E_PLAIN, E_RLE]
    else:
        bit_width = 0
        value_encoding = E_PLAIN
        res.encodings = [E_PLAIN, E_RLE]

    res.data_page_offset = len(res.buf)
    present_all = None if nulls is None else ~np.asarray(nulls)

    for lo in range(0, len(values), _PAGE_ROWS):
        hi = min(lo + _PAGE_ROWS, len(values))
        page_vals = values[lo:hi]
        parts = []
        if optional:
            defs = present_all[lo:hi].astype(np.int64)
            parts.append(encode_rle_bitpacked(defs, 1, length_prefixed=True))
            present = page_vals[present_all[lo:hi]]
            res.null_count += int(hi - lo - len(present))
        else:
            present = page_vals
        if dictionary is not None:
            codes = np.clip(present.astype(np.int64), 0, None)
            parts.append(bytes([bit_width])
                         + encode_rle_bitpacked(codes, bit_width,
                                                length_prefixed=False))
            if len(codes):
                pmn, pmx = dict_min_max(dictionary, codes)
                res.min_v = pmn if res.min_v is None else min(res.min_v, pmn)
                res.max_v = pmx if res.max_v is None else max(res.max_v, pmx)
        else:
            parts.append(_plain_encode(ptype, present))
            if len(present):
                pmn, pmx = present.min(), present.max()
                res.min_v = pmn if res.min_v is None else min(res.min_v, pmn)
                res.max_v = pmx if res.max_v is None else max(res.max_v, pmx)
        raw = b"".join(parts)
        comp = _compress(codec_id, raw)
        header = _write_page_header(PT_DATA, len(raw), len(comp),
                                    hi - lo, value_encoding)
        res.buf += header + comp
        res.uncompressed += len(header) + len(raw)
    return res


def dict_min_max(dictionary: Dictionary, codes: np.ndarray):
    vals = dictionary.values[np.unique(codes)]
    s = sorted(str(v) for v in vals)
    return s[0], s[-1]


# ---------------------------------------------------------------------------
# file-level writer
# ---------------------------------------------------------------------------

def write_parquet(path: str, names: Sequence[str], types: Sequence[Type],
                  dicts: Sequence[Optional[Dictionary]],
                  pages: Sequence[Page], codec: str = "uncompressed",
                  row_group_rows: int = _ROW_GROUP_ROWS) -> int:
    """Write pages (live rows compacted) as one parquet file; returns rows.
    Mirrors write_pcol's contract so the file connector's sink can target
    either format."""
    codec_id = _codec_id(codec)
    ncols = len(names)
    from .pcol import compact_pages
    total, cols = compact_pages(names, types, pages)
    for c in range(ncols):
        if dicts[c] is not None and not hasattr(dicts[c], "values"):
            raise ValueError(
                f"column {names[c]}: virtual dictionaries cannot be "
                "persisted; decode before writing")

    phys = [_physical(t) for t in types]

    with open(path, "wb") as f:
        f.write(MAGIC)
        row_groups = []  # (num_rows, [(chunk_meta...)])
        for lo in range(0, total, row_group_rows):
            hi = min(lo + row_group_rows, total)
            chunk_metas = []
            for c in range(ncols):
                ptype, _ct, _s, _p = phys[c]
                data, nulls = cols[c]
                chunk = _write_chunk(
                    ptype, codec_id, data[lo:hi],
                    None if nulls is None else nulls[lo:hi],
                    nulls is not None, dicts[c])
                start = f.tell()
                f.write(chunk.buf)
                chunk_metas.append((c, start, chunk))
            row_groups.append((hi - lo, chunk_metas))

        meta = _TWriter()
        meta.field_i32(1, 1)                        # version
        meta.field_list(2, _CT_STRUCT, ncols + 1)   # schema
        meta.list_struct_begin()                    # root element
        meta.field_binary(4, b"schema")
        meta.field_i32(5, ncols)
        meta.struct_end()
        for c in range(ncols):
            ptype, ct, scale, precision = phys[c]
            _data, nulls = cols[c]
            meta.list_struct_begin()
            meta.field_i32(1, ptype)
            meta.field_i32(3, 1 if nulls is not None else 0)  # repetition
            meta.field_binary(4, names[c].encode("utf-8"))
            if ct is not None:
                meta.field_i32(6, ct)
                if ct == CT_DECIMAL:
                    meta.field_i32(7, scale)
                    meta.field_i32(8, precision)
            meta.struct_end()
        meta.field_i64(3, total)                    # num_rows
        meta.field_list(4, _CT_STRUCT, len(row_groups))
        for num_rows, chunk_metas in row_groups:
            meta.list_struct_begin()                # RowGroup
            meta.field_list(1, _CT_STRUCT, len(chunk_metas))
            group_bytes = 0
            for c, start, chunk in chunk_metas:
                ptype, _ct, _s, _p = phys[c]
                group_bytes += chunk.uncompressed
                meta.list_struct_begin()            # ColumnChunk
                meta.field_i64(2, start)            # file_offset
                meta.field_struct(3)                # ColumnMetaData
                meta.field_i32(1, ptype)
                meta.field_list(2, _CT_I32, len(chunk.encodings))
                for e in chunk.encodings:
                    meta.zigzag(e)
                meta.field_list(3, _CT_BINARY, 1)   # path_in_schema
                meta.varint(len(names[c].encode()))
                meta.out += names[c].encode()
                meta.field_i32(4, codec_id)
                meta.field_i64(5, chunk.num_values)
                meta.field_i64(6, chunk.uncompressed)
                meta.field_i64(7, len(chunk.buf))   # total_compressed_size
                meta.field_i64(9, start + chunk.data_page_offset)
                if chunk.dict_page_offset is not None:
                    meta.field_i64(11, start + chunk.dict_page_offset)
                if chunk.min_v is not None or chunk.null_count:
                    meta.field_struct(12)           # Statistics
                    meta.field_i64(3, chunk.null_count)
                    if chunk.max_v is not None:
                        meta.field_binary(
                            5, _stat_bytes(ptype, chunk.max_v))
                        meta.field_binary(
                            6, _stat_bytes(ptype, chunk.min_v))
                    meta.struct_end()
                meta.struct_end()                   # ColumnMetaData
                meta.struct_end()                   # ColumnChunk
            meta.field_i64(2, group_bytes)          # total_byte_size
            meta.field_i64(3, num_rows)
            meta.struct_end()                       # RowGroup
        meta.field_binary(6, b"presto-tpu")         # created_by
        meta.struct_end()                           # FileMetaData STOP byte
        footer = meta.bytes()
        f.write(footer)
        f.write(struct.pack("<I", len(footer)))
        f.write(MAGIC)
    return total
