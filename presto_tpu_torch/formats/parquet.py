"""Parquet reader of the PyTorch port: the file catalog's external ingest.

Counterpart of ``presto_tpu/formats/parquet.py``, host numpy code ported
as it is: the thrift compact-protocol reader of FileMetaData and
PageHeader; PLAIN (int32/int64/float/double/byte_array/boolean),
RLE_DICTIONARY and PLAIN_DICTIONARY values; the RLE/bit-packed hybrid for
definition levels (flat optional columns) and dictionary indices; data
pages v1 and v2 and dictionary pages; FIXED_LEN_BYTE_ARRAY decimals; the
codecs UNCOMPRESSED, SNAPPY (``snappy_decompress``, its own decoder), GZIP
and ZSTD (``zstandard``, imported only where a zstd page is met); and
``ParquetFile`` with its row-group statistics and
``column_distinct_strings``. Types map into the engine's substrate:
INT32 -> INTEGER/DATE/SMALLINT, INT64 -> BIGINT/DECIMAL/TIMESTAMP,
FLBA decimal -> scaled int64, BYTE_ARRAY -> VARCHAR, DOUBLE, FLOAT ->
REAL, BOOLEAN.

Nested (repeated) schemas and INT96 timestamps are rejected. The reader
returns numpy arrays; the file connector builds the host pages.
"""
from __future__ import annotations

import dataclasses
import gzip
import os
import struct
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..types import (BIGINT, BOOLEAN, DATE, DOUBLE, INTEGER, REAL, SMALLINT,
                     TIMESTAMP, Type, VARCHAR, DecimalType)

MAGIC = b"PAR1"

# parquet::Type
T_BOOLEAN, T_INT32, T_INT64, T_INT96 = 0, 1, 2, 3
T_FLOAT, T_DOUBLE, T_BYTE_ARRAY, T_FLBA = 4, 5, 6, 7
# parquet::CompressionCodec
C_UNCOMPRESSED, C_SNAPPY, C_GZIP, C_LZO, C_BROTLI, C_LZ4, C_ZSTD = range(7)
# parquet::Encoding
E_PLAIN, E_PLAIN_DICTIONARY, E_RLE, E_BIT_PACKED = 0, 2, 3, 4
E_DELTA_BINARY_PACKED, E_DELTA_LENGTH_BA, E_DELTA_BA = 5, 6, 7
E_RLE_DICTIONARY = 8
# parquet::ConvertedType (subset)
CT_UTF8, CT_DECIMAL, CT_DATE = 0, 5, 6
CT_TIMESTAMP_MILLIS, CT_INT_16 = 9, 16
# parquet::PageType
PT_DATA, PT_INDEX, PT_DICTIONARY, PT_DATA_V2 = 0, 1, 2, 3


# ---------------------------------------------------------------------------
# thrift compact protocol (reader only)
# ---------------------------------------------------------------------------

class _TReader:
    """Minimal thrift compact-protocol reader over a bytes buffer."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def _byte(self) -> int:
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def varint(self) -> int:
        out = 0
        shift = 0
        while True:
            b = self._byte()
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7

    def zigzag(self) -> int:
        v = self.varint()
        return (v >> 1) ^ -(v & 1)

    def read_bytes(self) -> bytes:
        n = self.varint()
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def skip(self, ftype: int) -> None:
        if ftype in (1, 2):          # BOOL true/false (value in the type)
            return
        if ftype == 3:               # byte
            self.pos += 1
        elif ftype in (4, 5, 6):     # i16/i32/i64 zigzag varints
            self.varint()
        elif ftype == 7:             # double
            self.pos += 8
        elif ftype == 8:             # binary/string
            # NOTE: must read the varint FIRST — `pos += varint()` loads pos
            # before varint() advances it (augmented-assignment order)
            n = self.varint()
            self.pos += n
        elif ftype == 9:             # list
            head = self._byte()
            size = head >> 4
            etype = head & 0x0F
            if size == 15:
                size = self.varint()
            for _ in range(size):
                self.skip(etype)
        elif ftype == 12:            # struct
            self.skip_struct()
        elif ftype == 11:            # map? (not used by parquet)
            raise ValueError("unexpected thrift map in parquet metadata")
        else:
            raise ValueError(f"cannot skip thrift type {ftype}")

    def skip_struct(self) -> None:
        last = 0
        while True:
            head = self._byte()
            if head == 0:
                return
            delta = head >> 4
            ftype = head & 0x0F
            last = last + delta if delta else self.zigzag()
            self.skip(ftype)

    def fields(self):
        """Yield (field_id, ftype) for one struct; caller reads or .skip()s."""
        last = 0
        while True:
            head = self._byte()
            if head == 0:
                return
            delta = head >> 4
            ftype = head & 0x0F
            if delta:
                last += delta
            else:
                last = self.zigzag()
            yield last, ftype

    def list_header(self) -> Tuple[int, int]:
        head = self._byte()
        size = head >> 4
        etype = head & 0x0F
        if size == 15:
            size = self.varint()
        return size, etype

    def bool_value(self, ftype: int) -> bool:
        return ftype == 1


# ---------------------------------------------------------------------------
# metadata structs (only the fields the reader uses)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SchemaElement:
    name: str = ""
    ptype: Optional[int] = None
    type_length: int = 0
    repetition: int = 0          # 0 required, 1 optional, 2 repeated
    num_children: int = 0
    converted_type: Optional[int] = None
    scale: int = 0
    precision: int = 0


@dataclasses.dataclass
class ColumnMeta:
    ptype: int = 0
    encodings: List[int] = dataclasses.field(default_factory=list)
    path: Tuple[str, ...] = ()
    codec: int = 0
    num_values: int = 0
    total_compressed_size: int = 0
    data_page_offset: int = 0
    dictionary_page_offset: Optional[int] = None
    min_value: Optional[bytes] = None
    max_value: Optional[bytes] = None
    null_count: Optional[int] = None


@dataclasses.dataclass
class RowGroup:
    columns: List[ColumnMeta]
    num_rows: int


def _read_schema_element(r: _TReader) -> SchemaElement:
    e = SchemaElement()
    for fid, ft in r.fields():
        if fid == 1:
            e.ptype = r.zigzag()
        elif fid == 2:
            e.type_length = r.zigzag()
        elif fid == 3:
            e.repetition = r.zigzag()
        elif fid == 4:
            e.name = r.read_bytes().decode("utf-8")
        elif fid == 5:
            e.num_children = r.zigzag()
        elif fid == 6:
            e.converted_type = r.zigzag()
        elif fid == 7:
            e.scale = r.zigzag()
        elif fid == 8:
            e.precision = r.zigzag()
        else:
            r.skip(ft)
    return e


def _read_statistics(r: _TReader) -> Tuple[Optional[bytes], Optional[bytes],
                                           Optional[int]]:
    mn = mx = None
    nulls = None
    for fid, ft in r.fields():
        if fid == 1:    # max (legacy)
            mx = mx or r.read_bytes()
        elif fid == 2:  # min (legacy)
            mn = mn or r.read_bytes()
        elif fid == 3:
            nulls = r.zigzag()
        elif fid == 5:  # max_value
            mx = r.read_bytes()
        elif fid == 6:  # min_value
            mn = r.read_bytes()
        else:
            r.skip(ft)
    return mn, mx, nulls


def _read_column_meta(r: _TReader) -> ColumnMeta:
    m = ColumnMeta()
    for fid, ft in r.fields():
        if fid == 1:
            m.ptype = r.zigzag()
        elif fid == 2:
            n, _ = r.list_header()
            m.encodings = [r.zigzag() for _ in range(n)]
        elif fid == 3:
            n, _ = r.list_header()
            m.path = tuple(r.read_bytes().decode() for _ in range(n))
        elif fid == 4:
            m.codec = r.zigzag()
        elif fid == 5:
            m.num_values = r.zigzag()
        elif fid == 7:
            m.total_compressed_size = r.zigzag()
        elif fid == 9:
            m.data_page_offset = r.zigzag()
        elif fid == 11:
            m.dictionary_page_offset = r.zigzag()
        elif fid == 12:
            m.min_value, m.max_value, m.null_count = _read_statistics(r)
        else:
            r.skip(ft)
    return m


def _read_column_chunk(r: _TReader) -> ColumnMeta:
    meta = None
    for fid, ft in r.fields():
        if fid == 3:
            meta = _read_column_meta(r)
        else:
            r.skip(ft)
    if meta is None:
        raise ValueError("column chunk without metadata")
    return meta


def _read_row_group(r: _TReader) -> RowGroup:
    cols: List[ColumnMeta] = []
    rows = 0
    for fid, ft in r.fields():
        if fid == 1:
            n, _ = r.list_header()
            cols = [_read_column_chunk(r) for _ in range(n)]
        elif fid == 3:
            rows = r.zigzag()
        else:
            r.skip(ft)
    return RowGroup(cols, rows)


@dataclasses.dataclass
class FileMeta:
    schema: List[SchemaElement]
    num_rows: int
    row_groups: List[RowGroup]


def _read_file_meta(buf: bytes) -> FileMeta:
    r = _TReader(buf)
    schema: List[SchemaElement] = []
    num_rows = 0
    groups: List[RowGroup] = []
    for fid, ft in r.fields():
        if fid == 2:
            n, _ = r.list_header()
            schema = [_read_schema_element(r) for _ in range(n)]
        elif fid == 3:
            num_rows = r.zigzag()
        elif fid == 4:
            n, _ = r.list_header()
            groups = [_read_row_group(r) for _ in range(n)]
        else:
            r.skip(ft)
    return FileMeta(schema, num_rows, groups)


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------

def snappy_decompress(data: bytes) -> bytes:
    """Raw-snappy decoder (format: varint uncompressed length, then
    literal/copy tagged elements)."""
    pos = 0
    n = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    out = bytearray(n)
    opos = 0
    ln = len(data)
    while pos < ln:
        tag = data[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:                       # literal
            size = (tag >> 2) + 1
            if size > 60:
                nb = size - 60
                size = int.from_bytes(data[pos:pos + nb], "little") + 1
                pos += nb
            out[opos:opos + size] = data[pos:pos + size]
            pos += size
            opos += size
            continue
        if kind == 1:                       # copy, 1-byte offset
            size = ((tag >> 2) & 0x7) + 4
            offset = ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif kind == 2:                     # copy, 2-byte offset
            size = (tag >> 2) + 1
            offset = int.from_bytes(data[pos:pos + 2], "little")
            pos += 2
        else:                               # copy, 4-byte offset
            size = (tag >> 2) + 1
            offset = int.from_bytes(data[pos:pos + 4], "little")
            pos += 4
        if offset == 0:
            raise ValueError("corrupt snappy stream: zero offset")
        start = opos - offset
        if offset >= size:
            out[opos:opos + size] = out[start:start + size]
        else:  # overlapping copy: byte-at-a-time semantics
            for i in range(size):
                out[opos + i] = out[start + i]
        opos += size
    return bytes(out)


def _decompress(codec: int, data: bytes, uncompressed_size: int) -> bytes:
    if codec == C_UNCOMPRESSED:
        return data
    if codec == C_SNAPPY:
        return snappy_decompress(data)
    if codec == C_GZIP:
        return gzip.decompress(data)
    if codec == C_ZSTD:
        import zstandard

        return zstandard.ZstdDecompressor().decompress(
            data, max_output_size=uncompressed_size)
    raise NotImplementedError(f"parquet codec {codec} not supported")


# ---------------------------------------------------------------------------
# page decoding
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PageHeader:
    page_type: int = 0
    uncompressed_size: int = 0
    compressed_size: int = 0
    num_values: int = 0
    encoding: int = E_PLAIN
    def_encoding: int = E_RLE
    # v2 extras
    num_nulls: int = 0
    num_rows: int = 0
    def_levels_len: int = 0
    rep_levels_len: int = 0
    v2_is_compressed: bool = True


def _read_page_header(r: _TReader) -> PageHeader:
    h = PageHeader()
    for fid, ft in r.fields():
        if fid == 1:
            h.page_type = r.zigzag()
        elif fid == 2:
            h.uncompressed_size = r.zigzag()
        elif fid == 3:
            h.compressed_size = r.zigzag()
        elif fid == 5:  # data_page_header
            for f2, t2 in r.fields():
                if f2 == 1:
                    h.num_values = r.zigzag()
                elif f2 == 2:
                    h.encoding = r.zigzag()
                elif f2 == 3:
                    h.def_encoding = r.zigzag()
                else:
                    r.skip(t2)
        elif fid == 7:  # dictionary_page_header
            for f2, t2 in r.fields():
                if f2 == 1:
                    h.num_values = r.zigzag()
                elif f2 == 2:
                    h.encoding = r.zigzag()
                else:
                    r.skip(t2)
        elif fid == 8:  # data_page_header_v2
            for f2, t2 in r.fields():
                if f2 == 1:
                    h.num_values = r.zigzag()
                elif f2 == 2:
                    h.num_nulls = r.zigzag()
                elif f2 == 3:
                    h.num_rows = r.zigzag()
                elif f2 == 4:
                    h.encoding = r.zigzag()
                elif f2 == 5:
                    h.def_levels_len = r.zigzag()
                elif f2 == 6:
                    h.rep_levels_len = r.zigzag()
                elif f2 == 7:
                    h.v2_is_compressed = r.bool_value(t2)
                else:
                    r.skip(t2)
        else:
            r.skip(ft)
    return h


def _decode_rle_bitpacked(data: bytes, bit_width: int, count: int,
                          length_prefixed: bool) -> np.ndarray:
    """RLE/bit-packed hybrid (def levels and dictionary indices)."""
    pos = 0
    if length_prefixed:
        pos = 4  # i32 length; trust `count` for the payload extent
    out = np.empty(count, dtype=np.int32)
    filled = 0
    if bit_width == 0:
        out[:] = 0
        return out
    mask = (1 << bit_width) - 1
    byte_width = (bit_width + 7) // 8
    while filled < count:
        header = 0
        shift = 0
        while True:
            b = data[pos]
            pos += 1
            header |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        if header & 1:   # bit-packed run: (header >> 1) groups of 8 values
            n_groups = header >> 1
            n_vals = n_groups * 8
            n_bytes = n_groups * bit_width
            chunk = np.frombuffer(data[pos:pos + n_bytes], dtype=np.uint8)
            pos += n_bytes
            bits = np.unpackbits(chunk, bitorder="little")
            vals = bits.reshape(-1, bit_width)
            weights = (1 << np.arange(bit_width, dtype=np.int64))
            decoded = (vals.astype(np.int64) * weights).sum(axis=1)
            take = min(n_vals, count - filled)
            out[filled:filled + take] = decoded[:take]
            filled += take
        else:            # RLE run
            run_len = header >> 1
            v = int.from_bytes(data[pos:pos + byte_width], "little") & mask
            pos += byte_width
            take = min(run_len, count - filled)
            out[filled:filled + take] = v
            filled += take
    return out


def _decode_plain(ptype: int, data: bytes, count: int, type_length: int
                  ) -> np.ndarray:
    if ptype == T_INT32:
        return np.frombuffer(data, dtype="<i4", count=count)
    if ptype == T_INT64:
        return np.frombuffer(data, dtype="<i8", count=count)
    if ptype == T_FLOAT:
        return np.frombuffer(data, dtype="<f4", count=count)
    if ptype == T_DOUBLE:
        return np.frombuffer(data, dtype="<f8", count=count)
    if ptype == T_BOOLEAN:
        bits = np.frombuffer(data, dtype=np.uint8,
                             count=(count + 7) // 8)
        return np.unpackbits(bits, bitorder="little")[:count].astype(bool)
    if ptype == T_FLBA:
        return _decode_flba_decimal(data, count, type_length)
    if ptype == T_BYTE_ARRAY:
        return _decode_byte_array(data, count)
    raise NotImplementedError(f"parquet physical type {ptype}")


def _decode_byte_array(data: bytes, count: int) -> np.ndarray:
    """PLAIN byte_array: (u32 length, bytes)* -> object array of str."""
    lens = np.empty(count, dtype=np.int64)
    offs = np.empty(count, dtype=np.int64)
    pos = 0
    for i in range(count):
        n = int.from_bytes(data[pos:pos + 4], "little")
        pos += 4
        offs[i] = pos
        lens[i] = n
        pos += n
    out = np.empty(count, dtype=object)
    for i in range(count):
        o = int(offs[i])
        out[i] = data[o:o + int(lens[i])].decode("utf-8", "replace")
    return out


def _decode_flba_decimal(data: bytes, count: int, type_length: int
                         ) -> np.ndarray:
    """Fixed-len big-endian two's-complement decimal -> int64 unscaled."""
    if type_length > 8:
        # high bytes must be pure sign extension for precision <= 18
        arr = np.frombuffer(data, dtype=np.uint8,
                            count=count * type_length).reshape(count, -1)
        head = arr[:, : type_length - 8]
        sign = (arr[:, type_length - 8] & 0x80) != 0
        expect = np.where(sign, 0xFF, 0x00)
        if not np.array_equal(head, np.broadcast_to(
                expect[:, None], head.shape)):
            raise OverflowError("decimal wider than 64 bits")
        arr = arr[:, -8:]
        type_length = 8
    else:
        arr = np.frombuffer(data, dtype=np.uint8,
                            count=count * type_length).reshape(count, -1)
    out = np.zeros(count, dtype=np.int64)
    for b in range(type_length):
        out = (out << 8) | arr[:, b].astype(np.int64)
    # sign-extend from type_length bytes
    bits = 8 * type_length
    if bits < 64:
        sign_bit = np.int64(1) << (bits - 1)
        out = (out ^ sign_bit) - sign_bit
    return out


class ParquetColumnReader:
    """Decodes one column chunk of one row group into a numpy array."""

    def __init__(self, f, meta: ColumnMeta, elem: SchemaElement,
                 num_rows: int):
        self.f = f
        self.meta = meta
        self.elem = elem
        self.num_rows = num_rows
        self._dict_values: Optional[np.ndarray] = None

    def _read_at(self, offset: int, size: int) -> bytes:
        self.f.seek(offset)
        return self.f.read(size)

    def read(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """-> (values ndarray, null mask or None), length num_rows."""
        meta = self.meta
        start = meta.data_page_offset
        if meta.dictionary_page_offset is not None and \
                0 < meta.dictionary_page_offset < start:
            start = meta.dictionary_page_offset
        buf = self._read_at(start, meta.total_compressed_size)
        pos = 0
        vals_parts: List[np.ndarray] = []
        null_parts: List[np.ndarray] = []
        got = 0
        while got < meta.num_values and pos < len(buf):
            r = _TReader(buf, pos)
            h = _read_page_header(r)
            body = buf[r.pos:r.pos + h.compressed_size]
            pos = r.pos + h.compressed_size
            if h.page_type == PT_DICTIONARY:
                raw = _decompress(meta.codec, body, h.uncompressed_size)
                self._dict_values = _decode_plain(
                    meta.ptype, raw, h.num_values, self.elem.type_length)
                continue
            if h.page_type == PT_DATA:
                vals, nulls, n = self._decode_data_v1(h, body)
            elif h.page_type == PT_DATA_V2:
                vals, nulls, n = self._decode_data_v2(h, body)
            else:
                continue  # index pages etc.
            vals_parts.append(vals)
            null_parts.append(nulls)
            got += n
        if not vals_parts:
            return _empty_for(meta.ptype), None
        values = np.concatenate(vals_parts) if len(vals_parts) != 1 else \
            vals_parts[0]
        if any(n is not None for n in null_parts):
            nulls = np.concatenate([
                n if n is not None else np.zeros(len(v), dtype=bool)
                for n, v in zip(null_parts, vals_parts)])
        else:
            nulls = None
        return values, nulls

    # -- page bodies --------------------------------------------------------

    def _max_def(self) -> int:
        return 1 if self.elem.repetition == 1 else 0

    def _decode_values(self, encoding: int, raw: bytes, n_present: int
                       ) -> np.ndarray:
        if encoding in (E_RLE_DICTIONARY, E_PLAIN_DICTIONARY):
            if self._dict_values is None:
                raise ValueError("dictionary-encoded page without dictionary")
            bw = raw[0]
            idx = _decode_rle_bitpacked(raw[1:], bw, n_present,
                                        length_prefixed=False)
            return self._dict_values[idx]
        if encoding == E_PLAIN:
            return _decode_plain(self.meta.ptype, raw, n_present,
                                 self.elem.type_length)
        if encoding == E_RLE and self.meta.ptype == T_BOOLEAN:
            # RLE-encoded booleans (bit width 1, 4-byte length prefix)
            return _decode_rle_bitpacked(raw, 1, n_present,
                                         length_prefixed=True).astype(bool)
        raise NotImplementedError(f"parquet value encoding {encoding}")

    def _scatter(self, present_vals: np.ndarray, defs: Optional[np.ndarray],
                 n: int) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        if defs is None:
            return present_vals, None
        nulls = defs == 0
        if not nulls.any():
            return present_vals, None
        if present_vals.dtype == object:
            out = np.full(n, None, dtype=object)
        else:
            out = np.zeros(n, dtype=present_vals.dtype)
        out[~nulls] = present_vals
        return out, nulls

    def _decode_data_v1(self, h: PageHeader, body: bytes):
        raw = _decompress(self.meta.codec, body, h.uncompressed_size)
        n = h.num_values
        defs = None
        pos = 0
        if self._max_def() == 1:
            length = int.from_bytes(raw[0:4], "little")
            defs = _decode_rle_bitpacked(raw, 1, n, length_prefixed=True)
            pos = 4 + length
        n_present = n if defs is None else int((defs != 0).sum())
        vals = self._decode_values(h.encoding, raw[pos:], n_present)
        vals, nulls = self._scatter(vals, defs, n)
        return vals, nulls, n

    def _decode_data_v2(self, h: PageHeader, body: bytes):
        n = h.num_values
        pos = h.rep_levels_len + h.def_levels_len
        defs = None
        if self._max_def() == 1 and h.def_levels_len > 0:
            defs = _decode_rle_bitpacked(
                body[h.rep_levels_len:pos], 1, n, length_prefixed=False)
        raw = body[pos:]
        if h.v2_is_compressed:
            raw = _decompress(self.meta.codec, raw,
                              h.uncompressed_size - pos)
        n_present = n - h.num_nulls
        vals = self._decode_values(h.encoding, raw, n_present)
        vals, nulls = self._scatter(vals, defs, n)
        return vals, nulls, n


# ---------------------------------------------------------------------------
# file-level API
# ---------------------------------------------------------------------------

def _engine_type(elem: SchemaElement) -> Type:
    ct = elem.converted_type
    if elem.ptype == T_BOOLEAN:
        return BOOLEAN
    if elem.ptype == T_INT32:
        if ct == CT_DATE:
            return DATE
        return SMALLINT if ct == CT_INT_16 else INTEGER
    if elem.ptype == T_INT64:
        if ct == CT_DECIMAL:
            return DecimalType(elem.precision, elem.scale)
        return TIMESTAMP if ct == CT_TIMESTAMP_MILLIS else BIGINT
    if elem.ptype == T_FLOAT:
        return REAL
    if elem.ptype == T_DOUBLE:
        return DOUBLE
    if elem.ptype == T_FLBA and ct == CT_DECIMAL:
        return DecimalType(elem.precision, elem.scale)
    if elem.ptype == T_BYTE_ARRAY:
        return VARCHAR
    raise NotImplementedError(
        f"parquet column {elem.name}: type {elem.ptype}/{ct} not supported")


class ParquetFile:
    """One parquet file: schema + row-group readers."""

    def __init__(self, path: str):
        self.path = path
        self.f = open(path, "rb")
        try:
            size = os.fstat(self.f.fileno()).st_size
            self.f.seek(size - 8)
            tail = self.f.read(8)
            if tail[4:] != MAGIC:
                raise ValueError(f"{path}: not a parquet file")
            meta_len = struct.unpack("<I", tail[:4])[0]
            self.f.seek(size - 8 - meta_len)
            self.meta = _read_file_meta(self.f.read(meta_len))
            root, rest = self.meta.schema[0], self.meta.schema[1:]
            if sum(1 for e in rest if e.num_children) > 0:
                raise NotImplementedError(
                    "nested parquet schemas not supported")
            if any(e.repetition == 2 for e in rest):
                raise NotImplementedError(
                    "repeated parquet fields not supported")
        except BaseException:
            self.f.close()
            raise
        self.columns = rest
        self.num_rows = self.meta.num_rows

    @property
    def schema(self) -> List[Tuple[str, Type]]:
        return [(e.name, _engine_type(e)) for e in self.columns]

    @property
    def n_row_groups(self) -> int:
        return len(self.meta.row_groups)

    def row_group_rows(self, g: int) -> int:
        return self.meta.row_groups[g].num_rows

    def row_group_stats(self, g: int, column: str
                        ) -> Optional[Tuple[Any, Any]]:
        """(min, max) decoded to engine-value space, or None."""
        rg = self.meta.row_groups[g]
        for cm, e in zip(rg.columns, self.columns):
            if e.name != column:
                continue
            if cm.min_value is None or cm.max_value is None:
                return None
            return (_decode_stat(e, cm.min_value),
                    _decode_stat(e, cm.max_value))
        return None

    def column_distinct_strings(self, name: str) -> Optional[List[str]]:
        """Distinct values of a byte_array column WITHOUT decoding data pages:
        walks page headers, decodes only dictionary pages. Returns None when
        any data page is not dictionary-encoded (caller falls back to a full
        read) — parquet writers fall back to PLAIN when a dictionary page
        overflows, so this is exactly the cheap case."""
        out: List[str] = []
        seen = set()
        for rg in self.meta.row_groups:
            for cm, e in zip(rg.columns, self.columns):
                if e.name != name:
                    continue
                if cm.ptype != T_BYTE_ARRAY:
                    return None
                start = cm.data_page_offset
                if cm.dictionary_page_offset is not None and \
                        0 < cm.dictionary_page_offset < start:
                    start = cm.dictionary_page_offset
                self.f.seek(start)
                buf = self.f.read(cm.total_compressed_size)
                pos = 0
                got = 0
                while got < cm.num_values and pos < len(buf):
                    r = _TReader(buf, pos)
                    h = _read_page_header(r)
                    body = buf[r.pos:r.pos + h.compressed_size]
                    pos = r.pos + h.compressed_size
                    if h.page_type == PT_DICTIONARY:
                        raw = _decompress(cm.codec, body, h.uncompressed_size)
                        for v in _decode_byte_array(raw, h.num_values):
                            if v not in seen:
                                seen.add(v)
                                out.append(v)
                    elif h.page_type in (PT_DATA, PT_DATA_V2):
                        if h.encoding not in (E_RLE_DICTIONARY,
                                              E_PLAIN_DICTIONARY):
                            return None
                        got += h.num_values
        return out

    def read_row_group(self, g: int, columns: Sequence[str]
                       ) -> Dict[str, Tuple[np.ndarray, Optional[np.ndarray]]]:
        rg = self.meta.row_groups[g]
        out = {}
        by_name = {e.name: (cm, e) for cm, e in zip(rg.columns, self.columns)}
        for name in columns:
            if name not in by_name:
                raise KeyError(f"{self.path}: no column {name}")
            cm, e = by_name[name]
            reader = ParquetColumnReader(self.f, cm, e, rg.num_rows)
            out[name] = reader.read()
        return out

    def close(self):
        self.f.close()


def _empty_for(ptype: int) -> np.ndarray:
    dt = {T_BOOLEAN: np.bool_, T_INT32: np.int32, T_INT64: np.int64,
          T_FLOAT: np.float32, T_DOUBLE: np.float64}.get(ptype, object)
    return np.empty(0, dtype=dt)


def _decode_stat(elem: SchemaElement, raw: bytes):
    if elem.ptype == T_INT32:
        return struct.unpack("<i", raw)[0]
    if elem.ptype == T_INT64:
        return struct.unpack("<q", raw)[0]
    if elem.ptype == T_FLOAT:
        return struct.unpack("<f", raw)[0]
    if elem.ptype == T_DOUBLE:
        return struct.unpack("<d", raw)[0]
    if elem.ptype == T_BYTE_ARRAY:
        return raw.decode("utf-8", "replace")
    if elem.ptype == T_FLBA:
        return int(_decode_flba_decimal(raw, 1, len(raw))[0])
    return None
