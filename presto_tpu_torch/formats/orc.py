"""ORC reader of the PyTorch port: the file catalog's other external format.

Counterpart of ``presto_tpu/formats/orc.py``, host numpy code ported as it
is: the protobuf wire reader of PostScript / Footer / Metadata /
StripeFooter; compression framing with NONE/ZLIB/SNAPPY/ZSTD
(``zstandard``, imported only where a zstd block is met); byte RLE, boolean
RLE and integer RLEv2 (``decode_rlev2``: SHORT_REPEAT, DIRECT,
PATCHED_BASE, DELTA); boolean, byte/short/int/long, float, double, string
(DIRECT_V2 and DICTIONARY_V2), date and decimal (<= 18 digits) columns;
PRESENT streams as null masks; and ``OrcFile`` with its stripe statistics
for the file connector's split pruning.

One difference: a decimal column's zigzag varint mantissas decode in numpy
(``_decode_varint_stream``), not one value at a time in Python; the values
are the reference's. Nested types, timestamps and binary are rejected.
"""
from __future__ import annotations

import dataclasses
import os
import struct
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..types import (BIGINT, BOOLEAN, DATE, DOUBLE, INTEGER, REAL, SMALLINT,
                     Type, VARCHAR, DecimalType)
from .parquet import snappy_decompress

MAGIC = b"ORC"

# CompressionKind
K_NONE, K_ZLIB, K_SNAPPY, K_LZO, K_LZ4, K_ZSTD = range(6)
# Type.Kind
T_BOOLEAN, T_BYTE, T_SHORT, T_INT, T_LONG, T_FLOAT, T_DOUBLE = range(7)
T_STRING, T_BINARY, T_TIMESTAMP, T_LIST, T_MAP, T_STRUCT = 7, 8, 9, 10, 11, 12
T_UNION, T_DECIMAL, T_DATE, T_VARCHAR, T_CHAR = 13, 14, 15, 16, 17
# Stream.Kind
S_PRESENT, S_DATA, S_LENGTH, S_DICT_DATA = 0, 1, 2, 3
S_DICT_COUNT, S_SECONDARY, S_ROW_INDEX = 4, 5, 6
# ColumnEncoding.Kind
E_DIRECT, E_DICTIONARY, E_DIRECT_V2, E_DICTIONARY_V2 = range(4)

_INT_KINDS = (T_BYTE, T_SHORT, T_INT, T_LONG, T_DATE)
_STR_KINDS = (T_STRING, T_VARCHAR, T_CHAR)


# ---------------------------------------------------------------------------
# protobuf wire reader
# ---------------------------------------------------------------------------

class _PBReader:
    """Minimal protobuf wire-format reader over a bytes buffer."""

    __slots__ = ("buf", "pos", "end")

    def __init__(self, buf: bytes, pos: int = 0, end: Optional[int] = None):
        self.buf = buf
        self.pos = pos
        self.end = len(buf) if end is None else end

    def varint(self) -> int:
        out = 0
        shift = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7

    def fields(self):
        """Yield (field_number, wire_type) until the buffer region ends."""
        while self.pos < self.end:
            key = self.varint()
            yield key >> 3, key & 7

    def bytes_field(self) -> bytes:
        n = self.varint()
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def sub(self) -> "_PBReader":
        n = self.varint()
        r = _PBReader(self.buf, self.pos, self.pos + n)
        self.pos += n
        return r

    def skip(self, wire_type: int) -> None:
        if wire_type == 0:
            self.varint()
        elif wire_type == 1:
            self.pos += 8
        elif wire_type == 2:
            # read the varint FIRST: `pos += varint()` loads pos before
            # varint() advances it (augmented-assignment order; the thrift
            # reader in parquet.py hit the same trap)
            n = self.varint()
            self.pos += n
        elif wire_type == 5:
            self.pos += 4
        else:
            raise ValueError(f"cannot skip protobuf wire type {wire_type}")


# ---------------------------------------------------------------------------
# metadata structs
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class OrcType:
    kind: int = T_STRUCT
    subtypes: List[int] = dataclasses.field(default_factory=list)
    field_names: List[str] = dataclasses.field(default_factory=list)
    precision: int = 0
    scale: int = 0


@dataclasses.dataclass
class StripeInfo:
    offset: int = 0
    index_length: int = 0
    data_length: int = 0
    footer_length: int = 0
    num_rows: int = 0


@dataclasses.dataclass
class StreamInfo:
    kind: int = 0
    column: int = 0
    length: int = 0


@dataclasses.dataclass
class ColumnStats:
    """IntegerStatistics / DoubleStatistics subset for stripe pruning."""
    min_value: Optional[Any] = None
    max_value: Optional[Any] = None
    has_null: bool = False


def _read_postscript(buf: bytes):
    r = _PBReader(buf)
    footer_len = metadata_len = 0
    compression = K_NONE
    block_size = 256 * 1024
    for f, wt in r.fields():
        if f == 1:
            footer_len = r.varint()
        elif f == 2:
            compression = r.varint()
        elif f == 3:
            block_size = r.varint()
        elif f == 5:
            metadata_len = r.varint()
        elif f == 8000:
            r.bytes_field()  # magic
        else:
            r.skip(wt)
    return footer_len, compression, block_size, metadata_len


def _read_type(r: _PBReader) -> OrcType:
    t = OrcType()
    for f, wt in r.fields():
        if f == 1:
            t.kind = r.varint()
        elif f == 2:
            if wt == 2:  # packed repeated uint32
                sub = r.sub()
                while sub.pos < sub.end:
                    t.subtypes.append(sub.varint())
            else:
                t.subtypes.append(r.varint())
        elif f == 3:
            t.field_names.append(r.bytes_field().decode())
        elif f == 5:
            t.precision = r.varint()
        elif f == 6:
            t.scale = r.varint()
        else:
            r.skip(wt)
    return t


def _read_stripe_info(r: _PBReader) -> StripeInfo:
    s = StripeInfo()
    for f, wt in r.fields():
        if f == 1:
            s.offset = r.varint()
        elif f == 2:
            s.index_length = r.varint()
        elif f == 3:
            s.data_length = r.varint()
        elif f == 4:
            s.footer_length = r.varint()
        elif f == 5:
            s.num_rows = r.varint()
        else:
            r.skip(wt)
    return s


def _zigzag_decode_int(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def _read_column_stats(r: _PBReader) -> ColumnStats:
    out = ColumnStats()
    for f, wt in r.fields():
        if f == 2:      # IntegerStatistics {1: min sint64, 2: max sint64}
            sub = r.sub()
            for f2, wt2 in sub.fields():
                if f2 == 1:
                    v = sub.varint()
                    out.min_value = _zigzag_decode_int(v)
                elif f2 == 2:
                    v = sub.varint()
                    out.max_value = _zigzag_decode_int(v)
                else:
                    sub.skip(wt2)
        elif f == 3:    # DoubleStatistics {1: min, 2: max} (wire type 1)
            sub = r.sub()
            for f2, wt2 in sub.fields():
                if f2 in (1, 2):
                    (val,) = struct.unpack("<d", sub.buf[sub.pos:sub.pos + 8])
                    sub.pos += 8
                    if f2 == 1:
                        out.min_value = val
                    else:
                        out.max_value = val
                else:
                    sub.skip(wt2)
        elif f == 10:   # hasNull
            out.has_null = bool(r.varint())
        else:
            r.skip(wt)
    return out


# ---------------------------------------------------------------------------
# compression framing
# ---------------------------------------------------------------------------

def _decompress_block(codec: int, data: bytes) -> bytes:
    if codec == K_ZLIB:
        return zlib.decompress(data, -15)  # raw deflate
    if codec == K_SNAPPY:
        return snappy_decompress(data)
    if codec == K_ZSTD:
        import zstandard

        return zstandard.ZstdDecompressor().decompress(
            data, max_output_size=1 << 26)
    if codec == K_LZ4:
        raise NotImplementedError("orc lz4 compression not supported")
    raise NotImplementedError(f"orc compression kind {codec}")


def decompress_stream(codec: int, data: bytes) -> bytes:
    """Undo ORC chunk framing: 3-byte headers (len << 1 | is_original)."""
    if codec == K_NONE:
        return data
    out = []
    pos = 0
    n = len(data)
    while pos < n:
        header = int.from_bytes(data[pos:pos + 3], "little")
        pos += 3
        chunk_len = header >> 1
        chunk = data[pos:pos + chunk_len]
        pos += chunk_len
        out.append(chunk if header & 1 else _decompress_block(codec, chunk))
    return b"".join(out)


# ---------------------------------------------------------------------------
# run-length decoders
# ---------------------------------------------------------------------------

def decode_byte_rle(data: bytes, count: int) -> np.ndarray:
    """Byte RLE: control c in [0,127] = run of c+3 copies; c in [128,255] =
    256-c literal bytes."""
    out = np.empty(count, dtype=np.uint8)
    filled = 0
    pos = 0
    while filled < count:
        c = data[pos]
        pos += 1
        if c < 128:
            run = c + 3
            out[filled:filled + run] = data[pos]
            pos += 1
            filled += run
        else:
            lit = 256 - c
            out[filled:filled + lit] = np.frombuffer(
                data, dtype=np.uint8, count=lit, offset=pos)
            pos += lit
            filled += lit
    return out[:count]


def decode_bool_rle(data: bytes, count: int) -> np.ndarray:
    """Boolean stream: byte RLE over bit-bytes, bits MSB-first."""
    nbytes = (count + 7) // 8
    raw = decode_byte_rle(data, nbytes)
    return np.unpackbits(raw, bitorder="big")[:count].astype(bool)


# 5-bit width codes for DIRECT/PATCHED_BASE/DELTA payloads
_WIDTH_TABLE = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16,
                17, 18, 19, 20, 21, 22, 23, 24, 26, 28, 30, 32, 40, 48,
                56, 64]


def _closest_fixed_bits(bits: int) -> int:
    """Round up to the nearest encodable bit width (1..24, 26, 28, 30, 32,
    40, 48, 56, 64) — the Java reader's getClosestFixedBits."""
    for w in _WIDTH_TABLE:
        if bits <= w:
            return w
    return 64


def _bits_be(data: bytes, start_bit: int, count: int, width: int
             ) -> np.ndarray:
    """Unpack `count` big-endian `width`-bit values starting at start_bit."""
    if width == 0 or count == 0:
        return np.zeros(count, dtype=np.int64)
    end_bit = start_bit + count * width
    end_byte = (end_bit + 7) // 8
    bits = np.unpackbits(np.frombuffer(data, dtype=np.uint8,
                                       count=end_byte),
                         bitorder="big")[start_bit:end_bit]
    vals = bits.reshape(count, width).astype(np.int64)
    weights = (np.int64(1) << np.arange(width - 1, -1, -1,
                                        dtype=np.int64))
    return vals @ weights


def _varint_at(data: bytes, pos: int) -> Tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def decode_rlev2(data: bytes, count: int, signed: bool) -> np.ndarray:
    """Integer RLEv2: SHORT_REPEAT / DIRECT / PATCHED_BASE / DELTA runs."""
    out = np.empty(count, dtype=np.int64)
    filled = 0
    pos = 0
    while filled < count:
        b0 = data[pos]
        enc = b0 >> 6
        if enc == 0:                      # SHORT_REPEAT
            width = ((b0 >> 3) & 0x7) + 1
            run = (b0 & 0x7) + 3
            v = int.from_bytes(data[pos + 1:pos + 1 + width], "big")
            if signed:
                v = (v >> 1) ^ -(v & 1)
            out[filled:filled + run] = v
            filled += run
            pos += 1 + width
        elif enc == 1:                    # DIRECT
            width = _WIDTH_TABLE[(b0 >> 1) & 0x1F]
            run = ((b0 & 1) << 8 | data[pos + 1]) + 1
            vals = _bits_be(data[pos + 2:], 0, run, width)
            if signed:
                # LOGICAL shift for the zigzag decode: 64-bit-wide values set
                # the int64 sign bit and an arithmetic >> would sign-extend
                vals = (vals.view(np.uint64) >> np.uint64(1)).view(
                    np.int64) ^ -(vals & 1)
            out[filled:filled + run] = vals
            filled += run
            pos += 2 + (run * width + 7) // 8
        elif enc == 2:                    # PATCHED_BASE
            width = _WIDTH_TABLE[(b0 >> 1) & 0x1F]
            run = ((b0 & 1) << 8 | data[pos + 1]) + 1
            b2 = data[pos + 2]
            base_w = ((b2 >> 5) & 0x7) + 1
            patch_w = _WIDTH_TABLE[b2 & 0x1F]
            b3 = data[pos + 3]
            pgw = ((b3 >> 5) & 0x7) + 1   # patch GAP width, 1..8 BITS
            pll = b3 & 0x1F
            p = pos + 4
            base = int.from_bytes(data[p:p + base_w], "big")
            sign_mask = 1 << (base_w * 8 - 1)
            if base & sign_mask:
                base = -(base & (sign_mask - 1))
            p += base_w
            vals = _bits_be(data[p:], 0, run, width)
            p += (run * width + 7) // 8
            # each patch entry is gap(pgw bits) | patch(patch_w bits), stored
            # at the closest fixed bit width (the Java reader's
            # getClosestFixedBits(pgw + pw)); the block pads to whole bytes
            patch_bits = _closest_fixed_bits(pgw + patch_w)
            entries = _bits_be(data[p:], 0, pll, patch_bits)
            p += (pll * patch_bits + 7) // 8
            gap_acc = 0
            for e in entries:
                gap_acc += int(e) >> patch_w
                patch = int(e) & ((1 << patch_w) - 1)
                vals[gap_acc] |= patch << width
            out[filled:filled + run] = vals + base
            filled += run
            pos = p
        else:                             # DELTA
            width_code = (b0 >> 1) & 0x1F
            width = 0 if width_code == 0 else _WIDTH_TABLE[width_code]
            run = ((b0 & 1) << 8 | data[pos + 1]) + 1
            p = pos + 2
            base, p = _varint_at(data, p)
            if signed:
                base = (base >> 1) ^ -(base & 1)
            delta0, p = _varint_at(data, p)
            delta0 = (delta0 >> 1) ^ -(delta0 & 1)  # always signed
            seq = np.empty(run, dtype=np.int64)
            seq[0] = base
            if run > 1:
                seq[1] = base + delta0
                if run > 2:
                    if width == 0:
                        deltas = np.full(run - 2, abs(delta0),
                                         dtype=np.int64)
                    else:
                        deltas = _bits_be(data[p:], 0, run - 2, width)
                        p += ((run - 2) * width + 7) // 8
                    if delta0 < 0:
                        deltas = -deltas
                    seq[2:] = deltas
                    np.cumsum(seq[1:], out=seq[1:])
                elif width:  # spec: payload padded even when empty
                    p += 0
            out[filled:filled + run] = seq
            filled += run
            pos = p
    return out[:count]


# ---------------------------------------------------------------------------
# column readers
# ---------------------------------------------------------------------------

def _engine_type(t: OrcType) -> Type:
    if t.kind == T_BOOLEAN:
        return BOOLEAN
    if t.kind in (T_BYTE, T_SHORT):
        return SMALLINT
    if t.kind == T_INT:
        return INTEGER
    if t.kind == T_LONG:
        return BIGINT
    if t.kind == T_FLOAT:
        return REAL
    if t.kind == T_DOUBLE:
        return DOUBLE
    if t.kind in _STR_KINDS:
        return VARCHAR
    if t.kind == T_DATE:
        return DATE
    if t.kind == T_DECIMAL:
        if t.precision > 18:
            raise NotImplementedError(
                f"orc decimal({t.precision},{t.scale}) wider than 64 bits")
        return DecimalType(t.precision or 18, t.scale)
    raise NotImplementedError(f"orc type kind {t.kind} not supported")


def _decode_varint_stream(data: bytes, count: int) -> np.ndarray:
    """Decimal mantissas: ``count`` zigzag base-128 varints, decoded in
    numpy (each varint ends at its first byte below 0x80)."""
    if count == 0:
        return np.empty(0, dtype=np.int64)
    b = np.frombuffer(data, dtype=np.uint8)
    ends = np.flatnonzero(b < 0x80)[:count]
    if len(ends) < count:
        raise ValueError(f"varint stream holds {len(ends)} values, want {count}")
    lengths = np.diff(ends, prepend=-1)
    starts = ends + 1 - lengths
    used = b[:ends[-1] + 1].astype(np.uint64) & np.uint64(0x7F)
    shift = (np.arange(len(used)) - np.repeat(starts, lengths)) * 7
    z = np.bitwise_or.reduceat(used << shift.astype(np.uint64), starts)
    return (z >> np.uint64(1)).view(np.int64) ^ -(z & np.uint64(1)).view(np.int64)


class OrcFile:
    """One ORC file: schema + stripe readers (OrcReader analogue)."""

    def __init__(self, path: str):
        self.path = path
        self.f = open(path, "rb")
        try:
            size = os.fstat(self.f.fileno()).st_size
            tail_len = min(size, 16 * 1024)
            self.f.seek(size - tail_len)
            tail = self.f.read(tail_len)
            ps_len = tail[-1]
            ps = tail[-1 - ps_len:-1]
            footer_len, self.codec, self.block_size, meta_len = \
                _read_postscript(ps)
            need = footer_len + meta_len + ps_len + 1
            if need > tail_len:  # big footer (many stripes / wide schema)
                tail_len = min(size, need)
                self.f.seek(size - tail_len)
                tail = self.f.read(tail_len)
            footer_end = tail_len - 1 - ps_len
            footer_buf = decompress_stream(
                self.codec, tail[footer_end - footer_len:footer_end])
            self._parse_footer(footer_buf)
            meta_end = footer_end - footer_len
            # stripe statistics parse LAZILY on first stripe_col_stats call:
            # scans open one OrcFile per stripe split and never read them
            self._meta_raw = tail[meta_end - meta_len:meta_end] \
                if meta_len else b""
            self._stripe_stats: Optional[List[List[ColumnStats]]] = None
        except BaseException:
            self.f.close()
            raise
        root = self.types[0]
        if root.kind != T_STRUCT:
            raise NotImplementedError("orc root type must be a struct")
        for sub in root.subtypes:
            if self.types[sub].kind in (T_LIST, T_MAP, T_STRUCT, T_UNION,
                                        T_TIMESTAMP, T_BINARY):
                raise NotImplementedError(
                    f"orc column type kind {self.types[sub].kind} "
                    "not supported (flat schemas only)")

    def _parse_footer(self, buf: bytes) -> None:
        r = _PBReader(buf)
        self.stripes: List[StripeInfo] = []
        self.types: List[OrcType] = []
        self.num_rows = 0
        self.file_stats: List[ColumnStats] = []
        for f, wt in r.fields():
            if f == 3:
                self.stripes.append(_read_stripe_info(r.sub()))
            elif f == 4:
                self.types.append(_read_type(r.sub()))
            elif f == 6:
                self.num_rows = r.varint()
            elif f == 7:
                self.file_stats.append(_read_column_stats(r.sub()))
            else:
                r.skip(wt)

    @property
    def stripe_stats(self) -> List[List[ColumnStats]]:
        if self._stripe_stats is None:
            self._stripe_stats = []
            if self._meta_raw:
                self._parse_metadata(
                    decompress_stream(self.codec, self._meta_raw))
        return self._stripe_stats

    def _parse_metadata(self, buf: bytes) -> None:
        r = _PBReader(buf)
        for f, wt in r.fields():
            if f == 1:  # StripeStatistics { 1: colStats repeated }
                sub = r.sub()
                cols = []
                for f2, wt2 in sub.fields():
                    if f2 == 1:
                        cols.append(_read_column_stats(sub.sub()))
                    else:
                        sub.skip(wt2)
                self._stripe_stats.append(cols)
            else:
                r.skip(wt)

    # ------------------------------------------------------------------ api

    @property
    def schema(self) -> List[Tuple[str, Type]]:
        root = self.types[0]
        return [(name, _engine_type(self.types[sub]))
                for name, sub in zip(root.field_names, root.subtypes)]

    @property
    def n_stripes(self) -> int:
        return len(self.stripes)

    def stripe_rows(self, s: int) -> int:
        return self.stripes[s].num_rows

    def stripe_col_stats(self, s: int, column: str
                         ) -> Optional[Tuple[Any, Any]]:
        """(min, max) for an int/double column of one stripe, or None."""
        if s >= len(self.stripe_stats):
            return None
        root = self.types[0]
        try:
            ci = root.field_names.index(column)
        except ValueError:
            return None
        col_id = root.subtypes[ci]
        stats = self.stripe_stats[s]
        if col_id >= len(stats):
            return None
        cs = stats[col_id]
        if cs.min_value is None:
            return None
        return cs.min_value, cs.max_value

    def column_distinct_strings(self, name: str) -> Optional[List[str]]:
        """Distinct values of a string column by decoding ONLY dictionary
        streams (parallel of ParquetFile.column_distinct_strings). Returns
        None when any stripe is direct-encoded — caller falls back to a
        full read."""
        root = self.types[0]
        try:
            ci = root.field_names.index(name)
        except ValueError:
            return None
        col_id = root.subtypes[ci]
        if self.types[col_id].kind not in _STR_KINDS:
            return None
        out: List[str] = []
        seen = set()
        for info in self.stripes:
            streams, encodings, dict_sizes = self._stripe_footer(info)
            if encodings[col_id] != E_DICTIONARY_V2:
                return None
            offset = info.offset + info.index_length
            blob = lens_raw = None
            for st in streams:
                if st.kind in (S_ROW_INDEX, 7, 8):
                    continue
                if st.column == col_id and st.kind in (S_DICT_DATA, S_LENGTH):
                    self.f.seek(offset)
                    raw = decompress_stream(self.codec,
                                            self.f.read(st.length))
                    if st.kind == S_DICT_DATA:
                        blob = raw
                    else:
                        lens_raw = raw
                offset += st.length
            dsz = dict_sizes[col_id]
            lens = decode_rlev2(lens_raw or b"", dsz, signed=False)
            offs = np.concatenate([[0], np.cumsum(lens)])
            blob = blob or b""
            for i in range(dsz):
                v = blob[offs[i]:offs[i + 1]].decode("utf-8", "replace")
                if v not in seen:
                    seen.add(v)
                    out.append(v)
        return out

    def _stripe_footer(self, info: StripeInfo):
        self.f.seek(info.offset + info.index_length + info.data_length)
        buf = decompress_stream(self.codec, self.f.read(info.footer_length))
        r = _PBReader(buf)
        streams: List[StreamInfo] = []
        encodings: List[int] = []
        dict_sizes: List[int] = []
        for f, wt in r.fields():
            if f == 1:
                sub = r.sub()
                st = StreamInfo()
                for f2, wt2 in sub.fields():
                    if f2 == 1:
                        st.kind = sub.varint()
                    elif f2 == 2:
                        st.column = sub.varint()
                    elif f2 == 3:
                        st.length = sub.varint()
                    else:
                        sub.skip(wt2)
                streams.append(st)
            elif f == 2:
                sub = r.sub()
                enc = 0
                dsz = 0
                for f2, wt2 in sub.fields():
                    if f2 == 1:
                        enc = sub.varint()
                    elif f2 == 2:
                        dsz = sub.varint()
                    else:
                        sub.skip(wt2)
                encodings.append(enc)
                dict_sizes.append(dsz)
            else:
                r.skip(wt)
        return streams, encodings, dict_sizes

    def read_stripe(self, s: int, columns: Sequence[str]
                    ) -> Dict[str, Tuple[np.ndarray, Optional[np.ndarray]]]:
        """-> {name: (values, null_mask_or_None)} with len == stripe rows."""
        info = self.stripes[s]
        streams, encodings, dict_sizes = self._stripe_footer(info)
        n = info.num_rows
        root = self.types[0]
        wanted = {}
        for name in columns:
            try:
                ci = root.field_names.index(name)
            except ValueError:
                raise KeyError(f"{self.path}: no column {name}") from None
            wanted[root.subtypes[ci]] = name

        # stream layout: index streams first, then data streams sequentially
        offset = info.offset + info.index_length
        chunks: Dict[Tuple[int, int], bytes] = {}
        for st in streams:
            if st.kind in (S_ROW_INDEX, 7, 8):  # row index + bloom filters
                continue                        # live in the index region
            if st.column in wanted:
                self.f.seek(offset)
                chunks[(st.column, st.kind)] = decompress_stream(
                    self.codec, self.f.read(st.length))
            offset += st.length

        out = {}
        for col_id, name in wanted.items():
            t = self.types[col_id]
            enc = encodings[col_id] if col_id < len(encodings) else E_DIRECT
            nulls = None
            present = chunks.get((col_id, S_PRESENT))
            n_present = n
            if present is not None:
                bits = decode_bool_rle(present, n)
                if not bits.all():
                    nulls = ~bits
                n_present = int(bits.sum())
            vals = self._decode_column(t, enc, chunks, col_id, n_present,
                                       dict_sizes[col_id]
                                       if col_id < len(dict_sizes) else 0)
            if nulls is not None:
                if vals.dtype == object:
                    full = np.full(n, None, dtype=object)
                else:
                    full = np.zeros(n, dtype=vals.dtype)
                full[~nulls] = vals
                vals = full
            out[name] = (vals, nulls)
        return out

    def _decode_column(self, t: OrcType, enc: int, chunks, col_id: int,
                       n: int, dict_size: int) -> np.ndarray:
        data = chunks.get((col_id, S_DATA), b"")
        if t.kind == T_BOOLEAN:
            return decode_bool_rle(data, n)
        if t.kind == T_BYTE:
            # tinyint DATA is byte RLE regardless of the column encoding
            return decode_byte_rle(data, n).astype(np.int8).astype(np.int64)
        if t.kind in _INT_KINDS:
            if enc not in (E_DIRECT_V2,):
                raise NotImplementedError(
                    f"orc integer encoding {enc} (RLEv1) not supported")
            return decode_rlev2(data, n, signed=True)
        if t.kind == T_FLOAT:
            return np.frombuffer(data, dtype="<f4", count=n)
        if t.kind == T_DOUBLE:
            return np.frombuffer(data, dtype="<f8", count=n)
        if t.kind == T_DECIMAL:
            mantissa = _decode_varint_stream(data, n)
            # SECONDARY carries per-value scales; normalize to declared scale
            scales = decode_rlev2(chunks.get((col_id, S_SECONDARY), b""),
                                  n, signed=True)
            declared = t.scale
            diff = declared - scales
            return mantissa * (10 ** diff.clip(0)) // (10 ** (-diff).clip(0))
        if t.kind in _STR_KINDS:
            if enc == E_DICTIONARY_V2:
                codes = decode_rlev2(data, n, signed=False)
                lens = decode_rlev2(chunks.get((col_id, S_LENGTH), b""),
                                    dict_size, signed=False)
                blob = chunks.get((col_id, S_DICT_DATA), b"")
                offs = np.concatenate([[0], np.cumsum(lens)])
                values = [blob[offs[i]:offs[i + 1]].decode("utf-8", "replace")
                          for i in range(dict_size)]
                arr = np.empty(n, dtype=object)
                vals_np = np.asarray(values, dtype=object)
                if n:
                    arr[:] = vals_np[codes]
                return arr
            if enc == E_DIRECT_V2:
                lens = decode_rlev2(chunks.get((col_id, S_LENGTH), b""),
                                    n, signed=False)
                offs = np.concatenate([[0], np.cumsum(lens)])
                arr = np.empty(n, dtype=object)
                for i in range(n):
                    arr[i] = data[offs[i]:offs[i + 1]].decode(
                        "utf-8", "replace")
                return arr
            raise NotImplementedError(f"orc string encoding {enc}")
        raise NotImplementedError(f"orc type kind {t.kind}")

    def close(self):
        self.f.close()
