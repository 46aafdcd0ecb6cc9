"""ORC writer of the PyTorch port: the write side of ``formats/orc.py``.

Counterpart of ``presto_tpu/formats/orc_writer.py``, ported so that the
same pages give a byte-identical file: the protobuf wire writer; ZLIB
(raw deflate) chunk framing or NONE; integer RLEv2 (DIRECT runs, zigzag
for signed), byte RLE (``encode_byte_rle``) and boolean RLE; boolean,
short/int/long, float, double, date, decimal(<=18) (varint mantissa and a
SECONDARY scale stream) and varchar (DICTIONARY_V2 with a sorted
dictionary, or DIRECT_V2) columns; PRESENT streams; and stripe-level and
file-level statistics, which the file connector's stripe pruning reads.

One difference: a decimal column's zigzag varint mantissas encode in numpy
(``_encode_varint_stream``), not one value at a time in Python; the bytes
are the reference's. ``write_orc`` takes the port's host pages through
``formats/pcol.compact_pages``.
"""
from __future__ import annotations

import struct
import zlib
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from ..block import Dictionary, Page
from ..types import (BOOLEAN, DOUBLE, REAL, DecimalType, Type, is_string)
from .orc import (E_DICTIONARY_V2, E_DIRECT, E_DIRECT_V2, K_NONE, K_ZLIB,
                  MAGIC, S_DATA, S_DICT_DATA, S_LENGTH, S_PRESENT,
                  S_SECONDARY, T_BOOLEAN, T_DATE, T_DECIMAL, T_DOUBLE,
                  T_FLOAT, T_INT, T_LONG, T_SHORT, T_STRING, T_STRUCT,
                  _WIDTH_TABLE, _closest_fixed_bits)

_STRIPE_ROWS = 1 << 20       # rows per stripe
_BLOCK_SIZE = 256 * 1024     # compression chunk size


# ---------------------------------------------------------------------------
# protobuf wire writer (mirror of orc._PBReader)
# ---------------------------------------------------------------------------

class _PBWriter:
    __slots__ = ("out",)

    def __init__(self):
        self.out = bytearray()

    def varint(self, v: int) -> None:
        while True:
            b = v & 0x7F
            v >>= 7
            if v:
                self.out.append(b | 0x80)
            else:
                self.out.append(b)
                return

    def field_varint(self, fid: int, v: int) -> None:
        self.varint(fid << 3 | 0)
        self.varint(v)

    def field_svarint(self, fid: int, v: int) -> None:
        """sint64: zigzag varint."""
        self.field_varint(fid, (v << 1) ^ (v >> 63) if v < 0 else v << 1)

    def field_double(self, fid: int, v: float) -> None:
        self.varint(fid << 3 | 1)
        self.out += struct.pack("<d", v)

    def field_bytes(self, fid: int, data: bytes) -> None:
        self.varint(fid << 3 | 2)
        self.varint(len(data))
        self.out += data

    def field_message(self, fid: int, msg: "_PBWriter") -> None:
        self.field_bytes(fid, bytes(msg.out))

    def bytes(self) -> bytes:
        return bytes(self.out)


# ---------------------------------------------------------------------------
# compression framing
# ---------------------------------------------------------------------------

def compress_stream(codec: int, data: bytes) -> bytes:
    """Apply ORC chunk framing: 3-byte headers (len << 1 | is_original)."""
    if codec == K_NONE:
        return data
    out = bytearray()
    for pos in range(0, len(data), _BLOCK_SIZE):
        chunk = data[pos:pos + _BLOCK_SIZE]
        if codec == K_ZLIB:
            comp = zlib.compress(chunk, 6)[2:-4]  # raw deflate
        else:
            raise NotImplementedError(f"orc write codec {codec}")
        if len(comp) < len(chunk):
            header = len(comp) << 1
            out += header.to_bytes(3, "little") + comp
        else:
            header = len(chunk) << 1 | 1
            out += header.to_bytes(3, "little") + chunk
    return bytes(out)


# ---------------------------------------------------------------------------
# run-length encoders
# ---------------------------------------------------------------------------

def encode_byte_rle(vals: np.ndarray) -> bytes:
    """Byte RLE: repeats of 3..130 as (run-3, byte); literals of 1..128 as
    (256-len, bytes)."""
    vals = np.ascontiguousarray(vals, dtype=np.uint8)
    n = len(vals)
    out = bytearray()
    # run boundaries: positions where the value changes
    if n == 0:
        return b""
    change = np.flatnonzero(np.diff(vals)) + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [n]])
    lit_start = None

    def flush_literals(upto: int) -> None:
        nonlocal lit_start
        if lit_start is None:
            return
        pos = lit_start
        while pos < upto:
            k = min(128, upto - pos)
            out.append(256 - k)
            out.extend(vals[pos:pos + k].tobytes())
            pos += k
        lit_start = None

    for s, e in zip(starts, ends):
        run = e - s
        if run >= 3:
            flush_literals(s)
            pos = s
            while pos < e:
                k = min(130, e - pos)
                if k < 3:  # tail too short for a repeat: literal
                    out.append(256 - k)
                    out += vals[pos:pos + k].tobytes()
                else:
                    out.append(k - 3)
                    out.append(int(vals[pos]))
                pos += k
        elif lit_start is None:
            lit_start = s
    flush_literals(n)
    return bytes(out)


def encode_bool_rle(bits: np.ndarray) -> bytes:
    """Boolean stream: bits MSB-first into bytes, then byte RLE."""
    raw = np.packbits(np.asarray(bits, dtype=bool), bitorder="big")
    return encode_byte_rle(raw)


def _pack_bits_be(vals: np.ndarray, width: int) -> bytes:
    """Pack values (uint64 bit patterns) big-endian at `width` bits."""
    v = np.ascontiguousarray(vals).astype(np.uint64, copy=False)
    shifts = np.arange(width - 1, -1, -1, dtype=np.uint64)
    bits = ((v[:, None] >> shifts) & np.uint64(1)).astype(np.uint8)
    return np.packbits(bits.ravel(), bitorder="big").tobytes()


def _width_code(width: int) -> int:
    return _WIDTH_TABLE.index(_closest_fixed_bits(max(width, 1)))


def encode_rlev2(vals: np.ndarray, signed: bool) -> bytes:
    """Integer RLEv2 as DIRECT runs of <=512 values, per-run bit width.

    DIRECT is the universally-decodable sub-format (the reader handles all
    four; the writer emits the one with vectorizable packing)."""
    vals = np.asarray(vals, dtype=np.int64)
    if signed:
        u = (vals << 1) ^ (vals >> 63)
    else:
        u = vals
    u = u.view(np.uint64) if u.dtype == np.int64 else u.astype(np.uint64)
    out = bytearray()
    for pos in range(0, len(vals), 512):
        run = u[pos:pos + 512]
        hi = int(run.max()) if len(run) else 0
        width = _closest_fixed_bits(max(hi.bit_length(), 1))
        code = _width_code(width)
        n1 = len(run) - 1
        out.append((1 << 6) | (code << 1) | (n1 >> 8))
        out.append(n1 & 0xFF)
        out += _pack_bits_be(run, width)
    return bytes(out)


def _encode_varint_stream(vals: np.ndarray) -> bytes:
    """Decimal mantissas: zigzag base-128 varints, encoded in numpy (byte k
    of a value holds bits 7k..7k+6, with 0x80 set on every byte but its
    last)."""
    v = np.asarray(vals).astype(np.int64)
    z = ((v << 1) ^ (v >> 63)).view(np.uint64)
    nbytes = np.ones(len(z), dtype=np.int64)
    for k in range(1, 10):
        nbytes += z >= (np.uint64(1) << np.uint64(7 * k))
    offs = np.cumsum(nbytes) - nbytes
    out = np.empty(int(nbytes.sum()), dtype=np.uint8)
    for k in range(10):
        sel = nbytes > k
        if not sel.any():
            break
        byte = (z[sel] >> np.uint64(7 * k)) & np.uint64(0x7F)
        more = (nbytes[sel] > k + 1).astype(np.uint64) << np.uint64(7)
        out[offs[sel] + k] = (byte | more).astype(np.uint8)
    return out.tobytes()


# ---------------------------------------------------------------------------
# column stats
# ---------------------------------------------------------------------------

class _Stats:
    """Accumulates one column's min/max/hasNull over values it sees."""

    __slots__ = ("kind", "min", "max", "has_null", "count")

    def __init__(self, kind: int):
        self.kind = kind
        self.min: Optional[Any] = None
        self.max: Optional[Any] = None
        self.has_null = False
        self.count = 0

    def update(self, data: np.ndarray, nulls: Optional[np.ndarray]) -> None:
        if nulls is not None and nulls.any():
            self.has_null = True
            data = data[~nulls]
        self.count += len(data)
        if len(data) == 0 or self.kind not in (
                T_SHORT, T_INT, T_LONG, T_DATE, T_FLOAT, T_DOUBLE):
            return
        lo, hi = data.min(), data.max()
        if self.kind in (T_FLOAT, T_DOUBLE):
            lo, hi = float(lo), float(hi)
        else:
            lo, hi = int(lo), int(hi)
        self.min = lo if self.min is None else min(self.min, lo)
        self.max = hi if self.max is None else max(self.max, hi)

    def merge(self, other: "_Stats") -> None:
        self.count += other.count
        self.has_null = self.has_null or other.has_null
        for v, pick in ((other.min, min), (other.max, max)):
            if v is None:
                continue
            if pick is min:
                self.min = v if self.min is None else min(self.min, v)
            else:
                self.max = v if self.max is None else max(self.max, v)

    def to_pb(self) -> _PBWriter:
        w = _PBWriter()
        w.field_varint(1, self.count)
        if self.min is not None:
            sub = _PBWriter()
            if self.kind in (T_FLOAT, T_DOUBLE):
                sub.field_double(1, self.min)
                sub.field_double(2, self.max)
                w.field_message(3, sub)
            else:
                sub.field_svarint(1, self.min)
                sub.field_svarint(2, self.max)
                w.field_message(2, sub)
        if self.has_null:
            w.field_varint(10, 1)
        return w


# ---------------------------------------------------------------------------
# per-column encoders
# ---------------------------------------------------------------------------

def _orc_kind(t: Type) -> int:
    if t is BOOLEAN or t.name == "boolean":
        return T_BOOLEAN
    if isinstance(t, DecimalType):
        return T_DECIMAL
    if t is DOUBLE or t.name == "double":
        return T_DOUBLE
    if t is REAL or t.name == "real":
        return T_FLOAT
    if is_string(t):
        return T_STRING
    if t.name == "date":
        return T_DATE
    if t.name == "smallint":
        return T_SHORT
    if t.name == "integer":
        return T_INT
    if t.name in ("bigint",):
        return T_LONG
    raise NotImplementedError(
        f"orc writer: type {t.name} not supported (mirrors the reader's "
        f"flat-schema scope — formats/orc.py rejects it too)")


def _encode_column(kind: int, col_id: int, data: np.ndarray,
                   nulls: Optional[np.ndarray],
                   dictionary: Optional[Dictionary],
                   t: Type) -> Tuple[List[Tuple[int, int, bytes]], int, int]:
    """-> ([(stream_kind, column, raw_bytes)], encoding, dict_size).

    `data` holds the non-null values compacted out already when nulls exist
    (the reader re-expands through PRESENT)."""
    streams: List[Tuple[int, int, bytes]] = []
    if nulls is not None and nulls.any():
        streams.append((S_PRESENT, col_id, encode_bool_rle(~nulls)))
        data = data[~nulls]
    enc = E_DIRECT
    dict_size = 0
    if kind == T_BOOLEAN:
        streams.append((S_DATA, col_id, encode_bool_rle(data.astype(bool))))
    elif kind in (T_SHORT, T_INT, T_LONG, T_DATE):
        enc = E_DIRECT_V2
        streams.append((S_DATA, col_id,
                        encode_rlev2(data.astype(np.int64), signed=True)))
    elif kind == T_FLOAT:
        streams.append((S_DATA, col_id,
                        np.ascontiguousarray(data, dtype="<f4").tobytes()))
    elif kind == T_DOUBLE:
        streams.append((S_DATA, col_id,
                        np.ascontiguousarray(data, dtype="<f8").tobytes()))
    elif kind == T_DECIMAL:
        # DIRECT_V2 so readers decode the SECONDARY scale stream as RLEv2
        enc = E_DIRECT_V2
        streams.append((S_DATA, col_id,
                        _encode_varint_stream(data.astype(np.int64))))
        scale = t.scale if isinstance(t, DecimalType) else 0
        streams.append((S_SECONDARY, col_id, encode_rlev2(
            np.full(len(data), scale, dtype=np.int64), signed=True)))
    elif kind == T_STRING:
        if dictionary is not None and hasattr(dictionary, "values"):
            # DICTIONARY_V2 with a SORTED dictionary (the hive writer's
            # layout); codes remap through the sort permutation
            enc = E_DICTIONARY_V2
            values = [str(v) for v in dictionary.values]
            order = np.argsort(np.asarray(values, dtype=object))
            remap = np.empty(len(values), dtype=np.int64)
            remap[order] = np.arange(len(values))
            svals = [values[i] for i in order]
            blobs = [s.encode("utf-8") for s in svals]
            codes = remap[np.clip(data.astype(np.int64), 0,
                                  max(len(values) - 1, 0))] \
                if len(values) else np.zeros(len(data), dtype=np.int64)
            dict_size = len(svals)
            streams.append((S_DATA, col_id,
                            encode_rlev2(codes, signed=False)))
            streams.append((S_DICT_DATA, col_id, b"".join(blobs)))
            streams.append((S_LENGTH, col_id, encode_rlev2(
                np.asarray([len(b) for b in blobs], dtype=np.int64),
                signed=False)))
        else:
            enc = E_DIRECT_V2
            blobs = [("" if v is None else str(v)).encode("utf-8")
                     for v in data]
            streams.append((S_DATA, col_id, b"".join(blobs)))
            streams.append((S_LENGTH, col_id, encode_rlev2(
                np.asarray([len(b) for b in blobs], dtype=np.int64),
                signed=False)))
    else:
        raise NotImplementedError(f"orc write kind {kind}")
    return streams, enc, dict_size


# ---------------------------------------------------------------------------
# file writer
# ---------------------------------------------------------------------------

def write_orc(path: str, names: Sequence[str], types: Sequence[Type],
              dicts: Sequence[Optional[Dictionary]],
              pages: Sequence[Page], codec: str = "zlib",
              stripe_rows: int = _STRIPE_ROWS) -> int:
    """Write pages (live rows compacted) as one ORC file; returns rows.
    Mirrors write_parquet / write_pcol's contract so the connectors' sinks
    can target any format."""
    codec_id = {"none": K_NONE, "zlib": K_ZLIB}[codec]
    ncols = len(names)
    from .pcol import compact_pages
    total, cols = compact_pages(names, types, pages)
    for c in range(ncols):
        if dicts[c] is not None and not hasattr(dicts[c], "values"):
            raise ValueError(
                f"column {names[c]}: virtual dictionaries cannot be "
                "persisted; decode before writing")
    kinds = [_orc_kind(t) for t in types]

    # column ids: 0 = root struct, 1..ncols = children
    file_stats = [_Stats(T_STRUCT)] + [_Stats(k) for k in kinds]
    stripe_stats_pb: List[_PBWriter] = []
    stripe_infos = []  # (offset, index_len, data_len, footer_len, rows)

    with open(path, "wb") as f:
        f.write(MAGIC)
        offset = len(MAGIC)
        for lo in range(0, total, stripe_rows):
            hi = min(lo + stripe_rows, total)
            n = hi - lo
            row_stats = [_Stats(T_STRUCT)] + [_Stats(k) for k in kinds]
            row_stats[0].count = n
            all_streams: List[Tuple[int, int, bytes]] = []
            encodings = [(E_DIRECT, 0)]  # root struct
            for c in range(ncols):
                data, nulls = cols[c]
                d = data[lo:hi]
                nl = None if nulls is None else nulls[lo:hi]
                row_stats[c + 1].update(d, nl)
                streams, enc, dsz = _encode_column(
                    kinds[c], c + 1, d, nl, dicts[c], types[c])
                all_streams.extend(streams)
                encodings.append((enc, dsz))
            # data region: streams ordered by (column, kind) like the reader
            # walks them (any fixed order works — lengths drive offsets)
            data_blobs = [(sk, col, compress_stream(codec_id, raw))
                          for (sk, col, raw) in all_streams]
            data_len = sum(len(b) for _, _, b in data_blobs)
            # stripe footer
            sf = _PBWriter()
            for sk, col, blob in data_blobs:
                st = _PBWriter()
                st.field_varint(1, sk)
                st.field_varint(2, col)
                st.field_varint(3, len(blob))
                sf.field_message(1, st)
            for enc, dsz in encodings:
                ce = _PBWriter()
                ce.field_varint(1, enc)
                if dsz:
                    ce.field_varint(2, dsz)
                sf.field_message(2, ce)
            footer_blob = compress_stream(codec_id, sf.bytes())
            for _, _, blob in data_blobs:
                f.write(blob)
            f.write(footer_blob)
            stripe_infos.append((offset, 0, data_len, len(footer_blob), n))
            offset += data_len + len(footer_blob)
            # roll stripe stats into file stats + metadata section
            ss = _PBWriter()
            for st_ in row_stats:
                ss.field_message(1, st_.to_pb())
            stripe_stats_pb.append(ss)
            for fs, rs in zip(file_stats, row_stats):
                fs.merge(rs)

        # metadata (stripe statistics)
        meta = _PBWriter()
        for ss in stripe_stats_pb:
            meta.field_message(1, ss)
        meta_blob = compress_stream(codec_id, meta.bytes())
        f.write(meta_blob)

        # footer
        ft = _PBWriter()
        ft.field_varint(1, len(MAGIC))          # headerLength
        ft.field_varint(2, offset)              # contentLength
        for (soff, ilen, dlen, flen, rows) in stripe_infos:
            si = _PBWriter()
            si.field_varint(1, soff)
            si.field_varint(2, ilen)
            si.field_varint(3, dlen)
            si.field_varint(4, flen)
            si.field_varint(5, rows)
            ft.field_message(3, si)
        root = _PBWriter()
        root.field_varint(1, T_STRUCT)
        for c in range(ncols):
            root.field_varint(2, c + 1)
        for c in range(ncols):
            root.field_bytes(3, names[c].encode("utf-8"))
        ft.field_message(4, root)
        for c in range(ncols):
            tp = _PBWriter()
            tp.field_varint(1, kinds[c])
            if kinds[c] == T_DECIMAL:
                t = types[c]
                tp.field_varint(5, t.precision)
                tp.field_varint(6, t.scale)
            ft.field_message(4, tp)
        ft.field_varint(6, total)               # numberOfRows
        for fs in file_stats:
            ft.field_message(7, fs.to_pb())
        ft.field_varint(8, 0)                   # rowIndexStride: no indexes
        footer_blob = compress_stream(codec_id, ft.bytes())
        f.write(footer_blob)

        # postscript (uncompressed by definition)
        ps = _PBWriter()
        ps.field_varint(1, len(footer_blob))
        ps.field_varint(2, codec_id)
        ps.field_varint(3, _BLOCK_SIZE)
        ver = _PBWriter()
        ver.varint(0)
        ver.varint(12)
        ps.field_bytes(4, ver.bytes())          # version [0,12] packed
        ps.field_varint(5, len(meta_blob))
        ps.field_varint(6, 1)                   # writerVersion
        ps.field_bytes(8000, MAGIC)
        ps_blob = ps.bytes()
        f.write(ps_blob)
        f.write(bytes([len(ps_blob)]))
    return total
