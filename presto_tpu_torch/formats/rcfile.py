"""RCFile reader and writer of the PyTorch port: Hive's Record Columnar format.

Counterpart of ``presto_tpu/formats/rcfile.py``, ported as it is. The
layout follows Hive's RCFile.java:

    header:  "RCF" magic + version byte 1
             1 byte  compressed flag
             [Text codec class name]          (when compressed)
             SequenceFile.Metadata            (vint-count of Text k/v pairs;
                                               carries hive.io.rcfile.column.number)
             16-byte sync marker
    row group ("record"):
             int32 recordLen   (-1 => 16-byte sync follows, then real len)
             int32 keyLength
             int32 compressedKeyLength
             key buffer (compressed when codec set):
                 vint rowCount
                 per column: vint valueBytes (on-disk), vint uncompressedBytes,
                             vint keySectionLen, then keySectionLen bytes of
                             per-row cell lengths as RUN-LENGTH vints
                             (a negative vint -v means "previous length
                             repeats v MORE times")
             value buffer: per column, valueBytes bytes (per-column
                 compressed when codec set) - cells back to back.

Cells are the TEXT representation (ColumnarSerDe: numbers as ASCII, dates
ISO, ``\\N`` = NULL), decoded into typed columns one cell at a time
(``decode_cells``), as the reference does; RCFile is ingest-only in the file
catalog. Compression supports the DefaultCodec (zlib/deflate) and
uncompressed files. Hadoop vints follow WritableUtils.writeVLong.
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..types import (DecimalType, Type, is_string)

MAGIC = b"RCF"
VERSION = 1
DEFLATE_CODEC = "org.apache.hadoop.io.compress.DefaultCodec"
COLUMN_NUMBER_KEY = "hive.io.rcfile.column.number"
NULL_TEXT = b"\\N"
import re as _re

#: cells that need (had) NULL escaping: one or more backslashes then N
_SENTINEL_FAMILY = _re.compile(rb"\\+N")


# ------------------------------------------------------------- hadoop vints

def write_vlong(v: int) -> bytes:
    """WritableUtils.writeVLong."""
    if -112 <= v <= 127:
        return struct.pack("b", v)
    length = -112
    if v < 0:
        v = ~v
        length = -120
    tmp = v
    while tmp != 0:
        tmp >>= 8
        length -= 1
    out = struct.pack("b", length)
    length = -(length + 120) if length < -120 else -(length + 112)
    for idx in range(length - 1, -1, -1):
        out += bytes([(v >> (8 * idx)) & 0xFF])
    return out


class _Cursor:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def read(self, n: int) -> bytes:
        b = self.buf[self.pos:self.pos + n]
        if len(b) != n:
            raise EOFError("truncated rcfile")
        self.pos += n
        return b

    def read_vlong(self) -> int:
        first = struct.unpack("b", self.read(1))[0]
        if first >= -112:
            return first
        negative = first < -120
        length = -(first + 120) if negative else -(first + 112)
        v = 0
        for b in self.read(length):
            v = (v << 8) | b
        return ~v if negative else v

    def read_int(self) -> int:
        return struct.unpack(">i", self.read(4))[0]

    def read_text(self) -> str:
        n = self.read_vlong()
        return self.read(n).decode("utf-8")


# ------------------------------------------------------------------ writer

def write_rcfile(path: str, columns: Sequence[Sequence[Optional[str]]],
                 rows_per_group: int = 4096, compress: bool = True) -> None:
    """Write text-serde cell values (None = NULL) as an RCFile."""
    ncols = len(columns)
    nrows = len(columns[0]) if ncols else 0
    sync = bytes((7 * i + 13) % 256 for i in range(16))  # fixed, arbitrary

    def codec(data: bytes) -> bytes:
        return zlib.compress(data, 6) if compress else data

    out = bytearray()
    out += MAGIC + bytes([VERSION])
    out += bytes([1 if compress else 0])
    if compress:
        enc = DEFLATE_CODEC.encode()
        out += write_vlong(len(enc)) + enc
    # SequenceFile.Metadata: int32 count, then Text/Text pairs
    meta = {COLUMN_NUMBER_KEY: str(ncols)}
    out += struct.pack(">i", len(meta))
    for k, v in meta.items():
        ke, ve = k.encode(), v.encode()
        out += write_vlong(len(ke)) + ke + write_vlong(len(ve)) + ve
    out += sync

    for lo in range(0, max(nrows, 1), rows_per_group):
        hi = min(lo + rows_per_group, nrows)
        n = hi - lo
        if n <= 0 and nrows > 0:
            break
        col_cells = []
        for c in range(ncols):
            cells = []
            for v in columns[c][lo:hi]:
                if v is None:
                    cells.append(NULL_TEXT)
                else:
                    b = str(v).encode("utf-8")
                    # injective NULL escaping: any \...\N-shaped cell gains
                    # one leading backslash so the sentinel never collides
                    # with data (unescaping strips exactly one)
                    if _SENTINEL_FAMILY.fullmatch(b):
                        b = b"\\" + b
                    cells.append(b)
            col_cells.append(cells)
        key = bytearray(write_vlong(n))
        values = bytearray()
        for cells in col_cells:
            raw = b"".join(cells)
            disk = codec(raw)
            lengths = bytearray()
            prev, run = None, 0
            for cell in cells:
                ln = len(cell)
                if ln == prev:
                    run += 1
                else:
                    if run:
                        lengths += write_vlong(-run)
                    lengths += write_vlong(ln)
                    prev, run = ln, 0
            if run:
                lengths += write_vlong(-run)
            key += write_vlong(len(disk))
            key += write_vlong(len(raw))
            key += write_vlong(len(lengths))
            key += bytes(lengths)
            values += disk
        key_raw = bytes(key)
        key_disk = codec(key_raw)
        record_len = 4 + 4 + len(key_disk) + len(values)
        out += struct.pack(">i", -1) + sync
        out += struct.pack(">i", record_len)
        out += struct.pack(">i", len(key_raw))
        out += struct.pack(">i", len(key_disk))
        out += key_disk + values
        if nrows == 0:
            break
    with open(path, "wb") as f:
        f.write(bytes(out))


# ------------------------------------------------------------------ reader

class RcFile:
    """Row groups of text-serde cells; column-pruned, typed decoding."""

    def __init__(self, path: str):
        import mmap

        self.path = path
        # mmap, not read(): the index walk touches only record headers and
        # key buffers; value bytes page in lazily when a scan reads them
        self._file = open(path, "rb")
        try:
            self._buf = mmap.mmap(self._file.fileno(), 0,
                                  access=mmap.ACCESS_READ)
        except ValueError:  # empty file
            self._buf = b""
        cur = _Cursor(self._buf)
        if cur.read(3) != MAGIC:
            raise ValueError(f"{path}: not an RCFile (bad magic)")
        version = cur.read(1)[0]
        if version > 1:
            raise ValueError(f"{path}: unsupported RCFile version {version}")
        self.compressed = cur.read(1)[0] == 1
        if self.compressed:
            codec = cur.read_text()
            if codec != DEFLATE_CODEC:
                raise ValueError(f"{path}: unsupported codec {codec} "
                                 f"(DefaultCodec/deflate only)")
        self.metadata: Dict[str, str] = {}
        for _ in range(cur.read_int()):
            k = cur.read_text()
            v = cur.read_text()
            self.metadata[k] = v
        self.n_columns = int(self.metadata.get(COLUMN_NUMBER_KEY, "0"))
        self.sync = cur.read(16)
        # index the row groups once (offsets + row counts)
        self._groups: List[Tuple[int, int]] = []  # (offset of recordLen, rows)
        self.num_rows = 0
        pos = cur.pos
        while pos < len(self._buf):
            cur.pos = pos
            rec = cur.read_int()
            if rec == -1:
                if cur.read(16) != self.sync:
                    raise ValueError(f"{path}: bad sync marker")
                pos = cur.pos
                continue
            start = cur.pos - 4
            cur.read_int()  # keyLength (uncompressed)
            klen_disk = cur.read_int()
            key = self._decode(cur.read(klen_disk))
            kc = _Cursor(key)
            rows = kc.read_vlong()
            self._groups.append((start, rows))
            self.num_rows += rows
            pos = start + 4 + rec  # recordLen covers key hdr + key + values
        self.n_groups = len(self._groups)

    def _decode(self, data: bytes) -> bytes:
        return zlib.decompress(data) if self.compressed else data

    def group_rows(self, g: int) -> int:
        return self._groups[g][1]

    def read_group(self, g: int, wanted: Sequence[int]
                   ) -> Dict[int, List[Optional[bytes]]]:
        """-> {column index: list of raw cell bytes (None = NULL)} — only
        `wanted` columns are decompressed (RCFile's lazy column skip)."""
        start, rows = self._groups[g]
        cur = _Cursor(self._buf, start)
        cur.read_int()  # recordLen
        cur.read_int()  # keyLength
        klen_disk = cur.read_int()
        key = self._decode(cur.read(klen_disk))
        kc = _Cursor(key)
        n = kc.read_vlong()
        assert n == rows
        cols_meta = []
        for _c in range(self.n_columns):
            disk_len = kc.read_vlong()
            raw_len = kc.read_vlong()
            sect_len = kc.read_vlong()
            sect = _Cursor(kc.read(sect_len))
            lengths: List[int] = []
            while len(lengths) < rows:
                v = sect.read_vlong()
                if v < 0:
                    lengths.extend([lengths[-1]] * (-v))
                else:
                    lengths.append(v)
            cols_meta.append((disk_len, raw_len, lengths))
        want = set(wanted)
        out: Dict[int, List[Optional[bytes]]] = {}
        vpos = cur.pos
        for c, (disk_len, _raw_len, lengths) in enumerate(cols_meta):
            if c in want:
                raw = self._decode(self._buf[vpos:vpos + disk_len])
                cells: List[Optional[bytes]] = []
                o = 0
                for ln in lengths:
                    cell = raw[o:o + ln]
                    o += ln
                    if cell == NULL_TEXT:
                        cells.append(None)
                    elif _SENTINEL_FAMILY.fullmatch(cell):
                        cells.append(cell[1:])  # strip the escape backslash
                    else:
                        cells.append(cell)
                out[c] = cells
            vpos += disk_len
        return out


_OPEN_CACHE: Dict[tuple, "RcFile"] = {}
_OPEN_LOCK = __import__("threading").Lock()


def open_rcfile(path: str) -> "RcFile":
    """Signature-cached open: the connector constructs a reader per split
    and RcFile.__init__ walks + key-decompresses the group index — the
    cache makes a G-group scan index once, not G+1 times. Buffers are
    mmap-backed (page cache, not heap), so cached entries pin only the
    index, and construction happens OUTSIDE the lock."""
    import os

    st = os.stat(path)
    key = (path, st.st_mtime, st.st_size)
    with _OPEN_LOCK:
        f = _OPEN_CACHE.get(key)
    if f is not None:
        return f
    f = RcFile(path)
    with _OPEN_LOCK:
        cur = _OPEN_CACHE.get(key)
        if cur is not None:
            return cur
        stale = [k for k in _OPEN_CACHE if k[0] == path]
        for k in stale:
            del _OPEN_CACHE[k]
        while len(_OPEN_CACHE) > 16:
            del _OPEN_CACHE[next(iter(_OPEN_CACHE))]
        _OPEN_CACHE[key] = f
    return f


class RcTableFile:
    """File-connector adapter (_ExternalFile shape): one chunk per row
    group. The text serde carries NO types, so a sidecar ``<path>.schema``
    JSON (``{"columns": [[name, type_tag, scale], ...]}``) plays the hive
    metastore's role; ``write_rcfile_table`` emits both."""

    def __init__(self, path: str):
        import json

        from .pcol import _type_from_tag

        self.path = path
        self._f = open_rcfile(path)
        with open(path + ".schema") as f:
            doc = json.load(f)
        self.schema = [(n, _type_from_tag(tag, scale))
                       for n, tag, scale in doc["columns"]]
        if len(self.schema) != self._f.n_columns:
            raise ValueError(
                f"{path}: sidecar schema has {len(self.schema)} columns, "
                f"file has {self._f.n_columns}")
        self.num_rows = self._f.num_rows
        self.n_chunks = self._f.n_groups

    def chunk_rows(self, g: int) -> int:
        return self._f.group_rows(g)

    def chunk_stats(self, g: int, col: str):
        return None  # text cells carry no statistics

    def read_chunk(self, g: int, names: Sequence[str]):
        index = {n: i for i, (n, _t) in enumerate(self.schema)}
        wanted = [index[n] for n in names]
        raw = self._f.read_group(g, wanted)
        out = {}
        for n in names:
            i = index[n]
            out[n] = decode_cells(raw[i], self.schema[i][1])
        return out

    def column_distinct_strings(self, name: str):
        return None  # no dictionary pages: the loader decodes the column

    def close(self):
        pass


def write_rcfile_table(path: str, names: Sequence[str],
                       types: Sequence[Type],
                       columns: Sequence[Sequence[Optional[str]]],
                       rows_per_group: int = 4096,
                       compress: bool = True) -> None:
    """RCFile + the sidecar schema the engine's reader needs."""
    import json

    from .pcol import _type_tag

    write_rcfile(path, columns, rows_per_group, compress)
    with open(path + ".schema", "w") as f:
        json.dump({"columns": [[n, *_type_tag(t)]
                               for n, t in zip(names, types)]}, f)


def decode_cells(cells: Sequence[Optional[bytes]], t: Type
                 ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Text cells -> (typed values, null mask). String columns return a
    dtype=object array of str (the caller dictionary-encodes)."""
    n = len(cells)
    nulls = np.fromiter((c is None for c in cells), dtype=np.bool_, count=n)
    if not nulls.any():
        nulls = None
    if is_string(t):
        vals = np.array(["" if c is None else c.decode("utf-8")
                         for c in cells], dtype=object)
        return vals, nulls
    arr = np.zeros(n, dtype=t.np_dtype)
    for i, c in enumerate(cells):
        if c is None:
            continue
        s = c.decode("ascii")
        if isinstance(t, DecimalType):
            from decimal import Decimal
            arr[i] = int(Decimal(s).scaleb(t.scale))
        elif t.name == "date":
            import datetime
            d = datetime.date.fromisoformat(s)
            arr[i] = (d - datetime.date(1970, 1, 1)).days
        elif t.name == "timestamp":
            import datetime
            dt = datetime.datetime.fromisoformat(s)
            arr[i] = int((dt - datetime.datetime(1970, 1, 1)
                          ).total_seconds() * 1000)
        elif t.name == "boolean":
            arr[i] = s.lower() in ("true", "1")
        elif t.name in ("double", "real"):
            arr[i] = float(s)
        else:
            arr[i] = int(s)
    return arr, nulls
