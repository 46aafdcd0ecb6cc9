"""PCOL, the engine's columnar file format, in the PyTorch port.

Counterpart of ``presto_tpu/formats/pcol.py``, with the same layout, so a
file one package writes is byte-identical to the other's and readable by
it:

- column chunks are raw little-endian arrays at 64-byte alignment: a read
  is mmap -> numpy view, with no decode;
- a dictionary varchar column stores its code array and the dictionary's
  values once;
- a JSON header carries the schema, the chunk offsets and per-column
  min/max statistics.

Layout:  magic 'PCOL1\\n' | u32 header_len | header json | padded chunks...
Header: {"rows": N, "columns": [{name, type, scale, dtype, offset, nbytes,
         nulls_offset?, dict?: [values...], min?, max?}]}

The writer takes the port's host pages (CPU tensors) or numpy arrays and the
reader hands back numpy arrays; ``PcolFile.pages`` builds host pages of CPU
tensors. The data plane (mmap, statistics) is ``native/pcol.cpp``, with the
reference's numpy path where the library cannot be built. Which reader
opened a file is counted (``pcol.native_opens``, ``pcol.numpy_opens``; the
port's own counters).
"""
from __future__ import annotations

import ctypes
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..block import Block, Dictionary, Page
from ..types import (BIGINT, BOOLEAN, DATE, DOUBLE, INTEGER, REAL, SMALLINT, TIMESTAMP,
                     VARCHAR, WIDE_VARCHAR, DecimalType, Type)
from ..utils.metrics import METRICS

MAGIC = b"PCOL1\n"
_ALIGN = 64

_TYPE_TAGS = {"bigint": BIGINT, "integer": INTEGER, "smallint": SMALLINT,
              "double": DOUBLE, "real": REAL, "boolean": BOOLEAN,
              "date": DATE, "timestamp": TIMESTAMP, "varchar": VARCHAR,
              "wide_varchar": WIDE_VARCHAR}


def _host(a) -> np.ndarray:
    """A host array's numpy view (a CPU tensor's shares its memory)."""
    if isinstance(a, torch.Tensor):
        return a.detach().numpy()
    return np.asarray(a)


def compact_pages(names: Sequence[str], types: Sequence[Type],
                  pages: Sequence[Page]) -> Tuple[int, List[Tuple[np.ndarray,
                                                                  Optional[np.ndarray]]]]:
    """Compact live rows (page mask) into one contiguous array per column
    -> (total_rows, [(data as the type's numpy dtype, bool null mask or
    None)]). A null mask comes back only when a NULL survives compaction."""
    keeps = [np.flatnonzero(_host(p.mask)) for p in pages]
    total = int(sum(len(k) for k in keeps))
    cols: List[Tuple[np.ndarray, Optional[np.ndarray]]] = []
    for c in range(len(names)):
        datas = [_host(p.blocks[c].data)[k] for p, k in zip(pages, keeps)]
        data = np.concatenate(datas) if datas else np.zeros(0, dtype=types[c].np_dtype)
        data = np.ascontiguousarray(data.astype(types[c].np_dtype, copy=False))
        nulls = None
        if any(p.blocks[c].nulls is not None for p in pages):
            nparts = [_host(p.blocks[c].null_mask())[k] for p, k in zip(pages, keeps)]
            nm = np.concatenate(nparts) if nparts else np.zeros(0, dtype=bool)
            if nm.any():
                nulls = nm
        cols.append((data, nulls))
    return total, cols


def _type_tag(t: Type) -> Tuple[str, int]:
    if isinstance(t, DecimalType):
        return "decimal", t.scale
    if t.name == "varchar" and getattr(t, "wide", False):
        return "wide_varchar", 0
    return t.name, 0


def _type_from_tag(tag: str, scale: int) -> Type:
    if tag == "decimal":
        return DecimalType(18, scale)
    return _TYPE_TAGS[tag]


def _pad(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


def row_ranges(rows: int, step: int) -> List[Tuple[int, int]]:
    """[lo, hi) row splits at ``step`` granularity: the unit of a
    split-parallel read (each range is read on its own)."""
    step = max(int(step), 1)
    return [(lo, min(lo + step, rows)) for lo in range(0, rows, step)]


def _libpcol():
    try:
        from ..native import libpcol
        return libpcol()
    except Exception:  # noqa: BLE001 - no toolchain: the numpy path
        return None


def _native_stats(arr: np.ndarray):
    """Column min/max through libpcol when it loads, else numpy."""
    lib = _libpcol()
    if lib is not None and arr.dtype in (np.int64, np.int32, np.float64) and len(arr) > 0:
        c = np.ascontiguousarray(arr)
        if arr.dtype == np.float64:
            mn, mx = ctypes.c_double(), ctypes.c_double()
            lib.pcol_stats_f64(c.ctypes.data, len(c), ctypes.byref(mn), ctypes.byref(mx))
        elif arr.dtype == np.int32:
            mn, mx = ctypes.c_int64(), ctypes.c_int64()
            lib.pcol_stats_i32(c.ctypes.data, len(c), ctypes.byref(mn), ctypes.byref(mx))
        else:
            mn, mx = ctypes.c_int64(), ctypes.c_int64()
            lib.pcol_stats_i64(c.ctypes.data, len(c), ctypes.byref(mn), ctypes.byref(mx))
        return mn.value, mx.value
    if len(arr) == 0:
        return None, None
    return np.min(arr).item(), np.max(arr).item()


def write_pcol(path: str, names: Sequence[str], types: Sequence[Type],
               dicts: Sequence[Optional[Dictionary]], pages: Sequence[Page]) -> int:
    """Write the pages' live rows as one PCOL file; returns the rows."""
    total, compacted = compact_pages(names, types, pages)
    cols = [(data, None if nulls is None else np.ascontiguousarray(nulls.astype(np.uint8)))
            for data, nulls in compacted]
    headers = []
    offset = 0  # from the start of the data section
    for c, (data, nulls) in enumerate(cols):
        tag, scale = _type_tag(types[c])
        entry: Dict = {"name": names[c], "type": tag, "scale": scale,
                       "dtype": data.dtype.str, "offset": offset, "nbytes": int(data.nbytes)}
        offset = _pad(offset + data.nbytes)
        if nulls is not None:
            entry["nulls_offset"] = offset
            offset = _pad(offset + nulls.nbytes)
        d = dicts[c]
        if d is not None:
            if not hasattr(d, "values"):
                raise ValueError(f"column {names[c]}: virtual dictionaries cannot be "
                                 "persisted; decode before writing")
            entry["dict"] = [str(v) for v in d.values]
        mn, mx = _native_stats(data) if data.dtype.kind in "if" else (None, None)
        if mn is not None:
            entry["min"], entry["max"] = mn, mx
        headers.append(entry)

    header = json.dumps({"rows": total, "columns": headers}).encode()
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(np.uint32(len(header)).tobytes())
        f.write(header)
        data_start = _pad(f.tell())
        f.write(b"\0" * (data_start - f.tell()))
        for data, nulls in cols:
            f.write(data.tobytes())
            f.write(b"\0" * (_pad(data.nbytes) - data.nbytes))
            if nulls is not None:
                f.write(nulls.tobytes())
                f.write(b"\0" * (_pad(nulls.nbytes) - nulls.nbytes))
    return total


class PcolFile:
    """Reader: a native mmap when libpcol loads, else a host read.

    ``header`` skips the JSON header's parse with one already parsed: the
    split readers of one file each open their own mapping but share one
    parse (a header with large dictionaries can be megabytes)."""

    def __init__(self, path: str, header: Optional[Dict] = None):
        self.path = path
        self._map = None
        self._lib = _libpcol()
        if self._lib is not None:
            self._map = self._lib.pcol_open(path.encode())
            if not self._map:
                self._lib = None
        if self._lib is not None:
            length = self._lib.pcol_length(self._map)
            base = self._lib.pcol_data(self._map)
            self._buf = np.ctypeslib.as_array(base, shape=(length,))
            METRICS.count("pcol.native_opens")
        else:
            self._buf = np.fromfile(path, dtype=np.uint8)
            METRICS.count("pcol.numpy_opens")
        if bytes(self._buf[:6]) != MAGIC:
            self.close()
            raise ValueError(f"{path}: not a pcol file")
        hlen = int(np.frombuffer(self._buf[6:10], dtype=np.uint32)[0])
        self.header = header if header is not None \
            else json.loads(bytes(self._buf[10:10 + hlen]))
        self.rows = self.header["rows"]
        self._data_start = _pad(10 + hlen)
        self.columns = {e["name"]: e for e in self.header["columns"]}

    def close(self) -> None:
        if self._lib is not None and self._map:
            self._lib.pcol_close(self._map)
            self._map = None
            self._lib = None

    def column_stats(self, name: str):
        e = self.columns[name]
        return e.get("min"), e.get("max")

    def read_column(self, name: str):
        """-> (data view, bool null mask or None, Dictionary or None); the
        data is a zero-copy view into the mapping."""
        return self.read_column_range(name, 0, self.rows)

    def read_column_range(self, name: str, lo: int, hi: int):
        """Rows [lo, hi) of one column, as ``read_column``: chunks are raw
        aligned arrays, so a row range is a byte range."""
        e = self.columns[name]
        dt = np.dtype(e["dtype"])
        base = self._data_start + e["offset"]
        data = self._buf[base + lo * dt.itemsize: base + hi * dt.itemsize].view(dt)
        nulls = None
        if "nulls_offset" in e:
            nlo = self._data_start + e["nulls_offset"]
            nulls = self._buf[nlo + lo: nlo + hi].view(np.uint8).astype(bool)
        d = Dictionary(e["dict"]) if "dict" in e else None
        return data, nulls, d

    def pages(self, names: Sequence[str], page_capacity: int):
        """Yield fixed-capacity host pages (CPU tensors) over the selected
        columns."""
        cols = [self.read_column(n) for n in names]
        types = [_type_from_tag(self.columns[n]["type"], self.columns[n]["scale"])
                 for n in names]
        for lo in range(0, max(self.rows, 1), page_capacity):
            hi = min(lo + page_capacity, self.rows)
            n = hi - lo
            blocks = []
            for (data, nulls, d), tt in zip(cols, types):
                seg = np.zeros(page_capacity, dtype=data.dtype)
                seg[:n] = data[lo:hi]
                nseg = None
                if nulls is not None:
                    nseg = np.zeros(page_capacity, dtype=bool)
                    nseg[:n] = nulls[lo:hi]
                    nseg = torch.from_numpy(nseg)
                blocks.append(Block(tt, torch.from_numpy(seg), nseg, d))
            yield Page(tuple(blocks), torch.arange(page_capacity) < n)
            if self.rows == 0:
                break
