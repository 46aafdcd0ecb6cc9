"""Page wire format of the cluster's data plane: the ``PSER1`` frame.

The port's copy of ``presto_tpu/cluster/serde.py``, frame for frame: the
same header, column order, dtypes, null bitmaps and codec choice, so either
package reads the other's frames. A batch of pages becomes ONE columnar
frame: dead (masked-off) rows are dropped producer-side, each column's dense
little-endian bytes are concatenated and zlib-compressed per frame (level 1)
when that wins.

Frame layout:
    magic 'PSER1'  | u32 header_len | header json | column payload...
Header: {"rows": N, "cols": [{"dtype": str, "nbytes": int, "nulls": bool}],
         "codec": "zlib1" | "raw"}
Payload: for each column, data bytes then (if nulls) a packed null bitmap.

Types and dictionaries do not ride the wire: both ends plan the same
fragment and agree on the schema (``cluster/task.plan_subplan``). A column
whose dictionary is filled at run time (the ARRAY/MAP handles of a
collecting aggregate, ``block.ArrayValues``) has no plan-time meaning on the
other end, so ``pages_to_columns`` refuses it instead of shipping handles.

Device pages: ``pages_to_columns`` gathers the live rows where the pages lie
and copies each column to the host once per call (its data, and its null
flags when it has any), never once per page. ``columns_to_pages`` builds
host pages (CPU tensors); the consuming task's scan uploads each of them
once.
"""
from __future__ import annotations

import json
import struct
import zlib
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..block import ArrayValues, Block, Dictionary, Page
from ..types import Type

MAGIC = b"PSER1"


def _check_wire(pages: Sequence[Page], ncols: int) -> None:
    for p in pages:
        for c in range(ncols):
            if isinstance(p.blocks[c].dictionary, ArrayValues):
                raise NotImplementedError(
                    f"column {c} holds {p.blocks[c].dictionary!r} handles, which have no "
                    f"meaning outside this task: ARRAY/MAP columns cannot cross the page wire")


def pages_to_columns(pages: Sequence[Page], types: Sequence[Type],
                     rows: Optional[torch.Tensor] = None) -> tuple:
    """Concat pages, drop masked rows -> (datas, nulls, nrows) on the host.

    ``rows``, when given, are the positions (into the pages' concatenation)
    to keep, in the order to keep them; by default every live row in page
    order. One device -> host copy per column (plus one for its null flags)."""
    ncols = len(types)
    if not pages:
        return ([np.zeros(0, dtype=np.dtype(t.np_dtype)) for t in types], [None] * ncols, 0)
    _check_wire(pages, ncols)

    def cat(ts):
        return ts[0] if len(ts) == 1 else torch.cat(ts)

    if rows is None:
        rows = torch.nonzero(cat([p.mask for p in pages])).squeeze(1)
    datas: List[np.ndarray] = []
    nulls: List[Optional[np.ndarray]] = []
    for c in range(ncols):
        dt = np.dtype(types[c].np_dtype)
        col = cat([p.blocks[c].data for p in pages])[rows].cpu().numpy()
        datas.append(np.ascontiguousarray(col.astype(dt, copy=False)))
        if any(p.blocks[c].nulls is not None for p in pages):
            nm = cat([p.blocks[c].nulls if p.blocks[c].nulls is not None
                      else torch.zeros(p.capacity, dtype=torch.bool, device=p.mask.device)
                      for p in pages])[rows].cpu().numpy()
            nulls.append(nm if nm.any() else None)
        else:
            nulls.append(None)
    return datas, nulls, int(rows.shape[0])


def serialize_columns(datas: Sequence[np.ndarray],
                      nulls: Sequence[Optional[np.ndarray]],
                      nrows: int, compress: bool = True) -> bytes:
    cols_meta = []
    payload = bytearray()
    for data, nm in zip(datas, nulls):
        raw = data.tobytes()
        cols_meta.append({"dtype": data.dtype.str, "nbytes": len(raw),
                          "nulls": nm is not None})
        payload += raw
        if nm is not None:
            payload += np.packbits(nm).tobytes()
    body = bytes(payload)
    codec = "raw"
    if compress and len(body) > 512:
        z = zlib.compress(body, 1)
        if len(z) < len(body):
            body, codec = z, "zlib1"
    header = json.dumps({"rows": nrows, "cols": cols_meta,
                         "codec": codec}).encode()
    frame = MAGIC + struct.pack("<I", len(header)) + header + body
    from ..utils.metrics import METRICS
    METRICS.count("exchange.frames")
    METRICS.count("exchange.bytes", len(frame))
    METRICS.count("exchange.rows", nrows)
    return frame


def serialize_pages(pages: Sequence[Page], types: Sequence[Type],
                    compress: bool = True) -> bytes:
    datas, nulls, nrows = pages_to_columns(pages, types)
    return serialize_columns(datas, nulls, nrows, compress)


def deserialize_columns(frame: bytes) -> tuple:
    """-> (datas, nulls, nrows); inverse of serialize_columns."""
    if frame[:5] != MAGIC:
        raise ValueError("bad page frame magic")
    (hlen,) = struct.unpack_from("<I", frame, 5)
    header = json.loads(frame[9:9 + hlen].decode())
    body = frame[9 + hlen:]
    if header["codec"] == "zlib1":
        body = zlib.decompress(body)
    nrows = header["rows"]
    datas, nulls = [], []
    off = 0
    for cm in header["cols"]:
        dt = np.dtype(cm["dtype"])
        datas.append(np.frombuffer(body, dtype=dt, count=cm["nbytes"] // dt.itemsize,
                                   offset=off).copy())
        off += cm["nbytes"]
        if cm["nulls"]:
            nbytes = (nrows + 7) // 8
            bits = np.frombuffer(body, dtype=np.uint8, count=nbytes, offset=off)
            nulls.append(np.unpackbits(bits)[:nrows].astype(bool))
            off += nbytes
        else:
            nulls.append(None)
    return datas, nulls, nrows


def _pad(arr: np.ndarray, length: int) -> np.ndarray:
    if len(arr) >= length:
        return arr
    return np.concatenate([arr, np.zeros(length - len(arr), dtype=arr.dtype)])


def columns_to_pages(datas: Sequence[np.ndarray],
                     nulls: Sequence[Optional[np.ndarray]], nrows: int,
                     types: Sequence[Type],
                     dicts: Sequence[Optional[Dictionary]],
                     page_capacity: int) -> List[Page]:
    """Re-page received columns at pow2 capacities (at most
    ``page_capacity``), as host pages of CPU tensors."""
    if nrows == 0:
        return []
    cap = min(page_capacity, 1 << (nrows - 1).bit_length())
    out: List[Page] = []
    for lo in range(0, nrows, cap):
        hi = min(lo + cap, nrows)
        blocks = []
        for c, t in enumerate(types):
            nm = nulls[c]
            nm_slice = _pad(nm[lo:hi], cap) if nm is not None else None
            if nm_slice is not None and not nm_slice.any():
                nm_slice = None
            data = np.ascontiguousarray(_pad(datas[c][lo:hi], cap))
            blocks.append(Block(t, torch.from_numpy(data),
                                None if nm_slice is None else torch.from_numpy(
                                    np.ascontiguousarray(nm_slice)),
                                dicts[c] if dicts else None))
        out.append(Page(tuple(blocks),
                        torch.from_numpy(_pad(np.ones(hi - lo, dtype=bool), cap))))
    return out


def deserialize_pages(frame: bytes, types: Sequence[Type],
                      dicts: Sequence[Optional[Dictionary]],
                      page_capacity: int) -> List[Page]:
    datas, nulls, nrows = deserialize_columns(frame)
    return columns_to_pages(datas, nulls, nrows, types, dicts, page_capacity)
