"""Columnar data substrate of the PyTorch port: Dictionary, Block and Page.

Counterpart of ``presto_tpu/block.py``. A Block is one dense tensor (plus an
optional bool null mask and an optional host-side string dictionary); a Page
is a tuple of equal-capacity Blocks plus a bool row mask, padded to a fixed
capacity. The tensors live on whatever device the scan uploaded them to;
every function here runs on the tensors' own device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import resolve_device
from .types import VARCHAR, DateType, DecimalType, Type, is_string


def torch_dtype(t: Type) -> torch.dtype:
    """Tensor dtype of a SQL type's column (``Type.np_dtype`` mapped 1:1)."""
    return _NP_TO_TORCH[np.dtype(t.np_dtype)]


_NP_TO_TORCH = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.complex128): torch.complex128,  # GEOMETRY points (x + iy)
}


class Dictionary:
    """Host-side string dictionary shared by the varchar blocks of one column.

    Identity-hashed, like the reference's: two dictionaries are the same
    dictionary only if they are the same object.
    """

    __slots__ = ("values", "_index", "_ranks", "_order", "_sorted", "_token",
                 "_tables")

    def __init__(self, values: Sequence[str]):
        self.values = np.asarray(values, dtype=object)
        self._index = None
        self._ranks = None
        self._sorted = None

    def token(self) -> int:
        """Process-unique identity for cache keys (``utils/kernel_cache``),
        drawn at first use: subclasses may skip ``__init__``."""
        t = getattr(self, "_token", None)
        if t is None:
            from .utils.kernel_cache import new_token

            t = self._token = new_token()
        return t

    def __len__(self):
        return len(self.values)

    def index(self) -> dict:
        if self._index is None:
            self._index = {v: i for i, v in enumerate(self.values)}
        return self._index

    def code_of(self, value: str) -> int:
        """Code for value, or -1 if absent (comparisons against it are then const-false)."""
        return self.index().get(value, -1)

    def codes_where(self, predicate) -> np.ndarray:
        """Host-side predicate over dictionary entries -> int32 array of matching codes."""
        return np.asarray([i for i, v in enumerate(self.values) if predicate(v)], dtype=np.int32)

    def lookup(self, codes: np.ndarray) -> np.ndarray:
        out = np.empty(len(codes), dtype=object)
        mask = codes >= 0
        out[mask] = self.values[codes[mask]]
        out[~mask] = None
        return out

    def extend(self, values: Sequence) -> List[int]:
        """Codes for ``values``, appending the entries this dictionary lacks
        (INSERT re-encoding into a table's private dictionary). Existing
        codes never change; the reverse index stays valid, and the ranks
        and ``is_sorted`` caches are re-derived at the new length."""
        pos = self.index()
        out = []
        new_vals = None
        for v in values:
            code = pos.get(v)
            if code is None:
                if new_vals is None:
                    new_vals = list(self.values)
                code = len(new_vals)
                new_vals.append(v)
                pos[v] = code
            out.append(code)
        if new_vals is not None:
            self.values = _object_array(new_vals)
            self._index = pos
        return out

    def sort_keys(self) -> np.ndarray:
        """Rank of each code in lexicographic order, for ORDER BY on varchar."""
        if self._ranks is None or len(self._ranks) != len(self.values):
            order = np.argsort(self.values.astype(str), kind="stable")
            ranks = np.empty(len(self.values), dtype=np.int32)
            ranks[order] = np.arange(len(self.values), dtype=np.int32)
            self._ranks = ranks
            self._order = order.astype(np.int32)
        return self._ranks

    def sort_order(self) -> np.ndarray:
        """Inverse of ``sort_keys``: rank -> code."""
        self.sort_keys()
        return self._order

    def sort_table(self, which: str, device) -> torch.Tensor:
        """``sort_keys()`` ("ranks") or ``sort_order()`` ("order") as an
        int32 tensor on ``device``, copied there once per device and
        dictionary size."""
        arr = self.sort_keys() if which == "ranks" else self.sort_order()
        tables = getattr(self, "_tables", None)
        if tables is None:
            tables = self._tables = {}
        key = (which, torch.device(device), len(arr))
        if key not in tables:
            tables[key] = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.int32)).to(device)
        return tables[key]

    def is_sorted(self) -> bool:
        """True when the codes are the lexicographic ranks, so that min/max
        may reduce codes directly."""
        if self._sorted is None or self._sorted[1] != len(self.values):
            v = self.values.astype(str)
            ok = bool(np.all(v[:-1] <= v[1:])) if len(v) > 1 else True
            self._sorted = (ok, len(self.values))
        return self._sorted[0]

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other

    def __repr__(self):
        return f"Dictionary({len(self.values)} entries)"


def _object_array(values: Sequence) -> np.ndarray:
    """A 1-D object array of ``values`` (tuples stay elements, never a
    second dimension)."""
    arr = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        arr[i] = v
    return arr


class ArrayValues(Dictionary):
    """Host store of ragged ARRAY/MAP values behind int32 handles (the
    reference's ``block.ArrayValues``): the collecting aggregates install
    each group's values here at the output boundary, and the column holds
    the handles, as a varchar column holds dictionary codes. ``mode``
    picks the decoding: "array" gives lists, "map" dicts. Entries are
    tuples (a map's of (key, value) pairs), so equal values share a
    handle through the inherited index."""

    def __init__(self, mode: str = "array"):
        super().__init__([])
        self.mode = mode

    def lookup(self, codes: np.ndarray) -> np.ndarray:
        out = np.empty(len(codes), dtype=object)
        for i, c in enumerate(np.asarray(codes, dtype=np.int64)):
            if c < 0:
                out[i] = None
            elif self.mode == "map":
                out[i] = dict(self.values[c])
            else:
                out[i] = list(self.values[c])
        return out

    def __repr__(self):
        return f"ArrayValues({len(self.values)} {self.mode} entries)"


@dataclasses.dataclass
class Block:
    """One column: dense tensor + optional null mask + optional dictionary."""

    type: Type
    data: torch.Tensor
    nulls: Optional[torch.Tensor] = None  # True where NULL; None == no nulls
    dictionary: Optional[Dictionary] = None

    def null_mask(self) -> torch.Tensor:
        if self.nulls is None:
            return torch.zeros(self.data.shape[0], dtype=torch.bool,
                               device=self.data.device)
        return self.nulls


@dataclasses.dataclass
class Page:
    """A batch of rows: equal-capacity blocks + row-validity mask."""

    blocks: Tuple[Block, ...]
    mask: torch.Tensor  # bool (capacity,)

    @property
    def capacity(self) -> int:
        return int(self.mask.shape[0])

    @property
    def device(self) -> torch.device:
        return self.mask.device

    def select_channels(self, channels: Sequence[int]) -> "Page":
        return Page(tuple(self.blocks[c] for c in channels), self.mask)

    def accounted_bytes(self) -> int:
        """The page's bytes as the memory accounting counts them: the mask,
        each block's data and null flags, from capacity and dtype alone (no
        device read)."""
        rows = self.capacity
        total = rows
        for b in self.blocks:
            total += rows * b.data.element_size()
            if b.nulls is not None:
                total += rows
        return total

    def to_host(self) -> "Page":
        """The page copied to host RAM (a revocation's move)."""
        def host(t):
            return None if t is None else t.cpu()
        return Page(tuple(Block(b.type, host(b.data), host(b.nulls), b.dictionary)
                          for b in self.blocks), host(self.mask))

    def with_mask(self, mask: torch.Tensor) -> "Page":
        return Page(self.blocks, mask)

    def to_pylists(self) -> List[list]:
        """Rows of decoded Python values (host side). Live rows are gathered
        where the page lies, so only they cross to the host. A dictionary
        column decodes through its dictionary: strings, or the lists and
        dicts of an ``ArrayValues`` handle column."""
        idx = torch.nonzero(self.mask).squeeze(1)
        cols = []
        for b in self.blocks:
            arr = b.data[idx].cpu().numpy()
            # only non-NULL rows are decoded: a NULL row's data is whatever
            # its operator left there (a min/max identity, say)
            keep = ~b.nulls[idx].cpu().numpy() if b.nulls is not None else \
                np.ones(len(arr), dtype=bool)
            vals = np.full(len(arr), None, dtype=object)
            if b.dictionary is not None:
                vals[keep] = b.dictionary.lookup(arr[keep].astype(np.int64))
            else:
                vals[keep] = [b.type.to_python(v) for v in arr[keep]]
            cols.append(list(vals))
        return [list(row) for row in zip(*cols)] if cols else []


def _compact(page: Page) -> Page:
    """Pack live rows to the front; same capacity, prefix mask
    (``presto_tpu/block.py`` ``_compact``: cumsum target + dropping scatter)."""
    mask = page.mask
    cap = mask.shape[0]
    live = torch.nonzero(mask).squeeze(1)
    n = live.shape[0]
    new_blocks = []
    for b in page.blocks:
        out = torch.zeros_like(b.data)
        out[:n] = b.data[live]
        nulls = None
        if b.nulls is not None:
            nulls = torch.zeros(cap, dtype=torch.bool, device=mask.device)
            nulls[:n] = b.nulls[live]
        new_blocks.append(Block(b.type, out, nulls, b.dictionary))
    new_mask = torch.arange(cap, device=mask.device) < n
    return Page(tuple(new_blocks), new_mask)


def block_from_numpy(type_: Type, arr: np.ndarray, dictionary: Optional[Dictionary] = None,
                     nulls: Optional[np.ndarray] = None, device="cuda") -> Block:
    """A host array (cast to the type's dtype) as a block on ``device``."""
    device = resolve_device(device)
    arr = np.ascontiguousarray(arr, dtype=type_.np_dtype)
    mask = None if nulls is None else \
        torch.from_numpy(np.ascontiguousarray(nulls, dtype=np.bool_)).to(device)
    return Block(type_, torch.from_numpy(arr).to(device), mask, dictionary)


def block_from_strings(values: Sequence[Optional[str]], type_: Type = VARCHAR,
                       dictionary: Optional[Dictionary] = None) -> Block:
    """Dictionary-encode Python strings into a host varchar block (int32
    codes on the CPU; a new dictionary of the sorted distinct values unless
    one is given). NULLs get code 0 under the null mask."""
    if dictionary is None:
        dictionary = Dictionary(sorted({v for v in values if v is not None}))
    index = dictionary.index()
    codes = np.fromiter(((index[v] if v is not None else 0) for v in values),
                        dtype=np.int32, count=len(values))
    nulls = None
    if any(v is None for v in values):
        nulls = torch.from_numpy(np.fromiter((v is None for v in values), dtype=np.bool_,
                                             count=len(values)))
    return Block(type_, torch.from_numpy(codes), nulls, dictionary)


def page_from_arrays(types: Sequence[Type], arrays: Sequence[np.ndarray],
                     dictionaries: Optional[Sequence[Optional[Dictionary]]] = None,
                     count: Optional[int] = None, capacity: Optional[int] = None,
                     device="cuda") -> Page:
    """Build a page from host arrays, padding to capacity, on ``device``."""
    device = resolve_device(device)
    n = int(np.asarray(arrays[0]).shape[0]) if arrays else 0
    if count is None:
        count = n
    cap = capacity or n
    blocks = []
    for i, (t, a) in enumerate(zip(types, arrays)):
        a = np.asarray(a)
        if a.dtype != t.np_dtype:
            a = a.astype(t.np_dtype)
        if cap > n:
            a = np.concatenate([a, np.zeros(cap - n, dtype=a.dtype)])
        d = dictionaries[i] if dictionaries else None
        blocks.append(Block(t, torch.from_numpy(np.ascontiguousarray(a)).to(device),
                            None, d))
    mask = torch.arange(cap, device=device) < count
    return Page(tuple(blocks), mask)


def page_from_pylists(types: Sequence[Type], rows: Iterable[Sequence[Any]],
                      dictionaries: Optional[Sequence[Optional[Dictionary]]] = None,
                      capacity: Optional[int] = None, device="cuda") -> Page:
    """Rows of Python values -> a page on ``device``, padded to ``capacity``
    (the reference's test helper, presto-main's RowPagesBuilder). DECIMAL
    values are rounded to the type's scale, dates become days since
    1970-01-01, strings are dictionary-encoded (a new sorted dictionary
    unless one is given)."""
    import datetime

    device = resolve_device(device)
    rows = list(rows)
    n = len(rows)
    cap = capacity or max(n, 1)
    cols = list(zip(*rows)) if rows else [[] for _ in types]
    blocks = []
    for i, t in enumerate(types):
        vals = list(cols[i])
        d = dictionaries[i] if dictionaries else None
        if is_string(t):
            b = block_from_strings(vals + [None] * (cap - n), t, d)
            blocks.append(Block(t, b.data.to(device),
                                None if b.nulls is None else b.nulls.to(device), b.dictionary))
            continue
        conv = []
        for v in vals:
            if v is None:
                conv.append(0)
            elif isinstance(t, DecimalType):
                conv.append(round(float(v) * 10 ** t.scale))
            elif isinstance(t, DateType):
                conv.append((v - datetime.date(1970, 1, 1)).days
                            if isinstance(v, datetime.date) else int(v))
            else:
                conv.append(v)
        arr = np.zeros(cap, dtype=t.np_dtype)
        arr[:n] = np.asarray(conv, dtype=t.np_dtype) if conv else []
        nulls = np.zeros(cap, dtype=np.bool_)
        nulls[:n] = [v is None for v in vals]
        blocks.append(block_from_numpy(t, arr, None, nulls if nulls.any() else None, device))
    return Page(tuple(blocks), torch.arange(cap, device=device) < n)


def empty_page(types: Sequence[Type], capacity: int,
               dictionaries: Optional[Sequence[Optional[Dictionary]]] = None,
               device="cuda") -> Page:
    """A page of ``capacity`` zeroed rows, none of them live."""
    device = resolve_device(device)
    blocks = tuple(Block(t, torch.zeros(capacity, dtype=torch_dtype(t), device=device), None,
                         dictionaries[i] if dictionaries else None)
                   for i, t in enumerate(types))
    return Page(blocks, torch.zeros(capacity, dtype=torch.bool, device=device))
