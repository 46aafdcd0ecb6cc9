"""Columnar data substrate of the PyTorch port: Dictionary, Block and Page.

Counterpart of ``presto_tpu/block.py``. A Block is one dense tensor (plus an
optional bool null mask and an optional host-side string dictionary); a Page
is a tuple of equal-capacity Blocks plus a bool row mask, padded to a fixed
capacity. The tensors live on whatever device the scan uploaded them to;
every function here runs on the tensors' own device.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import resolve_device
from .types import Type


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
}


class Dictionary:
    """Host-side string dictionary shared by the varchar blocks of one column.

    Identity-hashed, like the reference's: two dictionaries are the same
    dictionary only if they are the same object.
    """

    __slots__ = ("values", "_index", "_ranks")

    def __init__(self, values: Sequence[str]):
        self.values = np.asarray(values, dtype=object)
        self._index = None
        self._ranks = None

    def __len__(self):
        return len(self.values)

    def index(self) -> dict:
        if self._index is None:
            self._index = {v: i for i, v in enumerate(self.values)}
        return self._index

    def code_of(self, value: str) -> int:
        """Code for value, or -1 if absent (comparisons against it are then const-false)."""
        return self.index().get(value, -1)

    def lookup(self, codes: np.ndarray) -> np.ndarray:
        out = np.empty(len(codes), dtype=object)
        mask = codes >= 0
        out[mask] = self.values[codes[mask]]
        out[~mask] = None
        return out

    def sort_keys(self) -> np.ndarray:
        """Rank of each code in lexicographic order, for ORDER BY on varchar."""
        if self._ranks is None or len(self._ranks) != len(self.values):
            order = np.argsort(self.values.astype(str), kind="stable")
            ranks = np.empty(len(self.values), dtype=np.int32)
            ranks[order] = np.arange(len(self.values), dtype=np.int32)
            self._ranks = ranks
        return self._ranks

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other

    def __repr__(self):
        return f"Dictionary({len(self.values)} entries)"


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

    def with_mask(self, mask: torch.Tensor) -> "Page":
        return Page(self.blocks, mask)

    def to_pylists(self) -> List[list]:
        """Rows of decoded Python values (host side). Live rows are gathered
        where the page lies, so only they cross to the host."""
        idx = torch.nonzero(self.mask).squeeze(1)
        cols = []
        for b in self.blocks:
            arr = b.data[idx].cpu().numpy()
            nulls = b.nulls[idx].cpu().numpy() if b.nulls is not None else None
            if b.dictionary is not None:
                vals = list(b.dictionary.lookup(arr.astype(np.int64)))
            else:
                vals = [b.type.to_python(v) for v in arr]
            if nulls is not None:
                vals = [None if n else v for v, n in zip(vals, nulls)]
            cols.append(vals)
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
