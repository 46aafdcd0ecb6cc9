"""TopN, full sort and limit of the PyTorch port (``presto_tpu/ops/topn.py``).

TopN keeps a fixed N-row device buffer and, per page, sorts [page ++ buffer]
by the order keys and keeps the first N rows. OrderBy buffers every page and
sorts once at finish; Limit passes the first N live rows through. Order keys
are multi-column, asc/desc, nulls last by default; DESC sorts by the negated
value and VARCHAR by dictionary rank.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from ..block import Block, Page
from ..types import Type, is_string
from .operator import Operator, OperatorContext, OperatorFactory, timed
from .sorting import lexsort_fast


@dataclasses.dataclass(frozen=True)
class SortOrder:
    channel: int
    descending: bool = False
    nulls_first: bool = False


def _sort_key_arrays(page: Page, orders: Sequence[SortOrder]) -> Tuple[torch.Tensor, ...]:
    """Lexsort key tensors, major key LAST; the caller appends ~mask so
    invalid rows sort to the very end."""
    keys = []
    for o in reversed(orders):
        b = page.blocks[o.channel]
        x = b.data
        if is_string(b.type) and b.dictionary is not None:
            if not hasattr(b.dictionary, "values"):
                raise NotImplementedError(
                    f"ORDER BY over virtual dictionary {b.dictionary!r}")
            ranks = torch.from_numpy(b.dictionary.sort_keys()).to(x.device)
            x = ranks[x.long()]
        if x.dtype == torch.bool:
            x = x.to(torch.int32)
        if b.nulls is not None:
            # null rows order by the remaining sort keys
            x = x.masked_fill(b.nulls, 0)
        if o.descending:
            x = -x
        keys.append(x)
        if b.nulls is not None:
            # appended after the value => more significant in lexsort
            keys.append(torch.where(b.nulls, -1 if o.nulls_first else 1, 0))
    return tuple(keys)


def topn_merge_stage(page: Page, buffer: Optional[Page],
                     orders: Tuple[SortOrder, ...], n: int) -> Page:
    """Sort [page ++ buffer] and keep the first n rows."""
    if buffer is not None:
        blocks = tuple(
            Block(b.type, torch.cat([b.data, bb.data]),
                  None if b.nulls is None and bb.nulls is None else
                  torch.cat([b.null_mask(), bb.null_mask()]),
                  b.dictionary)
            for b, bb in zip(page.blocks, buffer.blocks))
        merged = Page(blocks, torch.cat([page.mask, buffer.mask]))
    else:
        merged = page
    keys = _sort_key_arrays(merged, orders) + (~merged.mask,)
    top = lexsort_fast(keys)[:n].long()
    blocks = tuple(Block(b.type, b.data[top],
                         b.nulls[top] if b.nulls is not None else None, b.dictionary)
                   for b in merged.blocks)
    return Page(blocks, merged.mask[top])


class TopNOperator(Operator):
    def __init__(self, context: OperatorContext, n: int, orders: List[SortOrder],
                 types: List[Type]):
        super().__init__(context)
        self.n = n
        self.orders = tuple(orders)
        self._types = types
        self._buffer: Optional[Page] = None
        self._emitted = False

    @property
    def output_types(self) -> List[Type]:
        return self._types

    @timed("add_input_ns")
    def add_input(self, page: Page) -> None:
        self.context.record_input(page, page.capacity)
        self._buffer = topn_merge_stage(page, self._buffer, self.orders, self.n)

    @timed("get_output_ns")
    def get_output(self) -> Optional[Page]:
        if self._finishing and not self._emitted:
            self._emitted = True
            if self._buffer is not None:
                self.context.record_output(self._buffer, self.n)
                return self._buffer
        return None

    def is_finished(self) -> bool:
        return self._finishing and self._emitted


class TopNOperatorFactory(OperatorFactory):
    def __init__(self, operator_id: int, n: int, orders: List[SortOrder],
                 types: List[Type]):
        super().__init__(operator_id, "TopN")
        self.n = n
        self.orders = orders
        self.types = types

    def create_operator(self) -> TopNOperator:
        return TopNOperator(self.context(), self.n, self.orders, self.types)


def _concat_pages(pages: Sequence[Page]) -> Page:
    blocks = []
    for i, b0 in enumerate(pages[0].blocks):
        anynull = any(p.blocks[i].nulls is not None for p in pages)
        blocks.append(Block(b0.type, torch.cat([p.blocks[i].data for p in pages]),
                            torch.cat([p.blocks[i].null_mask() for p in pages])
                            if anynull else None, b0.dictionary))
    return Page(tuple(blocks), torch.cat([p.mask for p in pages]))


class OrderByOperator(Operator):
    """Full sort: buffers every page and sorts once at finish, then emits
    pages of the input's capacity."""

    def __init__(self, context: OperatorContext, orders: List[SortOrder],
                 types: List[Type]):
        super().__init__(context)
        self.orders = tuple(orders)
        self._types = types
        self._pages: List[Page] = []
        self._result: Optional[List[Page]] = None

    @property
    def output_types(self) -> List[Type]:
        return self._types

    @timed("add_input_ns")
    def add_input(self, page: Page) -> None:
        self.context.record_input(page, page.capacity)
        self._pages.append(page)

    def finish(self) -> None:
        if self._finishing:
            return
        super().finish()
        self._result = self._sort() if self._pages else []
        self._pages = []

    def _sort(self) -> List[Page]:
        cap = self._pages[0].capacity
        merged = _concat_pages(self._pages)
        order = lexsort_fast(_sort_key_arrays(merged, self.orders) + (~merged.mask,)).long()
        out = []
        for lo in range(0, merged.capacity, cap):
            idx = order[lo:lo + cap]
            pad = cap - idx.shape[0]
            blocks = tuple(Block(b.type, _pad(b.data[idx], pad),
                                 None if b.nulls is None else _pad(b.nulls[idx], pad),
                                 b.dictionary) for b in merged.blocks)
            out.append(Page(blocks, _pad(merged.mask[idx], pad)))
        return out

    @timed("get_output_ns")
    def get_output(self) -> Optional[Page]:
        if self._result:
            out = self._result.pop(0)
            self.context.record_output(out, out.capacity)
            return out
        return None

    def is_finished(self) -> bool:
        return self._finishing and self._result is not None and not self._result


def _pad(t: torch.Tensor, n: int) -> torch.Tensor:
    if n <= 0:
        return t
    return torch.cat([t, torch.zeros(n, dtype=t.dtype, device=t.device)])


class OrderByOperatorFactory(OperatorFactory):
    def __init__(self, operator_id: int, orders: List[SortOrder], types: List[Type]):
        super().__init__(operator_id, "OrderBy")
        self.orders = orders
        self.types = types

    def create_operator(self) -> OrderByOperator:
        return OrderByOperator(self.context(), self.orders, self.types)


class LimitOperator(Operator):
    """Passes through the first ``limit`` live rows, then finishes."""

    def __init__(self, context: OperatorContext, limit: int, types: List[Type]):
        super().__init__(context)
        self.remaining = limit
        self._types = types
        self._pending: Optional[Page] = None

    @property
    def output_types(self) -> List[Type]:
        return self._types

    def needs_input(self) -> bool:
        return not self._finishing and self._pending is None and self.remaining > 0

    @timed("add_input_ns")
    def add_input(self, page: Page) -> None:
        self.context.record_input(page, page.capacity)
        live = torch.cumsum(page.mask.to(torch.int32), 0)
        keep = page.mask & (live <= self.remaining)
        self.remaining -= int(keep.sum())
        self._pending = page.with_mask(keep)

    @timed("get_output_ns")
    def get_output(self) -> Optional[Page]:
        out, self._pending = self._pending, None
        if out is not None:
            self.context.record_output(out, out.capacity)
        if self.remaining <= 0:
            self._finishing = True
        return out

    def is_finished(self) -> bool:
        return self._finishing and self._pending is None


class LimitOperatorFactory(OperatorFactory):
    def __init__(self, operator_id: int, limit: int, types: List[Type]):
        super().__init__(operator_id, "Limit")
        self.limit = limit
        self.types = types

    def create_operator(self) -> LimitOperator:
        return LimitOperator(self.context(), self.limit, self.types)
