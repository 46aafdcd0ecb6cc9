"""EnforceSingleRow: the cardinality guard of a scalar subquery.

Counterpart of ``presto_tpu/ops/single_row.py``: buffers its input, fails
if more than one row arrives, and emits exactly one row, all NULL when the
input was empty (SQL scalar-subquery semantics). The kept row is sliced on
the device; only the page's live count crosses to the host.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from .. import resolve_device
from ..block import Block, Dictionary, Page, _compact, torch_dtype
from ..types import Type
from .operator import Operator, OperatorContext, OperatorFactory, timed


class EnforceSingleRowOperator(Operator):
    def __init__(self, context: OperatorContext, types: List[Type],
                 dicts: List[Optional[Dictionary]], device: torch.device):
        super().__init__(context)
        self.types = types
        self.dicts = dicts
        self.device = device
        self._row: Optional[Page] = None
        self._emitted = False

    @property
    def output_types(self) -> List[Type]:
        return self.types

    @timed("add_input_ns")
    def add_input(self, page: Page) -> None:
        self.context.record_input(page, page.capacity)
        n = int(page.mask.sum())  # host sync: the page's live rows
        if n == 0:
            return
        if self._row is not None or n > 1:
            raise RuntimeError("scalar subquery returned more than one row")
        # one live row: keep a capacity-1 page of it
        packed = _compact(page)
        blocks = tuple(Block(b.type, b.data[:1].clone(),
                             b.nulls[:1].clone() if b.nulls is not None else None,
                             b.dictionary)
                       for b in packed.blocks)
        self._row = Page(blocks, torch.ones(1, dtype=torch.bool, device=page.device))

    @timed("get_output_ns")
    def get_output(self) -> Optional[Page]:
        if not self._finishing or self._emitted:
            return None
        self._emitted = True
        out = self._row
        if out is None:  # empty input: one all-NULL row
            dev = self.device
            out = Page(tuple(Block(t, torch.zeros(1, dtype=torch_dtype(t), device=dev),
                                   torch.ones(1, dtype=torch.bool, device=dev), d)
                             for t, d in zip(self.types, self.dicts)),
                       torch.ones(1, dtype=torch.bool, device=dev))
        self.context.record_output(out, 1)
        return out

    def is_finished(self) -> bool:
        return self._emitted


class EnforceSingleRowOperatorFactory(OperatorFactory):
    def __init__(self, operator_id: int, types: List[Type],
                 dicts: Optional[List[Optional[Dictionary]]] = None, device="cuda"):
        super().__init__(operator_id, "EnforceSingleRow")
        self.types = list(types)
        self.dicts = list(dicts) if dicts is not None else [None] * len(self.types)
        self.device = resolve_device(device)

    def create_operator(self, worker: int = 0) -> EnforceSingleRowOperator:
        return EnforceSingleRowOperator(self.context(worker), self.types, self.dicts,
                                        self.worker_device(worker))
