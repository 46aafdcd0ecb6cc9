"""Filter + project: the compiled page processor of the PyTorch port.

Counterpart of ``presto_tpu/ops/filter_project.py``: ``PageProcessor`` puts
the filter result in the page mask (lazy selection) and the projections in
the output blocks; ``FilterProjectOperator`` runs one between operators
(a scan runs its own inside the scan).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from ..block import Block, Dictionary, Page
from ..types import Type
from .expressions import ExpressionCompiler, InputLayout, RowExpression
from .operator import Operator, OperatorContext, OperatorFactory, timed


class PageProcessor:
    """page -> page with projected blocks + filtered mask."""

    def __init__(self, layout: InputLayout, filter_expr: Optional[RowExpression],
                 projections: Sequence[RowExpression]):
        compiler = ExpressionCompiler(layout)
        self.filter = compiler.compile(filter_expr) if filter_expr is not None else None
        self.projections = [compiler.compile(p) for p in projections]

    @property
    def output_types(self) -> List[Type]:
        return [p.type for p in self.projections]

    @property
    def output_dicts(self) -> List[Optional[Dictionary]]:
        return [p.dictionary for p in self.projections]

    def __call__(self, page: Page) -> Page:
        datas = tuple(b.data for b in page.blocks)
        nulls = tuple(b.nulls for b in page.blocks)
        mask = page.mask
        if self.filter is not None:
            fd, fn_ = self.filter(datas, nulls)
            mask = mask & (fd if fn_ is None else (fd & ~fn_))
        shape, device = page.mask.shape, page.device
        blocks = []
        for proj in self.projections:
            d, n = proj(datas, nulls)
            if d.ndim == 0:
                d = d.to(device).expand(shape).clone()
            if n is not None and n.ndim == 0:
                n = n.to(device).expand(shape).clone()
            blocks.append(Block(proj.type, d, n, proj.dictionary))
        return Page(tuple(blocks), mask)


class FilterProjectOperator(Operator):
    def __init__(self, context: OperatorContext, processor: PageProcessor):
        super().__init__(context)
        self.processor = processor
        self._pending: Optional[Page] = None

    @property
    def output_types(self) -> List[Type]:
        return self.processor.output_types

    def needs_input(self) -> bool:
        return not self._finishing and self._pending is None

    @timed("add_input_ns")
    def add_input(self, page: Page) -> None:
        self.context.record_input(page, page.capacity)
        self._pending = self.processor(page)

    @timed("get_output_ns")
    def get_output(self) -> Optional[Page]:
        out, self._pending = self._pending, None
        if out is not None:
            self.context.record_output(out, out.capacity)
        return out

    def is_finished(self) -> bool:
        return self._finishing and self._pending is None


class FilterProjectOperatorFactory(OperatorFactory):
    def __init__(self, operator_id: int, processor: PageProcessor):
        super().__init__(operator_id, "FilterProject")
        self.processor = processor

    def create_operator(self) -> Operator:
        return FilterProjectOperator(self.context(), self.processor)
