"""Table scan: connector host pages -> device pages -> filter/project.

Counterpart of ``presto_tpu/ops/scan.py`` ``TableScanOperator`` on its
passthrough path (source page shapes, no re-batching), which is the path the
reference's hand-built factories take. The host->device copy is explicit;
narrow wire dtypes are widened to the declared types on the device
(``_widen_page``).
"""
from __future__ import annotations

from typing import Iterator, List, Optional

import torch

from ..block import Block, Page, torch_dtype
from ..spi.connector import ConnectorPageSource
from ..types import Type
from .filter_project import PageProcessor
from .operator import Operator, OperatorFactory, timed


def _upload(page: Page, device: torch.device) -> Page:
    """Explicit host->device copy of every block and the mask."""
    blocks = tuple(Block(b.type, b.data.to(device, non_blocking=True),
                         None if b.nulls is None else b.nulls.to(device, non_blocking=True),
                         b.dictionary)
                   for b in page.blocks)
    return Page(blocks, page.mask.to(device, non_blocking=True))


def _widen_page(page: Page) -> Page:
    """Device-side upcast of narrow wire blocks to their declared dtypes."""
    blocks = []
    for b in page.blocks:
        want = torch_dtype(b.type)
        data = b.data if b.data.dtype == want else b.data.to(want)
        blocks.append(Block(b.type, data, b.nulls, b.dictionary))
    return Page(tuple(blocks), page.mask.to(torch.bool))


class TableScanOperator(Operator):
    def __init__(self, context, source: ConnectorPageSource, types: List[Type],
                 processor: Optional[PageProcessor], device: torch.device):
        super().__init__(context)
        self.source = source
        self._types = types
        self.processor = processor
        self.device = device
        self._iter: Optional[Iterator[Page]] = None
        self._done = False

    @property
    def output_types(self) -> List[Type]:
        return self.processor.output_types if self.processor else self._types

    def needs_input(self) -> bool:
        return False  # source operator

    def add_input(self, page: Page) -> None:
        raise RuntimeError("table scan takes no input")

    @timed("get_output_ns")
    def get_output(self) -> Optional[Page]:
        if self._done:
            return None
        if self._iter is None:
            self._iter = iter(self.source)
        page = next(self._iter, None)
        if page is None:
            self._done = True
            self.source.close()
            return None
        self.context.record_input(page, page.capacity)
        page = _widen_page(_upload(page, self.device))
        if self.processor is not None:
            page = self.processor(page)
        self.context.record_output(page, page.capacity)
        return page

    def is_finished(self) -> bool:
        return self._done or self._finishing


class TableScanOperatorFactory(OperatorFactory):
    """Each create_operator() call consumes the next unclaimed page source."""

    def __init__(self, operator_id: int, page_sources, types: List[Type],
                 processor: Optional[PageProcessor], device: torch.device):
        super().__init__(operator_id, "TableScan")
        self._remaining = list(page_sources)
        self._types = types
        self._processor = processor
        self.device = torch.device(device)
        # a filter runs in the scan: a join after it may coalesce its pages
        self.has_filter = processor is not None and processor.filter is not None

    def create_operator(self) -> Operator:
        return TableScanOperator(self.context(), self._remaining.pop(0), self._types,
                                 self._processor, self.device)
