"""Table writer of the PyTorch port: the sink of a CTAS or INSERT pipeline.

Counterpart of ``presto_tpu/ops/writer.py``. Pages stream into the
connector's page sink; at finish the operator emits ONE row, the number of
rows it wrote (the runner commits the sinks' fragments after every writer
driver finished, the reference's TableFinishOperator step). Before a page
reaches the sink:

- ``casts`` retype a typeless NULL column (UNKNOWN) to the table's column
  type, its NULL flags riding along;
- ``remaps`` re-encode dictionary codes into the table's private
  dictionary: a code array gathered on the page's device, or a callable
  (the runner's ``_virtual_remap``) that decodes a virtual source
  dictionary on the host, live rows only; ``column_dicts`` then rebind
  every block to the table's dictionaries.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..block import Block, Page, torch_dtype
from ..spi.connector import ConnectorPageSink
from ..types import BIGINT, Type
from .operator import Operator, OperatorContext, OperatorFactory, timed


class TableWriterOperator(Operator):
    def __init__(self, context: OperatorContext, sink: ConnectorPageSink,
                 remaps=None, column_dicts=None, casts=None):
        super().__init__(context)
        self.sink = sink
        # per column: a code remap (None = pass through) and the table's
        # dictionary the written block carries
        self.remaps = remaps
        self.column_dicts = column_dicts
        # per column: the target Type of an UNKNOWN block (None = as it is)
        self.casts = casts
        self._remap_tables = {}
        self._rows = 0
        self._emitted = False

    @property
    def output_types(self) -> List[Type]:
        return [BIGINT]

    def _remap_table(self, i: int, remap: np.ndarray, device) -> torch.Tensor:
        """Column ``i``'s code remap as an int32 tensor on ``device``, copied
        there once."""
        key = (i, device)
        if key not in self._remap_tables:
            self._remap_tables[key] = torch.from_numpy(
                np.ascontiguousarray(remap, dtype=np.int32)).to(device)
        return self._remap_tables[key]

    @timed("add_input_ns")
    def add_input(self, page: Page) -> None:
        self.context.record_input(page, page.capacity)
        # the writer is the device -> host boundary: its reads are its work
        self._rows += int(page.mask.sum())
        if self.casts is not None and any(c is not None for c in self.casts):
            page = Page(tuple(b if t is None else
                              Block(t, b.data.to(torch_dtype(t)), b.nulls, b.dictionary)
                              for b, t in zip(page.blocks, self.casts)), page.mask)
        if self.remaps is not None or self.column_dicts is not None:
            blocks = []
            for i, b in enumerate(page.blocks):
                data = b.data
                remap = self.remaps[i] if self.remaps else None
                if callable(remap):  # a virtual source: re-encode by value
                    live = page.mask if b.nulls is None else (page.mask & ~b.nulls)
                    data = torch.from_numpy(remap(data.cpu().numpy(), live.cpu().numpy())) \
                        .to(data.device)
                elif remap is not None:
                    table = self._remap_table(i, remap, data.device)
                    data = table[data.long().clamp(0, len(remap) - 1)]
                d = self.column_dicts[i] if self.column_dicts else b.dictionary
                blocks.append(Block(b.type, data, b.nulls, d))
            page = Page(tuple(blocks), page.mask)
        self.sink.append_page(page)

    @timed("get_output_ns")
    def get_output(self) -> Optional[Page]:
        if self._finishing and not self._emitted:
            self._emitted = True
            out = Page((Block(BIGINT, torch.tensor([self._rows], dtype=torch.int64)),),
                       torch.ones(1, dtype=torch.bool))
            self.context.record_output(out, 1)
            return out
        return None

    def is_finished(self) -> bool:
        return self._finishing and self._emitted


class TableWriterOperatorFactory(OperatorFactory):
    """One sink per writer driver; ``sinks`` keeps them in creation order
    for the runner's commit."""

    def __init__(self, operator_id: int, sink_provider, insert_handle,
                 remaps=None, column_dicts=None, casts=None):
        super().__init__(operator_id, "TableWriter")
        self._provider = sink_provider
        self._handle = insert_handle
        self._remaps = remaps
        self._column_dicts = column_dicts
        self._casts = casts
        self.sinks: List[ConnectorPageSink] = []

    def create_operator(self, worker: int = 0) -> TableWriterOperator:
        sink = self._provider.create_page_sink(self._handle)
        self.sinks.append(sink)
        return TableWriterOperator(self.context(worker), sink, self._remaps,
                                   self._column_dicts, self._casts)
