"""Memory connector of the PyTorch port: writable in-process tables.

Counterpart of ``presto_tpu/connectors/memory/__init__.py``. A table is a
list of host pages per (schema, table) in the connector instance:

- the page sink copies each written device page to host RAM as CPU
  tensors (pinned, when the page lies on the card, so a later scan's
  upload copies it without staging it again), keeping every block's
  ``Dictionary`` object; the commit (``finish_insert``) appends the
  sinks' pages in sink order;
- a scan's splits are page ranges, one bucket per split;
- statistics give ``row_count`` only, and no column set is unique;
- a page source has no ``cache_token``: an INSERT changes the table, so
  its pages must never be replayed from the resident page cache;
- ``create_table`` refuses table properties.

Pages are stored as written, sparse ones too: a filtered CTAS keeps its
masked pages, as the reference's sink does.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import torch

from ...block import Block, Page
from ...spi.connector import (ColumnHandle, Connector, ConnectorMetadata, ConnectorPageSink,
                              ConnectorPageSinkProvider, ConnectorPageSource,
                              ConnectorPageSourceProvider, ConnectorSplitManager, Constraint,
                              SchemaTableName, Split, TableHandle, TableMetadata,
                              TableStatistics)


class _TableData:
    def __init__(self, metadata: TableMetadata):
        self.metadata = metadata
        self.pages: List[Page] = []
        self.row_count = 0


class MemoryMetadata(ConnectorMetadata):
    def __init__(self, connector_id: str):
        self.connector_id = connector_id
        self._tables: Dict[SchemaTableName, _TableData] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------- reads

    def list_schemas(self) -> List[str]:
        return sorted({n.schema for n in self._tables} | {"default"})

    def list_tables(self, schema: Optional[str] = None) -> List[SchemaTableName]:
        return [n for n in self._tables if schema is None or n.schema == schema]

    def get_table_handle(self, name: SchemaTableName) -> Optional[TableHandle]:
        if name in self._tables:
            return TableHandle(self.connector_id, name)
        return None

    def get_table_metadata(self, table: TableHandle) -> TableMetadata:
        return self._tables[table.schema_table].metadata

    def get_table_statistics(self, table: TableHandle,
                             constraint: Constraint) -> TableStatistics:
        data = self._tables.get(table.schema_table)
        return TableStatistics(row_count=float(data.row_count) if data else 0.0)

    # ------------------------------------------------------------ writes

    def create_table(self, metadata: TableMetadata, properties=None) -> None:
        if properties:
            raise ValueError("memory connector tables take no properties")
        with self._lock:
            if metadata.name in self._tables:
                raise ValueError(f"table {metadata.name} already exists")
            self._tables[metadata.name] = _TableData(metadata)

    def begin_insert(self, table: TableHandle):
        return table

    def finish_insert(self, handle, fragments) -> None:
        data = self._tables[handle.schema_table]
        with self._lock:
            for page in fragments:
                data.pages.append(page)
                data.row_count += int(page.mask.sum())

    def drop_table(self, table: TableHandle) -> None:
        with self._lock:
            self._tables.pop(table.schema_table, None)

    def table_data(self, table: TableHandle) -> _TableData:
        return self._tables[table.schema_table]


class MemorySplitManager(ConnectorSplitManager):
    def __init__(self, connector_id: str, metadata: MemoryMetadata):
        self.connector_id = connector_id
        self._metadata = metadata

    def get_splits(self, table: TableHandle, constraint: Constraint,
                   desired_splits: int) -> List[Split]:
        n_pages = len(self._metadata.table_data(table).pages)
        n_splits = max(1, min(desired_splits or 1, n_pages or 1))
        step = math.ceil(max(n_pages, 1) / n_splits)
        return [Split(self.connector_id, payload=(table.schema_table, lo, min(lo + step, n_pages)),
                      bucket=b)
                for b, lo in enumerate(range(0, max(n_pages, 1), step))]


class MemoryPageSource(ConnectorPageSource):
    """The stored pages of one split, narrowed to the scanned columns."""

    def __init__(self, pages: List[Page], columns: Sequence[ColumnHandle],
                 all_columns: List[str]):
        self._pages = pages
        self._select = [all_columns.index(c.name) for c in columns]

    def __iter__(self) -> Iterator[Page]:
        for p in self._pages:
            yield Page(tuple(p.blocks[i] for i in self._select), p.mask)


class MemoryPageSourceProvider(ConnectorPageSourceProvider):
    def __init__(self, metadata: MemoryMetadata):
        self._metadata = metadata

    def create_page_source(self, split: Split, columns: Sequence[ColumnHandle],
                           page_capacity: int,
                           constraint: Constraint = Constraint.all()) -> ConnectorPageSource:
        name, lo, hi = split.payload
        data = self._metadata._tables[name]
        all_cols = [c.name for c in data.metadata.columns]
        return MemoryPageSource(data.pages[lo:hi], columns, all_cols)


def _to_host(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A tensor in host RAM: a card tensor is copied into pinned memory; a
    CPU tensor is kept as it is (no operator changes a page's tensors in
    place)."""
    if t is None or t.device.type == "cpu":
        return t
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out


def host_page(page: Page) -> Page:
    """``page`` with every tensor in host RAM, each block keeping its
    dictionary (the reference's ``jax.device_get`` of a page)."""
    return Page(tuple(Block(b.type, _to_host(b.data), _to_host(b.nulls), b.dictionary)
                      for b in page.blocks), _to_host(page.mask))


class MemoryPageSink(ConnectorPageSink):
    """Buffers written pages in host RAM; ``finish`` returns them as the
    fragments the metadata commit appends."""

    def __init__(self):
        self._pages: List[Page] = []
        self.rows_written = 0

    def append_page(self, page: Page) -> None:
        host = host_page(page)
        self._pages.append(host)
        self.rows_written += int(host.mask.sum())

    def finish(self) -> List[Page]:
        return self._pages

    def abort(self) -> None:
        self._pages = []


class MemoryPageSinkProvider(ConnectorPageSinkProvider):
    def create_page_sink(self, insert_handle) -> ConnectorPageSink:
        return MemoryPageSink()


class MemoryConnector(Connector):
    def __init__(self, connector_id: str):
        self._metadata = MemoryMetadata(connector_id)
        self._splits = MemorySplitManager(connector_id, self._metadata)
        self._sources = MemoryPageSourceProvider(self._metadata)
        self._sinks = MemoryPageSinkProvider()

    def metadata(self) -> ConnectorMetadata:
        return self._metadata

    def split_manager(self) -> ConnectorSplitManager:
        return self._splits

    def page_source_provider(self) -> ConnectorPageSourceProvider:
        return self._sources

    def page_sink_provider(self) -> Optional[ConnectorPageSinkProvider]:
        return self._sinks
