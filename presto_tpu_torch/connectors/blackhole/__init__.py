"""Blackhole connector of the PyTorch port: writes count rows, scans return
nothing.

Counterpart of ``presto_tpu/connectors/blackhole/__init__.py``: CREATE and
INSERT succeed and return the rows written, and a scan yields no page.
"""
from __future__ import annotations

import threading
from typing import Dict, Iterator, List, Optional

from ...block import Page
from ...spi.connector import (Connector, ConnectorMetadata, ConnectorPageSink,
                              ConnectorPageSinkProvider, ConnectorPageSource,
                              ConnectorPageSourceProvider, ConnectorSplitManager, Constraint,
                              SchemaTableName, Split, TableHandle, TableMetadata,
                              TableStatistics)


class BlackholeMetadata(ConnectorMetadata):
    def __init__(self, connector_id: str):
        self.connector_id = connector_id
        self._tables: Dict[SchemaTableName, TableMetadata] = {}
        self._lock = threading.Lock()

    def list_schemas(self) -> List[str]:
        return sorted({n.schema for n in self._tables} | {"default"})

    def list_tables(self, schema: Optional[str] = None) -> List[SchemaTableName]:
        return [n for n in self._tables if schema is None or n.schema == schema]

    def get_table_handle(self, name: SchemaTableName) -> Optional[TableHandle]:
        return TableHandle(self.connector_id, name) if name in self._tables else None

    def get_table_metadata(self, table: TableHandle) -> TableMetadata:
        return self._tables[table.schema_table]

    def get_table_statistics(self, table: TableHandle,
                             constraint: Constraint) -> TableStatistics:
        return TableStatistics(row_count=0.0)

    def create_table(self, metadata: TableMetadata, properties=None) -> None:
        if properties:
            raise ValueError("blackhole connector tables take no properties")
        with self._lock:
            self._tables[metadata.name] = metadata

    def begin_insert(self, table: TableHandle):
        return table

    def finish_insert(self, handle, fragments) -> None:
        pass

    def drop_table(self, table: TableHandle) -> None:
        with self._lock:
            self._tables.pop(table.schema_table, None)


class _EmptySource(ConnectorPageSource):
    def __iter__(self) -> Iterator[Page]:
        return iter(())


class _Splits(ConnectorSplitManager):
    def __init__(self, connector_id: str):
        self.connector_id = connector_id

    def get_splits(self, table, constraint, desired_splits):
        return [Split(self.connector_id, payload=(table.schema_table,))]


class _Sources(ConnectorPageSourceProvider):
    def create_page_source(self, split, columns, page_capacity, constraint=Constraint.all()):
        return _EmptySource()


class _Sink(ConnectorPageSink):
    def __init__(self):
        self.rows_written = 0

    def append_page(self, page: Page) -> None:
        self.rows_written += int(page.mask.sum())

    def finish(self):
        return []


class _Sinks(ConnectorPageSinkProvider):
    def create_page_sink(self, insert_handle):
        return _Sink()


class BlackholeConnector(Connector):
    def __init__(self, connector_id: str):
        self._metadata = BlackholeMetadata(connector_id)
        self.connector_id = connector_id

    def metadata(self) -> ConnectorMetadata:
        return self._metadata

    def split_manager(self) -> ConnectorSplitManager:
        return _Splits(self.connector_id)

    def page_source_provider(self) -> ConnectorPageSourceProvider:
        return _Sources()

    def page_sink_provider(self) -> Optional[ConnectorPageSinkProvider]:
        return _Sinks()
