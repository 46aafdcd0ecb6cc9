"""Connector SPI of the PyTorch port, as much as the TPC-H connector uses.

Counterpart of ``presto_tpu/spi/connector.py``. A page source yields host
pages (Blocks over CPU tensors that view numpy arrays) of a fixed capacity,
the tail page padded and masked; the table scan copies them to the device.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

from ..block import Dictionary, Page
from ..types import Type


@dataclasses.dataclass(frozen=True)
class ColumnMetadata:
    name: str
    type: Type
    dictionary: Optional[Dictionary] = None
    hidden: bool = False


@dataclasses.dataclass(frozen=True)
class ColumnHandle:
    """Connector-opaque column reference."""
    connector_id: str
    name: str
    type: Type
    ordinal: int = -1


@dataclasses.dataclass(frozen=True)
class SchemaTableName:
    schema: str
    table: str

    def __str__(self):
        return f"{self.schema}.{self.table}"


@dataclasses.dataclass(frozen=True)
class TableHandle:
    connector_id: str
    schema_table: SchemaTableName
    extra: Tuple = ()  # connector payload (e.g. tpch scale factor)


@dataclasses.dataclass(frozen=True)
class TableMetadata:
    name: SchemaTableName
    columns: Tuple[ColumnMetadata, ...]

    def column(self, name: str) -> ColumnMetadata:
        for c in self.columns:
            if c.name == name:
                return c
        raise KeyError(name)


@dataclasses.dataclass
class ColumnStatistics:
    """Per-column statistics that feed the cost-based join ordering."""
    distinct_count: Optional[float] = None
    null_fraction: float = 0.0
    min_value: Optional[float] = None
    max_value: Optional[float] = None


@dataclasses.dataclass
class TableStatistics:
    row_count: Optional[float] = None
    columns: Dict[str, ColumnStatistics] = dataclasses.field(default_factory=dict)

    @staticmethod
    def empty() -> "TableStatistics":
        return TableStatistics()


@dataclasses.dataclass(frozen=True)
class Split:
    """A schedulable unit of data (a row range for TPC-H)."""
    connector_id: str
    payload: Tuple
    bucket: Optional[int] = None


class ConnectorPageSource(abc.ABC):
    """A stream of fixed-capacity masked host pages."""

    @abc.abstractmethod
    def __iter__(self) -> Iterator[Page]:
        ...

    def close(self) -> None:
        pass


class ConcatPageSource(ConnectorPageSource):
    """The pages of several sources, one source after the other."""

    def __init__(self, sources):
        self.sources = list(sources)

    def __iter__(self):
        for s in self.sources:
            yield from s

    def close(self) -> None:
        for s in self.sources:
            s.close()


@dataclasses.dataclass
class Constraint:
    """Pushed-down predicate summary (per-column domains)."""
    domains: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @staticmethod
    def all() -> "Constraint":
        return Constraint()


class ConnectorMetadata(abc.ABC):
    @abc.abstractmethod
    def list_schemas(self) -> List[str]:
        ...

    @abc.abstractmethod
    def list_tables(self, schema: Optional[str] = None) -> List[SchemaTableName]:
        ...

    @abc.abstractmethod
    def get_table_handle(self, name: SchemaTableName) -> Optional[TableHandle]:
        ...

    @abc.abstractmethod
    def get_table_metadata(self, table: TableHandle) -> TableMetadata:
        ...

    def get_column_handles(self, table: TableHandle) -> Dict[str, ColumnHandle]:
        meta = self.get_table_metadata(table)
        return {c.name: ColumnHandle(table.connector_id, c.name, c.type, i)
                for i, c in enumerate(meta.columns)}

    def get_table_statistics(self, table: TableHandle,
                             constraint: Constraint) -> TableStatistics:
        return TableStatistics.empty()

    def get_unique_column_sets(self, table: TableHandle) -> List[Tuple[str, ...]]:
        """Column sets that identify a row (primary or unique keys): they
        let the planner prove a join build unique."""
        return []


class ConnectorSplitManager(abc.ABC):
    @abc.abstractmethod
    def get_splits(self, table: TableHandle, constraint: Constraint,
                   desired_splits: int) -> List[Split]:
        ...


class ConnectorPageSourceProvider(abc.ABC):
    @abc.abstractmethod
    def create_page_source(self, split: Split, columns: Sequence[ColumnHandle],
                           page_capacity: int,
                           constraint: Constraint = Constraint.all()) -> ConnectorPageSource:
        ...


class Connector(abc.ABC):
    """Bundle of services for one catalog."""

    @abc.abstractmethod
    def metadata(self) -> ConnectorMetadata:
        ...

    @abc.abstractmethod
    def split_manager(self) -> ConnectorSplitManager:
        ...

    @abc.abstractmethod
    def page_source_provider(self) -> ConnectorPageSourceProvider:
        ...
