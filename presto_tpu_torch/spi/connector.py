"""Connector SPI of the PyTorch port: reads, and the write path.

Counterpart of ``presto_tpu/spi/connector.py``. A page source yields host
pages (Blocks over CPU tensors) of a fixed capacity, the tail page padded
and masked; the table scan copies them to the device. A writable catalog's
``page_sink_provider()`` hands the table writer one ``ConnectorPageSink``
per writer driver, and its metadata commits the sinks' fragments
(``create_table``, ``begin_insert``, ``finish_insert``, ``drop_table``);
a read-only catalog returns None there. A bucketing catalog says how its
tables are bucketed through ``node_partitioning_provider()``. A
``ConnectorFactory`` makes a catalog's connector from its
``etc/catalog/<name>.properties``, and a ``Plugin`` hands the server's
loader its factories and function registration hooks
(``server/config.load_plugins``).
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

    # True = a read may block indefinitely on progress the engine does not
    # control (a remote stream): the scan pipeline then runs its stages on
    # dedicated threads, never on the shared scan pool, whose steps must
    # end within a bounded wait. Generator and file reads are False.
    external_wait = False

    @abc.abstractmethod
    def __iter__(self) -> Iterator[Page]:
        ...

    def close(self) -> None:
        pass

    def split_readers(self, target_rows: int):
        """Optional scan-pipeline decomposition: a list of zero-argument
        callables, each returning an iterable of ``ops.scan_pipeline.
        HostChunk`` for one independently readable row range, in stream
        order. None = the source is read serially, page by page."""
        return None

    @property
    def cache_token(self) -> Optional[tuple]:
        """Hashable identity of a deterministic, immutable page stream, or
        None. A token lets the scan keep the uploaded device pages resident
        and replay them for a later scan with the same token; a source whose
        pages can change returns None."""
        return None


class FixedPageSource(ConnectorPageSource):
    """A fixed list of pages (a VALUES list). It has no ``cache_token``:
    its pages never enter the resident cache."""

    def __init__(self, pages: Sequence[Page]):
        self._pages = list(pages)

    def __iter__(self):
        return iter(self._pages)


class ConcatPageSource(ConnectorPageSource):
    """The pages of several sources, one source after the other."""

    def __init__(self, sources):
        self.sources = list(sources)

    @property
    def external_wait(self):
        """One externally blocking child keeps the whole concatenation off
        the shared scan pool."""
        return any(getattr(s, "external_wait", False) for s in self.sources)

    def __iter__(self):
        for s in self.sources:
            yield from s

    @property
    def cache_token(self):
        """Deterministic iff every child is: the tuple of the children's
        tokens."""
        toks = tuple(getattr(s, "cache_token", None) for s in self.sources)
        if any(t is None for t in toks):
            return None
        return ("concat",) + toks

    def split_readers(self, target_rows: int):
        """The children's range readers in stream order, all or nothing: one
        child without split support keeps the whole concatenation serial,
        so the output order always matches serial iteration."""
        out = []
        for s in self.sources:
            rs = s.split_readers(target_rows)
            if rs is None:
                return None
            out.extend(rs)
        return out

    def close(self) -> None:
        # every child is closed even when one close raises; the first error
        # is raised after the rest
        err = None
        for s in self.sources:
            try:
                s.close()
            except Exception as e:  # noqa: BLE001 - re-raised below
                err = err or e
        if err is not None:
            raise err


class ConnectorPageSink(abc.ABC):
    """The write path of INSERT and CTAS: one per writer driver."""

    @abc.abstractmethod
    def append_page(self, page: Page) -> None:
        ...

    def finish(self) -> Any:
        """The written fragments the metadata commit takes."""
        return None

    def abort(self) -> None:
        pass


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

    # the write path (optional)
    def begin_insert(self, table: TableHandle):
        raise NotImplementedError(f"{type(self).__name__} does not support inserts")

    def finish_insert(self, handle, fragments) -> None:
        pass

    def create_table(self, metadata: TableMetadata,
                     properties: Optional[Dict[str, Any]] = None) -> None:
        """``properties`` are the CTAS ``WITH (...)`` table properties; a
        connector that defines none rejects any."""
        raise NotImplementedError(f"{type(self).__name__} does not support CREATE TABLE")

    def drop_table(self, table: TableHandle) -> None:
        raise NotImplementedError(f"{type(self).__name__} does not support DROP TABLE")


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


class ConnectorPageSinkProvider(abc.ABC):
    @abc.abstractmethod
    def create_page_sink(self, insert_handle) -> ConnectorPageSink:
        ...


class ConnectorNodePartitioningProvider:
    """A connector's bucketing: the bucket count of a table and the columns
    its bucket hash is computed over. Grouped execution
    (``exec/grouped.py``) runs a plan over co-bucketed tables one bucket at
    a time. This default says "not bucketed"."""

    def bucket_count(self, table: TableHandle) -> Optional[int]:
        return None

    def bucket_columns(self, table: TableHandle) -> Optional[Tuple[str, ...]]:
        """Ordered column names of the bucket hash, or None."""
        return None


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

    def page_sink_provider(self) -> Optional[ConnectorPageSinkProvider]:
        """None: the catalog is read-only."""
        return None

    def node_partitioning_provider(self) -> ConnectorNodePartitioningProvider:
        return ConnectorNodePartitioningProvider()

    def shutdown(self) -> None:
        """Release the catalog's threads and handles (raptor's organizer and
        database); the server's owner calls it when a catalog goes away."""


class ConnectorFactory(abc.ABC):
    """Makes one catalog's connector from its properties."""

    @property
    @abc.abstractmethod
    def name(self) -> str:
        ...

    @abc.abstractmethod
    def create(self, catalog_name: str, config: Dict[str, str]) -> Connector:
        ...


class Plugin:
    """What an external plugin contributes. Subclass and override."""

    def connector_factories(self) -> List[ConnectorFactory]:
        return []

    def functions(self) -> List:
        return []

    def types(self) -> List[Type]:
        return []

    def event_listener_factories(self) -> List:
        return []
