"""Sessions, catalogs and the metadata manager of the PyTorch port.

Counterpart of ``presto_tpu/metadata.py``: qualified-name resolution to
table handles, column enumeration and statistics for the cost-based join
ordering, behind a catalog registry.

The port's ``Session.DEFAULTS`` hold only the properties the port honours,
with the reference's values, plus the four features the reference turns on
by default and the port has not ported yet, each set to its off value. A
property outside ``DEFAULTS``, or one of the four turned on, raises
``NotImplementedError`` naming it when a query is planned
(``Session.check_supported``): no property is ignored quietly.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch

from .spi.connector import (ColumnHandle, Connector, Constraint, SchemaTableName,
                            TableHandle, TableMetadata, TableStatistics)


@dataclasses.dataclass
class Session:
    """Per-query context: user, default catalog and schema, and session
    properties over ``DEFAULTS``."""

    user: str = "user"
    catalog: Optional[str] = None
    schema: Optional[str] = None
    properties: Dict[str, object] = dataclasses.field(default_factory=dict)

    DEFAULTS = {
        # None = the device's default (default_page_capacity)
        "page_capacity": None,
        "max_groups": 1 << 20,
        # join build/probe and grouping strategy: sorted | pallas | auto
        # (pallas = the open-addressing table on the hand-written kernels
        # wherever it is correct; auto = pallas joins on CUDA only, hash
        # grouping where the first page shows few groups on the CPU)
        "hash_kernels": "sorted",
        # --- features the reference turns on and the port has not ported;
        # each is off here and raises when turned on (ROADMAP.md, queue 1)
        # fused page-local segments (ROADMAP queue 1, item 2)
        "segment_fusion": False,
        # page coalescing before joins (ROADMAP queue 1, item 3)
        "coalesce_pages": False,
        # the streaming scan pipeline (ROADMAP queue 1, item 4)
        "scan_pipeline": False,
        # parallel drivers per pipeline (ROADMAP queue 1, item 5)
        "driver_parallelism": 1,
    }
    # the unported features above: DEFAULTS holds the only value each takes
    UNPORTED_FEATURES = ("segment_fusion", "coalesce_pages", "scan_pipeline",
                         "driver_parallelism")

    def get(self, name: str, default=None):
        if name in self.properties:
            return self.properties[name]
        if name in self.DEFAULTS:
            return self.DEFAULTS[name]
        return default

    def check_supported(self) -> None:
        """Raise NotImplementedError naming the first property the port
        would otherwise ignore: one it does not know, or an unported feature
        turned on."""
        for name, value in self.properties.items():
            if name not in self.DEFAULTS:
                raise NotImplementedError(
                    f"session property {name!r} is not ported to presto_tpu_torch")
            off = self.DEFAULTS[name]
            if name in self.UNPORTED_FEATURES and value != off:
                raise NotImplementedError(
                    f"session property {name}={value!r} needs a feature that is "
                    f"not ported to presto_tpu_torch (only {off!r} is supported)")


def default_page_capacity(device) -> int:
    """Default page size for ``device``: 2^22 rows on CUDA (the reference's
    accelerator value: few large pages keep the per-page host dispatch
    small) and 2^18 on the CPU (cache-sized pages). It reads only the
    device the caller passed."""
    return (1 << 22) if torch.device(device).type == "cuda" else (1 << 18)


@dataclasses.dataclass(frozen=True)
class QualifiedObjectName:
    catalog: str
    schema: str
    table: str

    def __str__(self):
        return f"{self.catalog}.{self.schema}.{self.table}"


class CatalogManager:
    """Registered connectors by catalog name."""

    def __init__(self):
        self._catalogs: Dict[str, Connector] = {}

    def register(self, name: str, connector: Connector) -> None:
        self._catalogs[name] = connector

    def get(self, name: str) -> Optional[Connector]:
        return self._catalogs.get(name)


class MetadataManager:
    """Engine-facing metadata fronting the connectors."""

    def __init__(self, catalogs: CatalogManager):
        self.catalogs = catalogs

    def resolve_table_name(self, session: Session,
                           parts: Sequence[str]) -> QualifiedObjectName:
        """A table name -> fully qualified, filling the session's defaults."""
        parts = list(parts)
        if len(parts) == 1:
            if not session.catalog or not session.schema:
                raise ValueError(f"table '{parts[0]}' requires session catalog/schema")
            return QualifiedObjectName(session.catalog, session.schema, parts[0])
        if len(parts) == 2:
            if not session.catalog:
                raise ValueError(f"table '{'.'.join(parts)}' requires session catalog")
            return QualifiedObjectName(session.catalog, parts[0], parts[1])
        if len(parts) == 3:
            return QualifiedObjectName(*parts)
        raise ValueError(f"invalid table name {'.'.join(parts)}")

    def get_table_handle(self, session: Session,
                         name: QualifiedObjectName) -> Optional[TableHandle]:
        conn = self.catalogs.get(name.catalog)
        if conn is None:
            return None
        return conn.metadata().get_table_handle(SchemaTableName(name.schema, name.table))

    def get_table_metadata(self, table: TableHandle) -> TableMetadata:
        return self._connector(table).metadata().get_table_metadata(table)

    def get_column_handles(self, table: TableHandle) -> Dict[str, ColumnHandle]:
        return self._connector(table).metadata().get_column_handles(table)

    def get_table_statistics(self, table: TableHandle,
                             constraint: Constraint = Constraint.all()) -> TableStatistics:
        return self._connector(table).metadata().get_table_statistics(table, constraint)

    def connector(self, catalog: str) -> Connector:
        conn = self.catalogs.get(catalog)
        if conn is None:
            raise KeyError(f"unknown catalog {catalog}")
        return conn

    def _connector(self, table: TableHandle) -> Connector:
        return self.connector(table.connector_id)
