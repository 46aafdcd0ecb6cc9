"""Sessions, catalogs and the metadata manager of the PyTorch port.

Counterpart of ``presto_tpu/metadata.py``: qualified-name resolution to
table handles, column enumeration and statistics for the cost-based join
ordering, behind a catalog registry.

The port's ``Session.DEFAULTS`` hold only the properties the port honours,
each with the reference's default value: fused segments, page coalescing,
the streaming scan pipeline, parallel drivers, the disk rung of the memory
ladder, the black-box recorder and grouped execution are on. A property outside
``DEFAULTS`` raises ``NotImplementedError`` naming it when a query is
planned (``Session.check_supported``): no property is ignored quietly.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

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
        # memory accounting (advisory, over torch's allocator): the
        # process-wide pool's size, the per-query user-memory limit, and the
        # fraction of either past which operators revoke their state: device
        # -> host RAM -> disk
        "memory_pool_bytes": 8 << 30,
        "query_max_memory_bytes": 4 << 30,
        "revoke_target_fraction": 0.9,
        # the disk rung (exec/spill.py, PCOL runs): spill_dir "" =
        # <tempdir>/presto-tpu-torch-spill; spill_max_bytes 0 = no per-query
        # bound on the bytes on disk
        "spill_to_disk": True,
        "spill_dir": "",
        "spill_max_bytes": 0,
        # grouped (lifespan) execution over co-bucketed tables: the plan runs
        # once per bucket, so join and grouping state hold one bucket's data
        # (exec/grouped.py)
        "grouped_execution": True,
        # the flight recorder (utils/trace.py): a full trace written to
        # query_trace_dir ("" = the tempdir) when query_trace is on, with a
        # ring of query_trace_max_events spans (0 = the default, 2^16);
        # else the coarse black box of query_blackbox_max_events spans (0 =
        # 2^13), written only when the query fails
        "query_trace": False,
        "query_trace_dir": "",
        "query_trace_max_events": 0,
        "query_blackbox": True,
        "query_blackbox_max_events": 0,
        # join build/probe and grouping strategy: sorted | pallas | auto
        # (pallas = the open-addressing table on the hand-written kernels
        # wherever it is correct; auto = pallas joins on CUDA only, hash
        # grouping where the first page shows few groups on the CPU)
        "hash_kernels": "sorted",
        # fused page-local pipeline segments (ops/fused_segment.py); False
        # runs the per-operator pipeline, the reference's differential oracle
        "segment_fusion": True,
        # page coalescing after a filtered scan before a join (ops/coalesce.py)
        "coalesce_pages": True,
        # the staged scan (ops/scan_pipeline.py): reader, re-batch or
        # passthrough, and upload stages on background threads; False reads
        # and copies each page on the driver's thread (the oracle)
        "scan_pipeline": True,
        # drivers per eligible pipeline: AUTO = task_concurrency on a CUDA
        # device, 1 on the CPU; an integer forces that many
        "driver_parallelism": "AUTO",
        # runner threads of the task executor, and AUTO's driver count
        "task_concurrency": 4,
        # scan stages on the process-wide SCAN_POOL (False: per-scan threads)
        "shared_pools": True,
        # readers per scan pipeline; 0 = scan_pipeline.DEFAULT_READER_THREADS
        "scan_reader_threads": 0,
        # rows of a re-batched page; 0 = the session's page capacity
        "scan_target_page_rows": 0,
        # in-flight bytes per scan (staged and uploaded-unconsumed);
        # 0 = scan_pipeline.DEFAULT_PREFETCH_BYTES
        "scan_prefetch_bytes": 0,
        # scaled writers: INSERT/CTAS fan out over K writer drivers (one
        # sink each) when the source is at least K times this many rows
        "scaled_writers": True,
        "writer_min_rows_per_driver": 1 << 20,
        # --- the multi-worker engine (parallel/, sql/planner/add_exchanges.py)
        # BROADCAST | PARTITIONED | AUTOMATIC: AUTOMATIC replicates a join's
        # build when the cost model says so, a build of at most
        # broadcast_join_threshold_rows estimated rows
        "join_distribution_type": "AUTOMATIC",
        "broadcast_join_threshold_rows": 1 << 15,
        # NONE | AUTOMATIC: accepted and read by nothing, as in the reference
        "join_reordering_strategy": "AUTOMATIC",
        # fragments exchange fixed-capacity chunks while producers run
        # (parallel/streaming_exchange.py); False = the stage-barrier
        # exchange, the differential oracle
        "streaming_exchange": True,
        # rows of a worker's chunk (pow2-rounded) and the in-flight bytes of
        # one exchange; 0 = the engine defaults (2^16 rows, 256 MiB; the
        # reference's chunk is 2^12 rows)
        "exchange_chunk_rows": 0,
        "exchange_inflight_bytes": 0,
        # a partitioned INNER join's exchanges split a hot build key
        # round-robin and replicate it on the probe side
        "skew_aware_exchange": True,
        # --- the cluster (cluster/): coordinator and HTTP workers
        # NONE fails fast; QUERY re-plans and re-runs the whole query on a
        # retryable failure, excluding failed nodes; TASK also re-places
        # failed task creates and recovers failed tasks in place
        "retry_policy": "NONE",
        "query_retry_attempts": 2,      # extra attempts after the first
        "task_retry_attempts": 2,       # in-place recoveries per task (TASK)
        "retry_initial_delay_s": 0.1,   # jittered exponential backoff floor
        "retry_max_delay_s": 2.0,       # ... and ceiling
        # transient-failure budgets: one remote-task create, one exchange
        # source before it is declared dead
        "remote_task_error_budget_s": 10.0,
        "exchange_error_budget_s": 60.0,
        # deterministic fault-injection spec (cluster/faults.py); "" = off
        "fault_injection": "",
        "fault_seed": 0,
        # per-task bound on the acked-frame replay spool (cluster/buffers.py),
        # reserved in the shared pool under the query id; 0 = no spool (a
        # mid-stream TASK recovery then escalates to a query retry)
        "exchange_spool_bytes": 64 << 20,
        # rows a task's sink accumulates per consumer before it flushes one
        # frame (one replayable chunk); None = 2^14
        "exchange_flush_rows": None,
        # straggler speculation: a duplicate of a task running past
        # max(speculation_min_wall_s, multiplier x its finished siblings'
        # median wall); the first copy to finish wins
        "speculative_execution": False,
        "speculation_min_wall_s": 5.0,
        "speculation_multiplier": 2.0,
    }

    def get(self, name: str, default=None):
        if name in self.properties:
            return self.properties[name]
        if name in self.DEFAULTS:
            return self.DEFAULTS[name]
        return default

    def with_properties(self, **kw) -> "Session":
        """A copy with ``kw`` over this session's properties."""
        props = dict(self.properties)
        props.update(kw)
        return dataclasses.replace(self, properties=props)

    def check_supported(self) -> None:
        """Raise NotImplementedError naming the first property the port
        does not know (and would otherwise ignore)."""
        for name in self.properties:
            if name not in self.DEFAULTS:
                raise NotImplementedError(
                    f"session property {name!r} is not ported to presto_tpu_torch")


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

    def names(self) -> List[str]:
        return list(self._catalogs)


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
