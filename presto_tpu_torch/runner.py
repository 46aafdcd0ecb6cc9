"""LocalQueryRunner of the PyTorch port: parse -> plan -> optimize -> execute.

Counterpart of ``presto_tpu/runner.py`` ``LocalQueryRunner`` for queries,
EXPLAIN and SHOW TABLES / SCHEMAS / COLUMNS, in-process, on an explicit
device: ``LocalQueryRunner(session, catalogs, device="cuda")`` raises
without CUDA unless it is given ``device="cpu"``. Its default catalog
registers ``tpch`` and ``tpcds``, as the reference's does; the reference's
``memory`` and ``blackhole`` catalogs are not ported. The drivers run on a
threaded ``TaskExecutor`` of ``task_concurrency`` runner threads; when a
driver fails, every driver is closed (stopping its scan pipeline's stages
and releasing its pool client) before the error propagates. Tracing,
access control, writes, EXPLAIN ANALYZE, the memory context and grouped
execution are not ported; a statement that needs one raises
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from . import resolve_device
from .connectors.tpcds.connector import TpcdsConnector
from .connectors.tpch.connector import TpchConnector
from .exec.local_planner import LocalExecutionPlanner
from .exec.task_executor import TaskExecutor
from .metadata import CatalogManager, MetadataManager, Session
from .sql import tree as t
from .sql.parser import SqlParser
from .sql.planner.optimizer import optimize
from .sql.planner.plan import OutputNode, plan_to_text
from .sql.planner.planner import LogicalPlanner


@dataclasses.dataclass
class QueryResult:
    rows: List[list]
    column_names: List[str]
    types: Optional[List] = None  # output Type objects when the engine knows them
    # execution stats, as the reference's: "scan_pipeline" (the scan
    # stages' busy/stall seconds and counts, when a scan staged) and
    # "segments" (the fused segments and the fusion decisions, when the
    # segment compiler considered any run); None when neither applies
    stats: Optional[dict] = None
    # the port's own: drivers per pipeline, and the pages the scans replayed
    # from the resident page cache
    drivers: Optional[List[int]] = None
    resident_pages: int = 0


def _scan_pipeline_stats(drivers) -> Optional[dict]:
    """Every staged scan's stage breakdown (``ops/scan_pipeline.py``)
    summed into one query-level dict."""
    agg: dict = {}
    for d in drivers:
        for op in d.operators:
            fn = getattr(op, "pipeline_stats", None)
            st = fn() if fn is not None else None
            for k, v in (st or {}).items():
                agg[k] = round(agg.get(k, 0) + v, 6)
    return agg or None


def _segment_stats(exec_plan) -> Optional[dict]:
    """The segment compiler's decisions and each fused segment's counts
    (``FusedSegmentOperatorFactory.describe``), for ``stats["segments"]``."""
    from .ops.fused_segment import FusedSegmentOperatorFactory

    segs = []
    dispatches = compiles = 0
    for pi, chain in enumerate(exec_plan.pipelines):
        for fac in chain:
            if isinstance(fac, FusedSegmentOperatorFactory):
                d = fac.describe()
                d["pipeline"] = pi
                segs.append(d)
                dispatches += d["dispatches"]
                compiles += d["compiles"]
    if not segs and not exec_plan.segment_decisions:
        return None
    return {"count": len(segs), "dispatches": dispatches, "compiles": compiles,
            "segments": segs, "decisions": exec_plan.segment_decisions}


class LocalQueryRunner:
    """In-process engine bound to a catalog registry and one device."""

    def __init__(self, session: Optional[Session] = None,
                 catalogs: Optional[CatalogManager] = None, device="cuda"):
        self.device = resolve_device(device)
        if catalogs is None:
            catalogs = CatalogManager()
            catalogs.register("tpch", TpchConnector("tpch"))
            catalogs.register("tpcds", TpcdsConnector("tpcds"))
        self.catalogs = catalogs
        self.metadata = MetadataManager(catalogs)
        self.session = session or Session(catalog="tpch", schema="tiny")
        self.parser = SqlParser()

    def plan_sql(self, sql: str) -> OutputNode:
        stmt = self.parser.parse(sql)
        if not isinstance(stmt, t.Query):
            raise ValueError(f"cannot plan {type(stmt).__name__}")
        return self.plan_statement(stmt)

    def plan_statement(self, stmt: t.Query) -> OutputNode:
        plan = LogicalPlanner(self.metadata, self.session).plan(stmt)
        return optimize(plan, self.metadata, self.session)

    def explain(self, sql: str) -> str:
        return plan_to_text(self.plan_sql(sql))

    def execute(self, sql: str) -> QueryResult:
        stmt = self.parser.parse(sql)
        if isinstance(stmt, t.Explain):
            if stmt.analyze:
                raise NotImplementedError("EXPLAIN ANALYZE is not ported to presto_tpu_torch")
            if not isinstance(stmt.statement, t.Query):
                raise ValueError("EXPLAIN requires a query")
            text = plan_to_text(self.plan_statement(stmt.statement))
            return QueryResult([[line] for line in text.split("\n")], ["Query Plan"])
        if isinstance(stmt, t.ShowTables):
            catalog, schema = self.session.catalog, self.session.schema
            if stmt.schema:  # FROM [catalog.]schema
                parts = tuple(stmt.schema)
                if len(parts) == 2:
                    catalog, schema = parts
                elif len(parts) == 1:
                    schema = parts[0]
                else:
                    raise ValueError("SHOW TABLES FROM takes [catalog.]schema")
            tables = self.metadata.connector(catalog).metadata().list_tables(schema)
            return QueryResult([[st.table] for st in tables], ["Table"])
        if isinstance(stmt, t.ShowSchemas):
            conn = self.metadata.connector(self.session.catalog)
            return QueryResult([[s] for s in conn.metadata().list_schemas()], ["Schema"])
        if isinstance(stmt, t.ShowColumns):
            qname = self.metadata.resolve_table_name(
                self.session, tuple(p.lower() for p in stmt.table))
            handle = self.metadata.get_table_handle(self.session, qname)
            if handle is None:
                raise ValueError(f"table {qname} does not exist")
            meta = self.metadata.get_table_metadata(handle)
            return QueryResult([[c.name, c.type.name] for c in meta.columns],
                               ["Column", "Type"])
        if not isinstance(stmt, t.Query):
            raise NotImplementedError(
                f"{type(stmt).__name__} statements are not ported to presto_tpu_torch")
        self.session.check_supported()
        plan = self.plan_statement(stmt)
        exec_plan = LocalExecutionPlanner(self.metadata, self.session, self.device).plan(plan)
        drivers = exec_plan.create_drivers()
        try:
            TaskExecutor(int(self.session.get("task_concurrency"))).execute(drivers)
        except BaseException:
            # abandoned drivers tear down (their scan stages stop and their
            # pool clients are released) before the error propagates
            for d in drivers:
                d.close()
            raise
        stats = {}
        scan = _scan_pipeline_stats(drivers)
        if scan is not None:
            stats["scan_pipeline"] = scan
        seg = _segment_stats(exec_plan)
        if seg is not None:
            stats["segments"] = seg
        return QueryResult(
            exec_plan.sink.rows(), exec_plan.output_names, exec_plan.output_types,
            stats=stats or None,
            drivers=[getattr(chain[0], "parallel_drivers", 1) for chain in exec_plan.pipelines],
            resident_pages=sum(getattr(op, "resident_hits", 0)
                               for d in drivers for op in d.operators))
