"""LocalQueryRunner of the PyTorch port: parse -> plan -> optimize -> execute.

Counterpart of ``presto_tpu/runner.py`` ``LocalQueryRunner`` for queries,
EXPLAIN and SHOW TABLES / SCHEMAS / COLUMNS, in-process, on an explicit
device: ``LocalQueryRunner(session, catalogs, device="cuda")`` raises
without CUDA unless it is given ``device="cpu"``. Its default catalog
registers ``tpch`` only. Tracing, access control, writes, EXPLAIN ANALYZE,
the memory context and grouped execution are not ported; a statement that
needs one raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from . import resolve_device
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


class LocalQueryRunner:
    """In-process engine bound to a catalog registry and one device."""

    def __init__(self, session: Optional[Session] = None,
                 catalogs: Optional[CatalogManager] = None, device="cuda"):
        self.device = resolve_device(device)
        if catalogs is None:
            catalogs = CatalogManager()
            catalogs.register("tpch", TpchConnector("tpch"))
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
        TaskExecutor().execute(exec_plan.create_drivers())
        return QueryResult(exec_plan.sink.rows(), exec_plan.output_names,
                           exec_plan.output_types)
