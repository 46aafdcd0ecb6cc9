"""LocalQueryRunner of the PyTorch port: parse -> plan -> optimize -> execute.

Counterpart of ``presto_tpu/runner.py`` ``LocalQueryRunner`` for queries,
EXPLAIN, SHOW TABLES / SCHEMAS / COLUMNS and the writes, in-process, on an
explicit device: ``LocalQueryRunner(session, catalogs, device="cuda")``
raises without CUDA unless it is given ``device="cpu"``. Its default
catalogs are ``tpch``, ``tpcds``, ``memory`` and ``blackhole``, as the
reference's are. The drivers run on a threaded ``TaskExecutor`` of
``task_concurrency`` runner threads; when a driver fails, every driver is
closed (stopping its scan pipeline's stages and releasing its pool client)
before the error propagates.

CREATE TABLE AS, INSERT (SELECT or VALUES) and DROP TABLE run through
``_execute_write``: the source query's result sink becomes a table writer
(``ops/writer.py``) feeding the catalog's page sinks, on K scaled writer
drivers behind a dealing local exchange when the source is large
(``_scaled_writer_count``), and the runner commits the sinks' fragments.
A failing CTAS closes the drivers, aborts the sinks and drops the table.

Queries, writes and EXPLAIN ANALYZE run through one recipe, ``_run_plan``:
the query's memory root on the process-wide pool (``_query_memory``:
``memory_pool_bytes``, ``query_max_memory_bytes``,
``revoke_target_fraction``) is attached to the planner, a live-progress
provider reads the drivers while they run (``exec/progress.py``), and the
query's reservations are cleared in a ``finally``. When ``spill_to_disk``
is on (the default) the query also gets a disk tier (``exec/spill.py``),
hung on its memory as ``memory.spill`` and closed in the same ``finally``
before the reservations are cleared. EXPLAIN ANALYZE prints the drivers'
operator stats under the reference's header (``exec/explain.py``).

Every statement runs under the per-query flight recorder
(``utils/trace.py``), as in the reference: a full one when ``query_trace``
is on (``QueryResult.trace_path`` is its Chrome trace), else the always-on
coarse black box, which is written only when the statement fails (the
exception's ``failure_trace_path``). The recorder wraps the statement in a
``lifecycle`` span ``query`` with ``parse``, ``plan``, ``local_plan`` and
``execute`` inside it where the reference puts them, and every statement's
wall goes into the ``query.wall_s`` histogram.

A query over co-bucketed tables runs grouped (``exec/grouped.py``, on by
default with ``grouped_execution``): ``_run_plan`` once per bucket, each
with its own memory reservation released before the next bucket, one
``local_plan`` and ``execute`` span per bucket under the statement's one
``query`` span, the scan and segment stats summed over the buckets and the
rows merged by ``merge_rows``. ``last_grouped`` holds the bucket count of
the last statement that ran grouped, else None. EXPLAIN ANALYZE runs
ungrouped, as in the reference.

Access control: with an ``AccessControl`` in ``access_control``
(``security.py``), ``execute(sql, user=...)`` checks the statement right
after the parse, before any planning, as the reference's runner does
(``_check_access``): every table a query reads needs the select privilege
(a name that a CTE in scope defines is not a table), and CTAS, INSERT and
DROP need their write privilege on the target. ``user`` defaults to the
session's.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import List, Optional

import numpy as np

from . import resolve_device
from .connectors.blackhole import BlackholeConnector
from .connectors.memory import MemoryConnector
from .connectors.tpcds.connector import TpcdsConnector
from .connectors.tpch.connector import TpchConnector
from .exec.grouped import analyze_grouped, merge_rows
from .exec.local_planner import LocalExecutionPlanner
from .exec.task_executor import TaskExecutor
from .metadata import CatalogManager, MetadataManager, Session
from .sql import tree as t
from .sql.parser import SqlParser
from .sql.planner.optimizer import optimize
from .sql.planner.plan import OutputNode, plan_to_text
from .sql.planner.planner import LogicalPlanner
from .types import BIGINT
from .utils import trace
from .utils.metrics import METRICS


def _virtual_remap(source_dict, target_dict):
    """-> callable(codes, live) -> int32 codes in ``target_dict``'s space,
    decoding a virtual source dictionary per page and extending the target
    with values it lacks. Only live rows decode: a masked or NULL row's
    stale code must never enter the dictionary. One lock, as writer
    drivers run concurrently."""
    lock = threading.Lock()

    def remap(codes, live):
        codes = np.asarray(codes, dtype=np.int64)
        out = np.zeros(len(codes), dtype=np.int32)
        sel = np.flatnonzero(np.asarray(live))
        if len(sel) == 0:
            return out
        uniq, inverse = np.unique(codes[sel], return_inverse=True)
        strings = [str(v) for v in source_dict.lookup(uniq)]
        with lock:
            mapped = np.asarray(target_dict.extend(strings), dtype=np.int32)
        out[sel] = mapped[inverse]
        return out
    return remap


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
    # the Chrome trace of a query_trace run (utils/trace.py); a failed
    # statement's forensic trace rides on its exception instead, as
    # ``failure_trace_path``, since there is no result then
    trace_path: Optional[str] = None


# query ids in the process-wide memory pool (itertools.count is atomic
# under the interpreter lock, so concurrent queries never share one)
_QUERY_MEM_SEQ = itertools.count(1)


def _pool_steps(pool_key: Optional[str]) -> int:
    """The steps this query's scans took on the shared scan pool (a plain
    int read, for live progress)."""
    if not pool_key:
        return 0
    from .exec.shared_pools import SCAN_POOL

    client = SCAN_POOL._clients.get(pool_key)
    return client.steps if client is not None else 0


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
            catalogs.register("memory", MemoryConnector("memory"))
            catalogs.register("blackhole", BlackholeConnector("blackhole"))
        self.catalogs = catalogs
        self.metadata = MetadataManager(catalogs)
        self.session = session or Session(catalog="tpch", schema="tiny")
        self.parser = SqlParser()
        # the bucket count of the last statement that ran grouped, else None
        self.last_grouped: Optional[int] = None

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

    # an AccessControl (security.py) that every statement is checked against
    access_control = None

    def _check_access(self, stmt, user: Optional[str] = None) -> None:
        """Raise ``AccessDeniedException`` unless ``user`` (default: the
        session's) may run ``stmt``: the reference's walk over the tables it
        names, before any planning."""
        ac = self.access_control
        if ac is None:
            return
        from .sql.analyzer import _ast_children

        user = user if user is not None else self.session.user

        def resolve(name_parts):
            return self.metadata.resolve_table_name(
                self.session, tuple(p.lower() for p in name_parts))

        def walk(node, cte_names=frozenset()):
            if isinstance(node, t.Query) and node.with_ is not None:
                names = set(cte_names)
                for cte_name, cte_query in node.with_.queries:
                    walk(cte_query, frozenset(names))  # a CTE's body is checked too
                    names.add(cte_name.lower())
                walk(node.body, frozenset(names))
                for c in _ast_children(node):
                    if c is not node.body and c is not node.with_:
                        walk(c, frozenset(names))
                return
            if isinstance(node, t.Table):
                # a one-part name that a CTE in scope defines is not a table
                if len(node.name) == 1 and node.name[0].lower() in cte_names:
                    return
                q = resolve(node.name)
                ac.check_can_select(user, q.catalog, q.schema, q.table)
                return
            for c in _ast_children(node):
                walk(c, cte_names)

        if isinstance(stmt, t.CreateTableAsSelect):
            q = resolve(stmt.name)
            ac.check_can_write(user, q.catalog, q.schema, q.table, "create")
            walk(stmt.query)
        elif isinstance(stmt, t.Insert):
            q = resolve(stmt.name)
            ac.check_can_write(user, q.catalog, q.schema, q.table, "insert")
            if stmt.query is not None:
                walk(stmt.query)
        elif isinstance(stmt, t.DropTable):
            q = resolve(stmt.name)
            ac.check_can_write(user, q.catalog, q.schema, q.table, "drop")
        else:
            walk(stmt)

    def execute(self, sql: str, user: Optional[str] = None) -> QueryResult:
        """Run one statement as ``user`` (default: the session's) under the
        query's flight recorder (full with ``query_trace``, else the coarse
        black box), histogramming its wall in ``query.wall_s``. A failing
        statement dumps the ring as a forensic trace pinned to the
        exception."""
        t0 = time.perf_counter()
        rec = trace.maybe_recorder(self.session)
        installed = rec is not None and trace.install(rec)
        try:
            if installed:
                with rec.span(trace.LIFECYCLE, "query"):
                    result = self._execute_statement(sql, user)
            else:
                result = self._execute_statement(sql, user)
        except BaseException as e:
            if installed:
                trace.attach_failure(e, rec, self.session)
            raise
        finally:
            if installed:
                trace.uninstall(rec)
        METRICS.histogram("query.wall_s", time.perf_counter() - t0)
        if installed and not rec.coarse:
            result.trace_path = trace.export(rec, self.session)
        return result

    def _execute_statement(self, sql: str, user: Optional[str] = None) -> QueryResult:
        self.last_grouped = None  # set again on the grouped path
        with trace.span(trace.LIFECYCLE, "parse"):
            stmt = self.parser.parse(sql)
        self._check_access(stmt, user)
        if isinstance(stmt, t.Explain):
            if not isinstance(stmt.statement, t.Query):
                raise ValueError("EXPLAIN requires a query")
            if stmt.analyze:
                text = self._explain_analyze(stmt.statement)
            else:
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
        if isinstance(stmt, (t.CreateTableAsSelect, t.Insert, t.DropTable)):
            return self._execute_write(stmt)
        if not isinstance(stmt, t.Query):
            raise NotImplementedError(
                f"{type(stmt).__name__} statements are not ported to presto_tpu_torch")
        self.session.check_supported()
        with trace.span(trace.LIFECYCLE, "plan"):
            plan = self.plan_statement(stmt)
        g = analyze_grouped(plan, self.metadata, self.session)
        if g is not None:
            self.last_grouped = g.bucket_count
        results, scan_stats, seg_stats, resident = [], {}, None, 0
        for bucket in (range(g.bucket_count) if g is not None else [None]):
            exec_plan, drivers, _wall = self._run_plan(plan, bucket_filter=bucket)
            results.append(exec_plan.sink.rows())
            for k, v in (_scan_pipeline_stats(drivers) or {}).items():
                scan_stats[k] = round(scan_stats.get(k, 0) + v, 6)
            seg = _segment_stats(exec_plan)
            if seg is not None:
                if seg_stats is None:
                    seg_stats = seg
                else:  # counters summed over the buckets, one decision set
                    for k in ("count", "dispatches", "compiles"):
                        seg_stats[k] += seg[k]
                    seg_stats["segments"].extend(seg["segments"])
            resident += sum(getattr(op, "resident_hits", 0)
                            for d in drivers for op in d.operators)
        stats = {}
        if scan_stats:
            stats["scan_pipeline"] = scan_stats
        if seg_stats is not None:
            stats["segments"] = seg_stats
        return QueryResult(
            merge_rows(results, g) if g is not None else results[0],
            exec_plan.output_names, exec_plan.output_types, stats=stats or None,
            drivers=[getattr(chain[0], "parallel_drivers", 1) for chain in exec_plan.pipelines],
            resident_pages=resident)

    def _run_plan(self, plan: OutputNode, bucket_filter: Optional[int] = None):
        """The execution recipe of queries and EXPLAIN ANALYZE (the writes
        attach the same memory): local planning with the query's memory
        attached, a live-progress provider while the drivers run, and the
        query's reservations cleared in the ``finally``. ``bucket_filter``:
        the one bucket a grouped query's scans read this run.
        -> (exec_plan, drivers, wall seconds of the run)."""
        from .exec import progress
        from .exec.explain import driver_stats

        mem, over_target, release = self._query_memory()
        unregister = lambda: None  # noqa: E731 - rebound once the drivers exist
        try:
            with trace.span(trace.LIFECYCLE, "local_plan"):
                local = LocalExecutionPlanner(self.metadata, self.session, self.device,
                                              bucket_filter=bucket_filter)
                local.attach_memory(mem, over_target)
                exec_plan = local.plan(plan)
                drivers = exec_plan.create_drivers()

            def live() -> dict:
                return {"operators": driver_stats(drivers),
                        "memory_reserved_bytes": mem.total_bytes(),
                        "pool_steps": _pool_steps(local.scan_options.get("pool_key"))}
            unregister = progress.register(live)
            t0 = time.perf_counter()
            with trace.span(trace.LIFECYCLE, "execute"):
                self._run_drivers(drivers)
            return exec_plan, drivers, time.perf_counter() - t0
        finally:
            unregister()
            release()

    def _run_drivers(self, drivers) -> None:
        try:
            TaskExecutor(int(self.session.get("task_concurrency"))).execute(drivers)
        except BaseException:
            # abandoned drivers tear down (their scan stages stop and their
            # pool clients are released) before the error propagates, and
            # before the query's reservations are cleared
            for d in drivers:
                d.close()
            raise

    def _explain_analyze(self, stmt: t.Query) -> str:
        """Run the query through ``_run_plan`` and render every driver's
        operator stats (rows, wall, blocked, peak memory), the fused
        segments, the scan stages and the plan, as the reference does."""
        from .exec.explain import driver_stats, table

        plan = self.plan_statement(stmt)
        exec_plan, drivers, wall = self._run_plan(plan)
        lines = [f"Query: {wall * 1000:.0f}ms wall, {len(drivers)} drivers, "
                 f"{sum(len(d.operators) for d in drivers)} operators", ""]
        lines += table(driver_stats(drivers), pipelines=True)
        seg = _segment_stats(exec_plan)
        if seg:
            lines += ["", f"fused segments: {seg['count']} fused, "
                          f"{seg['dispatches']} dispatches, {seg['compiles']} compiles"]
            for sg in seg["segments"]:
                lines.append(f"  pipeline {sg['pipeline']}: {'+'.join(sg['operators'])} "
                             f"({sg['dispatches']} dispatches, {sg['compiles']} compiles)")
        scan = _scan_pipeline_stats(drivers)
        if scan:
            lines += ["", "scan pipeline: " + ", ".join(f"{k}={scan[k]}" for k in sorted(scan))]
        lines += ["", plan_to_text(plan)]
        return "\n".join(lines)

    def _query_memory(self):
        """The query's memory root on the process-wide GENERAL pool ->
        (memory, over_target, release). The probe fires when the pool, all
        queries together, is over ``revoke_target_fraction`` of its size, or
        when this query alone is over that fraction of its session's
        ``memory_pool_bytes`` (the shared pool only grows, so a small
        session budget still revokes); ``release`` clears this query's
        reservations at its end.

        The query's disk tier rides along as ``memory.spill``: a
        ``SpillManager`` when ``spill_to_disk`` is on, else None.
        ``attach_memory`` lifts it into the factories, and ``release``
        closes it (its files deleted, its ledger bytes freed) before the
        reservations are cleared."""
        from .exec.spill import SpillManager
        from .memory import QueryContextMemory, shared_general_pool

        session_bytes = int(self.session.get("memory_pool_bytes"))
        pool = shared_general_pool(session_bytes)
        qid = f"query-{next(_QUERY_MEM_SEQ)}"
        qmem = QueryContextMemory(qid, pool, int(self.session.get("query_max_memory_bytes")))
        target = float(self.session.get("revoke_target_fraction"))
        spill = None
        if bool(self.session.get("spill_to_disk")):
            spill = SpillManager(qid, pool, spill_dir=str(self.session.get("spill_dir") or ""),
                                 max_bytes=int(self.session.get("spill_max_bytes") or 0))
        qmem.memory.spill = spill

        def over_target() -> bool:
            return (pool.reserved_bytes() > pool.max_bytes * target
                    or pool.query_bytes(qid) > session_bytes * target)

        def release() -> None:
            if spill is not None:
                spill.close()
            pool.clear_query(qid)
        return qmem.memory, over_target, release

    def _execute_write(self, stmt) -> QueryResult:
        """CTAS / INSERT / DROP (the reference's ``_execute_write``): plan
        the source query, swap its result sink for table writers feeding the
        connector's page sinks, run, and commit the written fragments. The
        error messages are the reference's, word for word."""
        from .block import Dictionary
        from .ops.writer import TableWriterOperatorFactory
        from .spi.connector import ColumnMetadata, SchemaTableName, TableMetadata
        from .types import UNKNOWN, ArrayType, MapType
        from .utils.testing import PageConsumerFactory

        qname = self.metadata.resolve_table_name(
            self.session, tuple(p.lower() for p in stmt.name))
        conn = self.metadata.connector(qname.catalog)
        meta = conn.metadata()
        name = SchemaTableName(qname.schema, qname.table)
        handle = meta.get_table_handle(name)

        if isinstance(stmt, t.DropTable):
            if handle is None:
                if stmt.exists_ok:
                    return QueryResult([[0]], ["rows"], [BIGINT])
                raise ValueError(f"table {qname} does not exist")
            meta.drop_table(handle)
            return QueryResult([[0]], ["rows"], [BIGINT])

        # the source plan first: its output schema defines or checks the
        # target columns
        self.session.check_supported()
        plan = self.plan_statement(stmt.query)
        # the query's memory, as in _run_plan: attached before planning,
        # its reservations cleared however the write ends
        mem, over_target, mem_release = self._query_memory()
        try:
            local = LocalExecutionPlanner(self.metadata, self.session, self.device)
            local.attach_memory(mem, over_target)
            exec_plan = local.plan(plan)
            for n, tt in zip(exec_plan.output_names, exec_plan.output_types):
                if isinstance(tt, (ArrayType, MapType)):
                    # handles index a store that lives as long as the query
                    raise ValueError(
                        f"column {n}: {tt.name} values cannot be persisted "
                        f"(array_agg/map_agg outputs are query-scoped)")

            created = False
            remaps: List[Optional[object]] = []
            casts: List[Optional[object]] = []
            if isinstance(stmt, t.CreateTableAsSelect):
                if handle is not None:
                    if stmt.not_exists:
                        return QueryResult([[0]], ["rows"], [BIGINT])
                    raise ValueError(f"table {qname} already exists")
                if len(set(exec_plan.output_names)) != len(exec_plan.output_names):
                    raise ValueError(
                        f"CTAS output has duplicate column names: {exec_plan.output_names}")
                # materialized dictionaries are COPIED so the table owns them: a
                # later INSERT extends the table's, never a source connector's
                cols = tuple(
                    ColumnMetadata(n, tt, dictionary=(
                        Dictionary(list(d.values)) if d is not None and hasattr(d, "values")
                        else d))
                    for n, tt, d in zip(exec_plan.output_names, exec_plan.output_types,
                                        exec_plan.output_dicts))
                props = dict(stmt.properties)
                if props:
                    meta.create_table(TableMetadata(name, cols), properties=props)
                else:
                    meta.create_table(TableMetadata(name, cols))
                handle = meta.get_table_handle(name)
                created = True
            else:  # INSERT
                if handle is None:
                    raise ValueError(f"table {qname} does not exist")
                tcols = list(meta.get_table_metadata(handle).columns)
                if stmt.columns and list(stmt.columns) != [c.name for c in tcols]:
                    raise ValueError("INSERT column list must match the table "
                                     "schema (partial inserts not supported)")
                if len(tcols) != len(exec_plan.output_types):
                    raise ValueError(
                        f"INSERT has {len(exec_plan.output_types)} columns, "
                        f"table {qname} has {len(tcols)}")
                for c, st, sd in zip(tcols, exec_plan.output_types, exec_plan.output_dicts):
                    if st is UNKNOWN or st.name == "unknown":
                        # a typeless NULL column takes the table column's type
                        # at write time, its NULL flags riding along
                        casts.append(c.type)
                        remaps.append(None)
                        continue
                    casts.append(None)
                    if c.type.name != st.name:
                        raise ValueError(
                            f"INSERT type mismatch on {c.name}: {st.name} vs {c.type.name}")
                    if c.dictionary is None or sd is c.dictionary:
                        remaps.append(None)
                        continue
                    # re-encode the source codes into the table's private
                    # dictionary, extending it with values it has not seen
                    if sd is None or not hasattr(c.dictionary, "values"):
                        raise ValueError(
                            f"INSERT into dictionary column {c.name} requires a "
                            "materialized target dictionary")
                    if not hasattr(sd, "values"):
                        remaps.append(_virtual_remap(sd, c.dictionary))
                        continue
                    remaps.append(np.asarray(c.dictionary.extend([str(v) for v in sd.values]),
                                             dtype=np.int32))

            sink_provider = conn.page_sink_provider()
            if sink_provider is None:
                raise ValueError(f"catalog {qname.catalog} is not writable")
            insert_handle = meta.begin_insert(handle)
            is_insert = isinstance(stmt, t.Insert)
            if is_insert and any(r is not None for r in remaps):
                # INSERT pages carry the table's dictionaries; CTAS pages keep
                # their source dictionaries (the table's copies match them)
                column_dicts = [c.dictionary for c in meta.get_table_metadata(handle).columns]
                writer_fac = TableWriterOperatorFactory(9000, sink_provider, insert_handle,
                                                        remaps=remaps, column_dicts=column_dicts,
                                                        casts=casts)
            elif is_insert and any(c is not None for c in casts):
                writer_fac = TableWriterOperatorFactory(9000, sink_provider, insert_handle,
                                                        casts=casts)
            else:
                writer_fac = TableWriterOperatorFactory(9000, sink_provider, insert_handle)
            count_sink = PageConsumerFactory(9001, [BIGINT])
            n_writers = self._scaled_writer_count(plan)
            if n_writers > 1:
                from .ops.local_exchange import (LocalExchangeFactory, LocalExchangeSinkFactory,
                                                 LocalExchangeSourceFactory)

                # pages are DEALT round-robin, so every writer gets a share
                # however fast the source bursts pages into the buffer
                lx = LocalExchangeFactory(n_producers=1, max_pages=2 * n_writers + 2,
                                          deal_slots=n_writers)
                exec_plan.pipelines[-1] = exec_plan.pipelines[-1][:-1] + \
                    [LocalExchangeSinkFactory(9002, lx, [])]
                for _ in range(n_writers):
                    exec_plan.pipelines.append(
                        [LocalExchangeSourceFactory(9003, lx, []), writer_fac, count_sink])
            else:
                exec_plan.pipelines[-1] = exec_plan.pipelines[-1][:-1] + [writer_fac, count_sink]
            drivers = exec_plan.create_drivers()
            try:
                self._run_drivers(drivers)
            except BaseException:
                for s in writer_fac.sinks:
                    s.abort()
                if created:  # CTAS is atomic: roll the metadata back
                    meta.drop_table(handle)
                raise
            fragments = [p for s in writer_fac.sinks for p in s.finish()]
            meta.finish_insert(insert_handle, fragments)
            total = sum(r[0] for r in count_sink.rows())
            return QueryResult([[total]], ["rows"], [BIGINT])
        finally:
            mem_release()

    def _scaled_writer_count(self, plan: OutputNode) -> int:
        """K writer drivers when the source is large enough that each of K
        sinks stays above ``writer_min_rows_per_driver`` rows, at most
        ``task_concurrency``."""
        if not self.session.get("scaled_writers"):
            return 1
        try:
            from .sql.planner.optimizer import estimate_rows
            est = estimate_rows(plan.source, self.metadata)
        except Exception:  # noqa: BLE001 - no estimate: one writer
            return 1
        per_driver = int(self.session.get("writer_min_rows_per_driver"))
        cap = int(self.session.get("task_concurrency"))
        return max(1, min(cap, int(est // max(per_driver, 1))))
