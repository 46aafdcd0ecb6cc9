"""The /v1/statement protocol of the PyTorch port: query records and the
query manager (``presto_tpu/server/protocol.py``).

``QueryManager.submit`` records a query and runs it on a thread of its own
through the engine it wraps (a ``LocalQueryRunner``, a
``DistributedQueryRunner`` or a ``ClusterQueryRunner`` on its device);
clients page the finished rows through ``nextUri``. The wire shape is the
reference's, field for field: ``{"id", "infoUri", "nextUri", "columns":
[{"name", "type"}], "data": [[...]], "stats": {"state", ...}, "error":
{...}}``. A finished query keeps host values only (``_to_json_row``), so
the done-query history never holds device memory.

Optional wiring, each None by default: resource-group admission, the
``QueryMonitor`` of event listeners, access control, and one
``TransactionManager`` transaction per query over every catalog.
"""
from __future__ import annotations

import dataclasses
import datetime
import decimal
import itertools
import threading
import time
import traceback
from typing import Dict, List, Optional

import numpy as np
import torch

# QueryState.java vocabulary (narrowed to the states this engine reaches)
QUEUED = "QUEUED"
RUNNING = "RUNNING"
FINISHED = "FINISHED"
FAILED = "FAILED"
CANCELED = "CANCELED"

_DONE = {FINISHED, FAILED, CANCELED}


@dataclasses.dataclass
class QueryInfo:
    query_id: str
    sql: str
    state: str = QUEUED
    rows: Optional[List[list]] = None
    columns: Optional[List[Dict[str, str]]] = None
    error: Optional[Dict] = None
    # wall-clock timestamps (what clients display); duration math uses the
    # monotonic pair below — wall deltas jump under NTP steps
    create_time: float = dataclasses.field(default_factory=time.time)
    end_time: Optional[float] = None
    create_mono: float = dataclasses.field(default_factory=time.monotonic)
    end_mono: Optional[float] = None
    row_count: int = 0
    user: str = ""
    source: str = ""
    catalog: str = ""    # per-query default-catalog override (JDBC/DBAPI)
    schema: str = ""
    trace_token: str = ""   # X-Presto-Trace-Token correlation id
    # flight-recorder export (query_trace session knob): local path of the
    # Chrome trace JSON, served at GET /v1/query/{id}/trace
    trace_path: Optional[str] = None
    # black-box forensic dump (always-on coarse ring, utils/trace.py): set
    # when the query FAILED (from the exception's failure_trace_path) or
    # survived a failed attempt; /v1/query/{id}/trace serves it when no
    # opted-in trace exists — failed queries are debuggable after the fact
    failure_trace_path: Optional[str] = None

    def done(self) -> bool:
        return self.state in _DONE

    def elapsed_millis(self) -> int:
        return int(((self.end_mono if self.end_mono is not None
                     else time.monotonic()) - self.create_mono) * 1000)


class QueryManager:
    """Owns query lifecycle: submit -> background execute -> paged fetch.

    One engine serves every query; queries run on daemon threads (the HTTP
    layer never blocks on the engine), which ``close()`` joins."""

    def __init__(self, runner, page_rows: int = 1000,
                 max_done_queries: int = 100,
                 resource_groups=None, monitor=None, access_control=None,
                 transactions=None):
        self.runner = runner
        self.page_rows = page_rows
        # completed-query history is bounded (SqlQueryManager's expiration):
        # oldest done queries are evicted, their materialized rows with them
        self.max_done_queries = max_done_queries
        # service subsystems, all optional (None = allow-all / no-op):
        self.resource_groups = resource_groups   # ResourceGroupManager
        self.monitor = monitor                   # QueryMonitor (events)
        self.access_control = access_control     # AccessControl
        self.transactions = transactions         # TransactionManager
        self._queries: Dict[str, QueryInfo] = {}
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        # live execution threads by query id (removed by _run on exit):
        # close() joins them so shutdown never abandons a query mid-write
        # and tests never leak engine threads across cases
        self._run_threads: Dict[str, threading.Thread] = {}
        self._closed = False
        import inspect

        try:
            self._execute_takes_user = "user" in inspect.signature(
                runner.execute).parameters
        except (TypeError, ValueError):
            self._execute_takes_user = False

    # ----------------------------------------------------------------- api

    def submit(self, sql: str, user: str = "", source: str = "",
               catalog: str = "", schema: str = "",
               trace_token: str = "") -> QueryInfo:
        with self._lock:
            qid = f"q{next(self._ids)}_{int(time.time())}"
            info = QueryInfo(qid, sql, user=user, source=source,
                             catalog=catalog, schema=schema,
                             trace_token=trace_token)
            self._queries[qid] = info
            self._expire_locked()
        if self.monitor is not None:
            from ..spi.eventlistener import QueryCreatedEvent

            self.monitor.query_created(
                QueryCreatedEvent(qid, sql, user=user, source=source,
                                  trace_token=trace_token))
        from ..utils import events
        from ..utils.metrics import METRICS
        METRICS.count("query_manager.submitted")
        events.emit("query.submitted", query_id=qid, user=user, source=source)
        # daemon (a wedged kernel must not block interpreter exit) but
        # REGISTERED: close() joins every live one, bounded
        t = threading.Thread(target=self._run, args=(info,),
                             name=f"query-{qid}", daemon=True)
        with self._lock:
            if self._closed:
                info.state = FAILED
                info.error = {"message": "server is shutting down",
                              "errorType": "ServerShuttingDown"}
                info.end_time = time.time()
                info.end_mono = time.monotonic()
                return info
            self._run_threads[qid] = t
            # start INSIDE the lock: a concurrent close() must never snapshot
            # (and try to join) a registered-but-unstarted thread
            t.start()
        return info

    def _expire_locked(self) -> None:
        done = [q for q in self._queries.values() if q.done()]
        if len(done) <= self.max_done_queries:
            return
        done.sort(key=lambda q: q.end_time or 0)
        for q in done[:len(done) - self.max_done_queries]:
            self._queries.pop(q.query_id, None)

    def get(self, query_id: str) -> Optional[QueryInfo]:
        return self._queries.get(query_id)

    def cancel(self, query_id: str) -> bool:
        info = self._queries.get(query_id)
        if info is None:
            return False
        canceled = False
        with self._lock:
            if not info.done():
                # engine slices are not interruptible mid-kernel; the query is
                # marked canceled and its results are dropped on completion
                info.state = CANCELED
                info.end_time = time.time()
                info.end_mono = time.monotonic()
                canceled = True
        if canceled:
            from ..utils import events
            events.emit("query.canceled", severity=events.WARN,
                        query_id=query_id)
        return True

    def list_queries(self) -> List[QueryInfo]:
        return list(self._queries.values())

    def close(self, timeout_s: float = 10.0) -> None:
        """Join every live query thread (bounded on the WHOLE close): new
        submissions are refused, running queries get `timeout_s` to finish.
        A thread still alive after the deadline is abandoned (daemon) rather
        than hanging shutdown."""
        with self._lock:
            self._closed = True
            live = list(self._run_threads.values())
        deadline = time.monotonic() + timeout_s
        for t in live:
            t.join(timeout=max(0.0, deadline - time.monotonic()))

    def _scoped_runner(self, info: QueryInfo):
        """The engine with the query's default catalog and schema (the
        X-Presto-Catalog/Schema headers a DBAPI client sends): a shallow
        copy with its own session. It shares the engine's device, catalogs
        and metadata; the resident page cache, the memory pool and the
        kernel builds are process-wide, so the copy costs nothing."""
        if not (info.catalog or info.schema):
            return self.runner
        import copy
        import dataclasses as _dc

        runner = copy.copy(self.runner)
        runner.session = _dc.replace(
            runner.session,
            catalog=info.catalog or runner.session.catalog,
            schema=info.schema or runner.session.schema)
        return runner

    # ------------------------------------------------------------- execute

    def _run(self, info: QueryInfo) -> None:
        ticket = None
        tx = None
        t0 = time.monotonic()
        t_run = t0
        try:
            with self._lock:
                if info.state != QUEUED:  # canceled before the thread started
                    return
            if self.access_control is not None:
                self.access_control.check_can_execute_query(info.user)
            if self.resource_groups is not None:
                # may QUEUE the query (blocks this thread) or reject
                ticket = self.resource_groups.submit(
                    info.query_id, info.user, info.source)
            t_run = time.monotonic()  # cpu charge excludes queue wait
            with self._lock:
                if info.state != QUEUED:  # canceled while queued
                    return
                info.state = RUNNING
            if self.transactions is not None:
                tx = self.transactions.begin(info.query_id)
                # conservative join: every registered catalog (hooks are
                # no-ops for connectors without transaction support), so any
                # connector the query touches gets its commit/rollback —
                # qualified cross-catalog writes included
                for cat in self.transactions.catalog_names():
                    self.transactions.join(tx, cat)
            runner = self._scoped_runner(info)
            # live progress: the engine's _run_plan / schedulers register
            # their per-operator providers under THIS query id while the
            # query runs (served at GET /v1/query/{id})
            from ..exec import progress as _progress
            with _progress.query_scope(info.query_id):
                if self._execute_takes_user:
                    result = runner.execute(info.sql, user=info.user)
                else:
                    result = runner.execute(info.sql)
            rows = [self._to_json_row(r) for r in result.rows]
            if tx is not None:
                self.transactions.commit(tx)
                tx = None
            with self._lock:
                if info.state == CANCELED:
                    return
                info.rows = rows
                info.trace_path = getattr(result, "trace_path", None)
                info.failure_trace_path = getattr(
                    result, "failure_trace_path", None)
                info.row_count = len(rows)
                info.columns = [{"name": n, "type": self._type_name(result, i)}
                                for i, n in enumerate(result.column_names)]
                info.state = FINISHED
                info.end_time = time.time()
                info.end_mono = time.monotonic()
            from ..utils import events
            from ..utils.metrics import METRICS
            METRICS.count("query_manager.completed")
            METRICS.count("query_manager.output_rows", len(rows))
            events.emit("query.finished", query_id=info.query_id,
                        rows=len(rows),
                        wall_s=round(time.monotonic() - t_run, 4))
        except Exception as e:  # noqa: BLE001 - reported through the protocol
            with self._lock:
                info.error = {
                    "message": str(e),
                    "errorType": type(e).__name__,
                    "stack": traceback.format_exc()[-2000:],
                }
                # the engine's failure forensic (always-on black-box ring)
                # rides the exception; GET /v1/query/{id}/trace serves it
                info.failure_trace_path = getattr(e, "failure_trace_path",
                                                  None)
                info.state = FAILED
                info.end_time = time.time()
                info.end_mono = time.monotonic()
            from ..utils import events
            from ..utils.metrics import METRICS
            METRICS.count("query_manager.failed")
            events.emit("query.failed", severity=events.ERROR,
                        query_id=info.query_id, error=type(e).__name__,
                        message=str(e)[:500],
                        forensic=bool(info.failure_trace_path))
        finally:
            with self._lock:
                self._run_threads.pop(info.query_id, None)
            if tx is not None:
                self.transactions.abort(tx)
            if ticket is not None:
                self.resource_groups.finish(
                    ticket, cpu_seconds=time.monotonic() - t_run)
            if self.monitor is not None:
                from ..spi.eventlistener import QueryCompletedEvent

                self.monitor.query_completed(QueryCompletedEvent(
                    info.query_id, info.sql, state=info.state, user=info.user,
                    trace_token=info.trace_token,
                    row_count=info.row_count,
                    wall_seconds=time.monotonic() - t0, error=info.error))

    @staticmethod
    def _type_name(result, i: int) -> str:
        types = getattr(result, "types", None)
        if types and i < len(types):
            return getattr(types[i], "name", "unknown")
        return "unknown"

    @staticmethod
    def _to_json_row(row) -> list:
        """One result row as JSON values: DECIMAL as its text, DATE as ISO
        text, numpy and torch scalars as Python numbers. A tensor never
        reaches the payload or the history (a 0-d one is read to the host)."""
        out = []
        for v in row:
            if isinstance(v, torch.Tensor):
                v = v.item() if v.dim() == 0 else v.tolist()
            if isinstance(v, decimal.Decimal):
                out.append(str(v))
            elif isinstance(v, datetime.date):
                out.append(v.isoformat())
            elif isinstance(v, np.generic):
                out.append(v.item())
            else:
                out.append(v)
        return out

    # ------------------------------------------------------------ protocol

    def results_payload(self, info: QueryInfo, token: int,
                        base_uri: str) -> Dict:
        """QueryResults wire shape for page `token` (nextUri paging:
        StatementClientV1.java:86 advances until nextUri is absent)."""
        payload: Dict = {
            "id": info.query_id,
            "infoUri": f"{base_uri}/v1/query/{info.query_id}",
            "stats": {
                "state": info.state,
                "elapsedTimeMillis": info.elapsed_millis(),
                "processedRows": info.row_count,
            },
        }
        if info.state == FAILED:
            payload["error"] = info.error
            return payload
        if info.state in (QUEUED, RUNNING):
            # not ready: client polls the same token
            payload["nextUri"] = \
                f"{base_uri}/v1/statement/{info.query_id}/{token}"
            return payload
        if info.state == CANCELED:
            # surface cancellation as an error: a client mid-pagination must
            # raise, not mistake the truncated rows for a complete result
            payload["error"] = {"message": "Query was canceled",
                                "errorType": "QueryCanceled"}
            return payload
        # FINISHED: serve page `token`, advance nextUri while rows remain
        lo = token * self.page_rows
        hi = lo + self.page_rows
        payload["columns"] = info.columns
        if lo < info.row_count:
            payload["data"] = info.rows[lo:hi]
        if hi < info.row_count:
            payload["nextUri"] = \
                f"{base_uri}/v1/statement/{info.query_id}/{token + 1}"
        return payload
