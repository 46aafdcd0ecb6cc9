"""DB-API connector family of the PyTorch port: external relational databases as catalogs.

Counterpart of ``presto_tpu/connectors/dbapi/__init__.py`` (presto-base-jdbc's
BaseJdbcClient, JdbcMetadata, JdbcSplitManager and record set, with its
concrete drivers): the generic layer speaks Python's DB-API 2.0, and a
``Dialect`` supplies what JDBC metadata gives the reference (connection,
table and column discovery, type mapping, identifier quoting).
``SqliteDialect`` is the built-in driver over the standard library's
``sqlite3``.

Pushdown: the scan's columns and the planner's ``[lo, hi]`` domains
(``exec/local_planner._extract_constraint``) become the remote SELECT's
column list and WHERE clause (``_where_clause``), so the external database
filters before anything crosses into the engine. A varchar column gets a
plan-time dictionary from ``SELECT DISTINCT`` (at most
``MAX_VARCHAR_DICTIONARY`` values). Writes (CTAS, INSERT) go through one
transaction per sink, committed at ``finish``.

The reference converts each written value in Python
(``DbApiPageSink.append_page``). Here the sink converts a column at once
where its type allows (``_remote_column``: the ints of an integer or DECINT
column as they are, a date column through numpy's ISO text), with the
reference's per-value code for any other type; the rows written (values
and sqlite storage classes) are the reference's
(``tests/test_torch_dbapi_connector.py``).
"""
from __future__ import annotations

import datetime
import sys
import threading
from decimal import Decimal
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...block import Block, Dictionary, Page
from ...spi.connector import (ColumnHandle, ColumnMetadata, Connector, ConnectorMetadata,
                              ConnectorPageSink, ConnectorPageSinkProvider,
                              ConnectorPageSource, ConnectorPageSourceProvider,
                              ConnectorSplitManager, Constraint, SchemaTableName, Split,
                              TableHandle, TableMetadata, TableStatistics)
from ...types import (BIGINT, BOOLEAN, DATE, DOUBLE, TIMESTAMP, VARCHAR, DecimalType, Type,
                      is_string, parse_type)
from ...utils.batching import clamp_capacity

MAX_VARCHAR_DICTIONARY = 1 << 20
_EPOCH_DATE = datetime.date(1970, 1, 1)
# the days of datetime.date's range, 0001-01-01 .. 9999-12-31
_MIN_DAY = (datetime.date.min - _EPOCH_DATE).days
_MAX_DAY = (datetime.date.max - _EPOCH_DATE).days


class Dialect:
    """What a concrete driver provides (the BaseJdbcClient surface)."""

    name = "generic"

    def connect(self):
        raise NotImplementedError

    def list_schemas(self, conn) -> List[str]:
        raise NotImplementedError

    def list_tables(self, conn, schema: str) -> List[str]:
        raise NotImplementedError

    def columns(self, conn, schema: str, table: str) -> List[Tuple[str, Type, bool]]:
        """-> [(column name, engine type, raw_substrate)].

        ``raw_substrate`` marks a column that stores the engine's substrate
        value directly (a sqlite DECINT column holds the unscaled decimal
        int), as against the remote database's native values; the read and
        write paths convert accordingly."""
        raise NotImplementedError

    def quote(self, ident: str) -> str:
        return '"' + ident.replace('"', '""') + '"'

    def qualified(self, schema: str, table: str) -> str:
        return f"{self.quote(schema)}.{self.quote(table)}"

    def create_table_sql(self, schema: str, table: str,
                         columns: Sequence[ColumnMetadata]) -> str:
        defs = ", ".join(f"{self.quote(c.name)} {self.type_to_sql(c.type)}" for c in columns)
        return f"CREATE TABLE {self.qualified(schema, table)} ({defs})"

    def type_to_sql(self, t: Type) -> str:
        """Declared SQL type for CTAS. It must round-trip through the
        dialect's column-type mapping, or values written in substrate units
        read back corrupted."""
        if is_string(t):
            return "VARCHAR"
        if t.name in ("double", "real"):
            return "DOUBLE PRECISION"
        if isinstance(t, DecimalType):
            # DECINT has INTEGER affinity in sqlite, so the unscaled int64
            # substrate stores exactly (a REAL or NUMERIC column would
            # corrupt decimals above 2^53); _affinity_type inverts it
            return f"DECINT({t.precision},{t.scale})"
        if t.name == "date":
            return "DATE"
        if t.name == "timestamp":
            return "TIMESTAMP"
        if t.name == "boolean":
            return "BOOLEAN"
        return "BIGINT"


class SqliteDialect(Dialect):
    """Concrete driver over the standard library's sqlite3.

    sqlite has no schemas: every table is in schema ``main`` (sqlite's own
    name for it). Types come from declared column affinities."""

    name = "sqlite"

    def __init__(self, path: str):
        self.path = path

    def connect(self):
        import sqlite3

        # one connection shared under DbApiMetadata's lock; the task
        # executor moves drivers across threads, so sqlite's same-thread
        # check is off
        conn = sqlite3.connect(self.path, check_same_thread=False)
        conn.row_factory = None
        return conn

    def list_schemas(self, conn) -> List[str]:
        return ["main"]

    def list_tables(self, conn, schema: str) -> List[str]:
        if schema != "main":
            return []
        cur = conn.execute("select name from sqlite_master where type = 'table' "
                           "and name not like 'sqlite_%' order by name")
        return [r[0] for r in cur.fetchall()]

    def columns(self, conn, schema: str, table: str) -> List[Tuple[str, Type, bool]]:
        cur = conn.execute(f"PRAGMA table_info({self.quote(table)})")
        out = []
        for _cid, name, decl, _notnull, _default, _pk in cur.fetchall():
            d = (decl or "").upper()
            out.append((name.lower(), _affinity_type(decl or ""), d.startswith("DECINT")))
        return out

    def qualified(self, schema: str, table: str) -> str:
        return self.quote(table)  # sqlite: no schema qualifier


def _affinity_type(decl: str) -> Type:
    """sqlite's type-affinity rules -> engine types (BaseJdbcClient's
    toPrestoType). It inverts ``Dialect.type_to_sql``, so a CTAS
    round-trips."""
    d = decl.upper()
    if d.startswith("DECINT"):
        p_, s_ = (int(x) for x in d[len("DECINT"):].strip("() ").split(","))
        return DecimalType(p_, s_)
    if "BOOL" in d:
        return BOOLEAN
    if "INT" in d:
        return BIGINT
    if any(k in d for k in ("CHAR", "CLOB", "TEXT")):
        return VARCHAR
    if any(k in d for k in ("REAL", "FLOA", "DOUB")):
        return DOUBLE
    if "DEC" in d or "NUM" in d:
        try:
            return parse_type(decl.lower())
        except ValueError:
            return DOUBLE
    if "TIMESTAMP" in d or "TIME" in d:
        return TIMESTAMP
    if "DATE" in d:
        return DATE
    return VARCHAR  # sqlite's catch-all affinity


class DbApiMetadata(ConnectorMetadata):
    def __init__(self, connector_id: str, dialect: Dialect):
        self.connector_id = connector_id
        self.dialect = dialect
        self._dicts: Dict[Tuple[SchemaTableName, str], Dictionary] = {}
        self._substrate: Dict[SchemaTableName, set] = {}
        self._lock = threading.Lock()
        # ONE shared connection under an RLock: the task executor moves
        # drivers across threads, and a sink's commit must see the pages
        # inserted from other threads (per-thread connections would commit
        # nothing)
        self._conn_obj = None
        self.conn_lock = threading.RLock()

    def _conn(self):
        with self.conn_lock:
            if self._conn_obj is None:
                self._conn_obj = self.dialect.connect()
            return self._conn_obj

    def list_schemas(self) -> List[str]:
        with self.conn_lock:
            return self.dialect.list_schemas(self._conn())

    def list_tables(self, schema: Optional[str] = None) -> List[SchemaTableName]:
        out = []
        for s in ([schema] if schema else self.list_schemas()):
            with self.conn_lock:
                tables = self.dialect.list_tables(self._conn(), s)
            out.extend(SchemaTableName(s, t) for t in tables)
        return out

    def get_table_handle(self, name: SchemaTableName) -> Optional[TableHandle]:
        with self.conn_lock:
            tables = self.dialect.list_tables(self._conn(), name.schema)
        if name.table in tables:
            return TableHandle(self.connector_id, name)
        return None

    def get_table_metadata(self, table: TableHandle) -> TableMetadata:
        name = table.schema_table
        with self.conn_lock:
            cols = self.dialect.columns(self._conn(), name.schema, name.table)
        if not cols:
            raise ValueError(f"no such table {name}")
        metas = [ColumnMetadata(cname, ctype,
                                dictionary=self._dictionary(name, cname)
                                if is_string(ctype) else None)
                 for cname, ctype, _raw in cols]
        return TableMetadata(name, tuple(metas))

    def substrate_columns(self, name: SchemaTableName) -> set:
        """Names of the columns whose remote storage is the engine substrate
        (engine-created DECINT); external decimal columns convert. Cached,
        since every scan and sink asks, and dropped with the dictionaries
        on create and drop."""
        with self._lock:
            hit = self._substrate.get(name)
        if hit is not None:
            return hit
        with self.conn_lock:
            cols = self.dialect.columns(self._conn(), name.schema, name.table)
        out = {cname for cname, _t, raw in cols if raw}
        with self._lock:
            self._substrate[name] = out
        return out

    def _dictionary(self, name: SchemaTableName, column: str) -> Dictionary:
        """Plan-time dictionary from SELECT DISTINCT (bounded), cached until
        a write through this connector drops it."""
        key = (name, column)
        with self._lock:
            hit = self._dicts.get(key)
            if hit is not None:
                return hit
        q = self.dialect.qualified(name.schema, name.table)
        with self.conn_lock:
            cur = self._conn().execute(
                f"SELECT DISTINCT {self.dialect.quote(column)} FROM {q} "
                f"LIMIT {MAX_VARCHAR_DICTIONARY + 1}")
            vals = [r[0] for r in cur.fetchall() if r[0] is not None]
        if len(vals) > MAX_VARCHAR_DICTIONARY:
            raise ValueError(f"varchar column {column!r} of {name} exceeds "
                             f"{MAX_VARCHAR_DICTIONARY} distinct values")
        d = Dictionary(sorted(str(v) for v in vals))
        with self._lock:
            self._dicts[key] = d
        return d

    def _forget(self, name: SchemaTableName, substrate: bool = True) -> None:
        with self._lock:
            self._dicts = {k: v for k, v in self._dicts.items() if k[0] != name}
            if substrate:
                self._substrate.pop(name, None)

    def get_table_statistics(self, table: TableHandle,
                             constraint: Constraint) -> TableStatistics:
        q = self.dialect.qualified(table.schema_table.schema, table.schema_table.table)
        types = {c.name: c.type for c in self.get_table_metadata(table).columns}
        where, params = _where_clause(self.dialect, constraint, types)
        with self.conn_lock:
            cur = self._conn().execute(f"SELECT COUNT(*) FROM {q}{where}", params)
            return TableStatistics(row_count=float(cur.fetchone()[0]))

    # --------------------------------------------------------------- writes

    def create_table(self, metadata: TableMetadata, properties=None) -> None:
        if properties:
            raise ValueError(f"{self.dialect.name} tables take no properties")
        name = metadata.name
        with self.conn_lock:
            conn = self._conn()
            conn.execute(self.dialect.create_table_sql(name.schema, name.table,
                                                       metadata.columns))
            conn.commit()
        self._forget(name)  # a recreated table must not see stale dictionaries

    def begin_insert(self, table: TableHandle):
        return table

    def finish_insert(self, handle, fragments) -> None:
        self._forget(handle.schema_table, substrate=False)  # new distinct strings

    def drop_table(self, table: TableHandle) -> None:
        name = table.schema_table
        with self.conn_lock:
            conn = self._conn()
            conn.execute(f"DROP TABLE {self.dialect.qualified(name.schema, name.table)}")
            conn.commit()
        self._forget(name)


def _where_clause(dialect: Dialect, constraint: Constraint,
                  types: Optional[Dict[str, Type]] = None,
                  columns: Optional[set] = None) -> Tuple[str, list]:
    """Constraint domains -> the pushed-down WHERE (BaseJdbcClient.buildSql's
    TupleDomain translation, narrowed to [lo, hi] ranges).

    Domains arrive in the engine's substrate units (scaled decimal ints,
    date days); the remote database stores native values, so each is
    converted by its column's type. Varchar domains (dictionary codes),
    decimal and timestamp domains never push down."""
    conds, params = [], []
    for col, dom in constraint.domains.items():
        if columns is not None and col not in columns:
            continue
        t = types.get(col) if types else None
        if t is not None and (is_string(t) or isinstance(t, DecimalType)
                              or t.name == "timestamp"):
            # decimal and timestamp remote forms are ambiguous (DECINT or
            # NUMERIC, text or epoch): the engine's filter refines instead
            continue
        lo, hi = dom if isinstance(dom, tuple) else (None, None)
        if lo is not None:
            conds.append(f"{dialect.quote(col)} >= ?")
            params.append(_remote_value(lo, t))
        if hi is not None:
            conds.append(f"{dialect.quote(col)} <= ?")
            params.append(_remote_value(hi, t))
    return (" WHERE " + " AND ".join(conds) if conds else ""), params


def _remote_value(v, t: Optional[Type]):
    """Engine substrate value -> the remote database's native value."""
    if t is not None and t.name == "date":
        return (_EPOCH_DATE + datetime.timedelta(days=int(v))).isoformat()
    return v


class DbApiSplitManager(ConnectorSplitManager):
    """One split per table (JdbcSplitManager's default: the remote database
    is the parallelism domain, not the engine)."""

    def __init__(self, connector_id: str):
        self.connector_id = connector_id

    def get_splits(self, table: TableHandle, constraint: Constraint,
                   desired_splits: int) -> List[Split]:
        return [Split(self.connector_id, payload=(table.schema_table,))]


class DbApiPageSource(ConnectorPageSource):
    def __init__(self, metadata: DbApiMetadata, split: Split,
                 columns: Sequence[ColumnHandle], capacity: int, constraint: Constraint):
        self._metadata = metadata
        self.split = split
        self.columns = list(columns)
        self.capacity = capacity
        self.constraint = constraint
        self.rows_fetched = 0

    def __iter__(self) -> Iterator[Page]:
        name = self.split.payload[0]
        dialect = self._metadata.dialect
        meta = self._metadata.get_table_metadata(TableHandle(self._metadata.connector_id, name))
        if not self.columns:
            return
        want = {c.name for c in self.columns}
        sel = ", ".join(dialect.quote(c.name) for c in self.columns)
        types = {c.name: c.type for c in meta.columns}
        where, params = _where_clause(dialect, self.constraint, types, want)
        q = dialect.qualified(name.schema, name.table)
        cap = self.capacity
        substrate = self._metadata.substrate_columns(name)
        # the whole result is fetched under ONE lock hold: released between
        # batches, a writer on the same shared connection could interleave
        # and the open cursor would see its rows mid-scan (INSERT INTO t
        # SELECT FROM t would re-read its own inserts). Snapshot semantics
        # over O(batch) memory; a dialect with per-connection isolation
        # could stream.
        with self._metadata.conn_lock:
            cur = self._metadata._conn().execute(f"SELECT {sel} FROM {q}{where}", params)
            batches = []
            while True:
                b = cur.fetchmany(cap)
                if not b:
                    break
                batches.append(b)
        for batch in batches:
            n = len(batch)
            self.rows_fetched += n
            bcap = clamp_capacity(n, cap)
            cols = list(zip(*batch))
            blocks = [_typed_block(meta.column(c.name), list(vals), bcap, c.name in substrate)
                      for c, vals in zip(self.columns, cols)]
            yield Page(tuple(blocks), torch.arange(bcap) < n)


def _typed_block(cm: ColumnMetadata, vals: List[object], cap: int,
                 raw_substrate: bool = False) -> Block:
    """One column of a fetched batch -> a host Block of ``cap`` rows."""
    n = len(vals)
    nulls = None
    if any(v is None for v in vals):
        nulls = np.zeros(cap, dtype=bool)
        nulls[:n] = [v is None for v in vals]
        nulls = torch.from_numpy(nulls)
    if is_string(cm.type):
        index = cm.dictionary.index() if cm.dictionary is not None else {}
        codes = np.zeros(cap, dtype=np.int32)
        for i, v in enumerate(vals):
            if v is not None:
                code = index.get(str(v))
                if code is None:
                    raise RuntimeError(
                        f"value {str(v)[:40]!r} missing from the plan-time "
                        f"dictionary of {cm.name} — table changed mid-query?")
                codes[i] = code
        return Block(cm.type, torch.from_numpy(codes), nulls, cm.dictionary)
    arr = np.zeros(cap, dtype=cm.type.np_dtype)
    for i, v in enumerate(vals):
        if v is None:
            continue
        if isinstance(cm.type, DecimalType):
            if raw_substrate:
                arr[i] = int(v)  # a DECINT column: the value is the substrate
            else:
                # an external decimal column: the real-world value, whatever
                # storage class sqlite gave it (int 5 for 5.00, float 5.25)
                arr[i] = int(round(Decimal(str(v)).scaleb(cm.type.scale)))
        elif cm.type.name == "date" and isinstance(v, str):
            arr[i] = (datetime.date.fromisoformat(v) - _EPOCH_DATE).days
        elif cm.type.name == "timestamp" and isinstance(v, str):
            dt = datetime.datetime.fromisoformat(v)
            epoch = datetime.datetime(1970, 1, 1, tzinfo=dt.tzinfo and datetime.timezone.utc)
            arr[i] = int((dt - epoch).total_seconds() * 1000)
        else:
            arr[i] = v
    return Block(cm.type, torch.from_numpy(arr), nulls, None)


class DbApiPageSourceProvider(ConnectorPageSourceProvider):
    def __init__(self, metadata: DbApiMetadata):
        self._metadata = metadata

    def create_page_source(self, split: Split, columns: Sequence[ColumnHandle],
                           page_capacity: int,
                           constraint: Constraint = Constraint.all()) -> ConnectorPageSource:
        return DbApiPageSource(self._metadata, split, columns, page_capacity, constraint)


class DbApiPageSink(ConnectorPageSink):
    """INSERT batches through executemany in ONE transaction, committed at
    ``finish``, so a failed multi-page insert leaves nothing behind
    (JdbcPageSink's commit discipline)."""

    def __init__(self, metadata: DbApiMetadata, table: TableHandle):
        self._metadata = metadata
        self._table = table
        self._meta = metadata.get_table_metadata(table)  # fixed for the sink
        self._substrate = metadata.substrate_columns(table.schema_table)
        self.rows_written = 0

    def append_page(self, page: Page) -> None:
        live = torch.nonzero(page.mask).squeeze(1)
        if live.numel() == 0:
            return
        cols = []
        for b, cm in zip(page.blocks, self._meta.columns):
            data = b.data[live].cpu().numpy()
            nulls = b.nulls[live].cpu().numpy() if b.nulls is not None else None
            cols.append(_remote_column(b, cm, data, nulls, cm.name in self._substrate))
        rows = list(zip(*cols))
        name = self._table.schema_table
        q = self._metadata.dialect.qualified(name.schema, name.table)
        holes = ", ".join("?" for _ in self._meta.columns)
        with self._metadata.conn_lock:
            self._metadata._conn().executemany(f"INSERT INTO {q} VALUES ({holes})", rows)
        self.rows_written += len(rows)

    def finish(self):
        with self._metadata.conn_lock:
            self._metadata._conn().commit()
        return []

    def abort(self) -> None:
        try:
            with self._metadata.conn_lock:
                self._metadata._conn().rollback()
        except Exception as e:
            # abort runs on the failure path: a rollback error must not mask
            # the query's error, but a half-applied INSERT must not pass
            # silently either
            print(f"presto_tpu_torch: dbapi abort: rollback failed: {e!r}", file=sys.stderr)


def _remote_column(b: Block, cm: ColumnMetadata, data: np.ndarray,
                   nulls: Optional[np.ndarray], substrate: bool) -> list:
    """One column of a written page's live rows -> the DB-API parameter
    values the reference writes (``_plain`` of its per-value conversion of
    the non-NULL rows): strings, unscaled ints for a DECINT column, ints,
    floats, bools, ISO dates; NULL rows None."""
    t = cm.type
    out = np.full(len(data), None, dtype=object)
    keep = np.ones(len(data), dtype=bool) if nulls is None else ~nulls
    x = data[keep]
    if b.dictionary is not None:
        vals = [None if s is None else str(s) for s in b.dictionary.lookup(x.astype(np.int64))]
    elif isinstance(t, DecimalType) and substrate:
        vals = x.tolist()
    elif t.name == "date" and (x.size == 0 or (x.min() >= _MIN_DAY and x.max() <= _MAX_DAY)):
        vals = x.astype("datetime64[D]").astype(str).tolist()
    elif t.name in ("bigint", "integer", "smallint"):
        vals = x.tolist()
    else:
        vals = [_plain(t.to_python(v)) for v in x.tolist()]
    out[keep] = vals if len(vals) else []
    return out.tolist()


def _plain(v):
    """DB-API parameter-friendly Python value."""
    if hasattr(v, "isoformat"):
        return v.isoformat()
    if type(v).__name__ == "Decimal":
        return float(v)
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, np.bool_):
        return bool(v)
    return v


class DbApiPageSinkProvider(ConnectorPageSinkProvider):
    def __init__(self, metadata: DbApiMetadata):
        self._metadata = metadata

    def create_page_sink(self, insert_handle) -> ConnectorPageSink:
        return DbApiPageSink(self._metadata, insert_handle)


class DbApiConnector(Connector):
    def __init__(self, connector_id: str, dialect: Dialect):
        self._metadata = DbApiMetadata(connector_id, dialect)
        self._splits = DbApiSplitManager(connector_id)
        self._sources = DbApiPageSourceProvider(self._metadata)
        self._sinks = DbApiPageSinkProvider(self._metadata)

    def metadata(self) -> ConnectorMetadata:
        return self._metadata

    def split_manager(self) -> ConnectorSplitManager:
        return self._splits

    def page_source_provider(self) -> ConnectorPageSourceProvider:
        return self._sources

    def page_sink_provider(self) -> Optional[ConnectorPageSinkProvider]:
        return self._sinks


def sqlite_connector(connector_id: str, path: str) -> DbApiConnector:
    return DbApiConnector(connector_id, SqliteDialect(path))
