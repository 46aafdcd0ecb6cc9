"""PEP 249 (DB-API 2.0) driver of the PyTorch port over the /v1/statement
protocol (``presto_tpu/client/dbapi.py``).

``connect()`` -> Connection -> Cursor with execute / executemany / fetchone
/ fetchmany / fetchall / description, the PEP 249 exception hierarchy, and
qmark parameters rendered into SQL literals on the client. stdlib only::

    import presto_tpu_torch.client.dbapi as dbapi
    conn = dbapi.connect(host="localhost", port=8080,
                         catalog="tpch", schema="sf1", user="alice")
    cur = conn.cursor()
    cur.execute("select n_name from nation where n_nationkey > ?", (10,))
    print(cur.fetchall())
"""
from __future__ import annotations

import datetime
import time as _time
from typing import Any, Iterator, List, Optional, Sequence, Tuple

from . import QueryError, StatementClient

apilevel = "2.0"
threadsafety = 2          # threads may share the module and connections
paramstyle = "qmark"


# --------------------------------------------------------------------------
# exceptions (PEP 249 hierarchy)
# --------------------------------------------------------------------------

class Warning(Exception):  # noqa: A001 - name mandated by PEP 249
    pass


class Error(Exception):
    pass


class InterfaceError(Error):
    pass


class DatabaseError(Error):
    pass


class DataError(DatabaseError):
    pass


class OperationalError(DatabaseError):
    pass


class IntegrityError(DatabaseError):
    pass


class InternalError(DatabaseError):
    pass


class ProgrammingError(DatabaseError):
    pass


class NotSupportedError(DatabaseError):
    pass


# --------------------------------------------------------------------------
# type objects + constructors (PEP 249)
# --------------------------------------------------------------------------

class _DBAPITypeObject:
    def __init__(self, *names: str):
        self.names = frozenset(names)

    def __eq__(self, other) -> bool:
        return other in self.names

    def __hash__(self):
        return hash(self.names)


STRING = _DBAPITypeObject("varchar", "char", "string")
BINARY = _DBAPITypeObject("varbinary")
NUMBER = _DBAPITypeObject("bigint", "integer", "smallint", "double", "real",
                          "decimal", "boolean")
DATETIME = _DBAPITypeObject("date", "timestamp")
ROWID = _DBAPITypeObject()

Date = datetime.date
Time = datetime.time
Timestamp = datetime.datetime


def DateFromTicks(ticks):  # noqa: N802 - PEP 249 names
    return Date.fromtimestamp(ticks)


def TimeFromTicks(ticks):  # noqa: N802
    return Time(*_time.localtime(ticks)[3:6])


def TimestampFromTicks(ticks):  # noqa: N802
    return Timestamp.fromtimestamp(ticks)


def Binary(data):  # noqa: N802
    return bytes(data)


# --------------------------------------------------------------------------
# parameter rendering
# --------------------------------------------------------------------------

def _render(value: Any) -> str:
    """One parameter -> SQL literal (the PrestoPreparedStatement pattern)."""
    if value is None:
        return "NULL"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, (int, float)):
        return repr(value)
    if isinstance(value, Timestamp):
        fmt = "%Y-%m-%d %H:%M:%S.%f" if value.microsecond \
            else "%Y-%m-%d %H:%M:%S"
        return f"timestamp '{value.strftime(fmt)}'"
    if isinstance(value, Date):
        return f"date '{value.isoformat()}'"
    if isinstance(value, Time):
        return f"time '{value.isoformat()}'"
    if isinstance(value, str):
        return "'" + value.replace("'", "''") + "'"
    if isinstance(value, (list, tuple)):
        return "ARRAY[" + ", ".join(_render(v) for v in value) + "]"
    import decimal

    if isinstance(value, decimal.Decimal):
        return f"decimal '{value}'"
    raise ProgrammingError(f"cannot bind parameter of type {type(value)!r}")


def substitute_params(sql: str, params: Optional[Sequence]) -> str:
    """Replace `?` placeholders outside string literals/comments."""
    if params is None:
        return sql
    out: List[str] = []
    it = iter(params)
    used = 0
    i, n = 0, len(sql)
    while i < n:
        ch = sql[i]
        if ch == "'":  # string literal: copy until the closing quote
            j = i + 1
            while j < n:
                if sql[j] == "'" and j + 1 < n and sql[j + 1] == "'":
                    j += 2
                    continue
                if sql[j] == "'":
                    break
                j += 1
            out.append(sql[i:j + 1])
            i = j + 1
        elif ch == "-" and sql[i:i + 2] == "--":  # line comment
            j = sql.find("\n", i)
            j = n if j < 0 else j
            out.append(sql[i:j])
            i = j
        elif ch == "/" and sql[i:i + 2] == "/*":  # block comment
            j = sql.find("*/", i + 2)
            j = n if j < 0 else j + 2
            out.append(sql[i:j])
            i = j
        elif ch == "?":
            try:
                out.append(_render(next(it)))
            except StopIteration:
                raise ProgrammingError(
                    "more placeholders than parameters") from None
            used += 1
            i += 1
        else:
            out.append(ch)
            i += 1
    remaining = sum(1 for _ in it)
    if remaining:
        raise ProgrammingError(
            f"{remaining} unused parameters ({used} placeholders)")
    return "".join(out)


# --------------------------------------------------------------------------
# connection / cursor
# --------------------------------------------------------------------------

class Connection:
    def __init__(self, host: str = "localhost", port: int = 8080,
                 user: Optional[str] = None, password: Optional[str] = None,
                 catalog: Optional[str] = None, schema: Optional[str] = None,
                 scheme: str = "http", timeout_s: float = 3600.0):
        self._server = f"{scheme}://{host}:{port}"
        self.user = user
        self.password = password
        self.catalog = catalog
        self.schema = schema
        self.timeout_s = timeout_s
        self._closed = False

    # -- PEP 249 ----------------------------------------------------------

    def close(self) -> None:
        self._closed = True

    def commit(self) -> None:
        # per-query autocommit transactions (transaction.py); nothing pending
        self._check()

    def rollback(self) -> None:
        raise NotSupportedError("presto_tpu_torch runs queries in autocommit mode")

    def cursor(self) -> "Cursor":
        self._check()
        return Cursor(self)

    # -- context management ----------------------------------------------

    def __enter__(self) -> "Connection":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _check(self) -> None:
        if self._closed:
            raise InterfaceError("connection is closed")


class Cursor:
    arraysize = 1

    def __init__(self, connection: Connection):
        self.connection = connection
        self.description: Optional[List[Tuple]] = None
        self.rowcount = -1
        self._rows: Optional[Iterator[list]] = None
        self._client: Optional[StatementClient] = None
        self._closed = False

    # -- execution --------------------------------------------------------

    def execute(self, sql: str, params: Optional[Sequence] = None) -> "Cursor":
        self._check()
        conn = self.connection
        conn._check()
        sql = substitute_params(sql, params)
        self._client = StatementClient(
            conn._server, sql, user=conn.user, password=conn.password,
            catalog=conn.catalog, schema=conn.schema,
            timeout_s=conn.timeout_s)
        self.description = None
        self.rowcount = -1
        try:
            it = self._client.rows()
            buffered: List[list] = []
            # pull until columns are known (they arrive with the first
            # payload that carries data or completion)
            first = next(it, None)
            if first is not None:
                buffered.append(first)
            import itertools
            self._rows = itertools.chain(buffered, it)
            if self._client.columns is not None:
                # type_code is the engine's type NAME: the module-level
                # singletons (STRING/NUMBER/DATETIME) compare against it per
                # the PEP 249 type-object protocol (NUMBER == "bigint")
                self.description = [
                    (c.name, c.type.split("(")[0],
                     None, None, None, None, None)
                    for c in self._client.columns]
        except QueryError as e:
            raise ProgrammingError(str(e)) from e
        except OSError as e:
            raise OperationalError(str(e)) from e
        return self

    def executemany(self, sql: str, seq_of_params: Sequence[Sequence]
                    ) -> "Cursor":
        for params in seq_of_params:
            self.execute(sql, params)
            self.fetchall()  # drain: executemany is for DML, results dropped
        return self

    # -- fetching ---------------------------------------------------------

    def fetchone(self) -> Optional[tuple]:
        self._check_results()
        try:
            return tuple(next(self._rows))
        except StopIteration:
            return None
        except QueryError as e:
            raise ProgrammingError(str(e)) from e
        except OSError as e:  # urllib errors are OSErrors: map per PEP 249
            raise OperationalError(str(e)) from e

    def fetchmany(self, size: Optional[int] = None) -> List[tuple]:
        self._check_results()
        size = self.arraysize if size is None else size
        out = []
        for _ in range(size):
            row = self.fetchone()
            if row is None:
                break
            out.append(row)
        return out

    def fetchall(self) -> List[tuple]:
        self._check_results()
        out = []
        while True:
            row = self.fetchone()
            if row is None:
                break
            out.append(row)
        self.rowcount = len(out)
        return out

    def __iter__(self):
        self._check_results()
        while True:
            row = self.fetchone()
            if row is None:
                return
            yield row

    # -- misc -------------------------------------------------------------

    def setinputsizes(self, sizes) -> None:
        pass

    def setoutputsize(self, size, column=None) -> None:
        pass

    def close(self) -> None:
        self._closed = True
        self._rows = None

    def __enter__(self) -> "Cursor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _check(self) -> None:
        if self._closed:
            raise InterfaceError("cursor is closed")

    def _check_results(self) -> None:
        self._check()
        if self._rows is None:
            raise ProgrammingError("no query has been executed")


def connect(**kwargs) -> Connection:
    """DB-API 2.0 entry point. Keyword args: host, port, user, password,
    catalog, schema, scheme, timeout_s."""
    return Connection(**kwargs)
