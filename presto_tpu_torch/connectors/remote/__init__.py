"""Remote-service connector of the PyTorch port: tables served by an RPC service.

Counterpart of ``presto_tpu/connectors/remote/__init__.py``
(presto-thrift-connector with presto-thrift-api's PrestoThriftService
contract: list schemas and tables, table metadata, splits and row batches
with continuation tokens). The transport is JSON-RPC over HTTP from the
standard library in place of Thrift.

Protocol (POST ``<endpoint>/rpc``, body ``{"method": str, "params":
{...}}``, response ``{"result": ...}`` or ``{"error": str}``):

- ``list_schemas() -> [schema]``
- ``list_tables(schema?) -> [[schema, table], ...]``
- ``table_metadata(schema, table) -> {"columns": [[name, type_str], ...]}``
- ``column_values(schema, table, column, limit) -> [str, ...]``: the
  distinct values of a varchar column (the plan-time dictionary)
- ``table_stats(schema, table) -> {"row_count": n}``
- ``splits(schema, table, desired, token?) -> {"splits": [{"id": ...},
  ...], "token": ...?}``: batched with continuation tokens (a split's
  ``host``, where a service names one, is not read: no scheduler places
  splits by host yet)
- ``rows(split_id, columns, token?, max_rows) -> {"columns": {name:
  [values...]}, "token": ...?}``: columnar row batches with continuation
  tokens, NULL as JSON null

Every call goes through the endpoints in turn on a connection error
(failover), starting from the last one that answered.

One difference from the reference, not in the rows: a batch's page is
``clamp_capacity(rows, page capacity)`` rows long (the reference pads every
batch to the full page capacity).
"""
from __future__ import annotations

import collections
import json
import threading
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...block import Block, Dictionary, Page
from ...spi.connector import (ColumnHandle, ColumnMetadata, Connector, ConnectorMetadata,
                              ConnectorPageSource, ConnectorPageSourceProvider,
                              ConnectorSplitManager, Constraint, SchemaTableName, Split,
                              TableHandle, TableMetadata, TableStatistics)
from ...types import BOOLEAN, DOUBLE, is_string, parse_type
from ...utils.batching import clamp_capacity

_DICT_LIMIT = 100_000  # the plan-time dictionary bound


class RemoteClient:
    """JSON-RPC client with endpoint failover."""

    def __init__(self, endpoints: Sequence[str], timeout_s: float = 30.0):
        if not endpoints:
            raise ValueError("remote connector needs at least one endpoint")
        self._endpoints = list(endpoints)
        self._timeout = timeout_s
        self._i = 0
        self._lock = threading.Lock()

    def call(self, method: str, **params) -> Any:
        body = json.dumps({"method": method, "params": params}).encode()
        last: Optional[Exception] = None
        with self._lock:
            order = [self._endpoints[(self._i + k) % len(self._endpoints)]
                     for k in range(len(self._endpoints))]
        for ep in order:
            req = urllib.request.Request(ep.rstrip("/") + "/rpc", data=body,
                                         headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=self._timeout) as r:
                    out = json.loads(r.read().decode())
            except (urllib.error.URLError, OSError, TimeoutError) as e:
                last = e
                with self._lock:  # rotate: the next call starts at a live host
                    self._i = (self._i + 1) % len(self._endpoints)
                continue
            if "error" in out and out["error"] is not None:
                raise RuntimeError(f"remote service error for {method}: {out['error']}")
            return out.get("result")
        raise ConnectionError(f"no remote endpoint reachable for {method}: {last!r}")


class RemoteMetadata(ConnectorMetadata):
    def __init__(self, connector_id: str, client: RemoteClient):
        self.connector_id = connector_id
        self.client = client
        self._dicts: Dict[Tuple[SchemaTableName, str], Dictionary] = {}
        self._lock = threading.Lock()

    def list_schemas(self) -> List[str]:
        return list(self.client.call("list_schemas"))

    def list_tables(self, schema: Optional[str] = None) -> List[SchemaTableName]:
        return [SchemaTableName(s, t) for s, t in self.client.call("list_tables", schema=schema)]

    def get_table_handle(self, name: SchemaTableName) -> Optional[TableHandle]:
        tables = self.client.call("list_tables", schema=name.schema)
        if [name.schema, name.table] in [list(t) for t in tables]:
            return TableHandle(self.connector_id, name)
        return None

    def get_table_metadata(self, table: TableHandle) -> TableMetadata:
        name = table.schema_table
        meta = self.client.call("table_metadata", schema=name.schema, table=name.table)
        cols = []
        for cname, tstr in meta["columns"]:
            ctype = parse_type(tstr)
            d = self._dictionary(name, cname) if is_string(ctype) else None
            cols.append(ColumnMetadata(cname, ctype, dictionary=d))
        return TableMetadata(name, tuple(cols))

    def _dictionary(self, name: SchemaTableName, column: str) -> Dictionary:
        """Plan-time dictionary of the service's distinct values, cached: the
        remote data is taken as stable for the catalog's lifetime."""
        key = (name, column)
        with self._lock:
            d = self._dicts.get(key)
            if d is None:
                vals = self.client.call("column_values", schema=name.schema, table=name.table,
                                        column=column, limit=_DICT_LIMIT + 1)
                if len(vals) > _DICT_LIMIT:
                    raise ValueError(f"remote varchar column {name}.{column} exceeds the "
                                     f"{_DICT_LIMIT}-value dictionary bound")
                d = Dictionary(sorted(str(v) for v in vals))
                self._dicts[key] = d
        return d

    def get_table_statistics(self, table: TableHandle,
                             constraint: Constraint) -> TableStatistics:
        name = table.schema_table
        try:
            stats = self.client.call("table_stats", schema=name.schema, table=name.table)
        except Exception:
            return TableStatistics.empty()
        if not stats:
            return TableStatistics.empty()
        return TableStatistics(row_count=float(stats.get("row_count", 0)))


class RemoteSplitManager(ConnectorSplitManager):
    def __init__(self, connector_id: str, client: RemoteClient):
        self.connector_id = connector_id
        self.client = client

    def get_splits(self, table: TableHandle, constraint: Constraint,
                   desired_splits: int) -> List[Split]:
        name = table.schema_table
        out: List[Split] = []
        token = None
        while True:  # split batches by continuation token
            batch = self.client.call("splits", schema=name.schema, table=name.table,
                                     desired=desired_splits, token=token)
            out.extend(Split(self.connector_id, payload=(name.schema, name.table, s["id"]))
                       for s in batch["splits"])
            token = batch.get("token")
            if token is None:
                return out


class RemotePageSource(ConnectorPageSource):
    """Pulls row batches by continuation token and builds masked pages,
    encoding varchar values through the plan-time dictionaries."""

    # waits on a remote service: never stepped on the shared scan pool
    external_wait = True

    def __init__(self, client: RemoteClient, split: Split, columns: Sequence[ColumnHandle],
                 page_capacity: int, dicts: Dict[str, Dictionary]):
        self.client = client
        self.split = split
        self.columns = list(columns)
        self.capacity = page_capacity
        self.dicts = dicts

    def __iter__(self):
        _schema, _table, split_id = self.split.payload
        token = None
        names = [c.name for c in self.columns]
        while True:
            batch = self.client.call("rows", split_id=split_id, columns=names, token=token,
                                     max_rows=self.capacity)
            cols = batch["columns"]
            n = len(cols[names[0]]) if names else 0
            if n > self.capacity:
                raise ValueError(f"remote service returned {n} rows for max_rows="
                                 f"{self.capacity}")
            if n:
                yield self._page(cols, n)
            token = batch.get("token")
            if token is None:
                return

    def _page(self, cols: Dict[str, list], n: int) -> Page:
        cap = clamp_capacity(n, self.capacity)
        blocks = []
        for c in self.columns:
            raw = cols[c.name]
            nulls_list = [v is None for v in raw]
            if is_string(c.type):
                index = self.dicts[c.name].index()
                data = np.zeros(cap, dtype=np.int32)
                for i, v in enumerate(raw):
                    if v is not None:
                        try:
                            data[i] = index[str(v)]
                        except KeyError:
                            raise ValueError(
                                f"remote value {v!r} not in the plan-time dictionary of "
                                f"{c.name} — service data changed mid-query?") from None
            elif c.type is BOOLEAN:
                data = np.zeros(cap, dtype=bool)
                data[:n] = [bool(v) for v in (0 if x is None else x for x in raw)]
            elif c.type is DOUBLE or c.type.name in ("double", "real"):
                data = np.zeros(cap, dtype=c.type.np_dtype)
                data[:n] = [0.0 if v is None else float(v) for v in raw]
            else:
                data = np.zeros(cap, dtype=c.type.np_dtype)
                data[:n] = [0 if v is None else int(v) for v in raw]
            nulls = None
            if any(nulls_list):
                nulls = np.zeros(cap, dtype=bool)
                nulls[:n] = nulls_list
                nulls = torch.from_numpy(nulls)
            blocks.append(Block(c.type, torch.from_numpy(data), nulls, self.dicts.get(c.name)))
        return Page(tuple(blocks), torch.arange(cap) < n)


class RemotePageSourceProvider(ConnectorPageSourceProvider):
    def __init__(self, metadata: RemoteMetadata, client: RemoteClient):
        self._metadata = metadata
        self._client = client

    def create_page_source(self, split: Split, columns: Sequence[ColumnHandle],
                           page_capacity: int,
                           constraint: Constraint = Constraint.all()) -> ConnectorPageSource:
        schema, table, _sid = split.payload
        dicts = {c.name: self._metadata._dictionary(SchemaTableName(schema, table), c.name)
                 for c in columns if is_string(c.type)}
        return RemotePageSource(self._client, split, columns, page_capacity, dicts)


class RemoteConnector(Connector):
    def __init__(self, connector_id: str, endpoints: Sequence[str], timeout_s: float = 30.0):
        self._client = RemoteClient(endpoints, timeout_s)
        self._metadata = RemoteMetadata(connector_id, self._client)
        self._splits = RemoteSplitManager(connector_id, self._client)
        self._sources = RemotePageSourceProvider(self._metadata, self._client)

    def metadata(self) -> ConnectorMetadata:
        return self._metadata

    def split_manager(self) -> ConnectorSplitManager:
        return self._splits

    def page_source_provider(self) -> ConnectorPageSourceProvider:
        return self._sources


# ---------------------------------------------------------------------------
# the testing service (presto-thrift-testing-server's role)
# ---------------------------------------------------------------------------

class RemoteTestingService:
    """In-process HTTP service behind the remote connector, for tests and
    the card's script.

    Tables are registered as Python columnar data; the service slices them
    into splits and row batches with continuation tokens, exercising the
    whole batched protocol. ``request_count`` counts the calls served,
    ``calls`` them by method."""

    def __init__(self, rows_per_batch: int = 1 << 12, n_splits: int = 3):
        self.rows_per_batch = rows_per_batch
        self.n_splits = n_splits
        # (schema, table) -> (columns [(name, type_str)], {name: [values]})
        self.tables: Dict[Tuple[str, str], Tuple[list, dict]] = {}
        self.request_count = 0
        self.calls: collections.Counter = collections.Counter()
        self._server = None
        self._thread = None

    def add_table(self, schema: str, table: str, columns: Sequence[Tuple[str, str]],
                  data: Dict[str, list]) -> None:
        if len({len(v) for v in data.values()}) > 1:
            raise ValueError("ragged columns")
        self.tables[(schema, table)] = (list(columns), dict(data))

    # ------------------------------------------------------------- methods

    def _rows_of(self, key) -> int:
        _cols, data = self.tables[key]
        return len(next(iter(data.values()))) if data else 0

    def handle(self, method: str, params: Dict[str, Any]) -> Any:
        self.request_count += 1
        self.calls[method] += 1
        if method == "list_schemas":
            return sorted({s for s, _ in self.tables})
        if method == "list_tables":
            schema = params.get("schema")
            return sorted([s, t] for s, t in self.tables if schema is None or s == schema)
        key = (params.get("schema"), params.get("table"))
        if method == "table_metadata":
            cols, _ = self.tables[key]
            return {"columns": [[n, t] for n, t in cols]}
        if method == "column_values":
            _cols, data = self.tables[key]
            vals = sorted({str(v) for v in data[params["column"]] if v is not None})
            return vals[:params.get("limit", _DICT_LIMIT)]
        if method == "table_stats":
            return {"row_count": self._rows_of(key)}
        if method == "splits":
            # two splits per batch, one continuation token per batch
            token = params.get("token") or 0
            total = min(self.n_splits, max(self._rows_of(key), 1))
            batch = [{"id": f"{key[0]}|{key[1]}|{i}|{total}"}
                     for i in range(token, min(token + 2, total))]
            return {"splits": batch, "token": token + 2 if token + 2 < total else None}
        if method == "rows":
            schema, table, idx, total = params["split_id"].rsplit("|", 3)
            idx, total = int(idx), int(total)
            _cols, data = self.tables[(schema, table)]
            nrows = self._rows_of((schema, table))
            lo = nrows * idx // total
            hi = nrows * (idx + 1) // total
            start = params.get("token") or lo
            step = min(self.rows_per_batch, params.get("max_rows") or self.rows_per_batch)
            end = min(start + step, hi)
            return {"columns": {name: data[name][start:end] for name in params["columns"]},
                    "token": end if end < hi else None}
        raise ValueError(f"unknown method {method}")

    # ------------------------------------------------------------ lifecycle

    def start(self) -> str:
        """Start the HTTP server on an ephemeral port of 127.0.0.1; returns
        its endpoint."""
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        service = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                if self.path != "/rpc":
                    self.send_error(404)
                    return
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n).decode())
                try:
                    body = json.dumps({"result": service.handle(req["method"],
                                                                req.get("params") or {})})
                except Exception as e:  # noqa: BLE001 - the error goes back on the wire
                    body = json.dumps({"error": repr(e)})
                body = body.encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # quiet
                pass

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()
        return f"http://127.0.0.1:{self._server.server_address[1]}"

    def stop(self) -> None:
        """Stop serving, close the socket and join the serving thread."""
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
