"""Client library of the PyTorch port: ``StatementClient`` over the
/v1/statement protocol (``presto_tpu/client/__init__.py``).

POST the statement, then follow ``nextUri`` until it is absent, yielding
each page's ``data``. stdlib ``urllib`` only: the client imports nothing of
the engine, not even torch.
"""
from __future__ import annotations

import dataclasses
import json
import time
import urllib.error
import urllib.request
from typing import Iterator, List, Optional


class QueryError(RuntimeError):
    def __init__(self, error: dict):
        super().__init__(error.get("message", "query failed"))
        self.error_type = error.get("errorType")
        self.stack = error.get("stack")


@dataclasses.dataclass
class Column:
    name: str
    type: str


class StatementClient:
    """One statement's lifecycle: submit -> page through results."""

    def __init__(self, server: str, sql: str, poll_interval_s: float = 0.05,
                 timeout_s: float = 3600.0, user: Optional[str] = None,
                 password: Optional[str] = None,
                 catalog: Optional[str] = None, schema: Optional[str] = None):
        self.server = server.rstrip("/")
        self.sql = sql
        self.poll_interval_s = poll_interval_s
        self.timeout_s = timeout_s
        self.user = user
        self.password = password
        self.catalog = catalog
        self.schema = schema
        self.columns: Optional[List[Column]] = None
        self.stats: dict = {}

    def _request(self, method: str, url: str, body: Optional[bytes] = None) -> dict:
        req = urllib.request.Request(url, data=body, method=method)
        req.add_header("Content-Type", "text/plain")
        if self.catalog:
            req.add_header("X-Presto-Catalog", self.catalog)
        if self.schema:
            req.add_header("X-Presto-Schema", self.schema)
        if self.password is not None:
            import base64

            cred = base64.b64encode(
                f"{self.user or ''}:{self.password}".encode()).decode()
            req.add_header("Authorization", f"Basic {cred}")
        elif self.user:
            req.add_header("X-Presto-User", self.user)
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read().decode())

    def rows(self) -> Iterator[list]:
        """Submit and yield every result row (advancing nextUri)."""
        payload = self._request("POST", f"{self.server}/v1/statement",
                                self.sql.encode())
        deadline = time.time() + self.timeout_s
        while True:
            if "error" in payload and payload["error"]:
                raise QueryError(payload["error"])
            if payload.get("columns") and self.columns is None:
                self.columns = [Column(c["name"], c["type"])
                                for c in payload["columns"]]
            self.stats = payload.get("stats", self.stats)
            yield from payload.get("data", [])
            next_uri = payload.get("nextUri")
            if not next_uri:
                return
            if time.time() > deadline:
                raise TimeoutError(f"query still {self.stats.get('state')} "
                                   f"after {self.timeout_s}s")
            state = self.stats.get("state")
            if state in ("QUEUED", "RUNNING"):
                time.sleep(self.poll_interval_s)
            payload = self._request("GET", next_uri)


def execute(server: str, sql: str) -> List[list]:
    """One-shot convenience: all rows of `sql` from `server`."""
    return list(StatementClient(server, sql).rows())
