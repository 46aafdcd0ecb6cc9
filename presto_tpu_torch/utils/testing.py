"""Page sink of the PyTorch port (``presto_tpu/utils/testing.py``
``PageConsumerOperator``/``PageConsumerFactory``).

The sink is also a UNION branch's buffer: the planner's replay scan reads
``pages_for(worker)`` once every consumer of that worker
(``consumers_by_worker``) has finished, and the barrier mesh runner routes
each worker's pages from it. A local query creates every operator for
worker 0.

Also here: ``drive_operators`` (an operator chain on one driver),
``assert_no_residue`` (a pool's ledgers and the leak sanitizer after a
query), ``normalize_value`` (a result value in a comparable form) and
``SqliteOracle`` (the generated TPC-H or TPC-DS tables in an in-memory
sqlite), which the verifier's oracle mode reads."""
from __future__ import annotations

import sqlite3
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..block import Page
from ..ops.operator import Operator, OperatorContext, OperatorFactory
from ..types import Type


class PageConsumerOperator(Operator):
    """Sink that keeps every page it receives."""

    def __init__(self, context: OperatorContext, types: List[Type]):
        super().__init__(context)
        self._types = types
        self.pages: List[Page] = []

    @property
    def output_types(self) -> List[Type]:
        return self._types

    def add_input(self, page: Page) -> None:
        self.context.record_input(page, page.capacity)
        self.pages.append(page)

    def get_output(self) -> Optional[Page]:
        return None

    def rows(self) -> List[list]:
        out = []
        for p in self.pages:
            out.extend(p.to_pylists())
        return out


class PageConsumerFactory(OperatorFactory):
    def __init__(self, operator_id: int = 999, types: Optional[List[Type]] = None):
        super().__init__(operator_id, "PageConsumer")
        self.types = types or []
        self.consumers: List[PageConsumerOperator] = []
        self.consumers_by_worker: Dict[int, List[PageConsumerOperator]] = {}

    def create_operator(self, worker: int = 0) -> PageConsumerOperator:
        op = PageConsumerOperator(self.context(worker), self.types)
        self.consumers.append(op)
        self.consumers_by_worker.setdefault(worker, []).append(op)
        return op

    def rows(self) -> List[list]:
        """Python-value rows (Decimal, datetime.date, int, str) of every page."""
        out = []
        for c in self.consumers:
            out.extend(c.rows())
        return out

    def pages_for(self, worker: int) -> List[Page]:
        """Every page the consumers of ``worker`` received, in driver order."""
        return [p for c in self.consumers_by_worker.get(worker, []) for p in c.pages]


def drive_operators(operators: List[Operator]) -> None:
    """Run an operator chain to completion on one driver."""
    from ..exec.driver import Driver

    Driver(operators).run_to_completion()


def assert_no_residue(pool, query_id: Optional[str] = None) -> None:
    """The zero-residue gate: with ``query_id``, that query holds no RAM
    and no spill bytes in ``pool``; without, the pool's spill ledger is
    empty (RAM is not judged pool-wide: the shared pool outlives a test,
    and another tenant's live reservation is not this test's residue).
    When the leak sanitizer is installed its findings must be empty too,
    so a leak the ledger happens to cancel still fails, with its stack."""
    if query_id is not None:
        held = pool.query_bytes(query_id)
        assert held == 0, f"query {query_id!r} left {held} reserved byte(s) in the pool"
        spilled = pool.spill_bytes(query_id)
        assert spilled == 0, f"query {query_id!r} left {spilled} spill byte(s) charged"
    else:
        ledger = pool.spill_by_query()
        assert ledger == {}, f"spill ledger residue: {ledger}"
    from . import leaksan

    if leaksan.enabled():
        leaksan.SANITIZER.assert_clean()


class SqliteOracle:
    """The generated tables in an in-memory sqlite. DECIMAL columns load as
    REAL (sqlite has no decimals); dictionary columns as their strings."""

    def __init__(self):
        self.conn = sqlite3.connect(":memory:")

    def load_tpch(self, schema_sf: float, tables: Sequence[str],
                  max_rows: Optional[int] = None) -> None:
        from ..connectors.tpch import generator as g

        for t in tables:
            if t == "lineitem":
                cols = list(g.LINEITEM_COLUMNS)
                n_orders = g.TPCH_TABLES["orders"].row_count(schema_sf)
                data = g.lineitem_for_orders(0, n_orders, schema_sf,
                                             [c[0] for c in cols])
            else:
                cols = [(c.name, c.type, c.dictionary)
                        for c in g.TPCH_TABLES[t].columns]
                n = g.table_row_count(t, schema_sf)
                if max_rows:
                    n = min(n, max_rows)
                data = g.generate_rows(t, 0, n, schema_sf, [c[0] for c in cols])
            self._load_table(t, cols, data)
        self.conn.commit()

    def load_tpcds(self, schema_sf: float, tables: Sequence[str]) -> None:
        from ..connectors.tpcds import generator as g

        for t in tables:
            cols = [(c.name, c.type, c.dictionary)
                    for c in g.TPCDS_TABLES[t].columns]
            n = g.table_row_count(t, schema_sf)
            data = g.generate_rows(t, 0, n, schema_sf, [c[0] for c in cols])
            self._load_table(t, cols, data)
        self.conn.commit()

    def _load_table(self, table: str, cols, data) -> None:
        cur = self.conn.cursor()
        names = [c[0] for c in cols]
        cur.execute(f"CREATE TABLE IF NOT EXISTS {table} ({', '.join(names)})")
        pycols = []
        for (cname, ctype, cdict) in cols:
            arr = np.asarray(data[cname])
            if cdict is not None:
                pycols.append(cdict.lookup(arr.astype(np.int64)))
            elif ctype.name == "decimal":
                pycols.append(arr.astype(np.float64) / (10 ** ctype.scale))
            else:
                pycols.append(arr)
        rows = list(zip(*[list(c) for c in pycols]))
        rows = [tuple(x.item() if isinstance(x, np.generic) else x for x in r)
                for r in rows]
        cur.executemany(
            f"INSERT INTO {table} VALUES ({', '.join('?' * len(names))})", rows)

    def query(self, sql: str, params: tuple = ()) -> List[tuple]:
        return self.conn.execute(sql, params).fetchall()


def normalize_value(v: Any) -> Any:
    """A result value in a comparable form: DECIMAL as float, DATE as days
    since 1970-01-01, numpy scalars as Python numbers."""
    import datetime
    from decimal import Decimal

    if isinstance(v, Decimal):
        return float(v)
    if isinstance(v, datetime.date):
        return (v - datetime.date(1970, 1, 1)).days
    if isinstance(v, np.generic):
        return v.item()
    return v
