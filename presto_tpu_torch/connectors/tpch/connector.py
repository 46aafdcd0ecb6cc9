"""TPC-H connector of the PyTorch port over its copy of the generator.

Counterpart of ``presto_tpu/connectors/tpch/connector.py``: the same schemas,
the same row-range splits (order ranges for lineitem), the same page
capacities (``clamp_capacity``) and the same narrow wire dtypes, so the pages
hold the same rows in the same order. Pages are host pages: Blocks over CPU
tensors viewing the generated numpy arrays; the table scan copies them to the
device and widens them there.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ...block import Block, Page
from ...spi.connector import (ColumnHandle, ColumnMetadata, ColumnStatistics,
                              Connector, ConnectorMetadata, ConnectorPageSource,
                              ConnectorPageSourceProvider, ConnectorSplitManager,
                              Constraint, SchemaTableName, Split, TableHandle,
                              TableMetadata, TableStatistics)
from ...utils.batching import clamp_capacity, take_rows
from . import generator as g

SCHEMAS = {"tiny": 0.01, "sf1": 1.0, "sf10": 10.0, "sf100": 100.0, "sf300": 300.0,
           "sf1000": 1000.0}

_TABLE_NAMES = ["region", "nation", "supplier", "part", "partsupp", "customer",
                "orders", "lineitem"]


def _columns_of(table: str):
    if table == "lineitem":
        return [(n, t, d) for (n, t, d) in g.LINEITEM_COLUMNS]
    t = g.TPCH_TABLES[table]
    return [(c.name, c.type, c.dictionary) for c in t.columns]


class TpchMetadata(ConnectorMetadata):
    def __init__(self, connector_id: str):
        self.connector_id = connector_id

    def list_schemas(self) -> List[str]:
        return list(SCHEMAS)

    def list_tables(self, schema: Optional[str] = None) -> List[SchemaTableName]:
        schemas = [schema] if schema else list(SCHEMAS)
        return [SchemaTableName(s, t) for s in schemas for t in _TABLE_NAMES]

    def get_table_handle(self, name: SchemaTableName) -> Optional[TableHandle]:
        if name.schema in SCHEMAS and name.table in _TABLE_NAMES:
            return TableHandle(self.connector_id, name, extra=(SCHEMAS[name.schema],))
        return None

    def get_table_metadata(self, table: TableHandle) -> TableMetadata:
        cols = tuple(ColumnMetadata(n, t, dictionary=d)
                     for (n, t, d) in _columns_of(table.schema_table.table))
        return TableMetadata(table.schema_table, cols)

    _UNIQUE_KEYS = {
        "region": [("r_regionkey",)],
        "nation": [("n_nationkey",)],
        "supplier": [("s_suppkey",)],
        "part": [("p_partkey",)],
        "partsupp": [("ps_partkey", "ps_suppkey")],
        "customer": [("c_custkey",)],
        "orders": [("o_orderkey",)],
        "lineitem": [("l_orderkey", "l_linenumber")],
    }

    def get_unique_column_sets(self, table: TableHandle):
        return list(self._UNIQUE_KEYS.get(table.schema_table.table, []))

    def get_table_statistics(self, table: TableHandle,
                             constraint: Constraint) -> TableStatistics:
        """Row counts, plus distinct counts for dictionary columns (their
        dictionary's size) and key columns (the row count): the reference's
        statistics, so the cost-based join order is the reference's."""
        name = table.schema_table.table
        sf = table.extra[0]
        rows = float(g.table_row_count(name, sf))
        stats = TableStatistics(row_count=rows)
        for (cname, _ctype, cdict) in _columns_of(name):
            cs = ColumnStatistics(null_fraction=0.0)
            if cdict is not None and type(cdict).__name__ == "Dictionary":
                cs.distinct_count = float(len(cdict))
            elif cname.endswith(("key",)):
                cs.distinct_count = rows
            stats.columns[cname] = cs
        return stats


class TpchSplitManager(ConnectorSplitManager):
    """Row-range splits; lineitem is split by order range."""

    def __init__(self, connector_id: str, splits_per_table: int = 8):
        self.connector_id = connector_id
        self.splits_per_table = splits_per_table

    def get_splits(self, table: TableHandle, constraint: Constraint,
                   desired_splits: int) -> List[Split]:
        name = table.schema_table.table
        sf = table.extra[0]
        if name == "lineitem":
            units = g.TPCH_TABLES["orders"].row_count(sf)  # split the order keyspace
        else:
            units = g.table_row_count(name, sf)
        n_splits = max(1, min(desired_splits or self.splits_per_table, units))
        step = math.ceil(units / n_splits)
        return [Split(self.connector_id, payload=(name, sf, lo, min(lo + step, units)),
                      bucket=b)
                for b, lo in enumerate(range(0, units, step))]


def _narrow_columns(table: str, sf: float, data: Dict[str, np.ndarray],
                    dicts: Dict[str, object]) -> Dict[str, np.ndarray]:
    """Downcast columns to their static wire dtypes (generator.narrow_dtype);
    the scan widens them back to the declared type on the device."""
    out = {}
    for name, arr in data.items():
        dt = g.narrow_dtype(table, name, sf, dicts.get(name))
        if dt is None or arr.dtype.kind != "i" or arr.dtype.itemsize <= dt.itemsize:
            out[name] = arr
            continue
        narrowed = arr.astype(dt)
        if len(arr) and not np.array_equal(narrowed.astype(arr.dtype), arr):
            raise AssertionError(
                f"narrow bounds violated for {table}.{name} (sf={sf}): "
                f"values outside {dt}")
        out[name] = narrowed
    return out


class _GenCache:
    """Bounded, thread-safe LRU over generated (and narrowed) column chunks,
    so a warm query re-slices host arrays instead of re-running the
    generator."""

    def __init__(self, max_bytes: int = 4 << 30):
        self.max_bytes = max_bytes
        self._data: Dict[tuple, Dict[str, np.ndarray]] = {}
        self._order: List[tuple] = []
        self._bytes = 0
        self._lock = threading.Lock()

    def get_or_generate(self, key: tuple, generate) -> Dict[str, np.ndarray]:
        with self._lock:
            hit = self._data.get(key)
            if hit is not None:
                self._order.remove(key)
                self._order.append(key)
                return hit
        data = generate()
        size = sum(a.nbytes for a in data.values())
        if size <= self.max_bytes:
            with self._lock:
                if key not in self._data:
                    while self._bytes + size > self.max_bytes and self._order:
                        old = self._order.pop(0)
                        self._bytes -= sum(
                            a.nbytes for a in self._data.pop(old).values())
                    self._data[key] = data
                    self._order.append(key)
                    self._bytes += size
        return data


GEN_CACHE = _GenCache()


class TpchPageSource(ConnectorPageSource):
    """Generates, narrows, caches and re-batches column chunks into full
    pages (exactly `capacity` live rows except the last)."""

    def __init__(self, split: Split, columns: Sequence[ColumnHandle], page_capacity: int):
        self.split = split
        self.columns = list(columns)
        name, _sf, lo, hi = split.payload
        est = (hi - lo) * 4 if name == "lineitem" else (hi - lo)
        self.capacity = clamp_capacity(est, page_capacity)

    def _chunks(self, names, dicts) -> Iterator[Dict[str, np.ndarray]]:
        name, sf, lo, hi = self.split.payload
        key_cols = tuple(sorted(names))
        if name == "lineitem":
            order_step = max(1, self.capacity // 4)  # ~capacity rows per chunk
            for olo in range(lo, hi, order_step):
                ohi = min(olo + order_step, hi)
                yield GEN_CACHE.get_or_generate(
                    ("lineitem", sf, olo, ohi, key_cols),
                    lambda: _narrow_columns(
                        name, sf, g.lineitem_for_orders(olo, ohi, sf, names),
                        dicts))
        else:
            for rlo in range(lo, hi, self.capacity):
                rhi = min(rlo + self.capacity, hi)
                yield GEN_CACHE.get_or_generate(
                    (name, sf, rlo, rhi, key_cols),
                    lambda: _narrow_columns(
                        name, sf, g.generate_rows(name, rlo, rhi, sf, names),
                        dicts))

    def __iter__(self) -> Iterator[Page]:
        name, sf, _lo, _hi = self.split.payload
        names = [c.name for c in self.columns]
        col_info = {n: (t, d) for (n, t, d) in _columns_of(name)}
        dicts = {n: d for n, (_t, d) in col_info.items()}
        wire_dtypes = {
            n: (g.narrow_dtype(name, n, sf, dicts.get(n))
                or col_info[n][0].np_dtype) for n in names}
        pend: List[List[np.ndarray]] = []
        pend_rows = 0
        empty = True
        for chunk in self._chunks(names, dicts):
            n = len(next(iter(chunk.values()))) if chunk else 0
            if n == 0:
                continue
            pend.append([chunk[c] for c in names])
            pend_rows += n
            while pend_rows >= self.capacity:
                yield self._assemble(pend, self.capacity, names, col_info,
                                     wire_dtypes)
                pend_rows -= self.capacity
                empty = False
        if pend_rows > 0 or empty:
            yield self._assemble(pend, pend_rows, names, col_info, wire_dtypes)

    def _assemble(self, pend: List[List[np.ndarray]], count: int,
                  names, col_info, wire_dtypes) -> Page:
        """Take exactly `count` rows off the front of `pend` into one page."""
        cols = take_rows(pend, count)
        blocks = []
        for i, cname in enumerate(names):
            ctype, cdict = col_info[cname]
            arr = cols[i] if cols else np.zeros(0, dtype=wire_dtypes[cname])
            if len(arr) < self.capacity:
                arr = np.concatenate(
                    [arr, np.zeros(self.capacity - len(arr), dtype=arr.dtype)])
            blocks.append(Block(ctype, torch.from_numpy(np.ascontiguousarray(arr)),
                                None, cdict))
        mask = torch.arange(self.capacity) < count
        return Page(tuple(blocks), mask)


class TpchPageSourceProvider(ConnectorPageSourceProvider):
    def create_page_source(self, split: Split, columns: Sequence[ColumnHandle],
                           page_capacity: int,
                           constraint: Constraint = Constraint.all()) -> ConnectorPageSource:
        return TpchPageSource(split, columns, page_capacity)


class TpchConnector(Connector):
    def __init__(self, connector_id: str, splits_per_table: int = 8):
        self._metadata = TpchMetadata(connector_id)
        self._splits = TpchSplitManager(connector_id, splits_per_table)
        self._sources = TpchPageSourceProvider()

    def metadata(self) -> ConnectorMetadata:
        return self._metadata

    def split_manager(self) -> ConnectorSplitManager:
        return self._splits

    def page_source_provider(self) -> ConnectorPageSourceProvider:
        return self._sources
