"""TPC-DS connector of the PyTorch port over its copy of the generator.

Counterpart of ``presto_tpu/connectors/tpcds/connector.py``: the same
schemas (scale factors), the same row-range splits, the same page
capacities (``clamp_capacity``), dtypes, dictionaries, unique column sets
and statistics, so the cost-based join order and ``explain()`` are the
reference's. Covers the Q64/Q72 table set (15 tables: the sales/returns
fact pairs, inventory, and their dimensions). Pages are host pages: Blocks
over CPU tensors with a ``torch.bool`` mask; the table scan copies them to
the device. As in the reference, a page source has no ``cache_token``: a
TPC-DS scan regenerates its pages on every run.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ...utils.batching import clamp_capacity
from ...block import Block, Page
from ...spi.connector import (ColumnHandle, ColumnMetadata, ColumnStatistics,
                              Connector, ConnectorFactory, ConnectorMetadata,
                              ConnectorPageSource,
                              ConnectorPageSourceProvider, ConnectorSplitManager,
                              Constraint, SchemaTableName, Split, TableHandle,
                              TableMetadata, TableStatistics)
from . import generator as g

SCHEMAS = {"tiny": 0.01, "sf1": 1.0, "sf10": 10.0, "sf100": 100.0,
           "sf300": 300.0, "sf1000": 1000.0}

_UNIQUE_KEYS = {
    "date_dim": [("d_date_sk",)],
    "item": [("i_item_sk",)],
    "store": [("s_store_sk",)],
    "warehouse": [("w_warehouse_sk",)],
    "customer": [("c_customer_sk",)],
    "customer_address": [("ca_address_sk",)],
    "customer_demographics": [("cd_demo_sk",)],
    "household_demographics": [("hd_demo_sk",)],
    "income_band": [("ib_income_band_sk",)],
    "promotion": [("p_promo_sk",)],
    "store_sales": [("ss_ticket_number",)],
    "catalog_sales": [("cs_order_number",)],
    # returns mirror a sales subset 1:1, so the sales key stays unique
    "store_returns": [("sr_ticket_number",)],
    "catalog_returns": [("cr_order_number",)],
    "inventory": [("inv_date_sk", "inv_item_sk", "inv_warehouse_sk")],
}


def _columns_of(table: str):
    return [(c.name, c.type, c.dictionary)
            for c in g.TPCDS_TABLES[table].columns]


class TpcdsMetadata(ConnectorMetadata):
    def __init__(self, connector_id: str):
        self.connector_id = connector_id

    def list_schemas(self) -> List[str]:
        return list(SCHEMAS)

    def list_tables(self, schema: Optional[str] = None) -> List[SchemaTableName]:
        schemas = [schema] if schema else list(SCHEMAS)
        return [SchemaTableName(s, t)
                for s in schemas for t in g.TPCDS_TABLES]

    def get_table_handle(self, name: SchemaTableName) -> Optional[TableHandle]:
        if name.schema in SCHEMAS and name.table in g.TPCDS_TABLES:
            return TableHandle(self.connector_id, name,
                               extra=(SCHEMAS[name.schema],))
        return None

    def get_table_metadata(self, table: TableHandle) -> TableMetadata:
        cols = tuple(ColumnMetadata(n, t, dictionary=d)
                     for (n, t, d) in _columns_of(table.schema_table.table))
        return TableMetadata(table.schema_table, cols)

    def get_unique_column_sets(self, table: TableHandle):
        return list(_UNIQUE_KEYS.get(table.schema_table.table, []))

    def get_table_statistics(self, table: TableHandle,
                             constraint: Constraint) -> TableStatistics:
        name = table.schema_table.table
        sf = table.extra[0]
        rows = float(g.table_row_count(name, sf))
        stats = TableStatistics(row_count=rows)
        for (cname, ctype, cdict) in _columns_of(name):
            cs = ColumnStatistics(null_fraction=0.0)
            if cdict is not None and type(cdict).__name__ == "Dictionary":
                cs.distinct_count = float(len(cdict))
            elif cname.endswith("_sk") or cname.endswith("_number"):
                cs.distinct_count = rows
            stats.columns[cname] = cs
        return stats


class TpcdsSplitManager(ConnectorSplitManager):
    def __init__(self, connector_id: str, splits_per_table: int = 8):
        self.connector_id = connector_id
        self.splits_per_table = splits_per_table

    def get_splits(self, table: TableHandle, constraint: Constraint,
                   desired_splits: int) -> List[Split]:
        name = table.schema_table.table
        sf = table.extra[0]
        units = g.table_row_count(name, sf)
        n_splits = max(1, min(desired_splits or self.splits_per_table, units))
        step = math.ceil(units / n_splits)
        return [Split(self.connector_id, payload=(name, sf, lo,
                                                  min(lo + step, units)),
                      bucket=b)
                for b, lo in enumerate(range(0, units, step))]


class TpcdsPageSource(ConnectorPageSource):
    def __init__(self, split: Split, columns: Sequence[ColumnHandle],
                 page_capacity: int):
        self.split = split
        self.columns = list(columns)
        # clamp to split size — padded rows are real upload+compute waste
        _name, _sf, lo, hi = split.payload
        self.capacity = clamp_capacity(hi - lo, page_capacity)
        self._bytes = 0

    def __iter__(self) -> Iterator[Page]:
        name, sf, lo, hi = self.split.payload
        names = [c.name for c in self.columns]
        col_info = {n: (t, d) for (n, t, d) in _columns_of(name)}
        for rlo in range(lo, hi, self.capacity):
            rhi = min(rlo + self.capacity, hi)
            data = g.generate_rows(name, rlo, rhi, sf, names)
            n = rhi - rlo
            blocks = []
            for cname in names:
                ctype, cdict = col_info[cname]
                arr = np.asarray(data[cname]).astype(ctype.np_dtype)
                if len(arr) < self.capacity:
                    arr = np.concatenate(
                        [arr,
                         np.zeros(self.capacity - len(arr), dtype=arr.dtype)])
                self._bytes += arr.nbytes
                blocks.append(Block(ctype, torch.from_numpy(np.ascontiguousarray(arr)),
                                    None, cdict))
            mask = torch.arange(self.capacity) < n
            yield Page(tuple(blocks), mask)

    def completed_bytes(self) -> int:
        return self._bytes


class TpcdsPageSourceProvider(ConnectorPageSourceProvider):
    def create_page_source(self, split: Split, columns: Sequence[ColumnHandle],
                           page_capacity: int,
                           constraint: Constraint = Constraint.all()
                           ) -> ConnectorPageSource:
        return TpcdsPageSource(split, columns, page_capacity)


class TpcdsConnector(Connector):
    def __init__(self, connector_id: str, splits_per_table: int = 8):
        self._metadata = TpcdsMetadata(connector_id)
        self._splits = TpcdsSplitManager(connector_id, splits_per_table)
        self._sources = TpcdsPageSourceProvider()

    def metadata(self) -> ConnectorMetadata:
        return self._metadata

    def split_manager(self) -> ConnectorSplitManager:
        return self._splits

    def page_source_provider(self) -> ConnectorPageSourceProvider:
        return self._sources


class TpcdsConnectorFactory(ConnectorFactory):
    @property
    def name(self) -> str:
        return "tpcds"

    def create(self, catalog_name: str, config: Dict[str, str]) -> Connector:
        return TpcdsConnector(catalog_name, int(config.get("tpcds.splits-per-node", "8")))
