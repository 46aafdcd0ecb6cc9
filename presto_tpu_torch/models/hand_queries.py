"""Hand-built TPC-H Q3 for the PyTorch port.

Counterpart of ``presto_tpu/models/hand_queries.py`` ``build_q3``/``run_q3``:
the same three pipelines over the same operators, with the ``orders`` build
strategy picked from ``hash_kernels`` the way the reference planner's
``_join_strategy`` picks it:

- ``"sorted"``: the sort + binary-search build;
- ``"pallas"``: the open-addressing table (insert and probe kernels) where
  the join is eligible (unique single-key INNER/LEFT), sorted elsewhere;
- ``"auto"`` (default): ``"pallas"`` exactly when the device is CUDA, so the
  hand-written kernels run on the card and the plain versions are never the
  default on the CPU (the reference keys the same choice on its TPU
  backend).
"""
from __future__ import annotations

from typing import List, Tuple

from .. import resolve_device
from ..connectors.tpch import generator as g
from ..connectors.tpch.connector import TpchConnector
from ..exec.driver import Driver
from ..ops.aggregates import AggregateCall, resolve_aggregate
from ..ops.expressions import InputLayout, call, constant, days_from_civil, input_ref
from ..ops.filter_project import PageProcessor
from ..ops.hash_agg import SINGLE, HashAggregationOperatorFactory
from ..ops.hash_join import (INNER, SEMI, JoinBuildOperatorFactory,
                             LookupJoinOperatorFactory, join_strategy)
from ..ops.scan import TableScanOperatorFactory
from ..ops.topn import SortOrder, TopNOperatorFactory
from ..spi.connector import (ConcatPageSource, ConnectorPageSource, Constraint,
                             SchemaTableName)
from ..types import BIGINT, BOOLEAN, DATE, VARCHAR, DecimalType
from ..utils.testing import PageConsumerFactory

DEC = DecimalType(12, 2)


def _table_source(schema: str, table: str, columns: List[str], page_capacity: int,
                  n_splits: int = 8) -> Tuple[ConnectorPageSource, InputLayout]:
    conn = TpchConnector("tpch")
    meta = conn.metadata()
    th = meta.get_table_handle(SchemaTableName(schema, table))
    handles = meta.get_column_handles(th)
    splits = conn.split_manager().get_splits(th, Constraint.all(), n_splits)
    sources = [conn.page_source_provider().create_page_source(
        s, [handles[c] for c in columns], page_capacity) for s in splits]
    if table == "lineitem":
        info = {n: (t, d) for (n, t, d) in g.LINEITEM_COLUMNS}
    else:
        info = {c.name: (c.type, c.dictionary) for c in g.TPCH_TABLES[table].columns}
    layout = InputLayout([info[c][0] for c in columns], [info[c][1] for c in columns])
    return ConcatPageSource(sources), layout


def build_q3(schema: str = "sf1", page_capacity: int = 1 << 20, device="cuda",
             hash_kernels: str = "auto"):
    """TPC-H Q3: customer semi-> orders build -> lineitem probe -> group -> TopN.

      pipeline 1: scan customer [c_mktsegment='BUILDING'] -> build semi set (custkey)
      pipeline 2: scan orders [o_orderdate < 1995-03-15] -> semi join customer
                  -> build lookup (o_orderkey -> o_orderdate, o_shippriority)
      pipeline 3: scan lineitem [l_shipdate > 1995-03-15] -> lookup join
                  -> project revenue -> hash agg by (okey, odate, oprio) -> TopN 10
    """
    device = resolve_device(device)
    cutoff = days_from_civil(1995, 3, 15)

    # pipeline 1: customer build (semi set of custkeys in BUILDING segment)
    csrc, clayout = _table_source(schema, "customer", ["c_custkey", "c_mktsegment"],
                                  page_capacity)
    cpred = call("equal", BOOLEAN, input_ref(1, VARCHAR), constant("BUILDING", VARCHAR))
    cproc = PageProcessor(clayout, cpred, [input_ref(0, BIGINT)])
    cscan = TableScanOperatorFactory(0, [csrc], cproc.output_types, cproc, device)
    cbuild = JoinBuildOperatorFactory(1, [0], [], [], strategy="sorted", unique=False,
                                      device=device)
    d1 = Driver([cscan.create_operator(), cbuild.create_operator()])

    # pipeline 2: orders filtered + semi-joined, then built as lookup source
    osrc, olayout = _table_source(schema, "orders",
                                  ["o_orderkey", "o_custkey", "o_orderdate",
                                   "o_shippriority"], page_capacity)
    oprio = olayout.types[3]
    opred = call("less_than", BOOLEAN, input_ref(2, DATE), constant(cutoff, DATE))
    oproc = PageProcessor(olayout, opred,
                          [input_ref(0, BIGINT), input_ref(1, BIGINT),
                           input_ref(2, DATE), input_ref(3, oprio)])
    oscan = TableScanOperatorFactory(2, [osrc], oproc.output_types, oproc, device)
    osemi = LookupJoinOperatorFactory(
        3, cbuild.lookup_factory, [1], [0, 1, 2, 3],
        [(BIGINT, None), (BIGINT, None), (DATE, None), (oprio, None)],
        [], [], SEMI)
    strategy = join_strategy(hash_kernels, device, INNER, [0], True)
    obuild = JoinBuildOperatorFactory(4, [0], [2, 3], [(DATE, None), (oprio, None)],
                                      strategy=strategy, unique=True, device=device)
    d2 = Driver([oscan.create_operator(), osemi.create_operator(),
                 obuild.create_operator()])

    # pipeline 3: lineitem probe -> revenue -> agg -> topn
    lsrc, llayout = _table_source(schema, "lineitem",
                                  ["l_orderkey", "l_shipdate", "l_extendedprice",
                                   "l_discount"], page_capacity)
    lpred = call("greater_than", BOOLEAN, input_ref(1, DATE), constant(cutoff, DATE))
    revenue = call("multiply", DecimalType(18, 4), input_ref(2, DEC),
                   call("subtract", DEC, constant(100, DEC), input_ref(3, DEC)))
    lproc = PageProcessor(llayout, lpred, [input_ref(0, BIGINT), revenue])
    lscan = TableScanOperatorFactory(5, [lsrc], lproc.output_types, lproc, device)
    ljoin = LookupJoinOperatorFactory(
        6, obuild.lookup_factory, [0], [0, 1],
        [(BIGINT, None), (DecimalType(18, 4), None)],
        [0, 1], [(DATE, None), (oprio, None)], INNER)
    calls = [AggregateCall(resolve_aggregate("sum", [DecimalType(18, 4)]), [1])]
    agg = HashAggregationOperatorFactory(
        7, [0, 2, 3], [BIGINT, DATE, oprio], [None, None, None], calls, SINGLE,
        page_capacity, device=device)
    out_types = [BIGINT, DATE, oprio, DecimalType(18, 4)]
    # final order: l_orderkey, revenue, o_orderdate, o_shippriority
    topn = TopNOperatorFactory(8, 10, [SortOrder(3, descending=True), SortOrder(1)],
                               out_types)
    sink = PageConsumerFactory(9, out_types)
    d3 = Driver([lscan.create_operator(), ljoin.create_operator(),
                 agg.create_operator(), topn.create_operator(),
                 sink.create_operator()])
    return [d1, d2, d3], sink


def run_q3(schema: str = "sf1", page_capacity: int = 1 << 20, device="cuda",
           hash_kernels: str = "auto"):
    """Run Q3; rows as [orderkey, revenue, orderdate, shippriority] Python values."""
    drivers, sink = build_q3(schema, page_capacity, device, hash_kernels)
    for d in drivers:  # build pipelines first, then probe
        d.run_to_completion()
    return [[r[0], r[3], r[1], r[2]] for r in sink.rows()]
