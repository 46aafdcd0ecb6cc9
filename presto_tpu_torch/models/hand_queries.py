"""Hand-built TPC-H operator pipelines of the PyTorch port.

Counterpart of ``presto_tpu/models/hand_queries.py``, itself the analogue
of presto-benchmark's HandTpchQuery1/HandTpchQuery6: the physical plans the
SQL planner produces, built directly. ``build_q1`` and ``build_q6`` are one
pipeline each (scan with filter and projections, aggregation, sink);
``run_query`` drives one and ``source_rows`` is the rows/s denominator.

``build_q3`` is three pipelines over the same operators, with the
``orders`` build strategy picked from ``hash_kernels`` the way the
reference planner's ``_join_strategy`` picks it:

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
from ..ops.expressions import (InputLayout, call, constant, days_from_civil, input_ref,
                               special)
from ..ops.filter_project import PageProcessor
from ..ops.hash_agg import SINGLE, HashAggregationOperatorFactory
from ..ops.hash_join import (INNER, SEMI, JoinBuildOperatorFactory,
                             LookupJoinOperatorFactory, join_strategy)
from ..ops.scan import TableScanOperatorFactory
from ..ops.topn import SortOrder, TopNOperatorFactory
# ConcatPageSource is re-exported under the reference's name in this module
from ..spi.connector import (ConcatPageSource, ConnectorPageSource, Constraint,  # noqa: F401
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


def _lineitem_source(schema: str, columns: List[str], page_capacity: int,
                     n_splits: int = 8) -> Tuple[ConnectorPageSource, InputLayout]:
    return _table_source(schema, "lineitem", columns, page_capacity, n_splits)


def build_q6(schema: str = "sf1", page_capacity: int = 1 << 20, device="cuda"):
    """TPC-H Q6: sum(extendedprice*discount) under date/discount/quantity filter
    (a GLOBAL aggregation). Returns (driver, sink)."""
    device = resolve_device(device)
    columns = ["l_shipdate", "l_discount", "l_quantity", "l_extendedprice"]
    source, layout = _lineitem_source(schema, columns, page_capacity)
    sd, disc, qty, ep = (input_ref(i, layout.types[i]) for i in range(4))
    pred = special(
        "AND", BOOLEAN,
        call("greater_than_or_equal", BOOLEAN, sd, constant(days_from_civil(1994, 1, 1), DATE)),
        call("less_than", BOOLEAN, sd, constant(days_from_civil(1995, 1, 1), DATE)),
        special("BETWEEN", BOOLEAN, disc, constant(5, DEC), constant(7, DEC)),
        call("less_than", BOOLEAN, qty, constant(2400, DEC)),
    )
    revenue = call("multiply", DecimalType(18, 4), ep, disc)
    processor = PageProcessor(layout, pred, [revenue])
    scan = TableScanOperatorFactory(0, lambda w: [source], processor.output_types, processor,
                                    device)
    agg = HashAggregationOperatorFactory(
        1, [], [], [], [AggregateCall(resolve_aggregate("sum", [DecimalType(18, 4)]), [0])],
        SINGLE, page_capacity, device=device)
    sink = PageConsumerFactory(2, agg_output_types(agg))
    return Driver([scan.create_operator(), agg.create_operator(), sink.create_operator()]), sink


def build_q1(schema: str = "sf1", page_capacity: int = 1 << 20, device="cuda"):
    """TPC-H Q1: grouped aggregation over returnflag x linestatus, DIRECT
    over the two dictionary domains. Returns (driver, sink)."""
    device = resolve_device(device)
    columns = ["l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
               "l_discount", "l_tax", "l_shipdate"]
    source, layout = _lineitem_source(schema, columns, page_capacity)
    rf, ls, qty, ep, disc, tax, sd = (input_ref(i, layout.types[i]) for i in range(7))
    cutoff = days_from_civil(1998, 12, 1) - 90
    pred = call("less_than_or_equal", BOOLEAN, sd, constant(cutoff, DATE))
    one = constant(100, DEC)  # literal 1 at scale 2
    disc_price = call("multiply", DecimalType(18, 4), ep, call("subtract", DEC, one, disc))
    charge = call("multiply", DecimalType(18, 6), disc_price, call("add", DEC, one, tax))
    processor = PageProcessor(layout, pred, [rf, ls, qty, ep, disc, disc_price, charge])
    scan = TableScanOperatorFactory(0, lambda w: [source], processor.output_types, processor,
                                    device)
    calls = [
        AggregateCall(resolve_aggregate("sum", [DEC]), [2]),                 # sum qty
        AggregateCall(resolve_aggregate("sum", [DEC]), [3]),                 # sum base price
        AggregateCall(resolve_aggregate("sum", [DecimalType(18, 4)]), [5]),  # sum disc price
        AggregateCall(resolve_aggregate("sum", [DecimalType(18, 6)]), [6]),  # sum charge
        AggregateCall(resolve_aggregate("avg", [DEC]), [2]),                 # avg qty
        AggregateCall(resolve_aggregate("avg", [DEC]), [3]),                 # avg price
        AggregateCall(resolve_aggregate("avg", [DEC]), [4]),                 # avg discount
        AggregateCall(resolve_aggregate("count", []), []),                   # count(*)
    ]
    agg = HashAggregationOperatorFactory(
        2, [0, 1], [VARCHAR, VARCHAR], [g.DICT_RETURNFLAG, g.DICT_LINESTATUS], calls, SINGLE,
        page_capacity, device=device,
        key_domains=[len(g.DICT_RETURNFLAG), len(g.DICT_LINESTATUS)])
    sink = PageConsumerFactory(3, agg_output_types(agg))
    return Driver([scan.create_operator(), agg.create_operator(), sink.create_operator()]), sink


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
    cscan = TableScanOperatorFactory(0, lambda w: [csrc], cproc.output_types, cproc, device)
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
    oscan = TableScanOperatorFactory(2, lambda w: [osrc], oproc.output_types, oproc, device)
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
    lscan = TableScanOperatorFactory(5, lambda w: [lsrc], lproc.output_types, lproc, device)
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


def agg_output_types(factory: HashAggregationOperatorFactory):
    """The aggregation's output types: its keys', then each call's."""
    return list(factory.key_types) + [c.function.output_type for c in factory.calls]


def run_query(builder, *args, **kw):
    """Build one single-driver pipeline (``build_q1``, ``build_q6``) and run
    it; its sink's rows as Python values."""
    driver, sink = builder(*args, **kw)
    driver.run_to_completion()
    return sink.rows()


_QUERY_TABLES = {"q1": ["lineitem"], "q6": ["lineitem"],
                 "q3": ["lineitem", "orders", "customer"]}


def source_rows(query: str, schema: str) -> int:
    """Total input rows a query scans (the presto-benchmark rows/s denominator)."""
    from ..connectors.tpch.connector import SCHEMAS

    sf = SCHEMAS[schema]
    return sum(g.table_row_count(t, sf) for t in _QUERY_TABLES[query])
