"""The collecting aggregates in the port (``ops/collect_agg.py``):
``array_agg``, ``map_agg`` and ``histogram``, held against presto_tpu on the
CPU at ``tpch.tiny``, with one module-scoped reference runner and one port
runner.

- every case of ``tests/test_collect_agg.py``, arrays compared as
  multisets (element order inside an array is engine-defined) and maps
  as dicts, under the defaults and unfused;
- the memory-seeded cases: ``array_agg`` with NULL elements and
  ``tests/test_minmax_by.py``'s ``min_by`` with NULL ordering values;
- the builder choice (a collect call takes the collect builder, and its
  aggregation never ends a fused segment) and the refusal to persist
  ARRAY/MAP columns;
- ``CollectAggregationBuilder.finish`` on random pages against numpy.
"""
from collections import Counter

import numpy as np
import pytest
import torch

from presto_tpu.metadata import Session as RefSession
from presto_tpu.runner import LocalQueryRunner as RefRunner
from presto_tpu_torch.block import Block, Page
from presto_tpu_torch.metadata import Session
from presto_tpu_torch.ops.aggregates import AggregateCall, resolve_aggregate
from presto_tpu_torch.ops.collect_agg import CollectAggregationBuilder
from presto_tpu_torch.ops.hash_agg import make_builder
from presto_tpu_torch.runner import LocalQueryRunner
from presto_tpu_torch.types import BIGINT
from test_torch_sql import UNFUSED

COLLECT_SQL = {
    "array_agg_grouped": "select n_regionkey, array_agg(n_name) from tpch.tiny.nation "
                         "group by n_regionkey order by n_regionkey",
    "array_agg_global": "select array_agg(r_name) from tpch.tiny.region",
    "array_agg_empty": "select array_agg(r_name) from tpch.tiny.region where r_regionkey > 99",
    "array_agg_algebraic_mix": "select n_regionkey, count(*), array_agg(n_nationkey), "
                               "sum(n_nationkey) from tpch.tiny.nation "
                               "group by n_regionkey order by n_regionkey",
    "array_agg_filter": "select array_agg(n_name) filter (where n_regionkey = 1) "
                        "from tpch.tiny.nation",
    "map_agg": "select map_agg(n_name, n_nationkey) from tpch.tiny.nation",
    "map_agg_grouped": "select n_regionkey, map_agg(n_name, n_nationkey) from tpch.tiny.nation "
                       "group by n_regionkey order by n_regionkey",
    "histogram": "select histogram(o_orderstatus) from tpch.tiny.orders",
    "histogram_grouped": "select o_orderpriority, histogram(o_orderstatus) "
                         "from tpch.tiny.orders group by o_orderpriority",
    "array_agg_order_by_after": "select n_regionkey, array_agg(n_nationkey) as a "
                                "from tpch.tiny.nation group by n_regionkey "
                                "order by n_regionkey desc limit 2",
    "cardinality_of_array_agg": "select n_regionkey, cardinality(array_agg(n_name)) "
                                "from tpch.tiny.nation group by n_regionkey "
                                "order by n_regionkey",
    # the port's own: many groups over several pages, dates and decimals
    "array_agg_orders": "select o_custkey, array_agg(o_orderkey), "
                        "cardinality(array_agg(o_orderkey)), count(*) from tpch.tiny.orders "
                        "group by o_custkey",
    "histogram_lineitem": "select l_returnflag, l_linestatus, histogram(l_shipmode), "
                          "count(*) from tpch.tiny.lineitem group by 1, 2",
    "array_agg_dates_decimals": "select o_orderpriority, array_agg(o_orderdate), "
                                "array_agg(o_totalprice), min(o_orderdate) "
                                "from tpch.tiny.orders where o_orderkey < 200 "
                                "group by o_orderpriority",
}
PROPS = {"defaults": {}, "unfused": UNFUSED}


def normalize(v):
    """An array as a multiset (its elements in a canonical order)."""
    if isinstance(v, list):
        return ("array", sorted(Counter(v).items(), key=repr))
    return v


def canon(rows, ordered):
    out = [tuple(normalize(v) for v in r) for r in rows]
    return out if ordered else sorted(out, key=repr)


@pytest.fixture(scope="module")
def runners():
    return {p: (RefRunner(RefSession(catalog="tpch", schema="tiny", properties=dict(props))),
                LocalQueryRunner(Session(catalog="tpch", schema="tiny", properties=dict(props)),
                                 device="cpu"))
            for p, props in PROPS.items()}


@pytest.mark.parametrize("props_id", sorted(PROPS))
@pytest.mark.parametrize("name", sorted(COLLECT_SQL))
def test_collect_matches_reference(runners, name, props_id):
    ref, port = runners[props_id]
    sql = COLLECT_SQL[name]
    ordered = "order by" in sql
    got, want = port.execute(sql).rows, ref.execute(sql).rows
    assert got
    assert canon(got, ordered) == canon(want, ordered)


def test_collect_shapes_match_the_reference_test(runners):
    """The reference test's own assertions, on the port's rows."""
    port = runners["defaults"][1]
    got = port.execute(COLLECT_SQL["array_agg_empty"]).rows
    assert got == [[None]]  # NULL, not an empty array
    got = port.execute(COLLECT_SQL["array_agg_global"]).rows
    assert Counter(got[0][0]) == Counter(["AFRICA", "AMERICA", "ASIA", "EUROPE",
                                          "MIDDLE EAST"])
    rows = port.execute("select n_name, n_nationkey from tpch.tiny.nation").rows
    assert port.execute(COLLECT_SQL["map_agg"]).rows[0][0] == {n: k for n, k in rows}
    assert all(c == 5 for _, c in port.execute(COLLECT_SQL["cardinality_of_array_agg"]).rows)
    got = port.execute(COLLECT_SQL["array_agg_order_by_after"]).rows
    assert [r[0] for r in got] == [4, 3]


# ------------------------------------------------------ memory-seeded

def _seeded(runner, name, create, rows, width):
    runner.execute(f"create table memory.default.seed_{name} as {create}")
    runner.execute(f"create table memory.default.{name} as select * from "
                   f"memory.default.seed_{name}")
    for row in rows:
        vals = ", ".join("null" if v is None else str(v) for v in row[:width])
        runner.execute(f"insert into memory.default.{name} values ({vals})")


MEMORY_CASES = {
    "array_agg_includes_nulls": (
        "select o_orderkey as k, o_custkey as v from tpch.tiny.orders limit 0",
        [(1, 10), (1, None), (2, None), (2, None)], 2,
        "select k, array_agg(v) from memory.default.{t} group by k"),
    "min_by_nulls": (
        "select o_orderkey as k, o_custkey as x, o_custkey as y from tpch.tiny.orders limit 0",
        [(1, 10, 5), (1, 20, None), (1, None, 1), (2, None, None), (2, 7, 9),
         (3, None, None)], 3,
        "select k, min_by(x, y) from memory.default.{t} group by k"),
}


@pytest.mark.parametrize("name", sorted(MEMORY_CASES))
def test_memory_seeded_case_matches_reference(runners, name):
    create, rows, width, query = MEMORY_CASES[name]
    ref, port = runners["defaults"]
    out = []
    for r in (ref, port):
        _seeded(r, f"mc_{name}", create, rows, width)
        out.append(canon(r.execute(query.format(t=f"mc_{name}")).rows, False))
    assert out[1] == out[0]
    got = dict((r[0], r[1]) for r in port.execute(query.format(t=f"mc_{name}")).rows)
    if name == "min_by_nulls":
        assert got == {1: None, 2: 7, 3: None}
    else:
        assert Counter(got[1]) == Counter([10, None]) and got[2] == [None, None]


def test_collect_columns_are_not_persisted(runners):
    ref, port = runners["defaults"]
    sql = ("create table memory.default.h as select o_orderpriority, "
           "histogram(o_orderstatus) h from tpch.tiny.orders group by 1")
    errs = []
    for r in (ref, port):
        with pytest.raises(ValueError, match="cannot be persisted") as e:
            r.execute(sql)
        errs.append(str(e.value))
    assert errs[1] == errs[0]


# ------------------------------------------------------------ builder

def _call(name, channels, arg_types):
    fn = resolve_aggregate(name, arg_types)
    return AggregateCall(fn, list(channels), None, output_dictionary=fn.output_dict)


def test_collect_calls_take_the_collect_builder():
    calls = [_call("array_agg", [1], [BIGINT]), _call("sum", [1], [BIGINT])]
    assert isinstance(make_builder([BIGINT], None, calls, device="cpu"),
                      CollectAggregationBuilder)
    assert isinstance(make_builder([], None, calls, device="cpu"), CollectAggregationBuilder)
    port = LocalQueryRunner(Session(catalog="tpch", schema="tiny"), device="cpu")
    res = port.execute("select o_orderpriority, array_agg(o_orderkey) from orders "
                       "where o_totalprice > 1000 group by 1")
    decisions = (res.stats or {}).get("segments", {}).get("decisions", [])
    assert not any(d.get("fused") and any("HashAggregation" in o for o in d["operators"])
                   for d in decisions)


@pytest.mark.parametrize("seed", [0, 1])
def test_collect_builder_matches_numpy(seed):
    """Random pages with NULL keys and values, masked rows and an empty
    tail page: array_agg and histogram per group, and the group count."""
    rng = np.random.default_rng(seed)
    cap = 256
    pages, rows = [], []
    for p in range(3):
        live = rng.random(cap) < (0.0 if p == 2 else 0.7)
        k = rng.integers(0, 12, cap)
        kn = rng.random(cap) < 0.1
        v = rng.integers(0, 5, cap)
        vn = rng.random(cap) < 0.2
        pages.append(Page((Block(BIGINT, torch.from_numpy(k), torch.from_numpy(kn)),
                           Block(BIGINT, torch.from_numpy(v), torch.from_numpy(vn))),
                          torch.from_numpy(live)))
        rows += [(None if kn[i] else int(k[i]), None if vn[i] else int(v[i]))
                 for i in range(cap) if live[i]]
    calls = [_call("array_agg", [1], [BIGINT]), _call("histogram", [1], [BIGINT]),
             _call("count", [], [])]
    b = CollectAggregationBuilder([BIGINT], calls, device="cpu").set_channels([0])
    for p in pages:
        b.add_page(p)
    keys, states, valid = b.finish()
    n = int(valid.sum())
    want = {}
    for k, v in rows:
        want.setdefault(k, []).append(v)
    assert n == len(want)
    arrays = calls[0].function.output_dict.lookup(states[0][:n].numpy())
    hists = calls[1].function.output_dict.lookup(states[1][:n].numpy())
    for i in range(n):
        key = None if bool(keys[1][i]) else int(keys[0][i])
        assert Counter(arrays[i]) == Counter(want[key])
        assert hists[i] == dict(Counter(x for x in want[key] if x is not None)) or \
            (hists[i] is None and all(x is None for x in want[key]))
        assert int(states[2][i]) == len(want[key])
