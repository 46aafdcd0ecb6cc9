"""FULL joins in the port, held against presto_tpu on the CPU at ``tpch.tiny``.

A FULL join builds sorted with ``track_unmatched``: NULL-key build rows go
to a side buffer, the probe ORs every matched build row into a visited flag
and emits unmatched probe rows with NULL build columns, and ``finish``
emits, once, the unvisited live build rows and the NULL-key rows with NULL
probe columns. Checked here:

- ``tests/test_sql_e2e.py:144`` (a duplicate-key build: range expansion and
  visited marking across chunks) and ``:153`` (a unique build), and both
  directions of ``orders``/``customer``: rows, fused segments and
  ``pallas.`` counter deltas equal to the reference's, under the defaults
  with ``pallas`` and unfused with ``sorted``;
- NULL keys on both sides through VALUES sources, an empty probe side and
  an empty build side;
- four drivers: the FULL probe's pipeline is cut exactly as the
  reference's (the probe stays on one driver), and the rows do not change;
- the unmatched epilogue's pages hold at most 2^16 rows.
"""
import threading

import pytest
import torch

from presto_tpu.exec.local_planner import LocalExecutionPlanner as RefPlanner
from presto_tpu.metadata import Session as RefSession
from presto_tpu.runner import LocalQueryRunner as RefRunner
from presto_tpu.utils.metrics import METRICS as REF_METRICS
from presto_tpu_torch.block import Block, Page
from presto_tpu_torch.exec.local_planner import LocalExecutionPlanner
from presto_tpu_torch.metadata import Session
from presto_tpu_torch.ops.hash_join import (FULL, JoinBuildOperatorFactory,
                                            LookupJoinOperatorFactory)
from presto_tpu_torch.runner import LocalQueryRunner
from presto_tpu_torch.types import BIGINT
from presto_tpu_torch.utils.metrics import METRICS
from test_torch_sql import COUNTERS, UNFUSED, assert_same_rows
from test_torch_sql_tpch_exprs import segment_view

FULL_SQL = {
    # tests/test_sql_e2e.py:144: the build (orders by o_custkey) has duplicates
    "e2e_duplicates": "select c_name, o_orderkey from "
                      "(select * from customer where c_custkey < 30) c full join "
                      "(select * from orders where o_orderkey < 7) o "
                      "on c_custkey = o_custkey",
    # tests/test_sql_e2e.py:153: the build (region) is unique
    "e2e_unique": "select n.n_regionkey, r_name from "
                  "(select * from nation where n_nationkey < 12) n full join region "
                  "on n.n_regionkey = r_regionkey",
    # a unique build with unmatched customers from the epilogue
    "orders_customer": "select o_orderkey, o_totalprice, c_custkey, c_name from orders "
                       "full join customer on o_custkey = c_custkey",
    # a duplicate-key build with every probe row matched
    "customer_orders": "select c_custkey, c_mktsegment, o_orderkey, o_orderdate from customer "
                       "full join orders on c_custkey = o_custkey",
    "null_keys": "select a.k, a.v, b.k, b.w from "
                 "(values (1, 10), (2, 20), (null, 30), (4, 40), (null, 50)) as a(k, v) "
                 "full join (values (1, 100), (null, 200), (3, 300), (1, 101), (null, 201)) "
                 "as b(k, w) on a.k = b.k",
    "empty_probe": "select c_custkey, o_orderkey from "
                   "(select * from customer where c_custkey < 0) c full join "
                   "(select * from orders where o_orderkey < 100) o on c_custkey = o_custkey",
    "empty_build": "select c_custkey, o_orderkey from "
                   "(select * from customer where c_custkey < 10) c full join "
                   "(select * from orders where o_orderkey < 0) o on c_custkey = o_custkey",
}
PROPS = {"pallas_defaults": {"hash_kernels": "pallas"},
         "sorted_unfused": {"hash_kernels": "sorted", **UNFUSED}}


def _run(runner_cls, session_cls, metrics, sql, props, **kw):
    before = {k: metrics.counter_value(k) for k in COUNTERS}
    res = runner_cls(session_cls(catalog="tpch", schema="tiny", properties=dict(props)),
                     **kw).execute(sql)
    delta = {k: metrics.counter_value(k) - before[k] for k in COUNTERS}
    return res.rows, segment_view((res.stats or {}).get("segments")), delta


@pytest.fixture(scope="module")
def reference():
    cache = {}

    def get(name, props_id):
        if (name, props_id) not in cache:
            cache[(name, props_id)] = _run(RefRunner, RefSession, REF_METRICS, FULL_SQL[name],
                                           PROPS[props_id])
        return cache[(name, props_id)]
    return get


@pytest.mark.parametrize("props_id", sorted(PROPS))
@pytest.mark.parametrize("name", sorted(FULL_SQL))
def test_rows_segments_and_counters_match_reference(reference, name, props_id):
    want_rows, want_seg, want_delta = reference(name, props_id)
    rows, seg, delta = _run(LocalQueryRunner, Session, METRICS, FULL_SQL[name],
                            PROPS[props_id], device="cpu")
    assert rows, "the query returned no rows"
    # probe rows in page order, then the epilogue in sorted build order
    assert_same_rows(rows, want_rows)
    assert seg == want_seg
    assert delta == want_delta
    assert delta["pallas.join_fallbacks"] == 0


def test_null_keys_on_both_sides():
    rows = LocalQueryRunner(Session(catalog="tpch", schema="tiny"), device="cpu") \
        .execute(FULL_SQL["null_keys"]).rows
    assert sorted(rows, key=repr) == sorted(
        [[1, 10, 1, 100], [1, 10, 1, 101], [2, 20, None, None], [None, 30, None, None],
         [4, 40, None, None], [None, 50, None, None], [None, None, 3, 300],
         [None, None, None, 200], [None, None, None, 201]], key=repr)


def _plan_view(pipelines):
    return [([f.name for f in p], getattr(p[0], "parallel_drivers", 1)) for p in pipelines]


@pytest.mark.parametrize("name", ["orders_customer", "customer_orders"])
def test_four_drivers_cut_and_rows_match_reference(reference, name):
    props = {"driver_parallelism": 4, "hash_kernels": "pallas"}
    rr = RefRunner(RefSession(catalog="tpch", schema="tiny", properties=props))
    want = RefPlanner(rr.metadata, rr.session).plan(rr.plan_sql(FULL_SQL[name]))
    pr = LocalQueryRunner(Session(catalog="tpch", schema="tiny", properties=props), device="cpu")
    got = LocalExecutionPlanner(pr.metadata, pr.session, "cpu").plan(pr.plan_sql(FULL_SQL[name]))
    assert _plan_view(got.pipelines) == _plan_view(want.pipelines)
    assert got.segment_decisions == want.segment_decisions
    probes = [(p, f) for p in got.pipelines for f in p
              if isinstance(f, LookupJoinOperatorFactory) and f.join_type == FULL]
    assert len(probes) == 1 and getattr(probes[0][0][0], "parallel_drivers", 1) == 1
    out = {}

    def run():
        out["rows"] = pr.execute(FULL_SQL[name]).rows
    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(120)
    assert not t.is_alive(), "the FULL join deadlocked under 4 drivers"
    want_rows = reference(name, "pallas_defaults")[0]
    assert_same_rows(sorted(out["rows"], key=repr), sorted(want_rows, key=repr))


def test_epilogue_runs_once_in_pages_of_at_most_2_16_rows():
    """A build of 70,000 unmatched rows and a probe that saw one page: the
    epilogue emits every build row once, in two pages (65,536 + 4,464), and
    a second finish emits nothing more."""
    n = 70000
    build = JoinBuildOperatorFactory(0, [0], [0, 1], [(BIGINT, None), (BIGINT, None)],
                                     strategy="sorted", unique=True, device="cpu",
                                     track_unmatched=True)
    keys = torch.arange(n, dtype=torch.int64) + 10 ** 6
    op = build.create_operator()
    op.add_input(Page((Block(BIGINT, keys), Block(BIGINT, keys * 2)),
                      torch.ones(n, dtype=torch.bool)))
    op.finish()
    probe = LookupJoinOperatorFactory(1, build.lookup_factory, [0], [0], [(BIGINT, None)],
                                      [0, 1], [(BIGINT, None), (BIGINT, None)], FULL,
                                      unique_build=True).create_operator()
    assert probe.is_blocked() is None
    probe.add_input(Page((Block(BIGINT, torch.arange(8, dtype=torch.int64)),),
                         torch.ones(8, dtype=torch.bool)))
    probe.finish()
    probe.finish()
    pages = []
    while (p := probe.get_output()) is not None:
        pages.append(p)
    assert probe.is_finished()
    assert [int(p.mask.sum()) for p in pages] == [8, 65536, 4464]
    assert max(p.capacity for p in pages) <= 1 << 16
    rows = [r for p in pages[1:] for r in p.to_pylists()]
    assert sorted(r[1] for r in rows) == list(range(10 ** 6, 10 ** 6 + n))
    assert all(r[0] is None and r[2] == 2 * r[1] for r in rows)
    assert all(r[1] is None and r[2] is None for r in pages[0].to_pylists())
