"""The port's grouped (lifespan) execution (``presto_tpu_torch/exec/
grouped.py`` and the runner's bucket loop) against presto_tpu on the CPU
at ``tpch.tiny``, over co-bucketed hive tables.

One reference runner and one port runner, each with a ``hive`` catalog of
its own holding the same tables (``orders`` and ``customer`` bucketed 4
ways on the customer key, and ``customer`` 8 ways), run the cases of
``tests/test_grouped_execution.py``: the same ``last_grouped`` (the bucket
count, or None when the query ran ungrouped) and equal rows. Besides:

- ``analyze_grouped`` gives the reference's bucket count, orderings and
  limit on the same plans;
- ``merge_rows`` equals the reference's on seeded rows with NULLs, for
  every combination of ``descending`` and ``nulls_first``, with and
  without a limit;
- each operator's accounted peak in a grouped run is no larger than in
  the ungrouped run, and each bucket's reservation is released before the
  next starts;
- a grouped query's trace nests as the reference's does: one ``query``
  span with each bucket's ``local_plan`` and ``execute`` under it.
"""
import json

import numpy as np
import pytest

from presto_tpu.connectors import hive as ref_hive
from presto_tpu.exec import grouped as ref_grouped
from presto_tpu.metadata import Session as RefSession
from presto_tpu.runner import LocalQueryRunner as RefRunner
from presto_tpu.utils import trace as ref_trace
from presto_tpu_torch.connectors import hive
from presto_tpu_torch.exec import grouped
from presto_tpu_torch.exec.explain import driver_stats
from presto_tpu_torch.metadata import Session
from presto_tpu_torch.runner import LocalQueryRunner
from presto_tpu_torch.utils import trace
from test_torch_sql import assert_same_rows
from test_torch_trace import _lifecycle

TABLES = [
    "create table hive.default.ord with (bucketed_by = array['o_custkey'], bucket_count = 4) "
    "as select o_orderkey, o_custkey, o_totalprice from orders",
    "create table hive.default.cust with (bucketed_by = array['c_custkey'], bucket_count = 4) "
    "as select c_custkey, c_name, c_mktsegment from customer",
    "create table hive.default.cust8 with (bucketed_by = array['c_custkey'], "
    "bucket_count = 8) as select c_custkey, c_name from customer",
]

# tests/test_grouped_execution.py's queries: (sql, last_grouped, session properties)
CASES = {
    "cobucketed join": (
        "select c_name, o_orderkey from hive.default.ord o join hive.default.cust c "
        "on o.o_custkey = c.c_custkey where o_totalprice > 100000.0", 4, {}),
    "agg on the bucket key": (
        "select o_custkey, count(*), sum(o_totalprice) from hive.default.ord "
        "group by o_custkey", 4, {}),
    "topn merges across buckets": (
        "select o_custkey, sum(o_totalprice) as total from hive.default.ord "
        "group by o_custkey order by total desc limit 7", 4, {}),
    "global agg": ("select count(*) from hive.default.ord", None, {}),
    "mismatched bucket counts": (
        "select c_name, o_orderkey from hive.default.ord o join hive.default.cust8 c "
        "on o.o_custkey = c.c_custkey", None, {}),
    "join not on the bucket key": (
        "select * from hive.default.ord o join hive.default.cust c "
        "on o.o_orderkey = c.c_custkey", None, {}),
    "session flag disables": (
        "select o_custkey, count(*) from hive.default.ord group by o_custkey", None,
        {"grouped_execution": False}),
    "limit below agg": (
        "select o_custkey, count(*) from (select o_custkey from hive.default.ord limit 10) "
        "group by o_custkey", None, {}),
    "left join null group": (
        "select c_custkey, count(*) from hive.default.ord o left join hive.default.cust c "
        "on o.o_custkey = c.c_custkey group by c_custkey", None, {}),
    "unbucketed scan": ("select count(*) from orders where o_custkey > 0", None, {}),
    "grouped matches ungrouped": (
        "select c_custkey, count(*) as n from hive.default.ord o join hive.default.cust c "
        "on o.o_custkey = c.c_custkey group by c_custkey order by n desc, c_custkey limit 11",
        4, {}),
    "join and agg by segment": (
        "select c_custkey, c_mktsegment, count(*), max(o_totalprice) from hive.default.ord o "
        "join hive.default.cust c on o.o_custkey = c.c_custkey "
        "where c_mktsegment = 'BUILDING' group by 1, 2 order by 4 desc, 1 limit 5", 4, {}),
}


@pytest.fixture(scope="module")
def runners(tmp_path_factory):
    """(reference runner, port runner), each over its own hive warehouse
    holding ``TABLES``."""
    base = tmp_path_factory.mktemp("grouped")
    ref = RefRunner(RefSession(catalog="tpch", schema="tiny"))
    ref.catalogs.register("hive", ref_hive.HiveConnector("hive", str(base / "ref")))
    port = LocalQueryRunner(Session(catalog="tpch", schema="tiny"), device="cpu")
    port.catalogs.register("hive", hive.HiveConnector("hive", str(base / "port")))
    for sql in TABLES:
        assert port.execute(sql).rows == ref.execute(sql).rows
    return ref, port


def _run(runner, sql, props):
    """-> (rows, last_grouped) under ``props``; the session is restored."""
    session = runner.session
    runner.session = session.with_properties(**props)
    try:
        return runner.execute(sql).rows, runner.last_grouped
    finally:
        runner.session = session


def _same(got, want, sql):
    if "order by" in sql:
        assert_same_rows(got, want)
    else:
        assert_same_rows(sorted(got, key=repr), sorted(want, key=repr))


@pytest.mark.parametrize("case", list(CASES))
def test_grouped_cases_equal_the_reference(runners, case):
    sql, grouped_as, props = CASES[case]
    ref, port = runners
    want, ref_grouped_as = _run(ref, sql, props)
    got, port_grouped_as = _run(port, sql, props)
    assert ref_grouped_as == grouped_as
    assert port_grouped_as == grouped_as
    _same(got, want, sql)
    assert got
    if case == "limit below agg":
        assert sum(r[1] for r in got) == 10


@pytest.mark.parametrize("case", ["grouped matches ungrouped", "topn merges across buckets",
                                  "cobucketed join"])
def test_grouped_rows_equal_the_ungrouped_run(runners, case):
    sql, _, _ = CASES[case]
    port = runners[1]
    got, g = _run(port, sql, {})
    want, u = _run(port, sql, {"grouped_execution": False})
    assert (g, u) == (4, None)
    _same(got, want, sql)


@pytest.mark.parametrize("case", list(CASES))
def test_analyze_grouped_equals_the_reference(runners, case):
    sql, _, props = CASES[case]
    ref, port = runners
    ref_session = ref.session.with_properties(**props)
    session = port.session.with_properties(**props)
    want = ref_grouped.analyze_grouped(ref.plan_sql(sql), ref.metadata, ref_session)
    got = grouped.analyze_grouped(port.plan_sql(sql), port.metadata, session)
    if want is None:
        assert got is None
    else:
        assert (got.bucket_count, got.orderings, got.limit) == \
            (want.bucket_count, want.orderings, want.limit)


def test_explain_analyze_runs_ungrouped(runners):
    for r in runners:
        text = r.execute("explain analyze " + CASES["agg on the bucket key"][0]).rows
        assert text and r.last_grouped is None


def _seeded_results(seed: int, buckets: int = 4):
    """Per-bucket rows with NULLs and ties: (int or None, str or None,
    float)."""
    rng = np.random.RandomState(seed)
    words = ["a", "b", "c", None]
    out = []
    for _ in range(buckets):
        n = int(rng.randint(0, 25))
        out.append([[None if rng.rand() < 0.2 else int(rng.randint(0, 6)),
                     words[rng.randint(0, 4)], float(rng.randint(0, 3)) / 2]
                    for _ in range(n)])
    return out


@pytest.mark.parametrize("limit", [None, 7])
@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("nulls_first", [False, True])
def test_merge_rows_equals_the_reference(descending, nulls_first, limit):
    results = _seeded_results(int(descending) * 4 + int(nulls_first) * 2 + (limit is None))
    orderings = [(0, descending, nulls_first), (1, not descending, not nulls_first),
                 (2, descending, nulls_first)]
    for order in (orderings, orderings[1:], []):
        want = ref_grouped.merge_rows([list(map(list, r)) for r in results],
                                      ref_grouped.GroupedExecution(4, order, limit))
        got = grouped.merge_rows(results, grouped.GroupedExecution(4, order, limit))
        assert got == want


def test_grouped_peak_per_operator_is_no_larger(runners):
    """Each operator's accounted peak: every bucket's run against the
    ungrouped run (one driver, 4,096-row pages), and the pool holds none of
    the query's bytes once a bucket's run ends."""
    from presto_tpu_torch.memory import shared_general_pool

    port = runners[1]
    sql = CASES["join and agg by segment"][0]
    session = port.session
    port.session = session.with_properties(page_capacity=1 << 12, driver_parallelism=1)
    try:
        plan = port.plan_sql(sql)
        _, drivers, _ = port._run_plan(plan)
        whole = [(s["name"], s["peak_memory_bytes"]) for s in driver_stats(drivers)]
        pool = shared_general_pool(int(port.session.get("memory_pool_bytes")))
        before = pool.reserved_bytes()
        for b in range(4):
            _, drivers, _ = port._run_plan(plan, bucket_filter=b)
            assert pool.reserved_bytes() == before
            per_bucket = [(s["name"], s["peak_memory_bytes"]) for s in driver_stats(drivers)]
            assert [n for n, _ in per_bucket] == [n for n, _ in whole]
            assert all(p <= w for (_, p), (_, w) in zip(per_bucket, whole)), \
                (per_bucket, whole)
    finally:
        port.session = session
    assert any(w > 0 for _, w in whole)


def test_grouped_trace_nests_as_the_reference(runners, tmp_path):
    """One ``query`` span, one ``plan``, and a ``local_plan`` and an
    ``execute`` per bucket under it, as the reference records them."""
    sql = CASES["agg on the bucket key"][0]
    docs = []
    for r, mod in zip(runners, (ref_trace, trace)):
        d = tmp_path / type(r).__module__.split(".")[0]
        d.mkdir()
        session = r.session
        r.session = session.with_properties(query_trace=True, query_trace_dir=str(d))
        try:
            res = r.execute(sql)
        finally:
            r.session = session
        assert r.last_grouped == 4
        with open(res.trace_path) as f:
            doc = json.load(f)
        docs.append((doc, set(mod.span_categories(doc)) - {mod.KERNEL}))
    (ref_doc, ref_cats), (doc, cats) = docs
    assert _lifecycle(doc) == _lifecycle(ref_doc)
    assert [n for n, _ in _lifecycle(doc)].count("execute") == 4
    assert [p for n, p in _lifecycle(doc) if n in ("local_plan", "execute")] == ["query"] * 8
    assert cats == ref_cats


def test_unbucketed_catalogs_reject_before_listing_splits(runners, tmp_path):
    """With grouped execution on (the default), a scan of ``tpch``,
    ``tpcds``, ``memory`` or the file catalog rejects grouping at its
    bucket count, before any split of it is listed."""
    from presto_tpu_torch.connectors.file import FileConnector
    from presto_tpu_torch.models.tpcds_sql import QUERIES as DS_QUERIES
    from presto_tpu_torch.models.tpch_sql import QUERIES

    port = runners[1]
    port.catalogs.register("wh", FileConnector("wh", str(tmp_path / "wh")))
    port.execute("create table memory.default.g_nat as select * from nation")
    port.execute("create table wh.default.g_nat as select * from nation")
    sqls = {"tpch": QUERIES[3], "tpcds": DS_QUERIES[3],
            "memory": "select n_regionkey, count(*) from memory.default.g_nat group by 1",
            "wh": "select n_regionkey, count(*) from wh.default.g_nat group by 1"}
    session = port.session
    for cat, sql in sqls.items():
        port.session = Session(catalog="tpcds", schema="tiny") if cat == "tpcds" else session
        plan = port.plan_sql(sql)
        manager = port.catalogs.get(cat).split_manager()

        def refuse(*a, **kw):
            raise AssertionError("grouped execution listed the splits of " + cat)
        manager.get_splits = refuse
        try:
            assert grouped.analyze_grouped(plan, port.metadata, port.session) is None
        finally:
            del manager.get_splits
        try:
            port.execute(sql)
        finally:
            port.session = session
        assert port.last_grouped is None
