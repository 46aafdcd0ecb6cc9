"""SQL through the port's LocalQueryRunner against presto_tpu's, on the CPU.

Both runners get the same session properties and run TPC-H at schema
``tiny``. The port runs on the CPU (``device="cpu"``), where the hash-table
wrappers run their plain versions. Comparisons are exact for ints,
decimals, dates and strings. DOUBLE columns (Q1's averages) are compared to
a relative tolerance of 1e-12: the reference sums float64 per-row
contributions, the port sums a DECIMAL average's scaled integers exactly
and scales once, so the two may differ in the last bits.
"""
import math

import pytest
import torch

from presto_tpu.metadata import Session as RefSession
from presto_tpu.models.tpch_sql import QUERIES as REF_QUERIES
from presto_tpu.runner import LocalQueryRunner as RefRunner
from presto_tpu.utils.metrics import METRICS as REF_METRICS
from presto_tpu.utils.testing import SqliteOracle, assert_rows_equal
from presto_tpu_torch.metadata import Session, default_page_capacity
from presto_tpu_torch.models.tpch_sql import QUERIES
from presto_tpu_torch.runner import LocalQueryRunner
from presto_tpu_torch.utils.metrics import METRICS
from test_sql_e2e import to_sqlite

DOUBLE_REL_TOL = 1e-12
# the unfused, uncoalesced pipeline: the differential oracle of the default one
UNFUSED = {"segment_fusion": False, "coalesce_pages": False}
HASH_KERNELS = ("sorted", "pallas", "auto")
COUNTERS = ("pallas.join_builds", "pallas.join_fallbacks", "pallas.agg_pages")


def _ref_rows(q: int, props: dict):
    return RefRunner(RefSession(catalog="tpch", schema="tiny", properties=dict(props))) \
        .execute(REF_QUERIES[q]).rows


def _port_rows(q: int, props: dict):
    return LocalQueryRunner(Session(catalog="tpch", schema="tiny", properties=dict(props)),
                            device="cpu").execute(QUERIES[q]).rows


def assert_same_rows(got, want):
    """Same rows in the same order; exact but for DOUBLE (DOUBLE_REL_TOL)."""
    assert len(got) == len(want), (got, want)
    for r, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w), (g, w)
        for c, (a, b) in enumerate(zip(g, w)):
            if isinstance(a, float) or isinstance(b, float):
                assert type(a) is type(b) and math.isclose(a, b, rel_tol=DOUBLE_REL_TOL,
                                                           abs_tol=0.0), (r, c, a, b)
            else:
                assert type(a) is type(b) and a == b, (r, c, a, b)


def test_tpch_texts_are_the_reference_texts():
    assert QUERIES == REF_QUERIES and len(QUERIES) == 22


@pytest.mark.parametrize("ref_props", [{}, UNFUSED], ids=["ref_default", "ref_unfused"])
@pytest.mark.parametrize("hash_kernels", HASH_KERNELS)
@pytest.mark.parametrize("q", [1, 3, 6])
def test_tpch_rows_match_reference(q, hash_kernels, ref_props):
    props = {"hash_kernels": hash_kernels}
    want = _ref_rows(q, {**props, **ref_props})
    got = _port_rows(q, props)
    assert got, "the query returned no rows"
    assert_same_rows(got, want)


@pytest.mark.parametrize("hash_kernels", HASH_KERNELS)
def test_q3_kernel_counters_match_reference(hash_kernels):
    """Joins built on the open-addressing table, their fallbacks and the
    pages grouped through the insert: the same deltas in both packages.
    Both run the passthrough scan (no re-batching), so the same pages
    reach the same builders."""
    props = {"hash_kernels": hash_kernels, "scan_pipeline": False, **UNFUSED}
    ref_before = {k: REF_METRICS.counter_value(k) for k in COUNTERS}
    want_rows = _ref_rows(3, props)
    ref_delta = {k: REF_METRICS.counter_value(k) - ref_before[k] for k in COUNTERS}
    before = {k: METRICS.counter_value(k) for k in COUNTERS}
    got_rows = _port_rows(3, props)
    delta = {k: METRICS.counter_value(k) - before[k] for k in COUNTERS}
    assert_same_rows(got_rows, want_rows)
    assert delta == ref_delta
    if hash_kernels == "pallas":  # both builds and the grouping on the table
        assert delta["pallas.join_builds"] == 2 and delta["pallas.join_fallbacks"] == 0
        assert delta["pallas.agg_pages"] > 0


@pytest.fixture(scope="module")
def oracle():
    o = SqliteOracle()
    o.load_tpch(0.01, ["customer", "orders", "lineitem"])
    return o


@pytest.mark.parametrize("q", [3, 6])
def test_rows_match_sqlite_oracle(oracle, q):
    import datetime

    got = _port_rows(q, {"hash_kernels": "pallas"})
    epoch = datetime.date(1970, 1, 1)
    norm = [[(v - epoch).days if isinstance(v, datetime.date) else v for v in r] for r in got]
    assert_rows_equal(norm, oracle.query(to_sqlite(QUERIES[q])), ordered=True)


@pytest.mark.parametrize("q", sorted(QUERIES))
def test_explain_matches_reference(q):
    want = RefRunner().explain(REF_QUERIES[q])
    assert LocalQueryRunner(device="cpu").explain(QUERIES[q]) == want


@pytest.mark.parametrize("q", [2, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18,
                               19, 20, 21, 22])
def test_other_tpch_queries_match_reference_or_refuse(q):
    """Beyond Q1/Q3/Q6 the port runs a query only where every node, join
    shape and function is ported; otherwise it raises, never answering
    wrongly."""
    try:
        got = _port_rows(q, {"hash_kernels": "pallas"})
    except NotImplementedError as e:
        assert "not ported" in str(e), e
        return
    assert_same_rows(got, _ref_rows(q, {"hash_kernels": "pallas"}))


SHAPES = {
    # groups ~ rows on the first page: the builder defers raw rows to the fold
    "deferred_grouping": "select o_orderkey, count(*), avg(o_totalprice) from orders "
                         "group by o_orderkey order by o_orderkey desc limit 30",
    "grouping": "select o_custkey, count(*), sum(o_totalprice), avg(o_totalprice) "
                "from orders group by o_custkey order by o_custkey",
    # a dictionary key: the direct builder, then ORDER BY ... DESC
    "direct_order_by": "select o_orderpriority, count(*) from orders "
                       "group by o_orderpriority order by o_orderpriority desc",
    "limit": "select n_name, n_regionkey from nation limit 7",
    # a LEFT join on a filtered unique build: unmatched rows get NULLs
    "left_join": "select o_orderkey, o_custkey, c_nationkey from orders left join customer "
                 "on o_custkey = c_custkey and c_mktsegment = 'BUILDING' "
                 "order by o_orderkey limit 20",
}


@pytest.mark.parametrize("hash_kernels", ["sorted", "pallas"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_sql_shapes_match_reference(shape, hash_kernels):
    props = {"hash_kernels": hash_kernels}
    want = RefRunner(RefSession(catalog="tpch", schema="tiny", properties=props)) \
        .execute(SHAPES[shape]).rows
    got = LocalQueryRunner(Session(catalog="tpch", schema="tiny", properties=props),
                           device="cpu").execute(SHAPES[shape]).rows
    assert got
    assert_same_rows(got, want)


@pytest.mark.parametrize("stmt", ["show schemas", "show tables", "show columns from orders"])
def test_show_statements_match_reference(stmt):
    want = RefRunner().execute(stmt)
    got = LocalQueryRunner(device="cpu").execute(stmt)
    assert got.rows == want.rows and got.column_names == want.column_names


@pytest.mark.parametrize("prop,value", [("exchange_spool_megabytes", 1),
                                        ("query_retries", 3)])
def test_unported_session_property_raises_naming_itself(prop, value):
    """Since the port has the cluster's keys, the two packages' keys are the
    same, so a key outside them stands for one the port lacks."""
    session = Session(catalog="tpch", schema="tiny", properties={prop: value})
    with pytest.raises(NotImplementedError, match=prop):
        LocalQueryRunner(session, device="cpu").execute(QUERIES[6])


@pytest.mark.parametrize("prop,value", [("exchange_spool_bytes", 1 << 20),
                                        ("query_retry_attempts", 3)])
def test_cluster_properties_run_locally(prop, value):
    """The cluster's keys run on the local runner, which reads none of them,
    with the reference's rows, as in the reference."""
    session = Session(catalog="tpch", schema="tiny", properties={prop: value})
    got = LocalQueryRunner(session, device="cpu").execute(QUERIES[6]).rows
    assert_same_rows(got, _ref_rows(6, {prop: value}))


@pytest.mark.parametrize("prop,value", [
    ("query_trace", True), ("query_blackbox", False), ("spill_to_disk", False),
    ("spill_dir", ""), ("spill_max_bytes", 1 << 30)])
def test_recorder_and_disk_spill_properties_are_honoured(prop, value):
    """The flight recorder's and the disk rung's keys run instead of
    raising, with the reference's rows."""
    session = Session(catalog="tpch", schema="tiny", properties={prop: value})
    got = LocalQueryRunner(session, device="cpu").execute(QUERIES[6]).rows
    assert_same_rows(got, _ref_rows(6, {prop: value}))


# each feature of the default path, off and on; on the CPU, AUTO drivers
# would give 1, so the parallel drivers are forced on with a count
FEATURES_OFF = {**UNFUSED, "scan_pipeline": False, "driver_parallelism": 1}
FEATURES_ON = {"segment_fusion": True, "coalesce_pages": True, "scan_pipeline": True,
               "driver_parallelism": 4}


@pytest.mark.parametrize("prop", sorted(FEATURES_ON))
def test_ported_feature_turned_on_alone_matches_reference(prop):
    """Each feature of the default path on, the others off: Q3's rows
    equal the reference's under the same properties."""
    props = {**FEATURES_OFF, prop: FEATURES_ON[prop], "hash_kernels": "pallas"}
    assert_same_rows(_port_rows(3, props), _ref_rows(3, props))


def test_defaults_equal_the_reference_on_shared_keys():
    shared = set(Session.DEFAULTS) & set(RefSession.DEFAULTS)
    assert {"scan_pipeline", "driver_parallelism", "task_concurrency", "shared_pools",
            "segment_fusion", "coalesce_pages", "grouped_execution"} <= shared
    assert {k: Session.DEFAULTS[k] for k in shared} == \
        {k: RefSession.DEFAULTS[k] for k in shared}
    # the default path runs rather than raises
    assert LocalQueryRunner(Session(catalog="tpch", schema="tiny"),
                            device="cpu").execute(QUERIES[6]).rows


def test_default_page_capacity_keys_on_the_device():
    assert default_page_capacity("cuda") == 1 << 22
    assert default_page_capacity("cpu") == 1 << 18


def test_runner_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LocalQueryRunner()
    assert LocalQueryRunner(device="cpu").execute(QUERIES[6]).rows
