"""Memory accounting and revocation of the port against the reference's,
on the CPU at ``tiny``.

The local cases of ``tests/test_spill.py`` run through both packages and
the reference's sqlite oracle. Under a one-byte pool every accounting
update is over the revoke target, so a join build moves its pages to host
RAM, a grouping spills its folds and a window offloads its pages; the rows
must not change. The port's ladder stops at host RAM, so the reference runs
with ``spill_to_disk`` off: the two then revoke the same operators the same
number of times (the ``memory.spill`` journal). The memory limit raises the
same exception in both and leaves the shared pool empty, and each
operator's accounted peak (from capacities and dtypes) equals the
reference's under an explicit ``page_capacity``.
"""
import collections

import pytest

from presto_tpu.exec.explain import driver_stats as ref_driver_stats
from presto_tpu.memory import ExceededMemoryLimitException as RefExceeded
from presto_tpu.memory import shared_general_pool as ref_pool
from presto_tpu.metadata import Session as RefSession
from presto_tpu.models.tpch_sql import QUERIES as REF_QUERIES
from presto_tpu.runner import LocalQueryRunner as RefRunner
from presto_tpu.utils import events as ref_events
from presto_tpu.utils.metrics import METRICS as REF_METRICS
from presto_tpu.utils.testing import SqliteOracle, assert_rows_equal
from presto_tpu_torch.exec.explain import driver_stats
from presto_tpu_torch.memory import (ExceededMemoryLimitException, MemoryPool,
                                     MemoryRevoker, shared_general_pool)
from presto_tpu_torch.metadata import Session
from presto_tpu_torch.models.tpch_sql import QUERIES
from presto_tpu_torch.runner import LocalQueryRunner
from presto_tpu_torch.utils import events
from presto_tpu_torch.utils.metrics import METRICS
from test_torch_sql import assert_same_rows

PRESSURE = {"memory_pool_bytes": 1, "page_capacity": 1 << 10}
JOIN_AGG_SQL = ("select n_name, count(*) from customer "
                "join nation on c_nationkey = n_nationkey group by n_name")
WINDOW_SQL = ("select o_orderpriority, count(*), sum(rn), max(rk) from (select "
              "o_orderpriority, row_number() over (partition by o_orderpriority "
              "order by o_orderkey) rn, rank() over (partition by o_custkey order by "
              "o_totalprice desc) rk from orders) t group by 1 order by 1")
PALLAS_COUNTERS = ("pallas.join_builds", "pallas.join_fallbacks", "pallas.agg_pages",
                   "pallas.agg_fallbacks")


@pytest.fixture(scope="module")
def oracle():
    o = SqliteOracle()
    o.load_tpch(0.01, ["orders", "customer", "nation"])
    return o


def _port(props):
    return LocalQueryRunner(Session(catalog="tpch", schema="tiny", properties=dict(props)),
                            device="cpu")


def _ref(props):
    # the reference's ladder goes on to disk by default; the port's stops at
    # host RAM, so the reference is held at that rung
    return RefRunner(RefSession(catalog="tpch", schema="tiny",
                                properties={**props, "spill_to_disk": False}))


def _spills(journal) -> dict:
    return dict(collections.Counter(e["operator"] for e in journal.events(kind="memory.spill")))


def _run_both(sql_port, sql_ref, props):
    """-> (port rows, reference rows, port spills, reference spills)."""
    events.JOURNAL.clear()
    ref_events.JOURNAL.clear()
    want = _ref(props).execute(sql_ref).rows
    got = _port(props).execute(sql_port).rows
    return got, want, _spills(events.JOURNAL), _spills(ref_events.JOURNAL)


def test_agg_overflow_spills_and_completes(oracle):
    """max_groups far below the ~1,000 customers: every fold spills to host
    RAM and the merge at finish is exact."""
    props = {"max_groups": 64, "page_capacity": 1 << 10}
    sql = ("select o_custkey, count(*), sum(o_totalprice), max(o_orderdate) "
           "from orders group by o_custkey")
    got = _port(props).execute(sql).rows
    assert len(got) > 64
    assert_same_rows(sorted(got), sorted(_ref(props).execute(sql).rows))
    assert_rows_equal(got, oracle.query(sql))


@pytest.mark.parametrize("drivers", [1, 4])
def test_pressure_revoke_spills_join_build_and_agg(oracle, drivers):
    """A one-byte pool: the join build offloads its pages on every input
    page; the rows equal the reference's and the oracle's, and the same
    operators revoked as often. Under 4 drivers every build driver revokes
    and the last one to finish re-admits its siblings' host pages."""
    props = {**PRESSURE, "driver_parallelism": drivers}
    got, want, spills, ref_spills = _run_both(JOIN_AGG_SQL, JOIN_AGG_SQL, props)
    assert_same_rows(sorted(got), sorted(want))
    assert_rows_equal(got, oracle.query(JOIN_AGG_SQL))
    assert spills == ref_spills and spills.get("JoinBuild", 0) > 0
    assert shared_general_pool().by_query() == {}


FULL_NULL_KEYS_SQL = (
    "select count(*), count(k), count(o_orderkey), sum(o_totalprice) from (select "
    "case when c_custkey % 7 = 0 then null else c_custkey end k from customer) c "
    "full join orders on k = o_custkey")
PRESSURED = {"q3": (QUERIES[3], REF_QUERIES[3]), "q18": (QUERIES[18], REF_QUERIES[18]),
             "full join null keys": (FULL_NULL_KEYS_SQL, FULL_NULL_KEYS_SQL)}


@pytest.mark.parametrize("case", sorted(PRESSURED))
def test_pressured_query_revokes_like_the_reference(case):
    """Q3 (two builds and a grouping in a fused segment), Q18 (a grouping
    above a semi join) and a FULL join whose build has NULL keys (its
    NULL-key pages revoked beside the others): rows and revocations
    equal."""
    got, want, spills, ref_spills = _run_both(*PRESSURED[case],
                                              {**PRESSURE, "driver_parallelism": 1})
    assert_same_rows(got, want)
    assert spills == ref_spills and sum(spills.values()) > 0


def test_pressured_pallas_build_matches_reference():
    """``hash_kernels="pallas"`` under pressure: the revoked build pages come
    back before the insert, so the builds still take the table, and the
    rows and ``pallas.`` counters equal the reference's."""
    props = {**PRESSURE, "hash_kernels": "pallas", "driver_parallelism": 1}
    before = {k: METRICS.counter_value(k) for k in PALLAS_COUNTERS}
    ref_before = {k: REF_METRICS.counter_value(k) for k in PALLAS_COUNTERS}
    revoked = METRICS.counter_value("memory.revoked_bytes")
    got, want, spills, ref_spills = _run_both(QUERIES[3], REF_QUERIES[3], props)
    delta = {k: METRICS.counter_value(k) - before[k] for k in PALLAS_COUNTERS}
    ref_delta = {k: REF_METRICS.counter_value(k) - ref_before[k] for k in PALLAS_COUNTERS}
    assert_same_rows(got, want)
    assert delta == ref_delta and delta["pallas.join_builds"] == 2
    assert delta["pallas.join_fallbacks"] == 0
    assert spills == ref_spills and spills["JoinBuild"] > 0
    assert METRICS.counter_value("memory.revoked_bytes") > revoked


def test_pressured_window_matches_reference():
    got, want, spills, ref_spills = _run_both(WINDOW_SQL, WINDOW_SQL,
                                              {**PRESSURE, "driver_parallelism": 1})
    assert_same_rows(got, want)
    assert spills == ref_spills and spills.get("Window", 0) > 0


def test_memory_limit_raises_and_leaves_the_pool_empty():
    """A ``query_max_memory_bytes`` below the scan's prefetch: the same
    exception and message in both packages, ``query.memory_exceeded``
    journaled, and no reservation left in either shared pool. Both resident
    caches are cleared first: replayed pages are staged by no scan, so they
    hold no user memory."""
    from presto_tpu.ops.scan import RESIDENT_CACHE as REF_RESIDENT_CACHE
    from presto_tpu_torch.ops.scan import RESIDENT_CACHE

    props = {"query_max_memory_bytes": 1000}
    events.JOURNAL.clear()
    RESIDENT_CACHE.clear()
    REF_RESIDENT_CACHE.clear()
    with pytest.raises(RefExceeded) as want:
        _ref(props).execute(REF_QUERIES[3])
    with pytest.raises(ExceededMemoryLimitException) as got:
        _port(props).execute(QUERIES[3])
    assert str(got.value) == str(want.value)
    evts = events.JOURNAL.events(kind="query.memory_exceeded")
    assert evts and evts[0]["limit_bytes"] == 1000 and evts[0]["reserved_bytes"] > 1000
    assert shared_general_pool().by_query() == {} and ref_pool().by_query() == {}


def test_memory_is_accounted():
    """``tests/test_spill.py::test_memory_is_accounted``: driving the plan
    by hand under the query's memory, the grouping reports revocable
    bytes."""
    r = _port({})
    plan = r.plan_sql("select o_custkey, sum(o_totalprice) from orders group by o_custkey")
    from presto_tpu_torch.exec.local_planner import LocalExecutionPlanner

    lp = LocalExecutionPlanner(r.metadata, r.session, r.device)
    mem, check, release = r._query_memory()
    lp.attach_memory(mem, check)
    drivers = lp.plan(plan).create_drivers()
    peak = 0
    try:
        for d in drivers:
            while not d.is_finished():
                d.process(10_000_000)
                peak = max(peak, mem.revocable.get_bytes())
                if d.blocked_on() is not None:
                    break
    finally:
        for d in drivers:
            d.close()
        release()
    assert peak > 0, "aggregation never accounted revocable bytes"


def test_revoker_external_scheduler():
    """``tests/test_spill.py::test_revoker_external_scheduler``: the revoker
    asks the largest revocable first and journals ``memory.revoke``."""
    class FakeOp:
        def __init__(self, b):
            self.b = b
            self.revoked = False

        def revocable_bytes(self):
            return 0 if self.revoked else self.b

        def start_memory_revoke(self):
            self.revoked = True

    events.JOURNAL.clear()
    pool = MemoryPool("general", 100)
    pool.reserve("q", 150, revocable=True)
    rv = MemoryRevoker(pool)
    big, small = FakeOp(120), FakeOp(10)
    rv.register(small)
    rv.register(big)
    requested = rv.maybe_revoke()
    assert big.revoked and not small.revoked and requested >= 60
    evt = events.JOURNAL.events(kind="memory.revoke")[-1]
    assert evt["requested_bytes"] == requested and evt["pool_max_bytes"] == 100
    pool.clear_query("q")
    assert pool.by_query() == {} and MemoryRevoker(pool).maybe_revoke() == 0


PEAK_CASES = {"q3": QUERIES[3], "q9": QUERIES[9], "q13": QUERIES[13], "q18": QUERIES[18],
              "window": WINDOW_SQL}


@pytest.mark.parametrize("case,fused", [
    ("q3", True), ("q3", False), ("q9", True), ("q13", True), ("q18", True),
    ("window", True), ("window", False)])
def test_peak_accounted_bytes_per_operator_match_reference(case, fused):
    """Each operator's accounted peak, under ``page_capacity`` 4,096 and one
    driver, equals the reference's: fused (the grouping as a segment's
    terminal) and unfused with the ``pallas`` builds."""
    props = {"page_capacity": 1 << 12, "driver_parallelism": 1}
    if not fused:
        props.update(segment_fusion=False, coalesce_pages=False, hash_kernels="pallas")
    sql = PEAK_CASES[case]
    ref = _ref(props)
    _, ref_drivers, _ = ref._run_plan(ref.plan_sql(sql))
    port = _port(props)
    _, drivers, _ = port._run_plan(port.plan_sql(sql))
    want = [(s["name"], s["peak_memory_bytes"]) for s in ref_driver_stats(ref_drivers)]
    got = [(s["name"], s["peak_memory_bytes"]) for s in driver_stats(drivers)]
    assert got == want
    assert any(b > 0 for _, b in got)
