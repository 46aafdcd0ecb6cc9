"""Local exchange, parallel drivers and the threaded executor of the port.

The reference's ``tests/test_local_exchange.py`` cases against the port,
with ``driver_parallelism=4`` forced on the CPU (AUTO gives one driver
there): the buffer's flow and completion, rows equal to the single-driver
run, the parallel build equal to the sequential one, and the pipeline cuts
and driver counts equal to the reference's plan. Q3, Q5, Q9 and Q18 equal
the reference's rows under both packages' full defaults. The executor's
own contract: the first error propagates, and drivers that can never
unblock stop the run instead of hanging it. Every executor run here is
joined with a timeout, so a deadlock fails instead of hanging.
"""
import threading

import numpy as np
import pytest
import torch

from presto_tpu.exec.local_planner import LocalExecutionPlanner as RefPlanner
from presto_tpu.metadata import Session as RefSession
from presto_tpu.models.tpch_sql import QUERIES as REF_QUERIES
from presto_tpu.runner import LocalQueryRunner as RefRunner
from presto_tpu_torch.block import page_from_arrays
from presto_tpu_torch.exec.driver import Driver
from presto_tpu_torch.exec.local_planner import LocalExecutionPlanner
from presto_tpu_torch.exec.task_executor import TaskExecutor
from presto_tpu_torch.metadata import Session
from presto_tpu_torch.models.tpch_sql import QUERIES
from presto_tpu_torch.ops.hash_join import (FULL, JoinBuildOperatorFactory,
                                            LookupJoinOperatorFactory, LookupSourceFactory)
from presto_tpu_torch.ops.local_exchange import (LocalExchangeFactory, LocalExchangeSinkFactory,
                                                 LocalExchangeSourceFactory)
from presto_tpu_torch.ops.operator import Operator, OperatorContext
from presto_tpu_torch.runner import LocalQueryRunner
from presto_tpu_torch.types import BIGINT
from test_torch_sql import assert_same_rows

DEADLOCK_S = 60.0
QUERY_SET = (3, 5, 9, 18)
# plans only: every query of CASE, division, min/max, scalar subqueries and
# filtered semi joins as well
CUT_QUERIES = QUERY_SET + (2, 8, 11, 12, 14, 15, 17, 21, 22)


def _page(vals):
    return page_from_arrays([BIGINT], [np.asarray(vals, dtype=np.int64)], device="cpu")


def _port(sql, **props):
    return LocalQueryRunner(Session(catalog="tpch", schema="tiny", properties=props),
                            device="cpu").execute(sql)


def _within(fn, timeout_s: float = DEADLOCK_S):
    """Run ``fn()`` in a helper thread joined with a timeout: a deadlock
    fails the test instead of hanging the run."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # noqa: BLE001 - re-raised in the test
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout_s)
    assert not t.is_alive(), "no end within the timeout: deadlock"
    if "error" in out:
        raise out["error"]
    return out.get("value")


# ------------------------------------------------------------ the buffer

def test_buffer_pages_flow_and_complete():
    lx = LocalExchangeFactory(n_producers=2)
    sink_fac = LocalExchangeSinkFactory(0, lx, [BIGINT])
    src_fac = LocalExchangeSourceFactory(1, lx, [BIGINT])
    s1, s2 = sink_fac.create_operator(), sink_fac.create_operator()
    src = src_fac.create_operator()
    assert src.is_blocked() is not None  # nothing yet, producers open
    s1.add_input(_page([1, 2]))
    assert src.is_blocked() is None
    assert src.get_output() is not None
    assert not src.is_finished()
    s1.finish()
    assert not src.is_finished()         # s2 still open
    s2.add_input(_page([3]))
    s2.finish()
    assert src.get_output() is not None
    assert src.is_finished()


def test_bounded_buffer_blocks_the_producer_until_drained():
    lx = LocalExchangeFactory(n_producers=1, max_pages=2)
    sink = LocalExchangeSinkFactory(0, lx, [BIGINT]).create_operator()
    src = LocalExchangeSourceFactory(1, lx, [BIGINT]).create_operator()
    sink.add_input(_page([1]))
    sink.add_input(_page([2]))
    assert sink.is_blocked() is not None and not sink.needs_input()
    assert src.get_output() is not None
    assert sink.is_blocked() is None and sink.needs_input()


def test_abandoned_producer_poisons_the_buffer():
    lx = LocalExchangeFactory(n_producers=2)
    sinks = [LocalExchangeSinkFactory(0, lx, [BIGINT]).create_operator() for _ in range(2)]
    src = LocalExchangeSourceFactory(1, lx, [BIGINT]).create_operator()
    sinks[0].finish()
    sinks[0].close()   # a finished producer closes cleanly
    sinks[1].close()   # closed before it finished: its query failed
    assert src.is_blocked() is None and not src.is_finished()
    with pytest.raises(RuntimeError, match="poisoned"):
        src.get_output()


# ------------------------------------------------------------ the executor

class _Source(Operator):
    """Emits ``pages`` pages, then finishes; raises at page ``fail_at``."""

    def __init__(self, pages: int, fail_at=None):
        super().__init__(OperatorContext(0, "Source"))
        self.left, self.fail_at, self.sent = pages, fail_at, 0
        self.closed = False

    @property
    def output_types(self):
        return [BIGINT]

    def needs_input(self):
        return False

    def add_input(self, page):
        raise RuntimeError("no input")

    def get_output(self):
        if self.sent == self.fail_at:
            raise ValueError("source failed")
        if self.left == 0:
            self.finish()
            return None
        self.left -= 1
        self.sent += 1
        return _page([self.sent])

    def close(self):
        self.closed = True


class _Collect(Operator):
    def __init__(self):
        super().__init__(OperatorContext(1, "Collect"))
        self.pages = []

    @property
    def output_types(self):
        return [BIGINT]

    def add_input(self, page):
        self.pages.append(page)

    def get_output(self):
        return None


class _WaitFor(Operator):
    """A source blocked until ``ready()``."""

    def __init__(self, ready):
        super().__init__(OperatorContext(2, "WaitFor"))
        self._ready = ready

    @property
    def output_types(self):
        return []

    def needs_input(self):
        return False

    def add_input(self, page):
        raise RuntimeError("no input")

    def is_blocked(self):
        return None if self._ready() else self._ready

    def get_output(self):
        self.finish()
        return None


@pytest.mark.parametrize("threads", [1, 4])
def test_executor_runs_every_driver_and_time_slices(threads):
    sinks = [_Collect() for _ in range(6)]
    drivers = [Driver([_Source(20), s]) for s in sinks]
    _within(lambda: TaskExecutor(threads, quantum_ns=1).execute(drivers))
    assert [len(s.pages) for s in sinks] == [20] * 6


def test_executor_raises_the_first_error_after_every_runner_left():
    bad = _Source(10, fail_at=3)
    drivers = [Driver([_Source(50), _Collect()]) for _ in range(3)] + \
        [Driver([bad, _Collect()])]
    with pytest.raises(ValueError, match="source failed"):
        _within(lambda: TaskExecutor(4).execute(drivers))


@pytest.mark.parametrize("threads", [1, 4])
def test_executor_stops_when_no_parked_driver_can_move(threads):
    lf = LookupSourceFactory()  # never set: the probe waits forever
    drivers = [Driver([_WaitFor(lf.done), _Collect()]) for _ in range(2)]
    with pytest.raises(RuntimeError, match="blocked with no runnable driver"):
        _within(lambda: TaskExecutor(threads).execute(drivers))


def test_executor_unparks_a_driver_when_its_build_publishes():
    lf = LookupSourceFactory()
    sink = _Collect()

    class _Publish(_Source):
        def get_output(self):
            out = super().get_output()
            if self.left == 0 and not lf.done():
                lf.set(object())
            return out

    drivers = [Driver([_WaitFor(lf.done), _Collect()]), Driver([_Publish(5), sink])]
    _within(lambda: TaskExecutor(4).execute(drivers))
    assert len(sink.pages) == 5


# ------------------------------------------------- parallel drivers, SQL

def _plan_view(pipelines):
    return [([f.name for f in p], getattr(p[0], "parallel_drivers", 1)) for p in pipelines]


@pytest.mark.parametrize("q", CUT_QUERIES)
def test_pipeline_cuts_and_driver_counts_match_reference(q):
    props = {"driver_parallelism": 4, "hash_kernels": "pallas"}
    rr = RefRunner(RefSession(catalog="tpch", schema="tiny", properties=props))
    want = RefPlanner(rr.metadata, rr.session).plan(rr.plan_sql(REF_QUERIES[q]))
    pr = LocalQueryRunner(Session(catalog="tpch", schema="tiny", properties=props),
                          device="cpu")
    got = LocalExecutionPlanner(pr.metadata, pr.session, "cpu").plan(pr.plan_sql(QUERIES[q]))
    assert _plan_view(got.pipelines) == _plan_view(want.pipelines)
    assert max(getattr(p[0], "parallel_drivers", 1) for p in got.pipelines) == 4
    assert len(got.create_drivers()) == \
        sum(getattr(p[0], "parallel_drivers", 1) for p in got.pipelines)


def test_auto_drivers_follow_the_device():
    pr = LocalQueryRunner(Session(catalog="tpch", schema="tiny"), device="cpu")
    assert LocalExecutionPlanner(pr.metadata, pr.session, "cpu").driver_count() == 1
    planner = LocalExecutionPlanner(pr.metadata, pr.session, "cpu")
    planner.device = torch.device("cuda")  # the rule only reads the device
    assert planner.driver_count() == Session.DEFAULTS["task_concurrency"] == 4


@pytest.fixture(scope="module")
def ref_default_rows():
    cache = {}

    def get(q):
        if q not in cache:
            cache[q] = RefRunner(RefSession(catalog="tpch", schema="tiny")) \
                .execute(REF_QUERIES[q]).rows
        return cache[q]
    return get


@pytest.mark.parametrize("props", [{}, {"driver_parallelism": 4},
                                   {"driver_parallelism": 4, "hash_kernels": "pallas"}],
                         ids=["defaults", "drivers4", "drivers4_pallas"])
@pytest.mark.parametrize("q", QUERY_SET)
def test_rows_match_reference_defaults(ref_default_rows, q, props):
    res = _within(lambda: _port(QUERIES[q], **props))
    assert res.rows
    assert_same_rows(res.rows, ref_default_rows(q))


def test_parallel_scan_results_match_single_driver():
    sql = ("select l_returnflag, count(*), sum(l_extendedprice) "
           "from lineitem group by 1 order by 1")
    one = _port(sql, driver_parallelism=1)
    four = _within(lambda: _port(sql, driver_parallelism=4))
    assert four.drivers[0] == 4 and one.drivers == [1]
    assert_same_rows(four.rows, one.rows)


def test_parallel_build_drivers_match_sequential():
    sql = ("select o_orderpriority, count(*) c, sum(l_quantity) q "
           "from orders join lineitem on o_orderkey = l_orderkey "
           "where o_orderdate < date '1996-01-01' "
           "group by o_orderpriority order by o_orderpriority")
    for kernels in ("sorted", "pallas"):
        seq = _port(sql, driver_parallelism=1, hash_kernels=kernels)
        par = _within(lambda: _port(sql, driver_parallelism=4, hash_kernels=kernels))
        assert par.rows == seq.rows


def test_parallel_build_uses_multiple_drivers():
    r = LocalQueryRunner(Session(catalog="tpch", schema="tiny",
                                 properties={"driver_parallelism": 4}), device="cpu")
    plan = r.plan_sql("select count(*) from orders join lineitem on o_orderkey = l_orderkey")
    ep = LocalExecutionPlanner(r.metadata, r.session, "cpu").plan(plan)
    builds = [p for p in ep.pipelines if isinstance(p[-1], JoinBuildOperatorFactory)]
    assert builds and any(getattr(p[0], "parallel_drivers", 1) > 1 for p in builds)
    ep.create_drivers()
    fac = next(p[-1] for p in builds if getattr(p[0], "parallel_drivers", 1) > 1)
    assert len(fac._created[0]) > 1  # several build operators, one lookup source


def test_full_join_probe_stays_single_driver():
    """FULL probes emit unmatched build rows at finish, exactly once: the
    rule keeps such a probe out of the producers (no FULL join is planned
    by the port yet, so the factories are built by hand)."""
    pr = LocalQueryRunner(Session(catalog="tpch", schema="tiny",
                                  properties={"driver_parallelism": 4}), device="cpu")
    planner = LocalExecutionPlanner(pr.metadata, pr.session, "cpu")
    chain = planner.visit(pr.plan_sql("select o_orderkey from orders").source)
    scan = chain.factories[0]
    assert scan.sources_per_worker == 8
    probe = LookupJoinOperatorFactory(90, LookupSourceFactory(), [0], [0], [(BIGINT, None)],
                                      [], [], FULL)
    consumer = LookupJoinOperatorFactory(91, LookupSourceFactory(), [0], [0],
                                         [(BIGINT, None)], [], [], "inner")
    planner._add_pipeline([scan, probe, consumer])
    assert _plan_view(planner.pipelines) == [
        (["TableScan", "LocalExchangeSink"], 4),
        (["LocalExchangeSource", "LookupJoin(full)", "LookupJoin(inner)"], 1)]


def test_launch_counts_survive_contention():
    """The kernel wrappers' launch counts are read-modify-writes shared by
    every driver thread: under a short switch interval and more threads
    than cores, no increment is lost, and each thread's own tally (what a
    fused segment reads) counts only its launches."""
    import os
    import sys

    from presto_tpu_torch.ops import pallas_hash as ph

    n_threads, per = 2 * (os.cpu_count() or 4), 2000
    before = ph.probe_table.launches
    tallies = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            start = ph.thread_launches(ph.probe_table)
            for _ in range(per):
                ph._count_launch(ph.probe_table)
            tallies.append(ph.thread_launches(ph.probe_table) - start)

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(DEADLOCK_S)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        launched = ph.probe_table.launches - before
        ph.probe_table.launches = before
    assert launched == n_threads * per
    assert tallies == [per] * n_threads


def test_parallel_build_merges_every_driver_under_contention():
    """Build operators of one factory finishing at once on many threads:
    exactly one lookup source is published, and it holds every driver's
    rows."""
    import sys

    fac = JoinBuildOperatorFactory(0, [0], [], [], device="cpu")
    ops = [fac.create_operator() for _ in range(12)]
    for i, op in enumerate(ops):
        op.add_input(_page(list(range(i * 10, i * 10 + 10))))
    published = []
    set_source = fac.lookup_factory.set
    fac.lookup_factory.set = lambda src, w=0: (published.append(src), set_source(src, w))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=op.finish) for op in ops]
        for t in threads:
            t.start()
        for t in threads:
            t.join(DEADLOCK_S)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert len(published) == 1 and fac.lookup_factory.done()
    src = fac.lookup_factory.get()
    assert sorted(src.key_arrays[0].tolist()) == list(range(120))
