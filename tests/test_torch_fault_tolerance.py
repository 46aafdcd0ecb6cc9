"""The port's fault-tolerant cluster execution, on the CPU
(``tests/test_fault_tolerance.py`` less its fault-injector units, which
cover the port's copy of ``faults.py``; its forensic tests and the
memory-manager tests of ``tests/test_service_layer.py`` are in
``tests/test_torch_cluster_lifecycle.py``).

Every scenario drives a retry path deterministically through the
``cluster/faults.py`` harness — count-triggered injected faults, not
sleeps-and-hope: a worker killed mid-query, 5xx storms on task create,
injected task failures. Rows of retried queries are held against the
reference's ``LocalQueryRunner``, one shared run per query.
"""
import threading
import time

import pytest

from presto_tpu.runner import LocalQueryRunner as RefRunner
from presto_tpu_torch.cluster import faults
from presto_tpu_torch.cluster.coordinator import ClusterQueryRunner
from presto_tpu_torch.cluster.discovery import Announcer
from presto_tpu_torch.cluster.exchange_client import StreamingRemoteSource
from presto_tpu_torch.cluster.scheduler import _remote_source_ids
from presto_tpu_torch.cluster.worker import WorkerServer
from presto_tpu_torch.metadata import Session
from presto_tpu_torch.types import BIGINT
from presto_tpu_torch.utils.events import JOURNAL
from presto_tpu_torch.utils.metrics import METRICS
from test_torch_cluster import assert_same_rows

AGG_SQL = ("select l_returnflag, count(*), sum(l_quantity) "
           "from lineitem group by l_returnflag")
# many frames leaf -> interior, so a mid-stream kill lands with chunks
# delivered and acked while the root stream is untouched
HICARD_SQL = ("select l_orderkey, count(*), sum(l_quantity) "
              "from lineitem group by l_orderkey")


@pytest.fixture(autouse=True)
def _isolated_injector():
    faults.clear()
    yield
    faults.clear()


@pytest.fixture(scope="module")
def want():
    runner = RefRunner()
    cache = {}

    def rows(sql):
        if sql not in cache:
            cache[sql] = runner.execute(sql).rows
        return cache[sql]
    return rows


class _Cluster:
    """2-worker in-process cluster with controllable announcements."""

    def __init__(self, properties=None, min_workers=2, n_workers=2):
        session = Session(catalog="tpch", schema="tiny", properties=dict(properties or {}))
        self.runner = ClusterQueryRunner(session=session, min_workers=min_workers,
                                         worker_wait_s=10.0, device="cpu")
        self.workers = [WorkerServer(port=0, device="cpu").start() for _ in range(n_workers)]
        self.dead = set()
        self._stop = threading.Event()
        for w in self.workers:
            self.runner.nodes.announce(w.node_id, w.uri)
        self._thread = threading.Thread(target=self._keep_alive, daemon=True)
        self._thread.start()

    def _keep_alive(self):
        while not self._stop.wait(0.5):
            for w in self.workers:
                if w.node_id not in self.dead:
                    self.runner.nodes.announce(w.node_id, w.uri)
            for node_id in list(self.dead):
                self.runner.nodes.remove(node_id)

    def kill(self, worker):
        """Deterministic worker death: server down and discovery forgets it."""
        self.dead.add(worker.node_id)
        worker.stop()
        self.runner.nodes.remove(worker.node_id)

    def close(self):
        self._stop.set()
        self._thread.join(5.0)
        self.runner.detector.stop()
        for w in self.workers:
            if w.node_id not in self.dead:
                w.stop()
        # every task thread ends: none outlives its test
        for w in self.workers:
            w.join_tasks(30.0)


def _kill_rule(cluster, victim, after=0):
    """Kill `victim` on its (after+1)-th results request, then slam the
    connection that triggered it."""
    def kill(ctx):
        cluster.kill(victim)
        raise faults.InjectedDisconnect("worker killed")

    inj = faults.FaultInjector(seed=11)
    inj.add("worker.results", faults.CALLBACK, node_id=victim.node_id,
            after=after, times=1, callback=kill)
    faults.install(inj)
    return inj


def _leaf_fragment_id(cluster, sql):
    sub = cluster.runner.plan_sql(sql)
    return next(f.id for f in sub.fragments
                if not _remote_source_ids(f.root) and f.id != sub.root_fragment.id)


# ---------------------------------------------------------------------------
# announcer failure accounting, stream rewire
# ---------------------------------------------------------------------------

def test_announcer_warns_on_persistent_failure(capsys):
    ann = Announcer("http://127.0.0.1:1", "nodeZ", "http://127.0.0.1:2")
    assert ann._announce_failures == 0
    for _ in range(3):
        ann._announce_once()  # nothing listens on port 1
    assert ann._announce_failures == 3
    err = capsys.readouterr().err
    assert "nodeZ" in err and "(3x)" in err and "failing" in err
    assert err.count("failing") == 1


def test_streaming_source_rewire_preserves_mid_stream_cursor():
    src = StreamingRemoteSource(
        ["http://127.0.0.1:1/v1/task/a", "http://127.0.0.1:1/v1/task/b"],
        0, [BIGINT], [None], 1024)
    assert src.reset_location("http://127.0.0.1:1/v1/task/a", "http://127.0.0.1:1/v1/task/a2")
    assert src.clients[0].location == "http://127.0.0.1:1/v1/task/a2"
    src.clients[1].token = 3
    assert src.reset_location("http://127.0.0.1:1/v1/task/b", "http://127.0.0.1:1/v1/task/b2")
    assert src.clients[1].location == "http://127.0.0.1:1/v1/task/b2"
    assert src.clients[1].token == 3
    assert not src.reset_location("http://127.0.0.1:1/v1/task/zz",
                                  "http://127.0.0.1:1/v1/task/b3")


def test_finished_client_rewire_keeps_the_replacement_replayable():
    """A consumer that already read a whole stream, rewired to the
    producer's replacement, acks the replacement's frames through its
    cursor instead of releasing the buffer: a later replacement of that
    consumer (cursor 0) still replays the stream (a release would answer it
    with a 410, ``replay window lost``), and the stream counts as delivered
    once the replacement ends."""
    from types import SimpleNamespace

    from presto_tpu_torch.cluster.buffers import GATHER, OutputBuffer

    worker = WorkerServer(port=0, device="cpu").start()
    try:
        out = OutputBuffer(GATHER, 1)
        worker.tasks.tasks["q.0.0.r1"] = SimpleNamespace(output=out, instance_id="i1")
        for frame in (b"a", b"b", b"c"):  # the replacement re-produces three frames
            out.enqueue(0, frame)
        src = StreamingRemoteSource(["http://127.0.0.1:1/v1/task/q.0.0"], 0, [BIGINT],
                                    [None], 1024)
        client = src.clients[0]
        client.token, client.complete, client.done = 3, True, True
        assert src.reset_location("http://127.0.0.1:1/v1/task/q.0.0",
                                  f"{worker.uri}/v1/task/q.0.0.r1")
        assert out.retained_bytes() == 0  # acked: no backpressure on the replacement
        assert out.get(0, 0, wait_s=0) == (b"a", 1, False)  # a fresh cursor replays
        assert out.replayable(0) and not out.output_drained()
        out.set_no_more_pages()
        assert out.output_drained()
    finally:
        worker.tasks.tasks.clear()
        worker.stop()


# ---------------------------------------------------------------------------
# retry policies under injected faults
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["QUERY", "TASK"])
def test_retry_survives_worker_kill(want, policy):
    """A worker killed on its first results request: QUERY re-runs the
    query on the survivor; TASK recovers in place or, where that cannot
    help, re-runs it too."""
    cluster = _Cluster(properties={"retry_policy": policy, "retry_initial_delay_s": 0.02,
                                   "retry_max_delay_s": 0.1})
    victim = cluster.workers[0]
    inj = _kill_rule(cluster, victim)
    retries_before = METRICS.counter_value("cluster.query_retries")
    try:
        got = cluster.runner.execute(AGG_SQL)
    finally:
        cluster.close()
    assert inj.rules[0].fired == 1, "kill fault never triggered"
    assert_same_rows(got.rows, want(AGG_SQL), ordered=False)
    assert got.stats["retry_policy"] == policy
    assert got.stats["faults_injected"] >= 1
    if policy == "QUERY":
        assert got.stats["query_attempts"] >= 2
        assert METRICS.counter_value("cluster.query_retries") > retries_before
    else:
        assert got.stats["query_attempts"] + got.stats["task_retries"] >= 2


def test_none_policy_fails_fast_naming_dead_node():
    cluster = _Cluster()
    victim = cluster.workers[0]
    inj = _kill_rule(cluster, victim)
    try:
        with pytest.raises(Exception, match=victim.node_id):
            cluster.runner.execute(AGG_SQL)
    finally:
        cluster.close()
    assert inj.rules[0].fired == 1, "kill fault never triggered"


def test_task_policy_replaces_node_rejecting_creates(want):
    cluster = _Cluster(properties={"retry_policy": "TASK", "remote_task_error_budget_s": 0.0,
                                   "retry_initial_delay_s": 0.01, "retry_max_delay_s": 0.02})
    victim = cluster.workers[0]
    inj = faults.FaultInjector()
    inj.add("worker.task_create", faults.HTTP_ERROR, code=503, times=None,
            node_id=victim.node_id)
    faults.install(inj)
    try:
        got = cluster.runner.execute(AGG_SQL)
    finally:
        cluster.close()
    assert_same_rows(got.rows, want(AGG_SQL), ordered=False)
    assert got.stats["query_attempts"] == 1, "re-placement, not query retry"
    assert got.stats["task_retries"] >= 1
    assert inj.rules[0].fired >= 3


def test_draining_worker_503_excludes_node_without_burning_backoff(want):
    cluster = _Cluster(properties={"retry_policy": "TASK", "retry_initial_delay_s": 0.01,
                                   "retry_max_delay_s": 0.02})
    victim = cluster.workers[0]
    victim.begin_drain(reason="test")  # worker-side only: discovery still places on it
    assert victim.state == "DRAINED"
    try:
        got = cluster.runner.execute(AGG_SQL)
    finally:
        cluster.close()
    assert_same_rows(got.rows, want(AGG_SQL), ordered=False)
    assert got.stats["query_attempts"] == 1
    assert not victim.tasks.tasks


def test_create_backoff_budget_honored_then_fail_fast():
    cluster = _Cluster(properties={"remote_task_error_budget_s": 0.0,
                                   "retry_initial_delay_s": 0.01, "retry_max_delay_s": 0.02})
    inj = faults.FaultInjector()
    inj.add("worker.task_create", faults.HTTP_ERROR, code=503, times=None)
    faults.install(inj)
    try:
        with pytest.raises(RuntimeError, match="cannot create task"):
            cluster.runner.execute(AGG_SQL)
    finally:
        cluster.close()
    assert inj.rules[0].fired == 3


def test_task_policy_recovers_failed_leaf_task_in_place(want):
    cluster = _Cluster(properties={"retry_policy": "TASK", "retry_initial_delay_s": 0.01,
                                   "retry_max_delay_s": 0.02})
    leaf = _leaf_fragment_id(cluster, AGG_SQL)
    inj = faults.FaultInjector()
    inj.add("worker.task_run", faults.ERROR, times=1, task_re=rf"\.{leaf}\.0$")
    faults.install(inj)
    try:
        got = cluster.runner.execute(AGG_SQL)
    finally:
        cluster.close()
    assert inj.rules[0].fired == 1, "task fault never triggered"
    assert_same_rows(got.rows, want(AGG_SQL), ordered=False)
    assert got.stats["query_attempts"] == 1
    assert got.stats["task_retries"] >= 1


def test_in_place_recovery_is_bounded_then_escalates():
    cluster = _Cluster(properties={"retry_policy": "TASK", "query_retry_attempts": 0,
                                   "task_retry_attempts": 2, "retry_initial_delay_s": 0.01,
                                   "retry_max_delay_s": 0.02})
    leaf = _leaf_fragment_id(cluster, AGG_SQL)
    inj = faults.FaultInjector()
    inj.add("worker.task_run", faults.ERROR, times=None, task_re=rf"\.{leaf}\.0(\.r\d+)?$")
    faults.install(inj)
    try:
        with pytest.raises(RuntimeError, match="injected fault"):
            cluster.runner.execute(AGG_SQL)
    finally:
        cluster.close()
    assert inj.rules[0].fired == 3


def test_query_retry_gives_up_after_attempt_budget():
    cluster = _Cluster(properties={"retry_policy": "QUERY", "query_retry_attempts": 1,
                                   "remote_task_error_budget_s": 0.0,
                                   "retry_initial_delay_s": 0.01, "retry_max_delay_s": 0.02})
    inj = faults.FaultInjector()
    inj.add("worker.task_create", faults.HTTP_ERROR, code=503, times=None)
    faults.install(inj)
    try:
        with pytest.raises(RuntimeError, match="cannot create task"):
            cluster.runner.execute(AGG_SQL)
    finally:
        cluster.close()
    assert inj.rules[0].fired == 6


def test_deterministic_query_error_is_not_retried():
    cluster = _Cluster(properties={"retry_policy": "QUERY"})
    try:
        cluster.runner.local.execute(
            "create table memory.default.coord_only2 as select 1 as x")
        with pytest.raises(Exception, match="(?i)task .* failed"):
            cluster.runner.execute("select count(*) from memory.default.coord_only2")
    finally:
        cluster.close()


# ---------------------------------------------------------------------------
# the chaos matrix: mid-stream replay, speculation, spool overflow, tenants
# ---------------------------------------------------------------------------

def test_task_policy_replays_spooled_chunks_after_mid_stream_kill(want):
    """A worker killed after its leaf task delivered (and consumers acked)
    chunks is recovered in place: every consumer re-issues GETs from its
    cursor, and the query finishes on attempt 1 with the reference's rows."""
    cluster = _Cluster(properties={"retry_policy": "TASK", "exchange_flush_rows": 512,
                                   "retry_initial_delay_s": 0.01,
                                   "retry_max_delay_s": 0.05})
    leaf = _leaf_fragment_id(cluster, HICARD_SQL)
    victim = min(cluster.workers, key=lambda w: w.node_id)
    killed = threading.Event()

    def kill(ctx):
        token = int(ctx["path"].partition("?")[0].rstrip("/").rsplit("/", 1)[-1])
        if token < 1 or killed.is_set():
            return
        killed.set()
        cluster.kill(victim)
        raise faults.InjectedDisconnect("worker killed")

    inj = faults.FaultInjector(seed=11)
    inj.add("worker.results", faults.CALLBACK, node_id=victim.node_id,
            task_re=rf"\.{leaf}\.0$", times=None, callback=kill)
    faults.install(inj)
    seq0 = JOURNAL.last_seq()
    try:
        got = cluster.runner.execute(HICARD_SQL)
    finally:
        cluster.close()
    assert killed.is_set(), "mid-stream kill never triggered"
    assert_same_rows(got.rows, want(HICARD_SQL), ordered=False)
    assert got.stats["query_attempts"] == 1
    assert got.stats["task_retries"] >= 1
    kinds = {e["kind"] for e in JOURNAL.events(since=seq0)}
    assert "task.retry" in kinds and "query.retry" not in kinds
    assert any(e.get("retry_kind") == "in-place-recovery"
               for e in JOURNAL.events(since=seq0, kind="task.retry"))


def test_recovery_re_places_when_its_node_begins_draining(want):
    """The node an in-place recovery picked begins draining before the
    replacement's create reaches it (a planned drain starting under the
    recovery): the create is refused with 503, the replacement goes to the
    next node, and the query still runs once."""
    cluster = _Cluster(properties={"retry_policy": "TASK", "exchange_flush_rows": 512,
                                   "retry_initial_delay_s": 0.01,
                                   "retry_max_delay_s": 0.05}, min_workers=3, n_workers=3)
    leaf = _leaf_fragment_id(cluster, HICARD_SQL)
    victim = min(cluster.workers, key=lambda w: w.node_id)
    killed = threading.Event()
    drained = []

    def kill(ctx):
        token = int(ctx["path"].partition("?")[0].rstrip("/").rsplit("/", 1)[-1])
        if token < 1 or killed.is_set():
            return
        killed.set()
        cluster.kill(victim)
        raise faults.InjectedDisconnect("worker killed")

    def drain(ctx):
        # the drain's onset, as coordinator.drain_worker makes it
        drained.append(ctx["node_id"])
        cluster.runner.nodes.set_draining(ctx["node_id"], True)
        next(w for w in cluster.workers if w.node_id == ctx["node_id"]).begin_drain("test")

    inj = faults.FaultInjector(seed=11)
    inj.add("worker.results", faults.CALLBACK, node_id=victim.node_id,
            task_re=rf"\.{leaf}\.0$", times=None, callback=kill)
    inj.add("client.task_create", faults.CALLBACK, task_re=r"\.r1$", times=1, callback=drain)
    faults.install(inj)
    try:
        got = cluster.runner.execute(HICARD_SQL)
    finally:
        cluster.close()
    assert killed.is_set() and len(drained) == 1
    assert_same_rows(got.rows, want(HICARD_SQL), ordered=False)
    assert got.stats["query_attempts"] == 1
    assert got.stats["task_retries"] >= 1


def test_drains_move_a_task_past_its_failure_budget(want):
    """A drain's handoff spends none of a task's failure budget
    (``task_retry_attempts``, 2): three drains in a row each move the
    live leaf task, and the query runs once."""
    cluster = _Cluster(properties={"retry_policy": "TASK", "exchange_flush_rows": 512,
                                   "retry_initial_delay_s": 0.01,
                                   "retry_max_delay_s": 0.05}, min_workers=4, n_workers=4)
    leaf = _leaf_fragment_id(cluster, HICARD_SQL)
    inj = faults.FaultInjector(seed=11)
    # every run of the leaf's first task (and of its replacements) waits, so
    # each drain finds it live
    inj.add("worker.task_run", faults.DELAY, delay_s=1.0, times=None,
            task_re=rf"\.{leaf}\.0(\.r\d+)?$")
    faults.install(inj)
    out = {}
    query = threading.Thread(target=lambda: out.update(got=cluster.runner.execute(HICARD_SQL)))
    query.start()
    try:
        deadline = time.monotonic() + 30.0
        while not (cluster.runner._schedulers
                   and leaf in next(iter(cluster.runner._schedulers.values())).stages):
            assert time.monotonic() < deadline, "the query never scheduled its leaf"
            time.sleep(0.01)
        sched = next(iter(cluster.runner._schedulers.values()))
        ids = []
        for _ in range(3):
            task = sched.stages[leaf].tasks[0]
            sched.drain_node(task.node.node_id, cluster.runner.nodes.active_nodes())
            ids.append(sched.stages[leaf].tasks[0].task_id)
        query.join(60.0)
    finally:
        cluster.close()
    assert [i.rsplit(".", 1)[-1] for i in ids] == ["r1", "r2", "r3"]
    got = out["got"]
    assert_same_rows(got.rows, want(HICARD_SQL), ordered=False)
    assert got.stats["query_attempts"] == 1 and got.stats["task_retries"] >= 3


def test_speculation_duplicates_straggler_and_journals_winner(want):
    cluster = _Cluster(properties={"retry_policy": "TASK", "speculative_execution": True,
                                   "speculation_min_wall_s": 0.4,
                                   "speculation_multiplier": 2.0,
                                   "retry_initial_delay_s": 0.01,
                                   "retry_max_delay_s": 0.05})
    leaf = _leaf_fragment_id(cluster, AGG_SQL)
    inj = faults.FaultInjector(seed=7)
    inj.add("worker.task_run", faults.DELAY, delay_s=5.0, times=1, task_re=rf"\.{leaf}\.0$")
    faults.install(inj)
    seq0 = JOURNAL.last_seq()
    try:
        got = cluster.runner.execute(AGG_SQL)
    finally:
        cluster.close()
    assert_same_rows(got.rows, want(AGG_SQL), ordered=False)
    assert got.stats["query_attempts"] == 1
    assert got.stats["task_speculations"] >= 1
    specs = JOURNAL.events(since=seq0, kind="task.speculated")
    assert specs and specs[-1]["winner"] == "speculative"
    assert specs[-1]["speculative_task_id"].endswith(".s1")
    assert specs[-1]["original_node"] != specs[-1]["speculative_node"]


def test_spool_overflow_mid_stream_escalates_to_loud_query_retry(want):
    cluster = _Cluster(properties={"retry_policy": "TASK", "exchange_spool_bytes": 0,
                                   "exchange_flush_rows": 512,
                                   "retry_initial_delay_s": 0.01,
                                   "retry_max_delay_s": 0.05})
    leaf = _leaf_fragment_id(cluster, HICARD_SQL)
    tripped = threading.Event()

    def crash_consumer(ctx):
        if ctx.get("token", 0) >= 2 and not tripped.is_set():
            tripped.set()
            raise faults.InjectedFault("injected fault: consumer crashed mid-stream")

    inj = faults.FaultInjector(seed=13)
    inj.add("client.results", faults.CALLBACK, times=None, location_re=rf"\.{leaf}\.0$",
            callback=crash_consumer)
    faults.install(inj)
    seq0 = JOURNAL.last_seq()
    try:
        got = cluster.runner.execute(HICARD_SQL)
    finally:
        cluster.close()
    assert tripped.is_set(), "mid-stream consumer crash never triggered"
    assert_same_rows(got.rows, want(HICARD_SQL), ordered=False)
    assert got.stats["query_attempts"] >= 2
    assert JOURNAL.events(since=seq0, kind="query.retry")


def test_concurrent_tenants_stay_row_correct_under_env_chaos(want):
    spec = ("worker.results:http_error:code=503,after=2,times=6;"
            "worker.results:delay:delay_s=0.02,probability=0.25,times=40")
    inj = faults.install_from_env({"PRESTO_TPU_FAULTS": spec, "PRESTO_TPU_FAULT_SEED": "17"})
    assert inj is not None and faults.active() is inj
    cluster = _Cluster(properties={"retry_policy": "TASK", "retry_initial_delay_s": 0.01,
                                   "retry_max_delay_s": 0.05})
    queries = [AGG_SQL, "select count(*) from lineitem",
               "select l_returnflag, max(l_extendedprice) from lineitem group by l_returnflag"]
    results, errors = {}, []

    def tenant(i, sql):
        try:
            results[i] = cluster.runner.execute(sql).rows
        except BaseException as e:  # noqa: BLE001 - re-raised via assert
            errors.append((sql, e))

    threads = [threading.Thread(target=tenant, args=(i, sql)) for i, sql in enumerate(queries)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
        assert not any(t.is_alive() for t in threads), "tenant wedged"
    finally:
        cluster.close()
    assert not errors, f"tenant failed under chaos: {errors[0]}"
    assert inj.total_fired >= 1
    for i, sql in enumerate(queries):
        assert_same_rows(results[i], want(sql), ordered=False)


def test_journal_correlates_protocol_and_internal_query_ids(want):
    from presto_tpu_torch.exec import progress

    cluster = _Cluster(properties={"retry_policy": "QUERY", "retry_initial_delay_s": 0.02,
                                   "retry_max_delay_s": 0.1})
    _kill_rule(cluster, cluster.workers[0])
    seq0 = JOURNAL.last_seq()
    try:
        with progress.query_scope("proto-q-42"):
            got = cluster.runner.execute(AGG_SQL)
    finally:
        cluster.close()
    assert_same_rows(got.rows, want(AGG_SQL), ordered=False)
    evts = JOURNAL.events(query_id="proto-q-42", since=seq0)
    kinds = {e["kind"] for e in evts}
    assert "query.retry" in kinds and "query.attempt_failed" in kinds
    internal = [e for e in evts if e["query_id"].startswith("cq")]
    assert internal and all(e.get("corr_id") == "proto-q-42" for e in internal)
