"""The port's cluster lifecycle, on the CPU: the drain state machine, the
coordinator's drain and the autoscaler (``tests/test_cluster_lifecycle.py``).

Also here: the failure forensics of ``tests/test_fault_tolerance.py`` and
the memory-manager tests of ``tests/test_service_layer.py``.

A PLANNED membership change loses no query: a draining worker refuses new
work (503), keeps serving its live streams from pinned spools until their
consumers are handed to replacements, and the queries it served finish with
``query_attempts == 1`` and the reference's rows. A DRAINED worker leaves
the coordinator's discovery over REST (``DELETE /v1/announcement/{id}``),
also when the drain is asked for with ``PUT /v1/cluster/drain/{id}``.
"""
import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from presto_tpu.runner import LocalQueryRunner as RefRunner
from presto_tpu_torch.cluster import faults
from presto_tpu_torch.cluster.autoscaler import WorkerPoolAutoscaler
from presto_tpu_torch.cluster.coordinator import ClusterQueryRunner
from presto_tpu_torch.cluster.memory_manager import ClusterMemoryManager
from presto_tpu_torch.cluster.worker import ACTIVE, DRAINED, DRAINING, SHUT_DOWN, WorkerServer
from presto_tpu_torch.metadata import Session
from presto_tpu_torch.utils import events
from presto_tpu_torch.utils.events import JOURNAL
from test_torch_cluster import assert_same_rows
from test_torch_fault_tolerance import AGG_SQL, want  # noqa: F401 - the shared fixture
from test_torch_fault_tolerance import _Cluster as _KillableCluster
from test_torch_fault_tolerance import _kill_rule


@pytest.fixture(autouse=True)
def _isolated_injector():
    faults.clear()
    yield
    faults.clear()


def _worker():
    return WorkerServer(port=0, device="cpu")


def test_transition_map_rejects_illegal_moves():
    w = _worker()  # not started: the machine needs no sockets
    try:
        assert w.state == ACTIVE
        with pytest.raises(ValueError):
            w.transition(DRAINED)
        assert w.transition(ACTIVE) is False
        assert w.transition(DRAINING) is True
        with pytest.raises(ValueError):
            w.transition(ACTIVE)
        assert w.transition(DRAINED) is True
        with pytest.raises(ValueError):
            w.transition(DRAINING)
        assert w.transition(SHUT_DOWN) is True
        with pytest.raises(ValueError):
            w.transition(ACTIVE)
    finally:
        w.httpd.server_close()


def test_idle_drain_completes_immediately_and_refuses_tasks():
    w = _worker().start()
    try:
        seq0 = JOURNAL.last_seq()
        req = urllib.request.Request(f"{w.uri}/v1/info/state", data=b'"DRAINING"',
                                     method="PUT")
        body = urllib.request.urlopen(req, timeout=5.0).read()
        assert json.loads(body) == DRAINED
        assert w.state == DRAINED
        kinds = [e["kind"] for e in JOURNAL.events(since=seq0)]
        assert "worker.draining" in kinds and "worker.drained" in kinds
        req = urllib.request.Request(f"{w.uri}/v1/task/t1", data=b"x", method="POST")
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=5.0)
        assert exc.value.code == 503
        assert b"shutting down" in exc.value.read()
    finally:
        w.stop()


def test_info_state_endpoint_shape_and_transition_guards():
    w = _worker().start()
    try:
        with urllib.request.urlopen(f"{w.uri}/v1/info/state", timeout=5.0) as r:
            st = json.loads(r.read())
        assert st == {"state": ACTIVE, "activeTasks": 0, "drainingTasks": 0,
                      "spooledBytes": 0, "tasks": {}}
        for body, code in ((b'"ACTIVE"', 409), (b'"BOGUS"', 400)):
            req = urllib.request.Request(f"{w.uri}/v1/info/state", data=body, method="PUT")
            with pytest.raises(urllib.error.HTTPError) as exc:
                urllib.request.urlopen(req, timeout=5.0)
            assert exc.value.code == code
    finally:
        w.stop()


class _Cluster:
    def __init__(self, properties=None, n_workers=2):
        session = Session(catalog="tpch", schema="tiny", properties=dict(properties or {}))
        self.runner = ClusterQueryRunner(session=session, min_workers=n_workers,
                                         worker_wait_s=10.0, device="cpu")
        self.workers = [_worker().start() for _ in range(n_workers)]
        self._stop = threading.Event()
        for w in self.workers:
            self.runner.nodes.announce(w.node_id, w.uri)
        self._thread = threading.Thread(target=self._keep_alive, daemon=True)
        self._thread.start()

    def _keep_alive(self):
        # announce ACTIVE and DRAINING workers (a draining node still
        # serves streams); never a DRAINED one — the coordinator removed it
        while not self._stop.wait(0.5):
            for w in list(self.workers):
                if w.state in (ACTIVE, DRAINING):
                    self.runner.nodes.announce(w.node_id, w.uri)

    def close(self):
        self._stop.set()
        self._thread.join(5.0)
        self.runner.detector.stop()
        for w in self.workers:
            w.stop()


class _Deadline:
    def __init__(self, seconds):
        self.t_end = time.time() + seconds

    def tick(self, msg):
        assert time.time() < self.t_end, msg
        time.sleep(0.05)


def _rest_coordinator():
    from presto_tpu_torch.server.http_server import PrestoTpuServer

    runner = ClusterQueryRunner(session=Session(catalog="tpch", schema="tiny"), min_workers=1,
                                worker_wait_s=15.0, device="cpu")
    server = PrestoTpuServer(runner, port=0)
    server.start()
    return runner, server


def test_drained_worker_deregisters_from_discovery():
    """A worker that reaches DRAINED sends DELETE /v1/announcement/{id} and
    its discovery entry goes without waiting out the liveness expiry."""
    runner, server = _rest_coordinator()
    w = WorkerServer(port=0, coordinator_uri=f"http://127.0.0.1:{server.port}",
                     device="cpu").start()
    try:
        deadline = _Deadline(10.0)
        while runner.nodes.get(w.node_id) is None:
            deadline.tick("worker never announced")
        w.begin_drain(reason="test")
        assert w.state == DRAINED
        deadline = _Deadline(10.0)
        while runner.nodes.get(w.node_id) is not None:
            deadline.tick("DRAINED worker never deregistered")
    finally:
        w.stop()
        runner.detector.stop()
        server.stop()


def test_operator_drain_over_http_deregisters_the_worker():
    """PUT /v1/cluster/drain/{id} on the coordinator's server: 202, then the
    worker walks to DRAINED and leaves discovery; an unknown node is a 404."""
    runner, server = _rest_coordinator()
    base = f"http://127.0.0.1:{server.port}"
    w = WorkerServer(port=0, coordinator_uri=base, device="cpu").start()
    try:
        deadline = _Deadline(10.0)
        while runner.nodes.get(w.node_id) is None:
            deadline.tick("worker never announced")
        seq0 = JOURNAL.last_seq()
        req = urllib.request.Request(f"{base}/v1/cluster/drain/{w.node_id}", method="PUT")
        with urllib.request.urlopen(req, timeout=10) as r:
            assert r.status == 202 and json.loads(r.read()) == {"draining": w.node_id}
        deadline = _Deadline(15.0)
        while runner.nodes.get(w.node_id) is not None or w.state != DRAINED:
            deadline.tick("the drained worker never left discovery")
        # the worker leaves discovery itself at DRAINED; the coordinator's
        # drain thread journals node.drained once its next poll sees that
        while not JOURNAL.events(since=seq0, kind="node.drained"):
            deadline.tick("the coordinator never journaled the drain")
        drained = JOURNAL.events(since=seq0, kind="node.drained")
        assert drained and drained[0]["signal"]["trigger"] == "operator"
        req = urllib.request.Request(f"{base}/v1/cluster/drain/no-such-node", method="PUT")
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=10)
        assert exc.value.code == 404
    finally:
        w.stop()
        runner.detector.stop()
        server.stop()


def test_drain_worker_idle_cluster_emits_events_and_removes_node():
    cluster = _Cluster()
    victim = cluster.workers[0]
    try:
        seq0 = JOURNAL.last_seq()
        out = cluster.runner.drain_worker(victim.node_id,
                                          signal={"trigger": "test", "reason": "idle"})
        assert out["drained"] and out["state"] == DRAINED
        assert out["tasks_handed_off"] == 0
        assert cluster.runner.nodes.get(victim.node_id) is None
        assert [n.node_id for n in cluster.runner.nodes.schedulable_nodes()] \
            == [cluster.workers[1].node_id]
        draining = JOURNAL.events(since=seq0, kind="node.draining")
        drained = JOURNAL.events(since=seq0, kind="node.drained")
        assert draining and draining[0]["signal"]["trigger"] == "test"
        assert drained and drained[0]["node"] == victim.node_id
        with pytest.raises(ValueError):
            cluster.runner.drain_worker("no-such-node")
    finally:
        cluster.close()


@pytest.mark.parametrize("joiner", [False, True], ids=["no-joiner", "joiner"])
def test_drain_hands_off_live_interior_tasks_mid_stream(joiner):
    """Drain a worker while a consumer is mid-stream on its output (chunk 0
    delivered and acked): the replacement is spliced in exactly once — the
    reference's rows, no query-level retry, task.retry journaled as a
    drain. With ``joiner``, a third worker joins the cluster first, as in
    the reference's churn drive (``bench.bench_churn``)."""
    from presto_tpu_torch.cluster.scheduler import _remote_source_ids

    sql = ("select l_suppkey, count(*), sum(l_quantity) "
           "from lineitem group by l_suppkey")
    want = RefRunner().execute(sql).rows
    cluster = _Cluster(properties={"retry_policy": "TASK", "exchange_flush_rows": 256,
                                   "retry_initial_delay_s": 0.01,
                                   "retry_max_delay_s": 0.05})
    victim = min(cluster.workers, key=lambda w: w.node_id)
    try:
        sub = cluster.runner.plan_sql(sql)
        leaf = next(f.id for f in sub.fragments
                    if not _remote_source_ids(f.root) and f.id != sub.root_fragment.id)
        mid_stream = threading.Event()

        def observe(ctx):
            token = int(ctx["path"].partition("?")[0].rstrip("/").rsplit("/", 1)[-1])
            if token >= 1:
                mid_stream.set()

        inj = faults.FaultInjector(seed=31)
        inj.add("worker.results", faults.CALLBACK, node_id=victim.node_id,
                task_re=rf"\.{leaf}\.0$", times=None, callback=observe)
        faults.install(inj)
        seq0 = JOURNAL.last_seq()
        holder = {}
        qt = threading.Thread(target=lambda: holder.update(res=cluster.runner.execute(sql)))
        qt.start()
        assert mid_stream.wait(30.0), "query never went mid-stream"
        if joiner:
            w = _worker().start()
            cluster.workers.append(w)
            cluster.runner.nodes.announce(w.node_id, w.uri)
        out = cluster.runner.drain_worker(victim.node_id, signal={"trigger": "test-mid-stream"})
        qt.join(60.0)
        res = holder["res"]
        assert out["drained"] and out["tasks_handed_off"] >= 1, out
        assert victim.state == DRAINED
        if joiner:
            assert cluster.runner.nodes.get(cluster.workers[-1].node_id) is not None
        assert_same_rows(res.rows, want, ordered=False)
        assert res.stats["query_attempts"] == 1, res.stats
        assert res.stats["task_retries"] >= 1, res.stats
        retries = JOURNAL.events(since=seq0, kind="task.retry")
        assert retries and all(e["retry_kind"] == "drain" for e in retries)
    finally:
        cluster.close()


def test_autoscaler_scales_up_on_queue_depth_and_down_through_drain():
    cluster = _Cluster(n_workers=1)
    scaler = WorkerPoolAutoscaler(cluster.runner, spawn_worker=lambda: _worker().start(),
                                  min_workers=1, max_workers=2, idle_polls_down=2)
    scaler.adopt(cluster.workers[0])
    spawned = []
    try:
        seq0 = JOURNAL.last_seq()
        events.emit("query.queued", severity=events.INFO, query_id="q-test", queue_depth=3)
        assert scaler.poll_once() == "scale_up"
        assert len(scaler.managed) == 2
        spawned = [h for nid, h in scaler.managed.items()
                   if nid != cluster.workers[0].node_id]
        assert cluster.runner.nodes.get(spawned[0].node_id) is not None
        ups = JOURNAL.events(since=seq0, kind="autoscaler.scale_up")
        assert ups and ups[0]["signal"]["queue_depth"] == 3

        seq1 = JOURNAL.last_seq()
        actions = [scaler.poll_once() for _ in range(3)]
        assert "scale_down" in actions
        assert len(scaler.managed) == 1
        downs = JOURNAL.events(since=seq1, kind="autoscaler.scale_down")
        assert downs
        draining = JOURNAL.events(since=seq1, kind="node.draining")
        assert draining and draining[0]["signal"]["trigger"] == "autoscaler.scale_down"
        assert JOURNAL.events(since=seq1, kind="node.drained")
        victim = [h for h in [cluster.workers[0]] + spawned
                  if h.node_id == downs[0]["node"]][0]
        assert victim.state == SHUT_DOWN
        assert cluster.runner.nodes.get(victim.node_id) is None
    finally:
        scaler.stop()
        for h in spawned:
            h.stop()
        cluster.close()


# ---------------------------------------------------------------------------
# failure forensics
# ---------------------------------------------------------------------------

def _load_forensic(exc):
    path = getattr(exc, "failure_trace_path", None)
    assert path, f"no forensic on {type(exc).__name__}: {exc}"
    with open(path) as f:
        doc = json.load(f)
    assert doc["otherData"]["coarse"] is True
    assert isinstance(doc["traceEvents"], list) and doc["traceEvents"]
    return doc


def test_fault_injected_failure_dumps_forensic_trace():
    from presto_tpu_torch.utils import trace

    cluster = _KillableCluster()
    _kill_rule(cluster, cluster.workers[0])
    try:
        with pytest.raises(Exception) as ei:
            cluster.runner.execute(AGG_SQL)
    finally:
        cluster.close()
    doc = _load_forensic(ei.value)
    assert trace.span_categories(doc).get("http", 0) > 0
    attempts = JOURNAL.events(kind="query.attempt_failed")
    assert attempts and attempts[-1]["query_id"].startswith("cq")


def test_query_surviving_retry_carries_failed_attempt_forensic(want):
    cluster = _KillableCluster(properties={"retry_policy": "QUERY", "retry_initial_delay_s": 0.02,
                                   "retry_max_delay_s": 0.1})
    _kill_rule(cluster, cluster.workers[0])
    try:
        got = cluster.runner.execute(AGG_SQL)
    finally:
        cluster.close()
    assert_same_rows(got.rows, want(AGG_SQL), ordered=False)
    assert got.failure_trace_path, "retried query lost its attempt forensic"
    with open(got.failure_trace_path) as f:
        assert json.load(f)["otherData"]["coarse"] is True
    retries = JOURNAL.events(kind="query.retry")
    assert retries and retries[-1]["attempt"] >= 1


def test_oom_killed_query_dumps_forensic_and_journals_decision():
    """A ClusterMemoryManager polled by hand, with a status fetch that
    inflates the reported bytes, kills the live query: it fails with a
    forensic, and the journal holds the decision with its evidence."""
    cluster = _KillableCluster(properties={"exchange_error_budget_s": 2.0})
    runner = cluster.runner

    def inflated(uri):
        with urllib.request.urlopen(f"{uri}/v1/status", timeout=2.0) as resp:
            status = json.loads(resp.read())
        status["queryMemory"] = {qid: b + (1 << 40)
                                 for qid, b in (status.get("queryMemory") or {}).items()}
        return status

    mgr = ClusterMemoryManager(runner.nodes, kill_query=runner._kill_query,
                               limit_bytes=1 << 30, grace_polls=1, fetch_status=inflated)
    inj = faults.FaultInjector(seed=3)
    # hold every results pull, so the query stays live across polls; the
    # port's tasks finish on the CPU before the first poll unless their
    # start is held too
    inj.add("worker.results", faults.CALLBACK, times=None,
            callback=lambda ctx: time.sleep(0.15))
    inj.add("worker.task_run", faults.DELAY, delay_s=1.0, times=None)
    faults.install(inj)
    box = {}

    def run():
        try:
            runner.execute(AGG_SQL)
            box["ok"] = True
        except BaseException as e:  # noqa: BLE001 - inspected by the test
            box["error"] = e

    t = threading.Thread(target=run)
    t.start()
    try:
        deadline = time.monotonic() + 30.0
        victim = None
        while victim is None and time.monotonic() < deadline and t.is_alive():
            # the kill aborts the tasks scheduled so far: poll once every
            # stage of the query exists, so none is created after it
            scheds = list(runner._schedulers.values())
            if scheds and all(len(s.stages) == len(s.subplan.fragments) for s in scheds):
                victim = mgr.poll_once()
            time.sleep(0.05)
        t.join(timeout=60.0)
        assert not t.is_alive(), "query wedged after OOM kill"
        assert "ok" not in box, "query finished before the memory manager saw it"
        assert victim is not None, "memory manager never picked a victim"
    finally:
        cluster.close()
    _load_forensic(box["error"])
    kill = JOURNAL.events(kind="query.oom_killed")[-1]
    assert kill["query_id"] == victim and kill["severity"] == "error"
    assert kill["per_node"] and any(victim in q for q in kill["per_node"].values())
    assert kill["victim_bytes"] > kill["limit_bytes"] >= 1 << 30


# ---------------------------------------------------------------------------
# the cluster memory manager (tests/test_service_layer.py)
# ---------------------------------------------------------------------------

class _Node:
    def __init__(self, uri):
        self.uri = uri


class _Nodes:
    def __init__(self, uris):
        self._nodes = [_Node(u) for u in uris]

    def active_nodes(self):
        return self._nodes


def test_cluster_memory_manager_kills_biggest_query():
    statuses = {"w1": {"queryMemory": {"q1": 10 << 20, "q2": 50 << 20}},
                "w2": {"queryMemory": {"q1": 15 << 20, "q2": 30 << 20}}}
    killed = []
    mgr = ClusterMemoryManager(_Nodes(["w1", "w2"]), kill_query=killed.append,
                               limit_bytes=64 << 20, grace_polls=2,
                               fetch_status=lambda uri: statuses[uri])
    assert mgr.poll_once() is None
    assert mgr.poll_once() == "q2"
    assert killed == ["q2"] and mgr.last_total == 105 << 20
    statuses["w1"] = {"queryMemory": {"q1": 1 << 20}}
    statuses["w2"] = {"queryMemory": {}}
    assert mgr.poll_once() is None and killed == ["q2"]


def test_memory_manager_revoke_beat_before_kill():
    state = {"spilled": False}

    def fetch(uri):
        if not state["spilled"]:
            return {"queryMemory": {"q1": 100 << 20}, "queryRevocable": {"q1": 90 << 20}}
        return {"queryMemory": {"q1": 10 << 20}, "querySpill": {"q1": 90 << 20}}

    killed, revoke_calls = [], []
    mgr = ClusterMemoryManager(_Nodes(["w1"]), kill_query=killed.append, limit_bytes=50 << 20,
                               grace_polls=2, fetch_status=fetch,
                               request_revoke=lambda: revoke_calls.append(1))
    assert mgr.poll_once() is None
    seq_before = JOURNAL.last_seq()
    assert mgr.poll_once() is None
    assert revoke_calls == [1]
    revokes = JOURNAL.events(since=seq_before, kind="memory.revoke")
    assert revokes and revokes[-1]["requested_bytes"] == 90 << 20
    state["spilled"] = True
    assert mgr.poll_once() is None
    assert killed == []


def test_memory_manager_kills_after_unhelpful_revoke_with_evidence():
    def fetch(uri):
        return {"queryMemory": {"q1": 100 << 20, "q2": 30 << 20},
                "queryRevocable": {"q1": 40 << 20}}

    killed = []
    mgr = ClusterMemoryManager(_Nodes(["w1"]), kill_query=killed.append, limit_bytes=50 << 20,
                               grace_polls=2, fetch_status=fetch)
    assert mgr.poll_once() is None
    assert mgr.poll_once() is None
    assert killed == []
    assert mgr.poll_once() == "q1" and killed == ["q1"]
    kill = JOURNAL.events(kind="query.oom_killed")[-1]
    assert kill["revoke_attempted"] is True and kill["revocable_bytes"] == 40 << 20


def test_worker_status_ships_spill_ledgers_and_gcs_residue():
    from presto_tpu_torch.memory import shared_general_pool

    w = _worker().start()
    try:
        pool = shared_general_pool()
        pool.reserve_spill("q_dead_spill", 4096)  # no live task owns this
        with urllib.request.urlopen(f"{w.uri}/v1/status", timeout=2.0) as resp:
            st = json.loads(resp.read())
        assert "querySpill" in st and "queryRevocable" in st
        assert "q_dead_spill" not in st["querySpill"]
        assert pool.spill_bytes("q_dead_spill") == 0
    finally:
        w.stop()


def test_memory_manager_legacy_status_kills_at_grace():
    killed = []
    mgr = ClusterMemoryManager(_Nodes(["w1"]), kill_query=killed.append, limit_bytes=50,
                               grace_polls=2,
                               fetch_status=lambda uri: {"queryMemory": {"q1": 100}})
    assert mgr.poll_once() is None
    assert mgr.poll_once() == "q1" and killed == ["q1"]


def test_memory_manager_tolerates_dead_worker():
    def fetch(uri):
        if uri == "dead":
            raise OSError("unreachable")
        return {"queryMemory": {"q1": 10}}

    mgr = ClusterMemoryManager(_Nodes(["dead", "ok"]), kill_query=lambda q: None,
                               limit_bytes=1 << 30, fetch_status=fetch)
    assert mgr.poll_once() is None and mgr.last_total == 10
