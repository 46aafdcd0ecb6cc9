"""The port's cluster against presto_tpu, on the CPU: a coordinator and two
worker servers in one process, with real HTTP between them
(``tests/test_cluster.py``'s ring).

Every query of the reference's ``CLUSTER_QUERIES`` and TPC-H Q3 at ``tiny``
gives rows equal to the reference's ``LocalQueryRunner`` (one shared run per
query) and to the port's own local run, under each retry policy. Also
ported: distributed EXPLAIN ANALYZE's roll-up, task-failure propagation,
the failure detector, too few workers, the drain of an idle worker, and the
whole stack over REST: a worker that announces itself to the coordinator's
``PrestoTpuServer``, a statement through the client, ``GET /v1/cluster``.
"""
import json
import math
import threading
import time
import urllib.error
import urllib.request

import pytest

from presto_tpu.runner import LocalQueryRunner as RefRunner
from presto_tpu_torch.cluster import ClusterQueryRunner, WorkerServer
from presto_tpu_torch.metadata import Session
from presto_tpu_torch.models.tpch_sql import QUERIES
from presto_tpu_torch.runner import LocalQueryRunner

DOUBLE_REL_TOL = 1e-12

CLUSTER_QUERIES = [
    "select l_returnflag, count(*), sum(l_quantity), avg(l_extendedprice) "
    "from lineitem group by l_returnflag",
    "select o_orderpriority, count(*) c from orders "
    "where o_orderdate >= date '1995-01-01' "
    "group by o_orderpriority order by o_orderpriority",
    "select n_name, count(*) from nation, region "
    "where n_regionkey = r_regionkey and r_name = 'ASIA' "
    "group by n_name order by n_name",
    "select count(*), sum(l_extendedprice * l_discount) from lineitem "
    "where l_quantity < 24",
    "select c_name, c_acctbal from customer order by c_acctbal desc limit 7",
    # ORDER BY without LIMIT: each worker sorts, the consumer merges
    "select o_orderkey, o_totalprice from orders "
    "where o_totalprice > 150000.0 order by o_totalprice desc, o_orderkey",
    "select n_name, n_regionkey from nation order by n_name",
]
SQL = CLUSTER_QUERIES + [QUERIES[3]]


def assert_same_rows(got, want, ordered):
    """Equal rows (in order where the SQL orders); exact but for DOUBLE,
    whose partial sums add in another order (DOUBLE_REL_TOL)."""
    def key(row):
        return tuple((x is None, round(x, 6) if isinstance(x, float) else x) for x in row)
    if not ordered:
        got, want = sorted(got, key=key), sorted(want, key=key)
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(a, float) or isinstance(b, float):
                assert type(a) is type(b) and math.isclose(a, b, rel_tol=DOUBLE_REL_TOL), (g, w)
            else:
                assert type(a) is type(b) and a == b, (g, w)


@pytest.fixture(scope="module")
def ref_rows():
    runner = RefRunner()
    cache = {}

    def rows(sql):
        if sql not in cache:
            cache[sql] = runner.execute(sql).rows
        return cache[sql]
    return rows


@pytest.fixture(scope="module")
def cluster():
    session = Session(catalog="tpch", schema="tiny")
    runner = ClusterQueryRunner(session=session, min_workers=2, worker_wait_s=10.0,
                                device="cpu")
    workers = [WorkerServer(port=0, device="cpu").start() for _ in range(2)]
    for w in workers:
        runner.nodes.announce(w.node_id, w.uri)
    stop = threading.Event()

    def keep_alive():
        while not stop.wait(1.0):
            for w in workers:
                runner.nodes.announce(w.node_id, w.uri)

    t = threading.Thread(target=keep_alive, daemon=True)
    t.start()
    local = LocalQueryRunner(session, device="cpu")
    yield runner, local
    stop.set()
    t.join(5.0)
    runner.detector.stop()
    for w in workers:
        w.stop()


@pytest.mark.parametrize("policy", ["NONE", "QUERY", "TASK"])
@pytest.mark.parametrize("i", range(len(SQL)))
def test_cluster_rows_equal_reference(cluster, ref_rows, i, policy):
    runner, local = cluster
    sql = SQL[i]
    base = runner.local.session
    runner.local.session = base.with_properties(retry_policy=policy)
    try:
        got = runner.execute(sql)
    finally:
        runner.local.session = base
    ordered = "order by" in sql
    assert_same_rows(got.rows, ref_rows(sql), ordered)
    assert got.stats["retry_policy"] == policy and got.stats["query_attempts"] == 1
    if policy == "NONE":
        assert_same_rows(got.rows, local.execute(sql).rows, ordered)


def test_explain_analyze_rolls_up_worker_stats(cluster):
    """Each task ships its per-operator stats in its TaskInfo; the
    coordinator renders one rolled-up table per fragment."""
    runner, _ = cluster
    for _ in range(2):  # the final stats snapshot holds run after run
        res = runner.execute(
            "explain analyze select r_name, count(*) from region group by r_name")
        text = "\n".join(r[0] for r in res.rows)
        assert "Fragment 0 [source]" in text and "tasks=2" in text
        assert "Operator" in text and "Wall ms" in text and "Blk ms" in text \
            and "Peak MB" in text
        scans = [line for line in text.splitlines() if line.strip().startswith("TableScan")]
        assert scans and all(int(line.split()[1]) > 0 for line in scans), text
        assert "(no operator stats reported)" not in text


def test_task_failure_propagates(cluster):
    """A table in the coordinator's `memory` catalog, which the workers do
    not configure: planning succeeds, the worker task fails, and the
    failure reaches the caller."""
    runner, _ = cluster
    runner.local.execute("create table memory.default.coord_only as select 1 as x")
    with pytest.raises(Exception, match="(?i)task .* failed"):
        runner.execute("select count(*) from memory.default.coord_only")


def test_failure_detector_gates_dead_node():
    from presto_tpu_torch.cluster.discovery import (DiscoveryNodeManager,
                                                    HeartbeatFailureDetector)
    nodes = DiscoveryNodeManager()
    nodes.announce("dead-node", "http://127.0.0.1:1")  # nothing listens
    detector = HeartbeatFailureDetector(nodes, period_s=0.05).start()
    try:
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            nodes.announce("dead-node", "http://127.0.0.1:1")
            if not nodes.active_nodes():
                break
            time.sleep(0.05)
        assert not nodes.active_nodes(), "dead node was never gated out"
    finally:
        detector.stop()


def test_insufficient_workers_raises():
    runner = ClusterQueryRunner(min_workers=3, worker_wait_s=0.2, device="cpu")
    runner.detector.stop()
    with pytest.raises(RuntimeError, match="active workers"):
        runner.execute("select count(*) from nation")


def test_rest_protocol_over_cluster(ref_rows):
    """The whole stack: REST coordinator (+ /v1/announcement discovery) ->
    cluster scheduler -> worker tasks -> paged client results."""
    from presto_tpu_torch import client
    from presto_tpu_torch.server.http_server import PrestoTpuServer

    runner = ClusterQueryRunner(session=Session(catalog="tpch", schema="tiny"), min_workers=1,
                                worker_wait_s=15.0, device="cpu")
    server = PrestoTpuServer(runner, port=0)
    server.start()
    worker = WorkerServer(port=0, coordinator_uri=f"http://127.0.0.1:{server.port}",
                          device="cpu").start()
    try:
        sql = "select r_name from region order by r_name"
        rows = client.execute(f"http://127.0.0.1:{server.port}", sql)
        assert [r[0] for r in rows] == ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
        assert rows == ref_rows(sql)
        # the cluster stats endpoint sees the announced worker
        with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/v1/cluster",
                                    timeout=5) as r:
            stats = json.loads(r.read())
        assert stats["activeWorkers"] == 1
        assert stats["nodes"][0]["nodeId"] == worker.node_id
    finally:
        worker.stop()
        runner.detector.stop()
        server.stop()


def test_graceful_shutdown_drains():
    w = WorkerServer(port=0, device="cpu").start()
    try:
        req = urllib.request.Request(f"{w.uri}/v1/info/state",
                                     data=b'"SHUTTING_DOWN"', method="PUT")
        body = urllib.request.urlopen(req, timeout=5.0).read()
        assert json.loads(body) == "DRAINED"
        assert w.state == "DRAINED"
        req = urllib.request.Request(f"{w.uri}/v1/task/t1", data=b"x", method="POST")
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=5.0)
        assert exc.value.code == 503
    finally:
        w.stop()


def test_entry_points_refuse_cuda_without_it():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        WorkerServer(port=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ClusterQueryRunner()


def test_worker_main_refuses_cuda_without_it():
    import os
    import subprocess
    import sys

    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-m", "presto_tpu_torch.cluster.worker",
                          "--port", "0", "--device", "cuda"], cwd=root,
                         env=dict(os.environ, PYTHONPATH=root), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0 and "CUDA is not available" in out.stderr
