"""The port's leak sanitizer (presto_tpu_torch/utils/leaksan.py), case for
case against tests/test_leaksan.py, on the CPU.

Unit level: memory, spill, client, recorder and thread residue reported
with the acquiring stack and owning query; balanced lifecycles clean; the
busy guard skipping reentrant notes; the ``leaksan.live_*`` gauges;
uninstall hygiene; the dump read back by ``--leak-diff``. Differential: one
seeded leak caught by both the static ``resource-discipline`` pass and the
sanitizer, and Q6 at ``tiny`` row-identical to the uninstrumented run and
the reference's runner with zero findings.

Also here: the port's counterpart of the reference's sanitized-session
gate, a few port workloads under all three sanitizers with zero findings.
"""
import os
import textwrap
import threading

import pytest
import torch

from presto_tpu.metadata import Session as RefSession
from presto_tpu.models.tpch_sql import QUERIES as REF_QUERIES
from presto_tpu.runner import LocalQueryRunner as RefRunner
from presto_tpu_torch.memory import MemoryPool, shared_general_pool
from presto_tpu_torch.metadata import Session
from presto_tpu_torch.models.tpch_sql import QUERIES
from presto_tpu_torch.runner import LocalQueryRunner
from presto_tpu_torch.utils import compilesan, leaksan, locksan
from presto_tpu_torch.utils.metrics import METRICS
from presto_tpu_torch.utils.testing import assert_no_residue
from test_torch_sql import assert_same_rows

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAN = leaksan.SANITIZER


@pytest.fixture(autouse=True)
def _fresh_sanitizer():
    """Install for each test and isolate its deliberate leaks without
    losing what the engine recorded before: earlier findings are absorbed
    back after, and an env-driven install stays installed."""
    env_installed = leaksan.enabled()
    engine_findings = SAN.findings()
    SAN.reset()
    leaksan.install()
    yield
    SAN.reset()
    if env_installed:
        leaksan.install()
    else:
        leaksan.uninstall()
    SAN.absorb(engine_findings)


# ------------------------------------------------------------ residue kinds

def test_memory_residue_carries_stack_and_query_id():
    pool = MemoryPool("general", 1 << 20)
    pool.reserve("q-leak", 4096)          # the acquire that is never paired
    pool.clear_query("q-leak")            # the backstop fires: a finding
    (f,) = SAN.findings()
    assert f["kind"] == "memory-residue"
    assert f["query_id"] == "q-leak" and f["bytes"] == 4096
    assert "4096 reserved byte(s)" in f["message"]
    # the report points at the acquire (this file), not the teardown
    assert f["site"].startswith("tests/test_torch_leaksan.py:")
    assert all(":" in frame for frame in f["stack"])


def test_spill_manager_residue_reported_at_clear_query(tmp_path):
    from presto_tpu_torch.exec.spill import SpillManager

    pool = MemoryPool("general", 1 << 20)
    mgr = SpillManager("q-spill", pool, spill_dir=str(tmp_path))
    pool.clear_query("q-spill")           # the manager was never closed
    assert [f["kind"] for f in SAN.findings()] == ["spill-residue"]
    assert SAN.findings()[0]["query_id"] == "q-spill"
    mgr.close()


def test_balanced_lifecycle_is_clean(tmp_path):
    from presto_tpu_torch.exec.spill import SpillManager

    pool = MemoryPool("general", 1 << 20)
    pool.reserve("q-ok", 4096)
    pool.reserve("q-ok", -4096)
    mgr = SpillManager("q-ok", pool, spill_dir=str(tmp_path))
    mgr.close()
    pool.clear_query("q-ok")
    assert SAN.findings() == []
    live = SAN.live_counts()
    assert live["reservations"] == 0 and live["spill_managers"] == 0


def test_pool_client_residue_at_exit_census():
    from presto_tpu_torch.exec.shared_pools import SharedWorkerPool

    sp = SharedWorkerPool("leaksan-test", 1)
    c = sp.client("q-client")
    try:
        SAN.check_exit()
        hits = [f for f in SAN.findings() if f["kind"] == "pool-client-residue"]
        assert len(hits) == 1 and "q-client" in hits[0]["message"]
    finally:
        c.release()
    assert SAN.live_counts()["pool_clients"] == 0


def test_recorder_residue_at_exit_census():
    from presto_tpu_torch.utils import trace

    rec = trace.TraceRecorder(query_id="q-rec")
    trace.install(rec)
    try:
        SAN.check_exit()
        hits = [f for f in SAN.findings() if f["kind"] == "recorder-residue"]
        assert len(hits) == 1 and hits[0]["query_id"] == "q-rec"
    finally:
        trace.uninstall(rec)
    assert SAN.live_counts()["recorders"] == 0


def test_thread_residue_nondaemon_flagged_daemon_exempt():
    gate = threading.Event()
    live = threading.Thread(target=gate.wait, name="leaksan-live")
    pool_worker = threading.Thread(target=gate.wait, name="leaksan-daemon", daemon=True)
    live.start()
    pool_worker.start()
    try:
        SAN.check_exit()
        msgs = [f["message"] for f in SAN.findings() if f["kind"] == "thread-residue"]
        assert any("leaksan-live" in m for m in msgs)
        assert not any("leaksan-daemon" in m for m in msgs)
    finally:
        gate.set()
        live.join(2.0)
        pool_worker.join(2.0)
    assert not live.is_alive() and not pool_worker.is_alive()


# ---------------------------------------------------------------- plumbing

def test_live_gauges_published_through_metrics():
    pool = MemoryPool("general", 1 << 20)
    pool.reserve("q-gauge", 2048)
    snap = METRICS.snapshot("leaksan")
    assert snap["leaksan.live_reservations"] == 1
    assert snap["leaksan.live_bytes"] == 2048
    pool.reserve("q-gauge", -2048)
    assert METRICS.snapshot("leaksan")["leaksan.live_bytes"] == 0
    pool.clear_query("q-gauge")
    assert SAN.findings() == []


def test_reentrant_notes_are_skipped_not_deadlocked():
    """A note made while another records on this thread is skipped by the
    busy guard instead of deadlocking on the meta lock."""
    pool = MemoryPool("general", 1 << 20)
    with SAN._Quiet(SAN._tls):
        pool.reserve("q-reentrant", 512)
        pool.reserve("q-reentrant", -512)
    assert SAN.live_counts()["reservations"] == 0    # both notes skipped
    pool.clear_query("q-reentrant")
    assert SAN.findings() == []


def test_uninstall_restores_raw_methods_and_stops_recording():
    assert leaksan.enabled()
    assert MemoryPool.reserve.__module__.endswith("leaksan")
    leaksan.uninstall()
    assert not leaksan.enabled()
    assert MemoryPool.reserve.__module__ == "presto_tpu_torch.memory"
    # the stdlib's start again (or the reference's sanitizer's, when the
    # environment armed it)
    assert threading.Thread.start.__module__ in ("threading", "presto_tpu.utils.leaksan")
    pool = MemoryPool("general", 1 << 20)
    pool.reserve("q-after", 128)
    pool.clear_query("q-after")
    assert SAN.findings() == []           # nothing recorded after uninstall


def test_dump_roundtrips_through_leakdiff(tmp_path):
    """dump() read back by ``--leak-diff`` over the port: a finding whose
    stack lies outside the scanned tree is reported unmapped, never
    dropped."""
    from tools.prestocheck.leakdiff import diff_dump_path

    pool = MemoryPool("general", 1 << 20)
    pool.reserve("q-dump", 1024)
    pool.clear_query("q-dump")
    dump = SAN.dump(str(tmp_path / "leaksan.json"))
    diff = diff_dump_path(dump, [os.path.join(REPO, "presto_tpu_torch")])
    assert diff["runtime_findings"] == 1
    assert diff["acquire_sites"] > 20     # the port's own acquires
    assert diff["matched"] == [] and diff["missing"] == []
    assert len(diff["unmapped"]) == 1     # test-file frames are not scanned


# ------------------------------------------------------------- differential

def test_differential_seeded_leak_caught_by_both_halves(tmp_path):
    """One seeded bug, a reserve paired with a happy-path clear_query: the
    static pass flags the source, and leaksan reports the residue when the
    same shape runs and the risky call raises."""
    from tools.prestocheck import run as static_run

    fixture = tmp_path / "leaky_op.py"
    fixture.write_text(textwrap.dedent("""
        def leaky(pool, query_id, page):
            pool.reserve(query_id, page.nbytes)
            process(page)                 # can raise: clear below skipped
            pool.clear_query(query_id)
        """))
    static = static_run([str(fixture)], select=["resource-discipline"],
                        baseline_path=None).new_findings
    assert len(static) == 1
    assert "`pool.clear_query()` paired with `pool.reserve()`" in static[0].message

    def process(page):
        raise RuntimeError("mid-query failure")

    def leaky(pool, query_id, nbytes):
        pool.reserve(query_id, nbytes)
        process(nbytes)
        pool.clear_query(query_id)

    pool = MemoryPool("general", 1 << 20)
    with pytest.raises(RuntimeError):
        leaky(pool, "q-diff", 4096)
    pool.clear_query("q-diff")            # the end-of-query backstop
    runtime = [f for f in SAN.findings() if f["kind"] == "memory-residue"]
    assert len(runtime) == 1
    assert runtime[0]["query_id"] == "q-diff" and runtime[0]["bytes"] == 4096


def test_q6_differential_row_identical_zero_findings():
    """Sanitized run == uninstrumented run == the reference's rows, and
    zero findings."""
    def port_rows():
        return LocalQueryRunner(Session(catalog="tpch", schema="tiny"), device="cpu") \
            .execute(QUERIES[6]).rows

    leaksan.uninstall()
    baseline = port_rows()
    leaksan.install()
    SAN.reset()
    sanitized = port_rows()
    assert_same_rows(sanitized, baseline)
    ref = RefRunner(RefSession(catalog="tpch", schema="tiny")).execute(REF_QUERIES[6]).rows
    assert_same_rows(sanitized, ref)
    SAN.assert_clean()
    assert SAN.live_counts()["reservations"] == 0


# ------------------------------------------------- all three, port workloads

def test_port_workloads_under_all_three_sanitizers_zero_findings():
    """Q3 at ``tiny`` on one runner, on four logical CPU workers and on a
    cluster of two HTTP workers, with the lock, leak and compile sanitizers
    all installed: equal rows, zero findings from each."""
    from presto_tpu_torch.cluster.coordinator import ClusterQueryRunner
    from presto_tpu_torch.cluster.worker import WorkerServer
    from presto_tpu_torch.parallel.mesh import MeshContext
    from presto_tpu_torch.parallel.runner import DistributedQueryRunner

    session = Session(catalog="tpch", schema="tiny")
    want = LocalQueryRunner(session, device="cpu").execute(QUERIES[3]).rows
    armed = {m: m.enabled() for m in (locksan, compilesan)}
    saved = {m: m.SANITIZER.findings() for m in (locksan, compilesan)}
    for m in armed:
        m.SANITIZER.reset()
        m.install()
    SAN.reset()
    try:
        local = LocalQueryRunner(session, device="cpu").execute(QUERIES[3]).rows
        dist = DistributedQueryRunner(MeshContext([torch.device("cpu")] * 4), session=session,
                                      device="cpu").execute(QUERIES[3]).rows
        cluster = ClusterQueryRunner(session=session, min_workers=2, worker_wait_s=10.0,
                                     device="cpu")
        workers = [WorkerServer(port=0, device="cpu").start() for _ in range(2)]
        try:
            for w in workers:
                cluster.nodes.announce(w.node_id, w.uri)
            clustered = cluster.execute(QUERIES[3]).rows
        finally:
            cluster.detector.stop()
            for w in workers:
                w.stop()
            for w in workers:
                assert w.join_tasks(30.0)
        for rows in (local, dist, clustered):
            assert_same_rows(rows, want)
        locksan.SANITIZER.assert_clean()
        compilesan.SANITIZER.assert_clean()
        SAN.check_exit()
        SAN.assert_clean()
        assert_no_residue(shared_general_pool())
        assert METRICS.snapshot("leaksan")["leaksan.live_bytes"] == 0
    finally:
        for m, was in armed.items():
            if not was:
                m.uninstall()
            m.SANITIZER.reset()
            m.SANITIZER.absorb(saved[m])
