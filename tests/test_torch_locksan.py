"""The port's lock sanitizer (presto_tpu_torch/utils/locksan.py), case for
case against tests/test_locksan.py, on the CPU.

Unit level: the acquisition-order graph, an inverted two-lock deadlock
found without hanging (the cycle is reported when its edge is added,
before any blocking), wait-while-held findings, the hold and wait
histograms in the port's METRICS, RLock reentrancy, condition wait and
notify, install hygiene and the dump. Differential: TPC-H Q3 at ``tiny``
with every port lock instrumented gives the rows of the uninstrumented
run and of the reference's runner, with zero findings.

Also here: both packages' lock and leak sanitizers installed in one
process, a port query under them, and the unwinding back to the stdlib's
primitives.
"""
import _thread
import json
import threading
import time

import pytest

from presto_tpu.metadata import Session as RefSession
from presto_tpu.models.tpch_sql import QUERIES as REF_QUERIES
from presto_tpu.runner import LocalQueryRunner as RefRunner
from presto_tpu.utils import leaksan as ref_leaksan
from presto_tpu.utils import locksan as ref_locksan
from presto_tpu_torch.metadata import Session
from presto_tpu_torch.models.tpch_sql import QUERIES
from presto_tpu_torch.runner import LocalQueryRunner
from presto_tpu_torch.utils import leaksan, locksan
from presto_tpu_torch.utils.metrics import METRICS
from test_torch_sql import assert_same_rows

SAN = locksan.SANITIZER


@pytest.fixture(autouse=True)
def _fresh_sanitizer():
    """Isolate each deliberate violation without losing what the engine
    recorded before this module: earlier findings are absorbed back after,
    and an env-driven install survives."""
    env_installed = locksan.enabled()
    engine_findings = SAN.findings()
    SAN.reset()
    yield
    SAN.reset()
    if env_installed:
        locksan.install()
    else:
        locksan.uninstall()
    SAN.absorb(engine_findings)


def _port_q3_rows():
    return LocalQueryRunner(Session(catalog="tpch", schema="tiny"), device="cpu") \
        .execute(QUERIES[3]).rows


# ----------------------------------------------------------- order graph

def test_order_graph_records_nesting_edges():
    a = locksan.Lock(name="A")
    b = locksan.Lock(name="B")
    c = locksan.Lock(name="C")
    with a:
        with b:
            with c:
                pass
    g = SAN.order_graph()
    assert "B" in g["A"] and "C" in g["A"]
    assert "C" in g["B"]
    assert g.get("C", []) == []
    assert SAN.findings() == []
    # each edge carries its first acquisition site
    assert all(e["site"].startswith("tests/test_torch_locksan.py:") for e in SAN.edges())


def test_inverted_two_lock_deadlock_detected_without_hanging():
    """A -> B then B -> A: the second order closes a cycle and is reported
    at the acquire attempt, with no real contention, so nothing hangs."""
    a = locksan.Lock(name="locka")
    b = locksan.Lock(name="lockb")
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    assert [f["kind"] for f in SAN.findings()] == ["order-cycle"], SAN.report()
    msg = SAN.findings()[0]["message"]
    assert "locka" in msg and "lockb" in msg and "deadlock" in msg


def test_consistent_order_stays_clean():
    a = locksan.Lock(name="c1")
    b = locksan.Lock(name="c2")
    for _ in range(3):
        with a:
            with b:
                pass
    assert SAN.findings() == []


def test_three_lock_cycle_detected():
    a = locksan.Lock(name="t1")
    b = locksan.Lock(name="t2")
    c = locksan.Lock(name="t3")
    for x, y in ((a, b), (b, c), (c, a)):
        with x:
            with y:
                pass
    f = SAN.findings()
    assert len(f) == 1 and f[0]["kind"] == "order-cycle"
    assert {"t1", "t2", "t3"} <= set(f[0]["locks"])


# ------------------------------------------------------------ histograms

def test_hold_time_histogram_plumbing():
    before = METRICS.histogram_summary("locksan.hold_s").get("count", 0)
    lk = locksan.Lock(name="held")
    with lk:
        time.sleep(0.002)
    after = METRICS.histogram_summary("locksan.hold_s")
    assert after["count"] >= before + 1 and after["p99"] > 0
    stats = SAN.lock_stats()
    assert stats["held"]["hold"]["count"] == 1
    assert stats["held"]["hold"]["p50"] >= 0.002


def test_contention_wait_histogram_plumbing():
    before = METRICS.histogram_summary("locksan.wait_s").get("count", 0)
    lk = locksan.Lock(name="contended")
    started = threading.Event()

    def holder():
        with lk:
            started.set()
            time.sleep(0.02)

    t = threading.Thread(target=holder)
    t.start()
    assert started.wait(2.0)
    with lk:     # contends with the holder: a recorded wait
        pass
    t.join(2.0)
    assert not t.is_alive()
    assert METRICS.histogram_summary("locksan.wait_s")["count"] >= before + 1
    assert SAN.lock_stats()["contended"]["wait"]["count"] >= 1
    assert SAN.findings() == []   # contention is a histogram, not a finding


# -------------------------------------------------------- wait-while-held

def test_condition_wait_while_holding_another_lock_is_flagged():
    other = locksan.Lock(name="outer")
    cv = locksan.Condition(name="cv")
    with other:
        with cv:
            cv.wait(timeout=0.01)
    f = [x for x in SAN.findings() if x["kind"] == "wait-while-held"]
    assert len(f) == 1, SAN.report()
    assert "outer" in f[0]["message"]


def test_condition_wait_alone_is_clean_and_wakes():
    cv = locksan.Condition(name="cv2")
    state = []

    def waiter():
        with cv:
            while not state:
                cv.wait(timeout=1.0)
            state.append("seen")

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.02)
    with cv:
        state.append("go")
        cv.notify_all()
    t.join(2.0)
    assert not t.is_alive() and state == ["go", "seen"]
    assert SAN.findings() == []


def test_condition_wait_for_predicate():
    cv = locksan.Condition(name="cv3")
    box = []

    def producer():
        time.sleep(0.02)
        with cv:
            box.append(1)
            cv.notify_all()

    t = threading.Thread(target=producer)
    t.start()
    with cv:
        assert cv.wait_for(lambda: box, timeout=2.0)
    t.join(2.0)
    assert not t.is_alive()
    assert SAN.findings() == []


def test_rlock_reentrancy_no_self_edges():
    rl = locksan.RLock(name="re")
    with rl:
        with rl:
            pass
    assert SAN.findings() == []
    assert "re" not in SAN.order_graph().get("re", [])


# -------------------------------------------------------------- install

def test_install_instruments_repo_locks_only():
    locksan.install()
    try:
        assert locksan.enabled()
        lk = threading.Lock()      # this file is under the repository root
        assert type(lk) is locksan._SanLock
        assert "test_torch_locksan" in lk.name
        import queue
        q = queue.Queue()          # a stdlib allocation stays raw
        assert not isinstance(q.mutex, locksan._SanLock)
    finally:
        locksan.uninstall()
    assert not locksan.enabled()
    assert not isinstance(threading.Lock(), locksan._SanLock)


def test_dump_roundtrip(tmp_path):
    a = locksan.Lock(name="d1")
    b = locksan.Lock(name="d2")
    with a:
        with b:
            pass
    path = SAN.dump(str(tmp_path / "locksan.json"))
    with open(path) as f:
        doc = json.load(f)
    assert {"edges", "findings", "locks", "lock_stats"} <= set(doc)
    assert any(e["held"] == "d1" and e["acquired"] == "d2" for e in doc["edges"])


# ------------------------------------------------------- Q3 differential

def test_locksan_on_q3_differential_row_identical_zero_findings():
    """Q3 with every port lock allocated under the sanitizer equals the
    uninstrumented run and the reference's runner, with zero findings and
    hold times recorded."""
    baseline = _port_q3_rows()
    assert len(baseline) == 10
    ref = RefRunner(RefSession(catalog="tpch", schema="tiny")).execute(REF_QUERIES[3]).rows
    assert_same_rows(baseline, ref)

    SAN.reset()
    before = METRICS.histogram_summary("locksan.hold_s").get("count", 0)
    locksan.install()
    try:
        sanitized = _port_q3_rows()
    finally:
        locksan.uninstall()
    assert_same_rows(sanitized, baseline)
    SAN.assert_clean()
    assert METRICS.histogram_summary("locksan.hold_s")["count"] > before
    assert isinstance(SAN.order_graph(), dict)


# ---------------------------------------------------------- two packages

def _is_stdlib():
    return (threading.Lock is _thread.allocate_lock
            and threading.RLock.__module__ == "threading"
            and isinstance(threading.Condition, type)
            and threading.Condition.__module__ == "threading"
            and threading.Thread.start.__module__ == "threading")


def test_both_packages_sanitizers_stack_and_unwind():
    """The reference's lock and leak sanitizers, then the port's, in one
    process: a port query runs clean under both, neither records the
    other's bookkeeping, and LIFO uninstalls leave the stdlib's objects."""
    # a sanitizer armed from the environment steps aside for the test
    mods = (ref_locksan, ref_leaksan, locksan, leaksan)
    armed = [m for m in mods if m.enabled()]
    for m in reversed(mods):
        m.uninstall()
    assert _is_stdlib()
    ref_lock_findings = ref_locksan.SANITIZER.findings()
    ref_leak_findings = ref_leaksan.SANITIZER.findings()
    port_leak_findings = leaksan.SANITIZER.findings()
    for san in (ref_locksan.SANITIZER, ref_leaksan.SANITIZER, leaksan.SANITIZER):
        san.reset()
    ref_locksan.install()
    ref_leaksan.install()
    ref_factory = threading.Lock
    try:
        locksan.install()
        leaksan.install()
        try:
            assert threading.Lock is locksan._lock_factory
            rows = _port_q3_rows()
        finally:
            leaksan.uninstall()
            locksan.uninstall()
        # the port's unwinding puts the reference's factories back
        assert threading.Lock is ref_factory
        assert threading.Thread.start.__module__.endswith("leaksan")
    finally:
        ref_leaksan.uninstall()
        ref_locksan.uninstall()
    try:
        assert _is_stdlib()
        assert len(rows) == 10
        SAN.assert_clean()
        leaksan.SANITIZER.check_exit()
        leaksan.SANITIZER.assert_clean()
        ref_locksan.SANITIZER.assert_clean()
        ref_leaksan.SANITIZER.assert_clean()
        # each sanitizer's own lock is a stdlib primitive
        raw = type(_thread.allocate_lock())
        for san in (SAN, leaksan.SANITIZER, ref_locksan.SANITIZER, ref_leaksan.SANITIZER):
            assert type(san._meta) is raw
        # the port instrumented the port's locks, the reference none of them
        port_names = list(SAN.lock_stats())
        assert port_names and all(n.startswith("presto_tpu_torch/") for n in port_names)
        assert not any("/utils/locksan.py" in n or "/utils/leaksan.py" in n
                       for n in port_names)
        assert not any(n.startswith("presto_tpu_torch/")
                       for n in ref_locksan.SANITIZER.lock_stats())
        assert ref_locksan.SANITIZER.edges() == []
    finally:
        ref_locksan.SANITIZER.reset()
        ref_locksan.SANITIZER.absorb(ref_lock_findings)
        ref_leaksan.SANITIZER.reset()
        ref_leaksan.SANITIZER.absorb(ref_leak_findings)
        leaksan.SANITIZER.reset()
        leaksan.SANITIZER.absorb(port_leak_findings)
        for m in armed:
            m.install()
