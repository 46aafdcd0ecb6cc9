"""The port's event journal (``presto_tpu_torch/utils/events.py``) and live
query progress (``presto_tpu_torch/exec/progress.py``), on the CPU.

The four journal tests of ``tests/test_events.py`` run on the port's
``EventJournal``, ``test_progress_scope_cleans_up`` on its progress
registry, and a live-progress snapshot is taken while a local query runs:
before its drivers start and after they finish, with the query still live.
The server tests of ``tests/test_events.py`` run against the port's
``PrestoTpuServer`` on the CPU: ``GET /v1/events`` ordering and filtering,
a failed query's forensic at ``GET /v1/query/{id}/trace``, live progress at
``GET /v1/query/{id}`` and the resource groups' admission events; and
``events_http_body`` gives the reference's body for the same journal.
"""
import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from presto_tpu_torch.exec import progress
from presto_tpu_torch.metadata import Session
from presto_tpu_torch.runner import LocalQueryRunner
from presto_tpu_torch.utils import events
from presto_tpu_torch.utils.events import EventJournal


@pytest.fixture(autouse=True)
def _clean_journal():
    events.JOURNAL.clear()
    yield
    events.JOURNAL.clear()
    events.JOURNAL.set_log_path(None)


def test_journal_orders_filters_and_pages():
    j = EventJournal()
    s1 = j.emit("query.submitted", query_id="q1")
    s2 = j.emit("query.submitted", query_id="q2")
    s3 = j.emit("task.retry", severity=events.WARN, query_id="q1",
                task_id="q1.0.0.r1", attempt=1)
    s4 = j.emit("query.failed", severity=events.ERROR, query_id="q1")
    assert [s1, s2, s3, s4] == sorted([s1, s2, s3, s4])
    all_q1 = j.events(query_id="q1")
    assert [e["kind"] for e in all_q1] == ["query.submitted", "task.retry", "query.failed"]
    monos = [e["mono_ns"] for e in all_q1]
    assert monos == sorted(monos)
    assert [e["seq"] for e in j.events(kind="query.")] == [s1, s2, s4]
    assert [e["seq"] for e in j.events(since=s2)] == [s3, s4]
    assert j.events(since=j.last_seq()) == []
    assert len(j.events(limit=2)) == 2


def test_journal_ring_bound_and_drop_count():
    j = EventJournal(max_events=16)
    for i in range(40):
        j.emit("tick", n=i)
    evts = j.events()
    assert len(evts) == 16
    assert j.dropped == 24
    assert [e["n"] for e in evts] == list(range(24, 40))


def test_journal_file_sink_appends_jsonl(tmp_path):
    path = str(tmp_path / "events.jsonl")
    j = EventJournal()
    j.set_log_path(path)
    j.emit("query.submitted", query_id="qx")
    j.emit("query.finished", query_id="qx", rows=3)
    j.set_log_path(None)
    with open(path) as f:
        lines = [json.loads(line) for line in f]
    assert [e["kind"] for e in lines] == ["query.submitted", "query.finished"]
    assert lines[1]["rows"] == 3


def test_emit_never_raises(tmp_path):
    j = EventJournal()
    j.set_log_path(str(tmp_path / "e.jsonl"))
    # an unserializable payload goes through default=str
    assert j.emit("odd", payload=object()) > 0
    j.set_log_path(None)


def test_progress_scope_cleans_up():
    with progress.query_scope("q-scope-test"):
        unreg = progress.register(lambda: {"operators": []})
        assert progress.snapshot("q-scope-test") is not None
        unreg()
        assert progress.snapshot("q-scope-test") is None
        progress.register(lambda: {"operators": []})
    # leaving the scope unregisters what is left
    assert progress.snapshot("q-scope-test") is None
    # with no scope bound, a registration does nothing
    progress.register(lambda: {"operators": []})()
    assert "q-scope-test" not in progress.live_query_ids()


def test_live_progress_while_a_local_query_runs(monkeypatch):
    """Inside a query scope the runner's provider serves the drivers'
    counters while the query is live: all zero before the drivers run, the
    final counts (EXPLAIN ANALYZE's roll-up) after they finish and before
    the query tears down, never decreasing; then the query is gone."""
    from presto_tpu_torch.exec.explain import driver_stats, rollup

    runner = LocalQueryRunner(Session(catalog="tpch", schema="tiny"), device="cpu")
    started, ran, go_on, release = (threading.Event() for _ in range(4))
    seen = {}
    orig = runner._run_drivers

    def gated(drivers):
        seen["drivers"] = drivers
        started.set()
        go_on.wait(30)
        orig(drivers)
        ran.set()
        release.wait(30)

    monkeypatch.setattr(runner, "_run_drivers", gated)
    box = {}

    def run():
        with progress.query_scope("q-live"):
            box["rows"] = runner.execute(
                "select o_orderpriority, count(*) from orders group by 1 order by 1").rows

    t = threading.Thread(target=run)
    t.start()
    try:
        assert started.wait(30)
        assert progress.live_query_ids() == ["q-live"]
        before = progress.snapshot("q-live")
        assert set(before) == {"operators", "memory_reserved_bytes", "pool_steps"}
        assert before["operators"] and all(o["input_rows"] == 0 for o in before["operators"])
        go_on.set()
        assert ran.wait(30)
        after = progress.snapshot("q-live")
        assert after["operators"] == rollup(driver_stats(seen["drivers"]))
        assert any(o["input_rows"] > 0 for o in after["operators"])
        for b, a in zip(before["operators"], after["operators"]):
            assert (a["name"], a["operator_id"]) == (b["name"], b["operator_id"])
            for k in ("input_rows", "output_rows", "blocked_ns", "total_ns"):
                assert a[k] >= b[k]
    finally:
        go_on.set()
        release.set()
        t.join(30)
    assert len(box["rows"]) == 5
    assert progress.snapshot("q-live") is None and progress.live_query_ids() == []


# ---------------------------------------------------------------------------
# HTTP surfaces
# ---------------------------------------------------------------------------

@pytest.fixture()
def server():
    from presto_tpu_torch.server.http_server import PrestoTpuServer

    srv = PrestoTpuServer(
        LocalQueryRunner(Session(catalog="tpch", schema="tiny"), device="cpu"), port=0)
    srv.start()
    yield srv, f"http://127.0.0.1:{srv.port}"
    srv.stop()


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=10) as r:
        return r.read()


def _submit(base, sql):
    req = urllib.request.Request(base + "/v1/statement", data=sql.encode(), method="POST")
    return json.loads(urllib.request.urlopen(req, timeout=10).read())["id"]


def _wait_done(base, qid, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        q = json.loads(_get(base, f"/v1/query/{qid}"))
        if q["state"] in ("FAILED", "FINISHED", "CANCELED"):
            return q
        time.sleep(0.02)
    raise AssertionError(f"query {qid} never finished")


def test_events_http_ordering_and_filtering(server):
    _srv, base = server
    qid_ok = _submit(base, "select count(*) from nation")
    assert _wait_done(base, qid_ok)["state"] == "FINISHED"
    qid_bad = _submit(base, "select no_such_column from nation")
    assert _wait_done(base, qid_bad)["state"] == "FAILED"

    doc = json.loads(_get(base, f"/v1/events?query_id={qid_ok}"))
    kinds = [e["kind"] for e in doc["events"]]
    assert kinds[0] == "query.submitted" and "query.finished" in kinds
    assert all(e["query_id"] == qid_ok for e in doc["events"])

    doc_bad = json.loads(_get(base, f"/v1/events?query_id={qid_bad}"))
    bad_kinds = [e["kind"] for e in doc_bad["events"]]
    assert "query.failed" in bad_kinds and "query.finished" not in bad_kinds
    failed = next(e for e in doc_bad["events"] if e["kind"] == "query.failed")
    assert failed["severity"] == "error" and failed["forensic"] is True

    # since= pagination across the whole journal
    first_seq = json.loads(_get(base, "/v1/events"))["events"][0]["seq"]
    after = json.loads(_get(base, f"/v1/events?since={first_seq}"))
    assert all(e["seq"] > first_seq for e in after["events"])
    # bad params are a 400, not a stack
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(base, "/v1/events?since=abc")
    assert ei.value.code == 400


def test_failed_query_serves_forensic_trace_over_http(server):
    """A query that never opted into tracing still serves a Chrome trace
    at /v1/query/{id}/trace after it fails (the black box)."""
    _srv, base = server
    qid = _submit(base, "select no_such_column from nation")
    q = _wait_done(base, qid)
    assert q["state"] == "FAILED" and q["hasFailureTrace"]
    doc = json.loads(_get(base, f"/v1/query/{qid}/trace"))
    assert isinstance(doc["traceEvents"], list)
    assert doc["otherData"]["coarse"] is True


def test_live_progress_is_monotone_while_running(server, monkeypatch):
    """GET /v1/query/{id} on a RUNNING query returns per-operator live
    counters, and they only grow across polls. The query's drivers are held
    between steps so that polls land while it runs."""
    from presto_tpu_torch.exec import driver as driver_mod

    _srv, base = server
    step = driver_mod.Driver._process_once

    def slow_step(self):
        time.sleep(0.002)
        return step(self)
    monkeypatch.setattr(driver_mod.Driver, "_process_once", slow_step)
    sql = ("select l_linenumber, count(*) c from lineitem group by l_linenumber "
           "order by c desc")
    qid = _submit(base, sql)
    snaps = []
    while True:
        q = json.loads(_get(base, f"/v1/query/{qid}"))
        if q["state"] in ("FAILED", "FINISHED"):
            break
        if q["state"] == "RUNNING" and q.get("progress"):
            snaps.append(q["progress"])
        time.sleep(0.01)
    assert q["state"] == "FINISHED", q
    assert len(snaps) >= 2, "no RUNNING progress observed"
    keys = ("input_rows", "output_rows", "blocked_ns")
    for prev, cur in zip(snaps, snaps[1:]):
        prev_ops = {(o.get("pipeline", 0), o.get("operator_id"), o["name"]): o
                    for o in prev["operators"]}
        for o in cur["operators"]:
            p = prev_ops.get((o.get("pipeline", 0), o.get("operator_id"), o["name"]))
            if p is None:
                continue
            for k in keys:
                assert o.get(k, 0) >= p.get(k, 0), (o["name"], k, p, o)
    assert "memory_reserved_bytes" in snaps[-1]
    assert "pool_steps" in snaps[-1]


def test_resource_group_admission_events():
    from presto_tpu_torch.server.resource_groups import (GroupSpec, QueryRejected,
                                                         ResourceGroupManager)

    rg = ResourceGroupManager(GroupSpec("root", hard_concurrency_limit=1, max_queued=1))
    t1 = rg.submit("q1")
    assert [e["kind"] for e in events.JOURNAL.events(query_id="q1")] == ["query.admitted"]

    # the second query queues; the third is rejected (queue full)
    box = {}

    def submit_blocking():
        box["t2"] = rg.submit("q2", timeout_s=30.0)

    t = threading.Thread(target=submit_blocking)
    t.start()
    deadline = time.monotonic() + 5.0
    while not events.JOURNAL.events(query_id="q2", kind="query.queued"):
        assert time.monotonic() < deadline, "q2 never queued"
        time.sleep(0.01)
    with pytest.raises(QueryRejected):
        rg.submit("q3", timeout_s=0.1)
    assert events.JOURNAL.events(query_id="q3", kind="query.rejected")

    rg.finish(t1)
    t.join(timeout=10.0)
    assert not t.is_alive()
    admitted = events.JOURNAL.events(query_id="q2", kind="query.admitted")
    assert admitted and admitted[0]["promoted"] is True
    rg.finish(box["t2"])


@pytest.mark.parametrize("query", ["", "query_id=q1", "kind=query.", "since=2", "limit=2",
                                   "since=2&kind=task.&query_id=q1", "since=abc",
                                   "limit=x"])
def test_events_http_body_equal_reference(query):
    """The same journal renders the same body and status in both packages
    (the stamps and sequence numbers are the port journal's own, copied)."""
    from presto_tpu.utils import events as ref_events

    saved = list(ref_events.JOURNAL._events), ref_events.JOURNAL.dropped
    try:
        events.JOURNAL.emit("query.submitted", query_id="q1")
        events.JOURNAL.emit("query.submitted", query_id="q2")
        events.JOURNAL.emit("task.retry", severity=events.WARN, query_id="q1", attempt=1)
        events.JOURNAL.emit("query.failed", severity=events.ERROR, query_id="q1")
        snapshot = events.JOURNAL.events()
        base = snapshot[0]["seq"]
        evts = [dict(e, seq=e["seq"] - base + 1) for e in snapshot]
        with events.JOURNAL._lock:
            events.JOURNAL._events.clear()
            events.JOURNAL._events.extend(evts)
        with ref_events.JOURNAL._lock:
            ref_events.JOURNAL._events.clear()
            ref_events.JOURNAL._events.extend(dict(e) for e in evts)
            ref_events.JOURNAL.dropped = events.JOURNAL.dropped
        got_body, got_status = events.events_http_body(query)
        want_body, want_status = ref_events.events_http_body(query)
        got, want = json.loads(got_body), json.loads(want_body)
        assert got_status == want_status
        if got_status == 200:
            assert got["events"] == want["events"] and got["dropped"] == want["dropped"]
        else:
            assert got == want
    finally:
        with ref_events.JOURNAL._lock:
            ref_events.JOURNAL._events.clear()
            ref_events.JOURNAL._events.extend(saved[0])
            ref_events.JOURNAL.dropped = saved[1]
