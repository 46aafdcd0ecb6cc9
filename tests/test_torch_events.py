"""The port's event journal (``presto_tpu_torch/utils/events.py``) and live
query progress (``presto_tpu_torch/exec/progress.py``), on the CPU.

The four journal tests of ``tests/test_events.py`` run on the port's
``EventJournal``, ``test_progress_scope_cleans_up`` on its progress
registry, and a live-progress snapshot is taken while a local query runs:
before its drivers start and after they finish, with the query still live.
"""
import json
import threading

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
