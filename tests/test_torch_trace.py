"""The port's flight recorder (``presto_tpu_torch/utils/trace.py``) against
the reference's, on the CPU at ``tiny``.

The local cases of ``tests/test_trace.py``: the recorder's mechanics run
the same calls through both modules and compare what they hold; the
engine cases run the same statements through both runners and compare
rows exactly, the ``lifecycle`` spans' names and nesting (never their
times) and the categories present. The ``kernel`` category is left out of
that comparison: a span there marks a kernel-cache miss, which depends on
what the process ran before (``ROADMAP.md`` §3). The number of ``driver``
spans follows the clock and is never compared.
"""
import json
import threading

import pytest

from presto_tpu.metadata import Session as RefSession
from presto_tpu.models.tpch_sql import QUERIES as REF_QUERIES
from presto_tpu.ops.scan import RESIDENT_CACHE as REF_RESIDENT_CACHE
from presto_tpu.runner import LocalQueryRunner as RefRunner
from presto_tpu.utils import events as ref_events
from presto_tpu.utils import trace as ref_trace
from presto_tpu_torch.metadata import Session
from presto_tpu_torch.models.tpch_sql import QUERIES
from presto_tpu_torch.ops.scan import RESIDENT_CACHE
from presto_tpu_torch.runner import LocalQueryRunner
from presto_tpu_torch.utils import events, trace
from presto_tpu_torch.utils.metrics import METRICS
from test_torch_sql import assert_same_rows

BOTH = {"port": trace, "reference": ref_trace}
FAILING_SQL = "select definitely_missing from lineitem"


def _port(props=None):
    return LocalQueryRunner(Session(catalog="tpch", schema="tiny",
                                    properties=dict(props or {})), device="cpu")


def _ref(props=None):
    return RefRunner(RefSession(catalog="tpch", schema="tiny", properties=dict(props or {})))


def _lifecycle(doc):
    """The lifecycle spans in start order, each with its innermost
    enclosing lifecycle span's name."""
    spans = sorted((e for e in doc["traceEvents"]
                    if e.get("ph") == "X" and e["cat"] == trace.LIFECYCLE),
                   key=lambda e: (e["ts"], -e["dur"]))
    out = []
    for e in spans:
        parents = [p for p in spans if p is not e and p["ts"] <= e["ts"]
                   and p["ts"] + p["dur"] >= e["ts"] + e["dur"]]
        parent = min(parents, key=lambda p: p["dur"]) if parents else None
        out.append((e["name"], parent["name"] if parent else None))
    return out


# ---------------------------------------------------------------- recorder

def _events_of(mod, fill):
    rec = mod.TraceRecorder("t", max_events=16)
    fill(rec)
    return rec, [e[:4] + e[6:] for e in rec.events()]  # (cat, name, t0, dur, args)


def test_ring_buffer_bounds_and_drop_count():
    def fill(rec):
        for i in range(40):
            rec.record("driver", f"e{i}", i, 1, {"i": i} if i % 2 else None)

    rec, got = _events_of(trace, fill)
    ref_rec, want = _events_of(ref_trace, fill)
    assert got == want and len(got) == 16
    assert rec.dropped == ref_rec.dropped == 24
    assert [e[1] for e in got] == [f"e{i}" for i in range(24, 40)]
    assert rec.count() == 16 and rec.count("driver") == 16 and rec.count("scan") == 0


def test_constants_equal_the_reference():
    for name in ("DEFAULT_MAX_EVENTS", "BLACKBOX_MAX_EVENTS", "_COARSE_DROP",
                 "MIN_OPERATOR_SPAN_NS", "LIFECYCLE", "DRIVER", "OPERATOR", "SEGMENT",
                 "SCAN", "EXCHANGE", "KERNEL", "HTTP", "POOL"):
        assert getattr(trace, name) == getattr(ref_trace, name), name


@pytest.mark.parametrize("pkg", sorted(BOTH))
def test_span_context_manager_and_module_helpers(pkg):
    mod = BOTH[pkg]
    rec = mod.TraceRecorder("t")
    with rec.span("scan", "read", reader=3):
        pass
    (cat, name, t0, dur, tid, tname, args), = rec.events()
    assert cat == "scan" and name == "read" and args == {"reader": 3}
    assert tid == threading.get_ident() and dur >= 0

    # the module helpers do nothing until a recorder is installed
    assert mod.active() is None
    mod.record("driver", "ghost", 0, 1)
    mod.instant("driver", "ghost2")
    with mod.span("driver", "ghost3"):
        pass
    assert rec.count() == 1

    assert mod.install(rec)
    try:
        mod.record("driver", "real", 0, 1)
        with mod.span("kernel", "build"):
            pass
        mod.instant("segment", "compile x")
    finally:
        mod.uninstall(rec)
    assert mod.active() is None
    assert [(e[0], e[1]) for e in rec.events()] == [
        ("scan", "read"), ("driver", "real"), ("kernel", "build"), ("segment", "compile x")]


def test_per_query_scoping_threads_record_separately():
    """Each thread's install binds its own recorder, ``bound`` hands one to
    a worker thread and restores the binding after."""
    rec_a = trace.TraceRecorder("a")
    rec_b = trace.TraceRecorder("b")
    ready = threading.Barrier(2)
    done = threading.Barrier(2)

    def query(rec, name):
        assert trace.install(rec)
        try:
            ready.wait(timeout=10)
            trace.record("driver", name, 0, 1)
            done.wait(timeout=10)
        finally:
            trace.uninstall(rec)

    t = threading.Thread(target=query, args=(rec_b, "from-b"))
    t.start()
    query(rec_a, "from-a")
    t.join(timeout=10)
    assert [e[1] for e in rec_a.events()] == ["from-a"]
    assert [e[1] for e in rec_b.events()] == ["from-b"]

    rec = trace.TraceRecorder("w")
    seen = {}

    def worker():
        with trace.bound(rec):
            trace.record("scan", "bound-span", 0, 1)
        seen["after"] = trace.active()
    w = threading.Thread(target=worker)
    w.start()
    w.join(timeout=10)
    assert [e[1] for e in rec.events()] == ["bound-span"] and seen["after"] is None


def test_chrome_trace_schema(tmp_path):
    """The same spans give the same document in both packages, but for the
    process name."""
    docs = {}
    for pkg, mod in BOTH.items():
        rec = mod.TraceRecorder("q42")
        rec.record("exchange", "chunk_dispatch f1", rec.t0_ns + 5_000, 2_000, {"chunk": 1})
        rec.record("scan", "read", rec.t0_ns + 9_000, 500)
        docs[pkg] = json.load(open(rec.write(str(tmp_path / f"{pkg}.json"))))
    doc = docs["port"]
    assert doc["otherData"] == {"query_id": "q42", "dropped_events": 0, "coarse": False}
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    metas = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    assert len(spans) == 2 and len(metas) == 2  # process and thread names
    e = spans[0]
    assert set(e) >= {"name", "cat", "ph", "ts", "dur", "pid", "tid"}
    assert e["ts"] == pytest.approx(5.0) and e["dur"] == pytest.approx(2.0)
    assert spans == [e for e in docs["reference"]["traceEvents"] if e["ph"] == "X"]
    assert doc["otherData"] == docs["reference"]["otherData"]
    assert metas[0]["args"]["name"] == "presto-tpu-torch q42"


OVERLAP_DOCS = {
    "half": ({"traceEvents": [
        {"ph": "X", "cat": "a", "ts": 0.0, "dur": 10.0},
        {"ph": "X", "cat": "a", "ts": 20.0, "dur": 10.0},
        {"ph": "X", "cat": "b", "ts": 5.0, "dur": 10.0},
        {"ph": "X", "cat": "b", "ts": 25.0, "dur": 100.0}]}, 0.5),
    "merged spans": ({"traceEvents": [
        {"ph": "X", "cat": "a", "ts": 0.0, "dur": 10.0},
        {"ph": "X", "cat": "a", "ts": 5.0, "dur": 10.0},
        {"ph": "X", "cat": "b", "ts": 0.0, "dur": 3.0},
        {"ph": "X", "cat": "b", "ts": 2.0, "dur": 2.0},
        {"ph": "M", "cat": "b", "ts": 0.0, "dur": 100.0}]}, 4.0 / 15.0),
    "empty": ({"traceEvents": []}, 0.0),
}


@pytest.mark.parametrize("case", sorted(OVERLAP_DOCS))
def test_overlap_ratio_math(case):
    doc, want = OVERLAP_DOCS[case]
    got = trace.overlap_ratio(doc, "a", "b")
    assert got == pytest.approx(want) and got == ref_trace.overlap_ratio(doc, "a", "b")
    assert trace.overlap_ratio(doc, "a", "missing") == 0.0
    assert trace.span_categories(doc) == ref_trace.span_categories(doc)


def test_maybe_recorder_modes():
    cases = [({}, True, trace.BLACKBOX_MAX_EVENTS),
             ({"query_blackbox_max_events": 100}, True, 100),
             ({"query_trace": True}, False, trace.DEFAULT_MAX_EVENTS),
             ({"query_trace": True, "query_trace_max_events": 64}, False, 64),
             ({"query_trace": True, "query_blackbox": False}, False,
              trace.DEFAULT_MAX_EVENTS)]
    for props, coarse, max_events in cases:
        got = trace.maybe_recorder(Session(catalog="tpch", schema="tiny", properties=props))
        want = ref_trace.maybe_recorder(RefSession(catalog="tpch", schema="tiny",
                                                   properties=props))
        assert (got.coarse, got.max_events) == (want.coarse, want.max_events) == \
            (coarse, max_events), props
    assert trace.maybe_recorder(Session(properties={"query_blackbox": False})) is None


def test_coarse_recorder_drops_per_page_categories():
    got = {}
    for pkg, mod in BOTH.items():
        rec = mod.TraceRecorder("q", max_events=64, coarse=True)
        for cat in (mod.OPERATOR, mod.SEGMENT, mod.DRIVER, mod.EXCHANGE, mod.POOL,
                    mod.SCAN, mod.KERNEL):
            rec.record(cat, "x", 0, 100)
        got[pkg] = [e[0] for e in rec.events()]
    assert got["port"] == got["reference"] == [
        trace.DRIVER, trace.EXCHANGE, trace.POOL, trace.SCAN, trace.KERNEL]


# ------------------------------------------------------- engine integration

ENGINE_SQL = {
    "q3": (QUERIES[3], REF_QUERIES[3]),
    "explain analyze q6": ("explain analyze " + QUERIES[6], "explain analyze " + REF_QUERIES[6]),
    "ctas": ("create table memory.default.traced_nation as select * from nation",) * 2,
    "show tables": ("show tables",) * 2,
}


@pytest.fixture(scope="module")
def traced_runs(tmp_path_factory):
    """Each statement of ``ENGINE_SQL`` traced in both packages, after cold
    scans: {case: (port result, reference result, port doc, reference
    doc)}."""
    out = {}
    for case, (sql, ref_sql) in ENGINE_SQL.items():
        d = str(tmp_path_factory.mktemp("trace"))
        props = {"query_trace": True, "query_trace_dir": d}
        REF_RESIDENT_CACHE.clear()
        want = _ref(props).execute(ref_sql)
        RESIDENT_CACHE.clear()
        got = _port(props).execute(sql)
        out[case] = (got, want, json.load(open(got.trace_path)),
                     json.load(open(want.trace_path)))
    return out


@pytest.mark.parametrize("case", sorted(ENGINE_SQL))
def test_lifecycle_spans_nest_as_the_reference(traced_runs, case):
    got, want, doc, ref_doc = traced_runs[case]
    if case != "explain analyze q6":  # its text carries the walls
        assert_same_rows(got.rows, want.rows)
    assert _lifecycle(doc) == _lifecycle(ref_doc)
    assert _lifecycle(doc)[:2] == [("query", None), ("parse", "query")]
    cats = set(trace.span_categories(doc)) - {trace.KERNEL}
    assert cats == set(ref_trace.span_categories(ref_doc)) - {ref_trace.KERNEL}
    assert doc["otherData"]["coarse"] is False and doc["otherData"]["dropped_events"] == 0


def test_local_trace_export_has_subsystem_spans(traced_runs):
    """A cold Q3: lifecycle phases, driver quanta, operator calls, scan
    stages, pool steps and fused-segment dispatches are all on the
    timeline, and the query-wall histogram has its percentiles."""
    _, _, doc, _ = traced_runs["q3"]
    cats = trace.span_categories(doc)
    for want in ("lifecycle", "driver", "operator", "scan", "pool", "segment"):
        assert cats.get(want, 0) > 0, (want, cats)
    names = {e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"}
    assert {"query", "parse", "plan", "local_plan", "execute"} <= names
    assert any(n.startswith("FusedSegment[") for n in names)
    assert "scan_step" in names
    # a share of the scan's busy time, up to float rounding of the sums
    assert 0.0 <= trace.overlap_ratio(doc, "scan", "driver") <= 1.0 + 1e-9
    snap = METRICS.snapshot("query.wall_s")
    assert snap["query.wall_s.count"] >= 1
    assert snap["query.wall_s.p99"] >= snap["query.wall_s.p50"] > 0


def test_tracing_off_is_a_noop_differential():
    """Q3's rows are the same traced, untraced, with the black box off and
    in the reference; only the traced run has a ``trace_path``, and no
    recorder outlives its query."""
    plain = _port().execute(QUERIES[3])
    off = _port({"query_blackbox": False}).execute(QUERIES[3])
    on = _port({"query_trace": True}).execute(QUERIES[3])
    assert plain.rows == off.rows == on.rows
    assert_same_rows(on.rows, _ref().execute(REF_QUERIES[3]).rows)
    assert plain.trace_path is None and off.trace_path is None and on.trace_path
    assert trace.active() is None


def test_blackbox_success_exports_nothing_failure_dumps_forensic(tmp_path):
    props = {"query_trace_dir": str(tmp_path)}
    runner = _port(props)
    ok = runner.execute(QUERIES[6])
    assert ok.trace_path is None
    assert trace.active() is None
    assert list(tmp_path.iterdir()) == []  # success writes no files
    seq = events.JOURNAL.last_seq()
    with pytest.raises(Exception) as got:
        runner.execute(FAILING_SQL)
    with pytest.raises(Exception) as want:
        _ref(props).execute(FAILING_SQL)
    assert type(got.value).__name__ == type(want.value).__name__
    path = getattr(got.value, "failure_trace_path", None)
    assert path and path.startswith(str(tmp_path))
    doc = json.load(open(path))
    ref_doc = json.load(open(want.value.failure_trace_path))
    assert doc["otherData"]["coarse"] is True
    # the failure is the analysis's: it ends the plan span
    assert _lifecycle(doc) == _lifecycle(ref_doc) == [
        ("query", None), ("parse", "query"), ("plan", "query")]
    dumped = events.JOURNAL.events(since=seq, kind="query.forensic_dumped")
    ref_dumped = ref_events.JOURNAL.events(kind="query.forensic_dumped")
    assert dumped and dumped[-1]["path"] == path
    assert dumped[-1]["error"] == ref_dumped[-1]["error"]
    assert dumped[-1]["severity"] == ref_dumped[-1]["severity"] == "error"
    assert trace.active() is None


def test_blackbox_off_is_off():
    with pytest.raises(Exception) as ei:
        _port({"query_blackbox": False}).execute(FAILING_SQL)
    assert getattr(ei.value, "failure_trace_path", None) is None


def test_full_trace_still_wins_for_failed_queries(tmp_path):
    """``query_trace`` on and a failure: the forensic rides the exception
    with the full (not coarse) ring."""
    with pytest.raises(Exception) as ei:
        _port({"query_trace": True, "query_trace_dir": str(tmp_path)}).execute(FAILING_SQL)
    path = getattr(ei.value, "failure_trace_path", None)
    assert path
    assert json.load(open(path))["otherData"]["coarse"] is False


def test_failure_in_execution_dumps_the_execute_span(tmp_path):
    """A query that fails while its drivers run (over its memory limit):
    the forensic holds the lifecycle spans up to ``execute``, as the
    reference's does, and the scan stage's read that ran into the limit."""
    props = {"query_trace_dir": str(tmp_path), "query_max_memory_bytes": 1000}
    RESIDENT_CACHE.clear()
    REF_RESIDENT_CACHE.clear()
    with pytest.raises(Exception) as got:
        _port(props).execute(QUERIES[3])
    with pytest.raises(Exception) as want:
        _ref(props).execute(REF_QUERIES[3])
    assert str(got.value) == str(want.value)
    doc = json.load(open(got.value.failure_trace_path))
    ref_doc = json.load(open(want.value.failure_trace_path))
    assert _lifecycle(doc) == _lifecycle(ref_doc)
    assert ("execute", "query") in _lifecycle(doc)
    assert trace.span_categories(doc).get("scan", 0) > 0
