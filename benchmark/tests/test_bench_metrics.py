"""The readers and the arithmetic under them, on small recorded inputs."""
import json

import pytest

from benchmark.core import harness, intervals, roofline, spec
from benchmark.core.devtrace import MARKER, DeviceProfile, read_spans

MS = 1_000_000  # ns
# the kernels' names as the profiler gives them on the card
PROBE = "(anonymous namespace)::ht_probe_rows(long const*, int const*, int, long const*)"
INSERT = "(anonymous namespace)::ht_insert_rounds((anonymous namespace)::InsertArgs)"


def test_union_gaps_and_innermost():
    ivals = [(0, 10), (5, 20), (30, 40), (35, 36), (50, 60)]
    assert intervals.merge(ivals) == [(0, 20), (30, 40), (50, 60)]
    assert intervals.union_length(ivals, 10, 55) == 10 + 10 + 5
    assert intervals.gaps(ivals, 0, 70) == [(20, 30), (40, 50), (60, 70)]
    spans = [(0, 100, "lifecycle:execute"), (10, 20, "operator:probe"), (0, 200, "lifecycle:query")]
    assert intervals.innermost(spans, 15) == "operator:probe"
    assert intervals.innermost(spans, 50) == "lifecycle:execute"
    assert intervals.innermost(spans, 150) == "lifecycle:query"
    assert intervals.innermost(spans, 250) is None


def test_p90_counts_the_queries_in_flight():
    # nine answered in 1 s, one still running at the close after 30 s
    assert harness.p90([1.0] * 9 + [30.0]) == 1.0
    assert harness.p90([1.0] * 8 + [30.0, 31.0]) == 30.0
    assert harness.p90([2.0]) == 2.0


def test_insert_bytes_match_the_kernel_tables_bound():
    # PERF.md's kernel table: n = 2^21, one component, 2^22 slots: 77.6 MB
    # counting every row's key (0.0232 ms); the rule counts live rows only
    n, slots = 1 << 21, 1 << 22
    assert roofline.insert_bytes(n, n, 1, slots) == n * 8 + n + slots * 8 + slots * 4 + n * 4 + 12
    assert roofline.bound_s(roofline.insert_bytes(n, n, 1, slots)) * 1e3 == pytest.approx(0.0232, abs=5e-5)
    # the unfused Q3 grouping: 6 comps, n = 2^20, 3,870 live, 8,192 slots: 5.85 MB
    assert roofline.insert_bytes(1 << 20, 3870, 6, 8192) / 1e6 == pytest.approx(5.85, abs=0.01)


def test_probe_bytes_stay_under_the_kernel_tables_walk():
    # the table's probe (2^20 rows, 90% live, 2^22 slots) counted 43.2 MB by
    # its walk; the rule without a walk may count less, never more
    n = 1 << 20
    live = int(0.9 * n)
    got = roofline.probe_bytes(n, live, 1 << 22)
    assert 42.5e6 < got <= 43.2e6
    # Q9's first stream: 32,768 slots, 750,480 live of 2^20: 11.6 MB
    assert roofline.probe_bytes(n, 750_480, 32_768) / 1e6 == pytest.approx(11.6, abs=0.1)


def _trace_doc(qid, spans):
    return {"traceEvents": [{"name": n, "cat": c, "ph": "X", "ts": ts, "dur": dur,
                             "pid": 1, "tid": 7} for c, n, ts, dur in spans],
            "otherData": {"query_id": qid, "dropped_events": 0, "coarse": False}}


@pytest.fixture
def recorded(tmp_path):
    """Two queries' traces (microseconds from each recorder's epoch) and a
    device sub-window of three kernels."""
    docs = {
        "q1_1": [("lifecycle", "query", 0, 900_000), ("lifecycle", "parse", 10, 2_000),
                 ("lifecycle", "plan", 2_100, 8_000), ("lifecycle", "local_plan", 10_200, 5_000),
                 ("lifecycle", "execute", 15_300, 880_000), ("operator", "probe", 20_000, 30_000)],
        "q2_1": [("lifecycle", "query", 0, 400_000), ("lifecycle", "parse", 10, 1_000),
                 ("lifecycle", "plan", 1_100, 3_000), ("lifecycle", "local_plan", 4_200, 2_000),
                 ("lifecycle", "execute", 6_300, 300_000), ("lifecycle", "execute", 306_400, 90_000)],
    }
    epochs = {}
    for i, (qid, sp) in enumerate(docs.items()):
        name = f"presto-torch-trace-1-{qid}.json"
        (tmp_path / name).write_text(json.dumps(_trace_doc(qid, sp)))
        epochs[name] = 1_000 * MS + i * 100 * MS
    spans = read_spans(str(tmp_path), epochs)
    device = {"window_ns": (1_000 * MS, 1_100 * MS),
              "events": [(PROBE, 1_020 * MS, 1_030 * MS),
                         ("elementwise", 1_025 * MS, 1_040 * MS),
                         (INSERT, 1_090 * MS, 1_120 * MS)],
              "busy_s": intervals.union_length([(1_020 * MS, 1_030 * MS), (1_025 * MS, 1_040 * MS),
                                                (1_090 * MS, 1_120 * MS)], 1_000 * MS, 1_100 * MS) / 1e9,
              "window_s": 0.1}
    answers = [{"query_id": "q1_1", "latency_s": 1.0}, {"query_id": "q2_1", "latency_s": 0.5},
               {"query_id": "q9_9", "latency_s": 3.0}]
    calls = [{"kind": "probe", "n": 1 << 20, "live": 1 << 19, "ncomps": 1, "slots": 1 << 21},
             {"kind": "insert", "n": 1 << 20, "live": 1 << 20, "ncomps": 1, "slots": 1 << 21}]
    return {"answers": answers, "spans": spans, "device": device, "hash_calls": calls,
            "hash_kernel_s": 0.02}


def test_span_readers(recorded):
    read = lambda name: spec.metric_reader(name)(recorded)  # noqa: E731
    # latency less the query span: (1000 - 900 + 500 - 400) / 2; the third
    # answer has no trace and is left out
    assert read("served_overhead_ms") == pytest.approx(100.0)
    assert read("planning_ms") == pytest.approx((2 + 8 + 5 + 1 + 3 + 2) / 2)
    # a grouped query's execute spans add up
    assert read("execute_ms") == pytest.approx((880 + 390) / 2)
    assert recorded["spans"]["q1_1"]["spans"][0] == (1_000 * MS, 1_900 * MS, "lifecycle:query")


def test_device_readers(recorded):
    read = lambda name: spec.metric_reader(name)(recorded)  # noqa: E731
    # busy 20 ms (1020-1040) + 10 ms (1090-1100) of a 100 ms window
    assert read("device_idle_share") == pytest.approx(70.0)
    nbytes = roofline.probe_bytes(1 << 20, 1 << 19, 1 << 21) + \
        roofline.insert_bytes(1 << 20, 1 << 20, 1, 1 << 21)
    assert read("hash_kernels_roofline") == pytest.approx(100 * nbytes / 3.35e12 / 0.02)
    # calls made but no ht_* kernel in the profile: nothing is read, no
    # second source of time stands in
    recorded["hash_kernel_s"] = 0.0
    assert read("hash_kernels_roofline") is None


def test_readers_return_nothing_without_readings():
    empty = {"answers": [], "spans": {}, "device": None, "hash_calls": [], "hash_kernel_s": None}
    for m in spec.benchmark()["per_layer"]:
        assert spec.metric_reader(m["name"])(empty) is None, m["name"]


def test_breakdown_labels_idle_gaps_by_the_open_span(recorded):
    out = harness.breakdown(recorded)
    assert out["device_ops"][0] == ["elementwise", pytest.approx(0.015)]
    assert [n for n, _ in out["device_ops"]] == ["elementwise", PROBE, INSERT]
    assert [bool(harness.HASH_KERNEL.search(n)) for n, _ in out["device_ops"]] == [False, True, True]
    # idle 1000-1020 ms (at its middle q1 is planning) and 1040-1090 ms
    # (q1 executing, its probe over)
    gaps = dict((round(s, 3), n) for n, s in out["idle_gaps"])
    assert set(gaps) == {0.02, 0.05}
    assert gaps[0.02] == "lifecycle:plan"
    assert gaps[0.05] == "lifecycle:execute"


def test_the_instrumentations_stream_is_left_out():
    """The marker's stream carries the live-row counts: none of its records
    reads as the program's device work, and the marker aligns the clocks."""
    prof = DeviceProfile()
    prof._wall, prof._marks = 0, [5_000]
    own, program = 7, 3
    raw = [("void at::native::reduce_kernel<count_nonzero>", 8_000, 9_000, own),
           (f"{MARKER}(long)", 6_000, 6_100, own),
           (PROBE, 7_000, 7_500, program),
           ("void at::native::reduce_kernel<sum>", 9_000, 9_400, program)]
    prof._raw_events = lambda: raw
    assert prof.device_events() == [(PROBE, 6_000, 6_500), ("void at::native::reduce_kernel<sum>",
                                                             8_000, 8_400)]
    prof._raw_events = lambda: raw[2:]
    with pytest.raises(RuntimeError):
        prof.device_events()
