"""The port's metrics registry (``presto_tpu_torch/utils/metrics.py``)
against the reference's: the cases of ``tests/test_metrics.py`` that need
no server. The same observations go into both registries, and the
snapshots, percentiles, raw forms, merges and the Prometheus text must be
equal exactly.
"""
import random

import pytest

from presto_tpu.utils import metrics as ref_metrics
from presto_tpu_torch.utils import metrics
from presto_tpu_torch.utils.metrics import Histogram, MetricsRegistry

BOTH = {"port": metrics, "reference": ref_metrics}


def _without_uptime(snap):
    return {k: v for k, v in snap.items() if k != "uptime_seconds"}


def test_registry_counters_and_gauges():
    snaps = {}
    for pkg, mod in BOTH.items():
        r = mod.MetricsRegistry()
        r.count("a.x")
        r.count("a.x", 2)
        r.count("b.y", 5)
        r.count_many({"p": 3, "q": 0, "r": 1.5}, prefix="c.")
        r.set_gauge("a.g", lambda: 42)
        snap = r.snapshot()
        assert "uptime_seconds" in snap
        snaps[pkg] = (_without_uptime(snap), r.snapshot("a."), r.counter_value("c.q"))
    assert snaps["port"] == snaps["reference"]
    snap, only_a, zero = snaps["port"]
    assert snap == {"a.x": 3, "b.y": 5, "c.p": 3, "c.r": 1.5, "a.g": 42}
    assert only_a == {"a.x": 3, "a.g": 42} and zero == 0


def test_gauge_error_is_null_counted_and_logged_once(capsys):
    r = MetricsRegistry()
    r.set_gauge("bad", lambda: 1 / 0)
    snap = r.snapshot()
    assert snap["bad"] is None
    assert r.counter_value("metrics.gauge_errors") == 1
    r.snapshot()
    r.snapshot()
    assert r.counter_value("metrics.gauge_errors") == 3
    err = capsys.readouterr().err
    assert err.count("gauge 'bad' failed") == 1
    assert "ZeroDivisionError" in err
    # a failing gauge is left out of the raw snapshot, as in the reference
    assert r.raw_snapshot()["gauges"] == {}


HIST_SAMPLES = {
    "two clusters": [0.001] * 100 + [0.1] * 10,
    "below the floor": [0.0, 1e-7, 1e-6, 2e-6],
    "beyond the top": [1e30, 5.0, 5.0],
    "uniform": [random.Random(7).uniform(1e-6, 30.0) for _ in range(500)],
    "empty": [],
}


@pytest.mark.parametrize("case", sorted(HIST_SAMPLES))
def test_histogram_percentile_math(case):
    """The same samples give the same buckets, percentiles, summary and raw
    form in both packages; each percentile bounds its value within 2x."""
    hists = {}
    for pkg, mod in BOTH.items():
        h = mod.Histogram()
        for v in HIST_SAMPLES[case]:
            h.add(v)
        hists[pkg] = h
    h, ref_h = hists["port"], hists["reference"]
    qs = [q / 100 for q in range(0, 101)]
    assert [h.percentile(q) for q in qs] == [ref_h.percentile(q) for q in qs]
    assert h.raw() == ref_h.raw() and h.summary() == ref_h.summary()
    got = [h.percentile(q) for q in qs]
    assert got == sorted(got)
    if case == "two clusters":
        assert 0.001 <= h.percentile(0.5) < 0.002
        assert 0.1 <= h.percentile(0.95) < 0.2 and 0.1 <= h.percentile(0.99) < 0.2
        assert h.n == 110 and abs(h.total - 1.1) < 1e-9
    if case == "empty":
        assert h.percentile(0.5) == 0.0 and h.summary()["count"] == 0


def test_registry_histogram_snapshot_keys():
    snaps = {}
    for pkg, mod in BOTH.items():
        r = mod.MetricsRegistry()
        for v in (0.002, 0.002, 0.002, 0.5):
            r.histogram("query.wall_s", v)
        snaps[pkg] = (r.snapshot("query."), r.histogram_summary("query.wall_s"),
                      r.histogram_summary("nope"))
        r.reset()
        assert r.histogram_summary("query.wall_s") == {}
    assert snaps["port"] == snaps["reference"]
    snap, summary, missing = snaps["port"]
    assert snap["query.wall_s.count"] == 4 == summary["count"]
    assert 0.002 <= snap["query.wall_s.p50"] < 0.004
    assert 0.5 <= snap["query.wall_s.p99"] < 1.0
    assert missing == {}


def _two_registries(mod):
    rng = random.Random(42)
    a = [rng.uniform(1e-6, 30.0) for _ in range(700)]
    b = [rng.uniform(1e-5, 0.5) for _ in range(350)]
    r1, r2 = mod.MetricsRegistry(), mod.MetricsRegistry()
    for v in a:
        r1.histogram("x.wall_s", v)
    r1.count("c.total", 5)
    r1.set_gauge("g.bytes", lambda: 10)
    for v in b:
        r2.histogram("x.wall_s", v)
    r2.count("c.total", 7)
    r2.set_gauge("g.bytes", lambda: 32)
    r2.histogram("only.on_two_s", 0.25)
    return a + b, r1, r2


def test_histogram_raw_roundtrip_and_merge_equals_union():
    """Merged percentiles equal the union's exactly, and both packages merge
    and flatten to the same numbers."""
    out = {}
    for pkg, mod in BOTH.items():
        samples, r1, r2 = _two_registries(mod)
        merged = mod.merge_raw_snapshots([r1.raw_snapshot(), None, r2.raw_snapshot()])
        oracle = mod.Histogram()
        for v in samples:
            oracle.add(v)
        out[pkg] = (merged, mod.flatten_raw(merged), oracle.raw())
        assert mod.Histogram.from_raw(oracle.raw()).raw() == oracle.raw()
    assert out["port"] == out["reference"]
    merged, flat, oracle_raw = out["port"]
    oracle = Histogram.from_raw(oracle_raw)
    assert flat["c.total"] == 12 and flat["g.bytes"] == 42
    assert flat["x.wall_s.count"] == 1050
    for q, key in ((0.50, "x.wall_s.p50"), (0.95, "x.wall_s.p95"), (0.99, "x.wall_s.p99")):
        assert flat[key] == round(oracle.percentile(q), 6)
    assert flat["only.on_two_s.count"] == 1


def test_prometheus_exposition_shape():
    texts = {}
    for pkg, mod in BOTH.items():
        reg = mod.MetricsRegistry()
        reg.count("queries.completed", 3)
        reg.set_gauge("pool.bytes", lambda: 123)
        for v in (0.002, 0.004, 1.5):
            reg.histogram("q.wall_s", v)
        texts[pkg] = mod.prometheus_text(reg.raw_snapshot())
    text = texts["port"]
    assert text == texts["reference"]
    assert "# TYPE presto_tpu_queries_completed counter" in text
    assert "presto_tpu_queries_completed 3" in text
    assert "# TYPE presto_tpu_pool_bytes gauge" in text
    assert "# TYPE presto_tpu_q_wall_s_seconds histogram" in text
    assert 'presto_tpu_q_wall_s_seconds_bucket{le="+Inf"} 3' in text
    assert "presto_tpu_q_wall_s_seconds_count 3" in text
    counts = [int(line.rsplit(" ", 1)[1]) for line in text.splitlines() if "_bucket{" in line]
    assert counts == sorted(counts), "bucket counts must be cumulative"


def test_query_wall_histogram_counts_every_statement():
    """``LocalQueryRunner.execute`` adds one ``query.wall_s`` observation
    per statement that completes, as the reference's does: a failed one
    records none."""
    from presto_tpu_torch.metadata import Session
    from presto_tpu_torch.runner import LocalQueryRunner

    runner = LocalQueryRunner(Session(catalog="tpch", schema="tiny"), device="cpu")
    before = metrics.METRICS.histogram_summary("query.wall_s").get("count", 0)
    runner.execute("show tables")
    runner.execute("select count(*) from nation")
    with pytest.raises(Exception):
        runner.execute("select definitely_missing from nation")
    after = metrics.METRICS.histogram_summary("query.wall_s")["count"]
    assert after - before == 2
