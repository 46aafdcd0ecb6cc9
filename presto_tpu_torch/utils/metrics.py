"""Process-wide metrics registry of the PyTorch port: counters, gauges and
histograms.

Counterpart of the local half of ``presto_tpu/utils/metrics.py``, under the
same names:

- ``count(name)`` / ``count_many``: monotonically increasing counters. The
  join build counts ``pallas.join_builds`` and ``pallas.join_fallbacks``;
  fused segments ``segments.dispatches`` and ``segments.compiles``; the
  disk rung ``spill.bytes_written`` and ``spill.bytes_read``. The port's
  own counters, which the reference does not keep: ``join.expanded_rows``
  and ``join.expansion_chunks`` (the expanding probe),
  ``join.semi_pages`` and ``join.semi_chunks`` (the filtered semi probe),
  ``coalesce.pages_in`` and ``coalesce.pages_out`` (page coalescing),
  ``memory.revoked_bytes`` (bytes a revocation moved to host RAM) and
  ``pcol.native_opens`` / ``pcol.numpy_opens`` (which reader opened a
  PCOL file).
- ``set_gauge(name, fn)``: a callable sampled at snapshot time; one that
  raises reads null, counts ``metrics.gauge_errors`` and is logged to
  stderr once.
- ``histogram(name, value)``: a fixed log2-bucket distribution (64
  buckets from 1e-6); ``snapshot()`` derives ``<name>.count/.p50/.p95/.p99``.
  Recorded: ``query.wall_s`` (every statement), ``segments.page_dispatch_s``
  (every fused dispatch) and ``spill.write_s`` (every disk run).

``raw_snapshot`` gives the mergeable form (bucket counts, not percentiles);
``merge_raw_snapshots``, ``flatten_raw`` and ``prometheus_text`` merge and
render it; ``metrics_http_body`` serves ``GET /v1/metrics`` on the server
and the worker.
"""
from __future__ import annotations

import math
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

# log2 histogram geometry: bucket 0 holds values <= _HIST_MIN seconds (1us);
# bucket i holds (MIN*2^(i-1), MIN*2^i]. 64 buckets reach ~2.9e5 hours —
# every engine latency fits, and the fixed layout makes percentile reads O(64)
_HIST_MIN = 1e-6
_HIST_BUCKETS = 64


class Histogram:
    """Fixed log-bucket distribution. NOT self-locking: the registry mutates
    it under its own lock (one lock acquisition per record, same discipline
    as the counters)."""

    __slots__ = ("counts", "n", "total")

    def __init__(self):
        self.counts = [0] * _HIST_BUCKETS
        self.n = 0
        self.total = 0.0

    def add(self, value: float) -> None:
        # registry-level lock discipline (class docstring): registry-owned
        # instances mutate only under MetricsRegistry._lock; merge-path
        # instances (from_raw/merge_raw) are function-local scratch
        self.counts[self._bucket(value)] += 1
        self.n += 1
        self.total += value

    @staticmethod
    def _bucket(value: float) -> int:
        if value <= _HIST_MIN:
            return 0
        return min(_HIST_BUCKETS - 1,
                   int(math.ceil(math.log2(value / _HIST_MIN))))

    @staticmethod
    def bucket_bound(i: int) -> float:
        """Upper bound (seconds) of bucket i."""
        return _HIST_MIN * (1 << i)

    def raw(self) -> Dict:
        """Mergeable form: the raw bucket counts (not percentiles) — what
        workers export at /v1/metrics?raw=1 so the coordinator can merge
        distributions and re-derive percentiles cluster-wide. Percentiles do
        not compose; bucket counts do."""
        return {"counts": list(self.counts), "n": self.n,
                "total": self.total}

    @classmethod
    def from_raw(cls, raw: Dict) -> "Histogram":
        h = cls()
        counts = list(raw.get("counts") or ())[:_HIST_BUCKETS]
        for i, c in enumerate(counts):
            h.counts[i] = int(c)
        h.n = int(raw.get("n") or sum(h.counts))
        h.total = float(raw.get("total") or 0.0)
        return h

    def merge_raw(self, raw: Dict) -> None:
        """Element-wise bucket merge — exact: the merged histogram is the
        histogram of the union of the samples (fixed shared geometry)."""
        # merge targets are merge-local scratch Histograms (built fresh in
        # merge_raw_snapshots, never the registry's lock-guarded instances)
        counts = list(raw.get("counts") or ())[:_HIST_BUCKETS]
        for i, c in enumerate(counts):
            self.counts[i] += int(c)
        self.n += int(raw.get("n") or sum(int(c) for c in counts))
        self.total += float(raw.get("total") or 0.0)

    def percentile(self, q: float) -> float:
        """Value at quantile ``q`` in [0, 1]: the upper bound of the bucket
        holding the q-th observation (within 2x of the true value by the
        log2 geometry; 0.0 for an empty histogram)."""
        if self.n == 0:
            return 0.0
        rank = max(1, math.ceil(q * self.n))
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                return self.bucket_bound(i)
        return self.bucket_bound(_HIST_BUCKETS - 1)

    def summary(self) -> Dict[str, float]:
        return {"count": self.n,
                "p50": round(self.percentile(0.50), 6),
                "p95": round(self.percentile(0.95), 6),
                "p99": round(self.percentile(0.99), 6)}


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, Callable[[], float]] = {}
        self._hists: Dict[str, Histogram] = {}
        # gauges whose failure was already logged: the FIRST failure per
        # gauge goes to stderr, later ones only bump the error counter
        self._gauge_logged: set = set()
        self._start = time.monotonic()

    def count(self, name: str, delta: float = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + delta

    def count_many(self, values: Dict[str, float], prefix: str = "") -> None:
        """Batch counter update under ONE lock acquisition — the scan
        pipeline flushes a whole stage-stat dict per stream this way."""
        with self._lock:
            for k, v in values.items():
                if v:
                    name = prefix + k
                    self._counters[name] = self._counters.get(name, 0) + v

    def histogram(self, name: str, value: float) -> None:
        """Record one observation into the named log-bucket histogram."""
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram()
            h.add(value)

    def histogram_summary(self, name: str) -> Dict[str, float]:
        """{count, p50, p95, p99} of one histogram ({} when unrecorded)."""
        with self._lock:
            h = self._hists.get(name)
            return h.summary() if h is not None else {}

    def set_gauge(self, name: str, fn: Callable[[], float]) -> None:
        with self._lock:
            self._gauges[name] = fn

    def counter_value(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0)

    def snapshot(self, prefix: str = "") -> Dict[str, float]:
        """-> {name: value}; `prefix` filters (the mbean-name lookup).
        Histograms expand to ``<name>.count/.p50/.p95/.p99`` keys."""
        with self._lock:
            out = {k: v for k, v in self._counters.items()
                   if k.startswith(prefix)}
            gauges = [(k, fn) for k, fn in self._gauges.items()
                      if k.startswith(prefix)]
            for k, h in self._hists.items():
                if k.startswith(prefix):
                    for stat, v in h.summary().items():
                        out[f"{k}.{stat}"] = v
        failed: List[tuple] = []
        for k, fn in gauges:
            try:
                out[k] = fn()
            except Exception as e:  # noqa: BLE001 — counted + logged below
                out[k] = None
                failed.append((k, e))
        for k, e in failed:
            # a silently-None gauge hides a broken probe forever: count it
            # (metrics.gauge_errors on this very endpoint) and log the first
            # failure per gauge to stderr so the breakage has a diagnostic
            self.count("metrics.gauge_errors")
            with self._lock:
                first = k not in self._gauge_logged
                self._gauge_logged.add(k)
            if first:
                print(f"presto-tpu metrics: gauge {k!r} failed: {e!r}",
                      file=sys.stderr)
        if not prefix or "uptime".startswith(prefix):
            out["uptime_seconds"] = round(time.monotonic() - self._start, 1)
        return out

    def raw_snapshot(self, prefix: str = "") -> Dict:
        """Mergeable snapshot: counters + sampled gauges as numbers,
        histograms as raw bucket counts. The cluster roll-up's wire shape
        (/v1/metrics?raw=1) — merge with :func:`merge_raw_snapshots`."""
        with self._lock:
            counters = {k: v for k, v in self._counters.items()
                        if k.startswith(prefix)}
            gauges = [(k, fn) for k, fn in self._gauges.items()
                      if k.startswith(prefix)]
            hists = {k: h.raw() for k, h in self._hists.items()
                     if k.startswith(prefix)}
        gauge_vals: Dict[str, float] = {}
        for k, fn in gauges:
            try:
                gauge_vals[k] = fn()
            except Exception:  # noqa: BLE001 - snapshot() owns gauge diagnostics
                pass
        return {"counters": counters, "gauges": gauge_vals,
                "histograms": hists}

    def reset(self) -> None:
        """Test hook."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            self._gauge_logged.clear()


METRICS = MetricsRegistry()


# ---------------------------------------------------------------------------
# cluster roll-up: merge raw snapshots from many processes, re-derive
# percentiles from the MERGED buckets (memory/ClusterMemoryManager's shape
# applied to metrics: the coordinator's GET /v1/cluster/metrics sums every
# worker's counters and merges every worker's histogram buckets — summing
# per-worker percentiles would be statistically meaningless)
# ---------------------------------------------------------------------------

def merge_raw_snapshots(snapshots) -> Dict:
    """Merge raw_snapshot() dicts: counters and gauges sum, histogram
    buckets add element-wise. Returns the same raw shape."""
    counters: Dict[str, float] = {}
    gauges: Dict[str, float] = {}
    hists: Dict[str, Histogram] = {}
    for snap in snapshots:
        if not snap:
            continue
        for k, v in (snap.get("counters") or {}).items():
            if isinstance(v, (int, float)):
                counters[k] = counters.get(k, 0) + v
        for k, v in (snap.get("gauges") or {}).items():
            if isinstance(v, (int, float)):
                gauges[k] = gauges.get(k, 0) + v
        for k, raw in (snap.get("histograms") or {}).items():
            h = hists.get(k)
            if h is None:
                h = hists[k] = Histogram()
            h.merge_raw(raw)
    return {"counters": counters, "gauges": gauges,
            "histograms": {k: h.raw() for k, h in hists.items()}}


def flatten_raw(raw: Dict) -> Dict[str, float]:
    """Raw snapshot -> the flat JSON shape /v1/metrics serves (histograms
    expand to <name>.count/.p50/.p95/.p99, re-derived from the buckets)."""
    out: Dict[str, float] = dict(raw.get("counters") or {})
    out.update(raw.get("gauges") or {})
    for k, hraw in (raw.get("histograms") or {}).items():
        for stat, v in Histogram.from_raw(hraw).summary().items():
            out[f"{k}.{stat}"] = v
    return out


def _prom_name(name: str) -> str:
    import re
    return "presto_tpu_" + re.sub(r"[^a-zA-Z0-9_:]", "_", name)


def prometheus_text(raw: Dict) -> str:
    """Prometheus text exposition (v0.0.4) of a raw snapshot: counters as
    `counter`, gauges as `gauge`, histograms as native Prometheus histograms
    (cumulative le-bucketed counts + _sum + _count) so one scrape config
    covers every server and `?format=prometheus` on the cluster endpoint
    yields fleet-wide distributions."""
    lines = []
    for k in sorted(raw.get("counters") or {}):
        v = raw["counters"][k]
        name = _prom_name(k)
        lines.append(f"# TYPE {name} counter")
        lines.append(f"{name} {v}")
    for k in sorted(raw.get("gauges") or {}):
        v = raw["gauges"][k]
        name = _prom_name(k)
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {v}")
    for k in sorted(raw.get("histograms") or {}):
        h = Histogram.from_raw(raw["histograms"][k])
        name = _prom_name(k + "_seconds")
        lines.append(f"# TYPE {name} histogram")
        cum = 0
        last = max((i for i, c in enumerate(h.counts) if c), default=-1)
        for i in range(last + 1):
            cum += h.counts[i]
            le = Histogram.bucket_bound(i)
            lines.append(f'{name}_bucket{{le="{le:g}"}} {cum}')
        lines.append(f'{name}_bucket{{le="+Inf"}} {h.n}')
        lines.append(f"{name}_sum {h.total}")
        lines.append(f"{name}_count {h.n}")
    return "\n".join(lines) + "\n"


def metrics_http_body(query: str, registry: Optional[MetricsRegistry] = None,
                      prefix: str = "") -> tuple:
    """``GET /v1/metrics`` of the server and the worker: ``query`` is the raw
    URL query string. ``raw=1`` serves the mergeable snapshot,
    ``format=prometheus`` the text exposition, anything else the flat JSON;
    returns (body bytes, content type)."""
    import json
    import urllib.parse

    reg = registry or METRICS
    params = urllib.parse.parse_qs(query or "")
    if params.get("raw", [""])[0] in ("1", "true"):
        return json.dumps(reg.raw_snapshot(prefix)).encode(), "application/json"
    if params.get("format", [""])[0] == "prometheus":
        return (prometheus_text(reg.raw_snapshot(prefix)).encode(),
                "text/plain; version=0.0.4")
    return json.dumps(reg.snapshot(prefix)).encode(), "application/json"
