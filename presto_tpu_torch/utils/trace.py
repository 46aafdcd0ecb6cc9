"""Per-query flight recorder of the PyTorch port: span tracing with
Chrome-trace export.

Counterpart of ``presto_tpu/utils/trace.py``, with the same names,
categories, constants and export format. Operator stats say how much time a
stage took, never when; this module records the timeline itself:

- :class:`TraceRecorder` is a thread-safe ring of spans stamped with
  ``time.perf_counter_ns``. The ring bound makes it safe to leave on: the
  oldest spans are overwritten and the drop count is exported.
- Recorders are per query: :func:`install` binds the query's recorder to
  its thread, and every component that hands work to other threads (the
  task executor's runner threads, the scan pipeline's stages, the shared
  pool's steps) captures :func:`active` at hand-off and binds it again with
  :func:`bound`. A process-global fallback covers threads with no query.
  Every instrumentation site goes through the module helpers
  :func:`record`, :func:`instant` and :func:`span`, which cost one
  thread-local load and a ``None`` check when tracing is off.
- Export is Chrome trace-event JSON (``{"traceEvents": [...]}``, loadable
  in Perfetto or ``chrome://tracing``), reachable as
  ``QueryResult.trace_path`` when the session's ``query_trace`` is on.
- Black-box mode, on by default: every query gets a COARSE recorder (a
  small ring; per-page operator and segment spans are dropped at the
  source) unless ``query_blackbox`` is off. When the query fails, the ring
  is written as a forensic Chrome trace and its path is pinned on the
  exception as ``failure_trace_path`` (:func:`attach_failure`, which
  journals ``query.forensic_dumped``). A query that succeeds writes
  nothing.

Categories, one per instrumented subsystem (``exchange`` and ``http``
belong to the distributed tier and the server, which the port does not
have yet):
  lifecycle  query / parse / plan / local_plan / execute phases
  driver     task-executor quanta (one span per driver slice)
  operator   Operator add_input/get_output (through ops.operator.timed)
  segment    fused-segment page dispatches and composition markers
  scan       scan-pipeline read/re-batch/upload work and the stalls
  exchange   streaming-exchange chunks
  kernel     kernel-cache misses (compositions)
  http       cluster task and exchange requests
  pool       shared-pool generator steps (exec/shared_pools.py)
  locksan    lock holds and contended waits of 1 ms or more, under the
             lock sanitizer (utils/locksan.py)
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional

LIFECYCLE = "lifecycle"
DRIVER = "driver"
OPERATOR = "operator"
SEGMENT = "segment"
SCAN = "scan"
EXCHANGE = "exchange"
KERNEL = "kernel"
LOCKSAN = "locksan"
HTTP = "http"
POOL = "pool"

DEFAULT_MAX_EVENTS = 1 << 16

# always-on black-box ring: small enough to be free, large enough that the
# last seconds of a failing query's coarse timeline survive to the dump
BLACKBOX_MAX_EVENTS = 1 << 13

# per-page categories a coarse (black-box) recorder drops at the source —
# everything else (driver quanta, exchange chunks, scan stage work/stalls,
# pool steps, kernel builds, cluster HTTP) is coarse by construction
_COARSE_DROP = frozenset((OPERATOR, SEGMENT))

# operator add_input/get_output fire constantly (get_output polls return
# None most slices); spans shorter than this are noise that would churn the
# ring — they are dropped at the source, not recorded-then-evicted
MIN_OPERATOR_SPAN_NS = 20_000

_TRACE_SEQ = itertools.count(1)


class TraceRecorder:
    """Ring buffer of (category, name, t0_ns, dur_ns, tid, tname, args)."""

    def __init__(self, query_id: str = "", max_events: int = 0,
                 coarse: bool = False):
        self.query_id = query_id or f"trace-{next(_TRACE_SEQ)}"
        self.max_events = max(int(max_events or DEFAULT_MAX_EVENTS), 16)
        # coarse = the always-on black-box mode: per-page operator/segment
        # spans are dropped before the tuple is even built, so the hot paths
        # pay one frozenset lookup — the ring holds only coarse spans
        self.coarse = coarse
        self._drop = _COARSE_DROP if coarse else frozenset()
        self._lock = threading.Lock()
        self._events: List[tuple] = []
        self._next = 0           # overwrite cursor once the ring is full
        self.dropped = 0
        self.t0_ns = time.perf_counter_ns()   # trace epoch (ts origin)

    # ------------------------------------------------------------ recording

    def record(self, cat: str, name: str, t0_ns: int, dur_ns: int,
               args: Optional[dict] = None) -> None:
        if cat in self._drop:
            return
        t = threading.current_thread()
        evt = (cat, name, t0_ns, dur_ns, t.ident, t.name, args)
        with self._lock:
            if len(self._events) < self.max_events:
                self._events.append(evt)
            else:
                self._events[self._next] = evt
                self._next = (self._next + 1) % self.max_events
                self.dropped += 1

    def instant(self, cat: str, name: str,
                args: Optional[dict] = None) -> None:
        self.record(cat, name, time.perf_counter_ns(), 0, args)

    def span(self, cat: str, name: str, **args) -> "_Span":
        return _Span(self, cat, name, args or None)

    # ------------------------------------------------------------- reading

    def events(self) -> List[tuple]:
        """Events in recording order (ring rotated so oldest comes first)."""
        with self._lock:
            return self._events[self._next:] + self._events[:self._next]

    def count(self, cat: Optional[str] = None) -> int:
        if cat is None:
            with self._lock:
                return len(self._events)
        return sum(1 for e in self.events() if e[0] == cat)

    # -------------------------------------------------------------- export

    def to_chrome_trace(self) -> dict:
        """The Chrome trace-event document (ph="X" complete events, ts/dur
        in MICROseconds — the unit the format specifies)."""
        pid = os.getpid()
        spans = []
        threads: Dict[int, str] = {}
        for cat, name, t0, dur, tid, tname, args in self.events():
            e = {"name": name, "cat": cat, "ph": "X",
                 "ts": (t0 - self.t0_ns) / 1e3, "dur": dur / 1e3,
                 "pid": pid, "tid": tid}
            if args:
                e["args"] = args
            spans.append(e)
            threads.setdefault(tid, tname)
        meta = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                 "args": {"name": f"presto-tpu-torch {self.query_id}"}}]
        meta += [{"name": "thread_name", "ph": "M", "pid": pid, "tid": t,
                  "args": {"name": n}} for t, n in sorted(threads.items())]
        return {"traceEvents": meta + spans, "displayTimeUnit": "ms",
                "otherData": {"query_id": self.query_id,
                              "dropped_events": self.dropped,
                              "coarse": self.coarse}}

    def write(self, path: str) -> str:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.to_chrome_trace(), f)
        return path


class _Span:
    __slots__ = ("rec", "cat", "name", "args", "t0")

    def __init__(self, rec: Optional[TraceRecorder], cat: str, name: str,
                 args: Optional[dict]):
        self.rec = rec
        self.cat = cat
        self.name = name
        self.args = args

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.rec is not None:
            self.rec.record(self.cat, self.name, self.t0,
                            time.perf_counter_ns() - self.t0, self.args)
        return False


_NULL_SPAN = _Span(None, "", "", None)


# ---------------------------------------------------------------------------
# the installed recorder: PER-QUERY scoping. A query's recorder binds to the
# threads doing its work — install() binds the calling (query) thread, and
# every engine component that hands work to other threads (TaskExecutor
# runs, scan-pipeline stages, exchange pumps, shared-pool steps) re-binds
# the recorder it captured from its submitting thread via bound(). The
# process-global slot remains only as a FALLBACK for ambient threads with no
# query affiliation, so the single-traced-query case keeps recording exactly
# what it did before — while a second traced query under concurrent load now
# exports its own complete timeline instead of silently running untraced.
# ---------------------------------------------------------------------------

_ACTIVE: Optional[TraceRecorder] = None
_ACTIVE_LOCK = threading.Lock()
_TLS = threading.local()


def active() -> Optional[TraceRecorder]:
    r = getattr(_TLS, "recorder", None)
    return r if r is not None else _ACTIVE


def install(recorder: TraceRecorder) -> bool:
    """Make `recorder` the calling thread's trace sink (and the process
    fallback, first-installed wins). Always succeeds: concurrent traced
    queries no longer collide — each query's threads are bound to its own
    recorder, so the timelines stay separate."""
    global _ACTIVE
    _TLS.recorder = recorder
    with _ACTIVE_LOCK:
        if _ACTIVE is None:
            _ACTIVE = recorder
    return True


def uninstall(recorder: TraceRecorder) -> None:
    global _ACTIVE
    if getattr(_TLS, "recorder", None) is recorder:
        _TLS.recorder = None
    with _ACTIVE_LOCK:
        if _ACTIVE is recorder:
            _ACTIVE = None


class _Bound:
    """Context manager binding a recorder to the current thread (and
    restoring whatever was bound before). Worker threads stepping another
    query's work wrap each step so spans land on the owning query."""

    __slots__ = ("rec", "prev")

    def __init__(self, rec: Optional[TraceRecorder]):
        self.rec = rec

    def __enter__(self):
        self.prev = getattr(_TLS, "recorder", None)
        _TLS.recorder = self.rec
        return self.rec

    def __exit__(self, *exc):
        _TLS.recorder = self.prev
        return False


def bound(recorder: Optional[TraceRecorder]) -> _Bound:
    """Bind `recorder` (captured via :func:`active` on the submitting
    thread) around work executed on a different thread."""
    return _Bound(recorder)


def record(cat: str, name: str, t0_ns: int, dur_ns: int,
           args: Optional[dict] = None) -> None:
    """Hot-path append: one thread-local load + None check when tracing is
    off."""
    r = active()
    if r is not None:
        r.record(cat, name, t0_ns, dur_ns, args)


def instant(cat: str, name: str, args: Optional[dict] = None) -> None:
    r = active()
    if r is not None:
        r.instant(cat, name, args)


def span(cat: str, name: str, **args) -> _Span:
    r = active()
    if r is None:
        return _NULL_SPAN
    return _Span(r, cat, name, args or None)


# ---------------------------------------------------------------------------
# session wiring (runner entry points call these two)
# ---------------------------------------------------------------------------

def maybe_recorder(session, query_id: str = "") -> Optional[TraceRecorder]:
    """The query's recorder: a FULL one when the session's `query_trace`
    knob is on, else the always-on coarse black-box ring (disable with
    `query_blackbox=False`). None only when both are off.

    The recorder's query_id defaults to the id a caller bound with
    exec.progress.query_scope, so forensic dumps, `query.forensic_dumped`
    events and trace filenames carry the id the caller knows, instead of a
    synthetic trace-N counter."""
    if not query_id:
        from ..exec import progress
        query_id = progress.current_query_id() or ""
    if session.get("query_trace"):
        return TraceRecorder(query_id,
                             int(session.get("query_trace_max_events") or 0))
    if not session.get("query_blackbox", True):
        return None
    return TraceRecorder(
        query_id,
        int(session.get("query_blackbox_max_events") or 0)
        or BLACKBOX_MAX_EVENTS,
        coarse=True)


def export(recorder: TraceRecorder, session, suffix: str = "") -> str:
    """Write the Chrome trace JSON under `query_trace_dir` (tempdir default)
    and return the path (what QueryResult.trace_path carries). The file is
    named ``presto-torch-trace-<pid>-<query id>[-<scope id>]<suffix>.json``:
    when the recorder was made before a query scope was bound, the scope's
    id is appended to the recorder's synthetic one."""
    import tempfile

    directory = str(session.get("query_trace_dir") or "") or \
        tempfile.gettempdir()
    os.makedirs(directory, exist_ok=True)
    from ..exec import progress
    corr = progress.current_query_id() or ""
    qid = recorder.query_id
    if corr and corr != qid:
        qid = f"{qid}-{corr}"
    path = os.path.join(
        directory,
        f"presto-torch-trace-{os.getpid()}-{qid}{suffix}.json")
    return recorder.write(path)


def attach_failure(exc: BaseException, recorder: TraceRecorder,
                   session) -> Optional[str]:
    """Failure forensics: dump `recorder`'s ring (scoped to this query) as a
    Chrome trace, pin the path onto the exception as `failure_trace_path`
    and journal `query.forensic_dumped`. First writer wins (the innermost
    tier saw the most detail); the dump itself never masks the real
    error."""
    if getattr(exc, "failure_trace_path", None):
        return exc.failure_trace_path
    try:
        path = export(recorder, session, suffix="-forensic")
        exc.failure_trace_path = path
        from . import events
        events.emit("query.forensic_dumped", severity="error",
                    query_id=recorder.query_id, path=path,
                    error=type(exc).__name__)
        return path
    except Exception:  # noqa: BLE001 - forensics are best-effort
        return None


# ---------------------------------------------------------------------------
# analysis helpers (chip_smoke.py and the tests read exported documents)
# ---------------------------------------------------------------------------

def _merged_intervals(doc: dict, cat: str) -> List[tuple]:
    ivals = sorted((e["ts"], e["ts"] + e.get("dur", 0))
                   for e in doc.get("traceEvents", [])
                   if e.get("ph") == "X" and e.get("cat") == cat)
    merged: List[list] = []
    for lo, hi in ivals:
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return [tuple(m) for m in merged]


def overlap_ratio(doc: dict, cat_a: str, cat_b: str) -> float:
    """Fraction of `cat_a` span time that overlaps some `cat_b` span —
    the proof-of-overlap number (e.g. exchange dispatches vs driver compute)
    the GPU-Presto paper argues accelerator engines must report."""
    a = _merged_intervals(doc, cat_a)
    b = _merged_intervals(doc, cat_b)
    total = sum(hi - lo for lo, hi in a)
    if total <= 0:
        return 0.0
    inter = 0.0
    bi = 0
    for lo, hi in a:
        while bi < len(b) and b[bi][1] <= lo:
            bi += 1
        j = bi
        while j < len(b) and b[j][0] < hi:
            inter += max(0.0, min(hi, b[j][1]) - max(lo, b[j][0]))
            j += 1
    return inter / total


def span_categories(doc: dict) -> Dict[str, int]:
    """{category: span count} of an exported document (schema validation)."""
    out: Dict[str, int] = {}
    for e in doc.get("traceEvents", []):
        if e.get("ph") == "X":
            out[e.get("cat", "")] = out.get(e.get("cat", ""), 0) + 1
    return out
