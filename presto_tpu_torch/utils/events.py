"""Structured event journal of the PyTorch port (``presto_tpu/utils/events.py``).

Each event is a JSON-safe dict ``{"seq", "kind", "severity", "query_id",
"task_id", "wall_ts", "mono_ns", ...fields}``: ``seq`` is a process-wide
monotone cursor (the ``since=`` paging key), ``wall_ts`` the wall clock and
``mono_ns`` the perf-counter stamp that orders events exactly.

Sinks: a bounded in-memory ring (old events drop and are counted) and an
optional append-only JSONL file. ``emit()`` never raises into the engine
path that calls it. The port emits ``memory.spill`` (an operator revoked
its state under pressure), ``memory.revoke`` (``MemoryRevoker``),
``query.memory_exceeded`` (a query over its user-memory limit),
``query.spill.disk`` (a PCOL run written), ``query.spill.failed`` (a run's
write or read failed, or the query went over ``spill_max_bytes``),
``spill.gc`` (a dead process's spill directories removed) and
``query.forensic_dumped`` (a failed query's black box written), as the
reference does. ``events_http_body`` renders ``GET /v1/events`` for the
server and the worker alike.
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from collections import deque
from typing import Dict, List, Optional

INFO = "info"
WARN = "warn"
ERROR = "error"

DEFAULT_MAX_EVENTS = 4096


class EventJournal:
    """Bounded in-memory journal with an optional JSONL file sink."""

    def __init__(self, max_events: int = DEFAULT_MAX_EVENTS):
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=max(int(max_events), 16))
        self._seq = itertools.count(1)
        self._log_file = None
        self.log_path: Optional[str] = None
        self.dropped = 0

    def emit(self, kind: str, severity: str = INFO, query_id: str = "",
             task_id: str = "", **fields) -> int:
        """Append one event; returns its seq, or 0 when the journal failed
        (emit never raises)."""
        try:
            evt: Dict = {"seq": next(self._seq), "kind": kind, "severity": severity,
                         "query_id": query_id or "", "task_id": task_id or "",
                         "wall_ts": time.time(), "mono_ns": time.perf_counter_ns()}
            if fields:
                evt.update(fields)
            if "corr_id" not in evt:
                # the id the thread's query scope is bound to, when it
                # differs from the event's own
                from ..exec import progress
                ambient = progress.current_query_id()
                if ambient and ambient != evt["query_id"]:
                    evt["corr_id"] = ambient
            with self._lock:
                if len(self._events) == self._events.maxlen:
                    self.dropped += 1
                self._events.append(evt)
                f = self._log_file
                if f is not None:
                    # flushed per event, so a killed process leaves its
                    # last decision on disk
                    f.write(json.dumps(evt, default=str) + "\n")
                    f.flush()
            return evt["seq"]
        except Exception:  # noqa: BLE001 - journaling must never break the engine
            return 0

    def events(self, query_id: Optional[str] = None, since: int = 0,
               kind: Optional[str] = None, limit: int = 1000) -> List[dict]:
        """Events with seq > ``since``, optionally filtered by query id (its
        own or its ``corr_id``) and kind prefix, in seq order."""
        with self._lock:
            snap = list(self._events)
        out: List[dict] = []
        if limit <= 0:
            return out
        for evt in snap:
            if evt["seq"] <= since:
                continue
            if query_id and evt.get("query_id") != query_id \
                    and evt.get("corr_id") != query_id:
                continue
            if kind and not str(evt.get("kind", "")).startswith(kind):
                continue
            out.append(evt)
            if len(out) >= limit:
                break
        return out

    def last_seq(self) -> int:
        with self._lock:
            return self._events[-1]["seq"] if self._events else 0

    def set_log_path(self, path: Optional[str]) -> None:
        """Attach (or, with None, detach) the append-only JSONL file sink."""
        with self._lock:
            if self._log_file is not None:
                try:
                    self._log_file.close()
                except OSError:
                    pass
                self._log_file = None
            self.log_path = path
            if path:
                self._log_file = open(path, "a", encoding="utf-8")

    def clear(self) -> None:
        """Drop buffered events; the seq cursor keeps advancing."""
        with self._lock:
            self._events.clear()
            self.dropped = 0


JOURNAL = EventJournal()


def emit(kind: str, severity: str = INFO, query_id: str = "", task_id: str = "",
         **fields) -> int:
    """Shorthand onto the process journal."""
    return JOURNAL.emit(kind, severity=severity, query_id=query_id, task_id=task_id,
                        **fields)


def events_http_body(query: str) -> tuple:
    """``GET /v1/events`` of the server and the worker: ``query`` is the raw
    URL query string (``query_id=``, ``since=``, ``kind=``, ``limit=``);
    returns (body bytes, status)."""
    import urllib.parse

    params = urllib.parse.parse_qs(query or "")

    def p(name, default=""):
        return params.get(name, [default])[0]

    try:
        since = int(p("since", "0") or 0)
        limit = int(p("limit", "1000") or 1000)
    except ValueError:
        return (json.dumps(
            {"error": {"message": "since/limit must be integers"}}).encode(), 400)
    return (json.dumps({
        "events": JOURNAL.events(query_id=p("query_id") or None, since=since,
                                 kind=p("kind") or None, limit=limit),
        "lastSeq": JOURNAL.last_seq(),
        "dropped": JOURNAL.dropped,
    }).encode(), 200)
