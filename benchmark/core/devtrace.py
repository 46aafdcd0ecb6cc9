"""What the traced run (``--trace 1``) records, from the benchmark's side.

- ``HashCalls`` wraps the program's hash-table entry points
  (``presto_tpu_torch.ops.pallas_hash.insert_table`` and ``probe_table``)
  and, while it is active, records each CUDA call's shape: rows, key
  components, slots, and its live rows, a ``count_nonzero`` of the mask
  launched on the instrumentation's own stream and read after the window.
- ``SpanClock`` wraps the flight recorder's export, so each exported trace
  is known with the ``perf_counter_ns`` epoch of its recorder, which puts
  its spans on the host clock.
- ``DeviceProfile`` runs ``torch.profiler`` over CUDA activity, started and
  stopped while the card is idle, and returns each device operation as
  (name, start, end) on the host clock, aligned by a marker kernel launched
  where the read sub-window opens. The marker runs on the instrumentation's
  stream, and every record of that stream (the marker, the live-row counts)
  is left out of the device operations, so the instrumentation never reads
  as the program's device work.

Every wrapper is removed by ``uninstall``; none of this runs with
``--trace 0``.
"""
from __future__ import annotations

import functools
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

MARKER = "spin_kernel"
_MARKER_CYCLES = 10_000


class HashCalls:
    KINDS = ("insert_table", "probe_table")

    def __init__(self):
        self.active = False
        self.calls: List[dict] = []
        self.stream = None  # the instrumentation's stream (DeviceProfile's)
        self._lock = threading.Lock()
        self._orig: Dict[str, object] = {}

    def install(self) -> None:
        from presto_tpu_torch.ops import pallas_hash as ph

        for name in self.KINDS:
            orig = getattr(ph, name)
            self._orig[name] = orig
            setattr(ph, name, functools.update_wrapper(self._wrap(name, orig), orig))

    def uninstall(self) -> None:
        from presto_tpu_torch.ops import pallas_hash as ph

        for name, orig in self._orig.items():
            setattr(ph, name, orig)
        self._orig.clear()

    def _wrap(self, name: str, orig):
        import torch

        kind = "insert" if name == "insert_table" else "probe"

        def wrapper(*args, **kwargs):
            if not self.active or args[0].device.type != "cuda":
                return orig(*args, **kwargs)
            t_ns = time.perf_counter_ns()
            out = orig(*args, **kwargs)
            if kind == "insert":
                comps, mask, slots = args[0], args[1], args[2]
                call = {"kind": kind, "n": int(comps.shape[1]), "ncomps": int(comps.shape[0]),
                        "slots": int(slots)}
            else:
                slot_keys, mask = args[0], args[3]
                call = {"kind": kind, "n": int(args[2].shape[0]), "ncomps": 1,
                        "slots": int(slot_keys.shape[0])}
            # the count waits for the mask on the instrumentation's stream;
            # the program's stream never waits for the count
            self.stream.wait_stream(torch.cuda.current_stream(mask.device))
            with torch.cuda.stream(self.stream):
                call.update(t_ns=t_ns, live_t=torch.count_nonzero(mask))
            mask.record_stream(self.stream)
            with self._lock:
                self.calls.append(call)
            return out

        return wrapper

    def finish(self) -> List[dict]:
        """The recorded calls with their live rows read (call after the
        device has synchronised)."""
        out = []
        for c in self.calls:
            c["live"] = int(c.pop("live_t"))
            out.append(c)
        self.calls = []
        return out


class SpanClock:
    """Each exported flight-recorder trace's path -> its recorder's epoch."""

    def __init__(self):
        self.epochs: Dict[str, int] = {}
        self._orig = None

    def install(self) -> None:
        from presto_tpu_torch.utils import trace

        orig = self._orig = trace.export

        def export(recorder, session, suffix=""):
            path = orig(recorder, session, suffix)
            self.epochs[os.path.basename(path)] = recorder.t0_ns
            return path

        trace.export = functools.update_wrapper(export, orig)

    def uninstall(self) -> None:
        if self._orig is not None:
            from presto_tpu_torch.utils import trace

            trace.export = self._orig
            self._orig = None


def read_spans(trace_dir: str, epochs: Dict[str, int]) -> Dict[str, dict]:
    """Query id -> {"lifecycle": {name: total ms}, "spans": [(start_ns,
    end_ns, "cat:name"), ...] on the host clock}, from the exported traces."""
    out: Dict[str, dict] = {}
    for fname in sorted(os.listdir(trace_dir)):
        if not fname.endswith(".json") or fname.endswith("-forensic.json"):
            continue
        with open(os.path.join(trace_dir, fname), encoding="utf-8") as f:
            doc = json.load(f)
        qid = doc.get("otherData", {}).get("query_id")
        if not qid:
            continue
        epoch = epochs.get(fname)
        life: Dict[str, float] = {}
        spans = []
        for e in doc.get("traceEvents", []):
            if e.get("ph") != "X":
                continue
            if e.get("cat") == "lifecycle":
                life[e["name"]] = life.get(e["name"], 0.0) + e.get("dur", 0.0) / 1e3
            if epoch is not None:
                lo = epoch + int(e["ts"] * 1e3)
                spans.append((lo, lo + int(e.get("dur", 0.0) * 1e3), f"{e.get('cat')}:{e['name']}"))
        out[qid] = {"lifecycle": life, "spans": spans}
    return out


class DeviceProfile:
    """``torch.profiler`` over CUDA activity from before the window to after
    its drain; the readings cover the sub-window between ``open_window``
    and ``close_window``."""

    def __init__(self):
        self.prof = None
        self.stream = None
        self.window: Optional[Tuple[int, int]] = None
        self._marks: List[int] = []

    def make_stream(self):
        """The instrumentation's own CUDA stream (made before the profiler
        starts, shared with ``HashCalls``)."""
        import torch

        self.stream = torch.cuda.Stream()
        return self.stream

    def _mark(self) -> None:
        import torch

        with torch.cuda.stream(self.stream):
            self._marks.append(time.perf_counter_ns())
            torch.cuda._sleep(_MARKER_CYCLES)

    def start(self) -> None:
        """Start profiling while nothing runs on the card: the profiler's
        start and stop race the launches of other threads (a traced run
        aborted in ``free()`` once when they were made mid-window)."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._wall = time.time_ns() - time.perf_counter_ns()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()

    def open_window(self) -> None:
        """The sub-window the readings cover starts now, with its marker."""
        self._t0 = time.perf_counter_ns()
        self._mark()

    def close_window(self) -> None:
        self.window = (self._t0, time.perf_counter_ns())

    def stop(self) -> None:
        """Stop once the card is idle again (the window's queries drained)."""
        import torch

        torch.cuda.synchronize()
        self.prof.stop()

    def device_events(self) -> List[Tuple[str, int, int]]:
        """(name, start_ns, end_ns) of every device operation of the
        program, on the host clock: the records of the instrumentation's
        stream (the marker and the live-row counts) left out."""
        raw = self._raw_events()
        marks = sorted((s, stream) for n, s, _, stream in raw if MARKER in n)
        if not marks or not self._marks:
            raise RuntimeError(f"the profiler recorded no marker kernel among {len(raw)} "
                               "device records: the trace cannot be aligned")
        offset = marks[0][0] - self._marks[0]
        own = marks[0][1]
        dropped = sum(1 for *_, stream in raw if stream == own)
        self.note = (f"{len(raw)} device records, {len(marks)} markers, {dropped} records of "
                     f"the instrumentation's stream left out, host-to-profiler offset "
                     f"{offset - self._wall} ns from the wall clock's")
        return [(n, s - offset, e - offset) for n, s, e, stream in raw if stream != own]

    def _raw_events(self) -> List[Tuple[str, int, int, int]]:
        """(name, start, end, stream) of every CUDA record, on the
        profiler's clock."""
        out = []
        for e in self.prof.profiler.kineto_results.events():
            if "CUDA" not in str(e.device_type()):
                continue
            s = int(e.start_ns())
            out.append((e.name(), s, s + int(e.duration_ns()), int(e.device_resource_id())))
        return out
