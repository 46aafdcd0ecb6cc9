"""One run of one cell: set-up, the measured window, the check, the readings.

``run_cell`` serves the cell's configuration with the program's
``PrestoTpuServer`` (a ``LocalQueryRunner`` on the card) in this process,
starts the clients in a process of their own (``clients.py``), and:

1. set-up: builds the kernels at first use, generates the cell's column
   sets and makes them resident by one pass of each query alone, then warms
   every statement the streams will send by one round of all streams at
   once;
2. the window: every stream sends its statements closed-loop for
   ``seconds``; with ``trace`` the flight recorder exports every query's
   trace, ``torch.profiler`` records the device over the middle of the
   window, and the hash-table calls are recorded there;
3. after the window, with the server stopped: the device's peak memory,
   then every answer against the plain reference (``compare.py``), and the
   metrics.

It returns the result line's object; ``run.py`` prints it.
"""
from __future__ import annotations

import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

from . import compare, spec, traffic
from .hostload import HostLoad
from .intervals import gaps, innermost, union_length

# the catalog's smallest schema and its scale factor, which tests run at
# in place of a configuration's own ``schema`` and ``scale_factor``
TINY = ("tiny", 0.01)
# a minute past the close for the answers still due
DRAIN_S = 60.0
# the profiled sub-window: the middle of the window, at most this long
PROFILE_MAX_S = 8.0
CLIENTS = Path(__file__).resolve().with_name("clients.py")
REFERENCE_CACHE = spec.BENCH_DIR / ".cache" / "reference"
FORBIDDEN = ("jax", "jaxlib", "flax", "presto_tpu")
# the hash-table kernels' device names, e.g. "(anonymous namespace)::ht_probe_rows(...)"
HASH_KERNEL = re.compile(r"\bht_(insert|probe)\w*\(")
# a device operation's name in the breakdown: enough to tell kernels apart
NAME_CHARS = 160


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def p90(values: List[float]) -> float:
    """Nearest-rank 90th percentile."""
    v = sorted(values)
    return v[max(0, math.ceil(0.9 * len(v)) - 1)]


class Clients:
    """The clients' process and its pipes."""

    def __init__(self):
        self.proc = subprocess.Popen([sys.executable, str(CLIENTS), str(spec.ROOT)],
                                     stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                     text=True)

    def send(self, obj) -> None:
        self.proc.stdin.write(json.dumps(obj) + "\n")
        self.proc.stdin.flush()

    def recv(self) -> dict:
        line = self.proc.stdout.readline()
        if not line:
            raise RuntimeError(f"the clients' process ended (code {self.proc.poll()})")
        return json.loads(line)

    def close(self) -> None:
        try:
            self.send({"cmd": "quit"})
        except (BrokenPipeError, OSError):
            pass
        try:
            self.proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()


def _pairs(statements) -> list:
    return [[s.key, s.sql] for s in statements]


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def scale_of(config: dict) -> Tuple[str, float]:
    """The catalog schema a configuration serves and its scale factor."""
    return config["schema"], float(config["scale_factor"])


def reference_rows(answers, queries, sf: float, arith_name: str = "exact") -> Dict:
    """The plain reference's rows for each distinct (query, parameters)
    among ``answers``."""
    from ..reference.common import ARITH
    from ..reference.db import Database

    db = Database(sf, cache_dir=str(REFERENCE_CACHE))
    arith = ARITH[arith_name]
    wanted = {}
    for key in sorted({(a["query"], a["params"]) for a in answers}):
        wanted[key] = spec.reference(key[0]).run(db, dict(key[1]), arith)
    return wanted


def source_rows(queries, sf: float) -> Dict[str, int]:
    from ..reference import tpch_gen as g

    return {q: sum(g.table_row_count(t, sf) for t in meta["tables"])
            for q, meta in queries.items()}


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             scale: Optional[Tuple[str, float]] = None, t_start: Optional[float] = None,
             fault: Optional[Callable] = None) -> dict:
    """One run of cell ``name``; returns the result line's object.
    ``scale`` = (schema, scale factor) overrides the configuration's (tests
    run at ``TINY``); ``fault(server)`` plants a fault in the served path
    (tests)."""
    import torch

    from presto_tpu_torch.metadata import Session
    from presto_tpu_torch.runner import LocalQueryRunner
    from presto_tpu_torch.server import PrestoTpuServer
    from presto_tpu_torch.utils.metrics import METRICS

    from .devtrace import DeviceProfile, HashCalls, SpanClock, read_spans

    t_start = time.perf_counter() if t_start is None else t_start
    cell = spec.cell(name)
    config, tr = cell["config"], cell["traffic"]
    schema, sf = scale or scale_of(config)
    log(f"configuration {config['name']}: schema {schema}, scale factor {sf:g}")
    queries = spec.queries_of(tr)
    streams = traffic.streams(tr, queries, seed)
    by_key = {s.key: s for st in streams for s in st}
    on_card = device.startswith("cuda")
    if on_card:
        log(f"device: {torch.cuda.get_device_name(0)}; {_power_limit()}")

    props = dict(config["session"])
    trace_dir = None
    hash_calls, span_clock, profile = HashCalls(), SpanClock(), DeviceProfile()
    if trace:
        trace_dir = tempfile.mkdtemp(prefix="bench-traces-")
        props.update(query_trace=True, query_trace_dir=trace_dir)
        span_clock.install()
        if on_card:
            hash_calls.stream = profile.make_stream()
            hash_calls.install()
    runner = LocalQueryRunner(Session(catalog="tpch", schema=schema, properties=props),
                              device=device)
    server = PrestoTpuServer(runner, port=0)
    server.start()
    if fault is not None:
        fault(server)
    url = f"http://127.0.0.1:{server.port}"
    clients = Clients()
    try:
        # set-up: each query alone (its column sets generated and made
        # resident), then every statement with all streams at once
        t0 = time.perf_counter()
        firsts = {}
        for st in streams:
            for s in st:
                firsts.setdefault(s.query, s)
        rounds = [[_pairs([s])] for s in firsts.values()] + [[_pairs(st) for st in streams]]
        clients.send({"cmd": "warm", "url": url, "rounds": rounds, "timeout_s": 1200})
        warm = clients.recv()["warm"]
        bad = [w for w in warm if w[2]]
        log(f"setup: warm-up of {len(warm)} statements in {time.perf_counter() - t0:.2f} s; "
            f"each query's first: " + ", ".join(f"{w[0]} {w[1]:.3f} s" for w in warm[:len(firsts)]))
        if bad:
            log(f"setup: {len(bad)} warm-up statements failed, first: {bad[0]}")
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            if trace:
                profile.start()
        counters0 = METRICS.snapshot()
        host = HostLoad()
        host.start()

        # the window
        clients.send({"cmd": "run", "url": url, "seconds": seconds, "drain_s": DRAIN_S,
                      "streams": [_pairs(st) for st in streams]})
        clients.recv()  # {"started": ...}
        t_window = time.perf_counter()
        setup_s = t_window - t_start
        if trace and on_card:
            length = min(PROFILE_MAX_S, seconds / 2)
            time.sleep(max(0.0, (seconds - length) / 2))
            profile.open_window()
            hash_calls.active = True
            time.sleep(length)
            hash_calls.active = False
            profile.close_window()
        done = clients.recv()
        host_load = host.stop()
        if trace and on_card:
            profile.stop()
        counters = {k: v - counters0.get(k, 0) for k, v in METRICS.snapshot().items()
                    if isinstance(v, (int, float)) and v != counters0.get(k, 0)}
        builds = counters.get("kernel_cache.misses", 0)
        memory_peak = torch.cuda.max_memory_allocated(0) if on_card else 0
    finally:
        clients.close()
        server.stop()
        span_clock.uninstall()
        hash_calls.uninstall()
    del runner, server

    # the answers
    w0, w1 = done["window"]
    answers = []
    for q in done["queries"]:
        st = by_key[q["key"]]
        q.update(query=st.query, params=st.params)
        q["latency_s"] = (q["t1"] if q.get("in_window") else w1) - q["t0"]
        answers.append(q)
    in_window = [q for q in answers if q.get("in_window") and "error" not in q]
    log(f"window: {len(answers)} queries sent, {len(in_window)} answered in the window, "
        f"{len(done['stuck'])} streams still busy after the drain; compositions built in "
        f"the window {builds:g}")
    log("window counters: " + ", ".join(f"{k} {v:g}" for k, v in sorted(counters.items())))
    log("host over the window and its drain: " + ", ".join(
        f"{k} {v:.6g}" for k, v in host_load.items()))
    log(window_profile(answers, w0, w1))

    # the check, once the window has closed and the server has stopped
    t_ref = time.perf_counter()
    due = [a for a in answers if "rows" in a]
    wanted = reference_rows(due, queries, sf)
    verdict = compare.judge(answers, queries, wanted)
    log(f"reference: {len(wanted)} statements in {time.perf_counter() - t_ref:.2f} s, "
        f"{verdict['compared']} answers compared")

    rows_of = source_rows(queries, sf)
    result = {"correct": verdict["correct"], "attempted": len(answers),
              "failed": verdict["failed"]}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": int(cell["entry"]["chips"]), "memory_peak_bytes": int(memory_peak)}
    if not trace:
        window_s = w1 - w0
        values = {
            "source_rows_per_s": sum(rows_of[q["query"]] for q in in_window) / window_s,
            "queries_per_s": len(in_window) / window_s,
            "latency_p90_s": p90([q["latency_s"] for q in answers]) if answers else None,
            "setup_s": setup_s,
        }
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                             for m in cell["end_to_end"] if values.get(m["name"]) is not None}
    else:
        run = {"answers": in_window, "spans": read_spans(trace_dir, span_clock.epochs),
               "device": None, "hash_calls": [], "hash_kernel_s": None}
        if on_card:
            events = profile.device_events()
            lo, hi = profile.window
            busy = union_length([(s, e) for _, s, e in events], lo, hi) / 1e9
            run["device"] = {"window_ns": (lo, hi), "events": events,
                             "busy_s": busy, "window_s": (hi - lo) / 1e9}
            run["hash_calls"] = hash_calls.finish()
            # the kernels of the calls recorded in the sub-window: those that start in it
            run["hash_kernel_s"] = sum(e - s for n, s, e in events
                                       if lo <= s < hi and HASH_KERNEL.search(n)) / 1e9
            log(f"profile: {profile.note}; {len(run['hash_calls'])} hash-table calls, ht_* "
                f"kernels {run['hash_kernel_s']:.6f} s, window {(hi - lo) / 1e9:.3f} s")
            device_info.update(busy_s=busy, window_s=(hi - lo) / 1e9)
            result["breakdown"] = breakdown(run)
        shutil.rmtree(trace_dir, ignore_errors=True)
        metrics = {}
        for m in cell["per_layer"]:
            value = spec.metric_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
    result["device"] = device_info
    result["checks"] = verdict["checks"]
    return result


def window_profile(answers: List[dict], w0: float, w1: float) -> str:
    """Queries answered in each fifth of the window, and each query's mean
    latency: whether a run was slow throughout or in a stretch."""
    edges = [w0 + (w1 - w0) * i / 5 for i in range(6)]
    done = [q["t1"] for q in answers if q.get("in_window") and "error" not in q]
    counts = [sum(1 for t in done if a < t <= b) for a, b in zip(edges, edges[1:])]
    by_query: Dict[str, List[float]] = defaultdict(list)
    for q in answers:
        by_query[q["query"]].append(q["latency_s"])
    means = ", ".join(f"{k} {sum(v) / len(v):.3f} s ({len(v)})"
                      for k, v in sorted(by_query.items()))
    return f"window: answered by fifths {counts}; mean latency by query {means}"


def breakdown(run: dict) -> dict:
    """The device operations that took most time, and the longest idle
    gaps, each labelled by the innermost flight-recorder span open then."""
    dev = run["device"]
    lo, hi = dev["window_ns"]
    by_name: Dict[str, float] = defaultdict(float)
    for n, s, e in dev["events"]:
        by_name[n] += max(0, min(e, hi) - max(s, lo)) / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    spans = [sp for q in run["spans"].values() for sp in q["spans"]]
    idle = sorted(gaps([(s, e) for _, s, e in dev["events"]], lo, hi),
                  key=lambda g: g[0] - g[1])[:10]
    labelled = [[innermost(spans, (a + b) / 2) or "no query span open", (b - a) / 1e9]
                for a, b in idle]
    return {"device_ops": [[n[:NAME_CHARS], v] for n, v in ops], "idle_gaps": labelled}
