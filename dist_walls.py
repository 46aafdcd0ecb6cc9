#!/usr/bin/env python3
"""One TPC-H query through the PyTorch port's distributed runner on one
NVIDIA GPU, held against the single-node runner, with the exchanges'
progress shown while it runs; and a profile of one streaming-exchange
dispatch.

    python3 dist_walls.py [--query 5] [--schema sf1] [--workers 4]
                          [--deadline-s 3000] [--progress-s 30]
                          [--out walls_out/dist_walls.jsonl] [--device cuda]

Runs the query once with ``LocalQueryRunner`` (the rows to hold the
distributed run against), then once with ``DistributedQueryRunner`` on
``MeshContext([device] * workers)`` under the session defaults with
``hash_kernels="pallas"``. Every ``--progress-s`` seconds a ``PROGRESS``
line gives each started exchange's chunks, delivered rows and
``partition_rows``; the same records go to ``--out``. At ``--deadline-s``
(counted from the start of the distributed run) it prints a ``PARTIAL``
line and exits 3 without a result. Otherwise it prints one ``DIST`` line
(wall, rows equal or not, every exchange's stats, ``host_uploads``, the
kernels' launches) and exits 0 only when the rows are equal.
``--no-local`` skips the single-node run (no rows are compared);
``--sample-ms P`` samples every host thread's stack every P ms and adds
the commonest frames, as shares, to the ``PARTIAL`` or ``DIST`` line.

``--profile-dispatch`` instead profiles one dispatch and delivery of a
full REPARTITION chunk (``--columns`` BIGINT columns, the default chunk
rows per worker) with ``torch.profiler``: the host wall of the dispatch,
the count of operators it issues, the host time by operator and the
device time. The card's name and power limit close the output. Exits
non-zero without CUDA unless ``--device cpu`` is given. It imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import threading
import time


def card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip() or "nvidia-smi gave nothing"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def same_rows(got, want, rel_tol: float = 1e-12) -> bool:
    """Equal rows in order: exact, but for floats (relative ``rel_tol``)."""
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        if len(g) != len(w):
            return False
        for a, b in zip(g, w):
            if isinstance(a, float) or isinstance(b, float):
                if not (isinstance(a, float) and isinstance(b, float)
                        and math.isclose(a, b, rel_tol=rel_tol, abs_tol=0.0)):
                    return False
            elif type(a) is not type(b) or a != b:
                return False
    return True


def emit(tag: str, rec: dict, out_path: str) -> None:
    line = json.dumps(rec, default=str)
    print(f"{tag} {line}", flush=True)
    with open(out_path, "a") as f:
        f.write(json.dumps({"tag": tag, **rec}, default=str) + "\n")


def profile_dispatch(device, workers: int, columns: int, reps: int, out_path: str) -> None:
    """One REPARTITION dispatch and its delivery at the default chunk,
    timed on the host and traced with torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from presto_tpu_torch.parallel.mesh import MeshContext
    from presto_tpu_torch.parallel.streaming_exchange import (StreamingExchange,
                                                              _ChunkState)
    from presto_tpu_torch.types import BIGINT

    mesh = MeshContext([device] * workers)
    types = [BIGINT] * columns
    ex = StreamingExchange(mesh, 0, "repartition", [0], types, [None] * columns)
    C = ex.chunk_rows
    gen = torch.Generator(device="cpu").manual_seed(7)

    def full_state():
        state = []
        for _ in range(workers):
            datas = tuple(torch.randint(0, 1 << 40, (C,), generator=gen).to(device)
                          for _ in types)
            nulls = tuple(torch.zeros(C, dtype=torch.bool, device=device) for _ in types)
            st = _ChunkState(datas, nulls, torch.ones(C, dtype=torch.bool, device=device))
            st.count = C
            state.append(st)
        return state

    def one(state):
        queue = [[] for _ in range(workers)]
        dispatched = ex._dispatch(state, queue)
        for _ in ex._deliver_gen(dispatched):
            pass
        for w in range(workers):  # what the consumers would take
            while ex._out[w].poll() is not None:
                pass

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    one(full_state())
    sync()
    walls = []
    for _ in range(reps):
        state = full_state()
        sync()
        t0 = time.perf_counter()
        one(state)
        sync()
        walls.append(time.perf_counter() - t0)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    state = full_state()
    sync()
    with profile(activities=acts) as prof:
        one(state)
        sync()
    events = prof.key_averages()
    rows = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)
    top = [{"op": e.key, "calls": e.count, "self_cpu_ms": e.self_cpu_time_total / 1e3,
            "device_ms": getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0)) / 1e3}
           for e in rows[:20]]
    aten = [e for e in events if e.key.startswith("aten::")]
    rec = {"workers": workers, "columns": columns, "chunk_rows": C, "out_cap": ex.out_cap,
           "host_wall_ms": [w * 1e3 for w in walls],
           "ops": sum(e.count for e in aten),
           "self_cpu_ms": sum(e.self_cpu_time_total for e in events) / 1e3,
           "device_ms": sum(getattr(e, "self_device_time_total",
                                    getattr(e, "self_cuda_time_total", 0))
                            for e in events) / 1e3,
           "top": top}
    emit("DISPATCH", rec, out_path)
    print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=25), flush=True)


class StackSampler:
    """Every ``period_s``, each other thread's innermost frame in
    ``presto_tpu_torch`` and the frame it is in (a wait, a torch call):
    where the host threads spend the run, as shares of the samples."""

    def __init__(self, period_s: float):
        self.counts: dict = {}
        self.n = 0
        self._me = set()
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._run, args=(period_s,), daemon=True,
                                        name="dist-walls-sampler")
        self._thread.start()

    def stop(self) -> None:
        self._done.set()
        self._thread.join(5.0)

    def _run(self, period_s: float) -> None:
        self._me.add(threading.get_ident())
        while not self._done.wait(period_s):
            names = {t.ident: t.name for t in threading.enumerate()}
            for ident, frame in sys._current_frames().items():
                if ident in self._me or names.get(ident, "").startswith("dist-walls"):
                    continue
                leaf = f"{os.path.basename(frame.f_code.co_filename)}:{frame.f_code.co_name}"
                f = frame
                while f is not None and "presto_tpu_torch" not in f.f_code.co_filename:
                    f = f.f_back
                ours = "-" if f is None else (f"{f.f_code.co_filename.split('presto_tpu_torch/')[-1]}"
                                              f":{f.f_code.co_name}:{f.f_lineno}")
                key = f"{ours} <- {leaf}"
                self.counts[key] = self.counts.get(key, 0) + 1
            self.n += 1

    def top(self, k: int = 40) -> list:
        total = max(sum(self.counts.values()), 1)
        return [[key, c, round(c / total, 4)] for key, c in
                sorted(self.counts.items(), key=lambda kv: -kv[1])[:k]]


def exchanges_now(live) -> list:
    return [{k: (round(v, 4) if isinstance(v, float) else v)
             for k, v in ex.stats.items()} for ex in list(live)]


def run_query(args, device, out_path: str) -> int:
    import torch

    from presto_tpu_torch import kernels
    from presto_tpu_torch.metadata import Session
    from presto_tpu_torch.models.tpch_sql import QUERIES
    from presto_tpu_torch.ops import pallas_hash as ph
    from presto_tpu_torch.ops.scan import RESIDENT_CACHE
    from presto_tpu_torch.parallel import streaming_exchange as sx
    from presto_tpu_torch.parallel.mesh import MeshContext
    from presto_tpu_torch.parallel.runner import EXCHANGE_STATS, DistributedQueryRunner
    from presto_tpu_torch.runner import LocalQueryRunner

    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    if on_card:
        kernels.build(kernels.SOURCE)
    props = {"hash_kernels": "pallas"}
    sql = QUERIES[args.query]

    local = local_s = None
    if not args.no_local:
        t0 = time.perf_counter()
        local = LocalQueryRunner(Session(catalog="tpch", schema=args.schema,
                                         properties=props), device=device).execute(sql)
        sync()
        local_s = time.perf_counter() - t0
        emit("LOCAL", {"query": args.query, "schema": args.schema, "wall_s": local_s,
                       "rows": len(local.rows)}, out_path)
        RESIDENT_CACHE.clear()

    # every exchange the run starts, to read its stats while it runs
    live = []
    init = sx.StreamingExchange.__init__

    def registering_init(self, *a, **kw):
        init(self, *a, **kw)
        live.append(self)
    sx.StreamingExchange.__init__ = registering_init

    uploads0 = EXCHANGE_STATS["host_uploads"]
    ph.insert_table.launches = 0
    ph.probe_table.launches = 0
    done = threading.Event()
    start = time.perf_counter()
    samples = StackSampler(args.sample_ms / 1e3) if args.sample_ms > 0 else None

    def monitor():
        while not done.wait(args.progress_s):
            elapsed = time.perf_counter() - start
            rec = {"elapsed_s": elapsed, "exchanges": exchanges_now(live),
                   "host_uploads": EXCHANGE_STATS["host_uploads"] - uploads0,
                   "launches": {"insert": ph.insert_table.launches,
                                "probe": ph.probe_table.launches}}
            if elapsed >= args.deadline_s:
                if samples is not None:
                    rec["stacks"] = samples.top()
                emit("PARTIAL", {"query": args.query, "schema": args.schema,
                                 "workers": args.workers, "card": card_line(), **rec},
                     out_path)
                os._exit(3)
            emit("PROGRESS", rec, out_path)

    threading.Thread(target=monitor, daemon=True, name="dist-walls-monitor").start()
    runner = DistributedQueryRunner(MeshContext([device] * args.workers),
                                    Session(catalog="tpch", schema=args.schema,
                                            properties=props), device=device)
    res = runner.execute(sql)
    sync()
    wall = time.perf_counter() - start
    done.set()
    equal = same_rows(res.rows, local.rows) if local is not None else None
    emit("DIST", {"query": args.query, "schema": args.schema, "workers": args.workers,
                  "wall_s": wall, "local_wall_s": local_s, "rows": len(res.rows),
                  "rows_equal": equal, "exchange": res.stats.get("exchange"),
                  "stacks": samples.top() if samples is not None else None,
                  "host_uploads": EXCHANGE_STATS["host_uploads"] - uploads0,
                  "launches": {"insert": ph.insert_table.launches,
                               "probe": ph.probe_table.launches}}, out_path)
    if equal is False:
        print(f"rows differ:\n{res.rows}\n{local.rows}", file=sys.stderr)
    return 1 if equal is False else 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--query", type=int, default=5)
    ap.add_argument("--schema", default="sf1")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--deadline-s", type=float, default=3000.0)
    ap.add_argument("--progress-s", type=float, default=30.0)
    ap.add_argument("--out", default="walls_out/dist_walls.jsonl")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile-dispatch", action="store_true")
    ap.add_argument("--no-local", action="store_true")
    ap.add_argument("--sample-ms", type=float, default=0.0)
    ap.add_argument("--columns", type=int, default=5)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("dist_walls: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    if args.profile_dispatch:
        profile_dispatch(device, args.workers, args.columns, args.reps, args.out)
        rc = 0
    else:
        rc = run_query(args, device, args.out)
    print(card_line(), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
