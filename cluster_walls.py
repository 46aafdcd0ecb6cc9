#!/usr/bin/env python3
"""TPC-H queries through the PyTorch port's cluster on one device: a
``ClusterQueryRunner`` and in-process HTTP ``WorkerServer``s, held against
the single-node runner, with where the host spends each run.

    python3 cluster_walls.py [--queries 3,9,merge] [--schema sf1] [--workers 4]
                             [--rounds 2] [--sample-ms 0]
                             [--out walls_out/cluster_walls.jsonl] [--device cuda]

``--queries`` takes TPC-H query ids and ``merge``, the merge query of
``chip_smoke.py``'s phase 22 (``MERGE_SQL``: ORDER BY without LIMIT, each
worker sorts and the root task merges their streams), which the phase runs
at ``tiny`` and this script at ``--schema``.

Runs each query once with ``LocalQueryRunner`` (the rows to hold the
cluster against), then ``--rounds`` times through the cluster under the
session defaults with ``hash_kernels="pallas"`` (the first round cold: the
resident page cache cleared). Each round prints one ``CLUSTERWALL`` line:
the wall; the seconds the coordinator spent creating tasks
(``SqlQueryScheduler.schedule``) and pulling the root's rows; the HTTP
requests the workers served, by endpoint (task create, task info, results
pulls); ``exchange.frames``/``bytes``/``rows``; whether the rows equal the
single-node run's. ``--sample-ms P`` samples every host thread's stack
every P ms during the last round and adds the commonest frames, as
shares of the samples (``dist_walls.StackSampler``). The same records go
to ``--out``; the card's name and power limit close the output. Exits 0
only when every round's rows are equal, non-zero without CUDA unless
``--device cpu`` is given. It imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import os
import sys
import threading
import time

# chip_smoke.py's CLUSTER_MERGE_SQL
MERGE_SQL = ("select o_orderkey, o_totalprice from orders where o_totalprice > "
             "150000.0 order by o_totalprice desc, o_orderkey")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--queries", default="3,9")
    ap.add_argument("--schema", default="sf1")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--sample-ms", type=float, default=0.0)
    ap.add_argument("--out", default="walls_out/cluster_walls.jsonl")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("cluster_walls: CUDA is not available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from dist_walls import StackSampler, card_line, emit, same_rows
    from presto_tpu_torch.cluster import ClusterQueryRunner, WorkerServer, faults
    from presto_tpu_torch.cluster import scheduler as sched
    from presto_tpu_torch.metadata import Session
    from presto_tpu_torch.models.tpch_sql import QUERIES
    from presto_tpu_torch.ops.scan import RESIDENT_CACHE
    from presto_tpu_torch.runner import LocalQueryRunner
    from presto_tpu_torch.utils.metrics import METRICS

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    session = Session(catalog="tpch", schema=args.schema, properties={"hash_kernels": "pallas"})
    coord = ClusterQueryRunner(session, min_workers=args.workers, device=device)
    workers = [WorkerServer(port=0, device=device).start() for _ in range(args.workers)]
    stop = threading.Event()

    def keep_alive():
        while not stop.wait(1.0):
            for w in workers:
                coord.nodes.announce(w.node_id, w.uri)
    for w in workers:
        coord.nodes.announce(w.node_id, w.uri)
    announcer = threading.Thread(target=keep_alive, daemon=True, name="walls-announce")
    announcer.start()

    # the time the coordinator spends creating tasks, per query
    schedule_s = []
    plain_schedule = sched.SqlQueryScheduler.schedule

    def timed_schedule(self):
        t0 = time.perf_counter()
        try:
            return plain_schedule(self)
        finally:
            schedule_s.append(time.perf_counter() - t0)
    sched.SqlQueryScheduler.schedule = timed_schedule
    # the requests the workers serve, counted by an observing fault rule
    points = ("worker.task_create", "worker.task_info", "worker.results")
    inj = faults.FaultInjector()
    for p in points:
        inj.add(p, faults.CALLBACK, times=None, callback=lambda ctx: None)
    faults.install(inj)

    ok = True
    try:
        for q in (x if x == "merge" else int(x) for x in args.queries.split(",")):
            sql = MERGE_SQL if q == "merge" else QUERIES[q]
            want = LocalQueryRunner(session, device=device).execute(sql).rows
            for rnd in range(args.rounds):
                if rnd == 0:
                    RESIDENT_CACHE.clear()
                last = rnd == args.rounds - 1
                sampler = StackSampler(args.sample_ms / 1e3) if last and args.sample_ms > 0 \
                    else None
                fired0 = [r.fired for r in inj.rules]
                ex0 = {k: METRICS.counter_value(k)
                       for k in ("exchange.frames", "exchange.bytes", "exchange.rows")}
                n_sched = len(schedule_s)
                t0 = time.perf_counter()
                res = coord.execute(sql)
                sync()
                wall = time.perf_counter() - t0
                if sampler is not None:
                    sampler.stop()
                equal = same_rows(res.rows, want)
                ok &= equal
                sched_s = sum(schedule_s[n_sched:])
                rec = {"query": q, "schema": args.schema, "workers": args.workers,
                       "round": rnd, "wall_s": round(wall, 4),
                       "schedule_s": round(sched_s, 4),
                       "after_schedule_s": round(wall - sched_s, 4),
                       "requests": {p: r.fired - f0
                                    for p, r, f0 in zip(points, inj.rules, fired0)},
                       "exchange": {k: int(METRICS.counter_value(k) - v) for k, v in ex0.items()},
                       "rows": len(res.rows), "rows_equal": equal,
                       "stacks": sampler.top() if sampler is not None else None}
                emit("CLUSTERWALL", rec, args.out)
    finally:
        faults.clear()
        sched.SqlQueryScheduler.schedule = plain_schedule
        stop.set()
        announcer.join(5.0)
        coord.detector.stop()
        for w in workers:
            w.stop()
        for w in workers:
            w.join_tasks(60.0)
    print(card_line(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
