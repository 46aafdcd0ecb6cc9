#!/usr/bin/env python3
"""Warm SQL walls of the PyTorch port on one NVIDIA GPU, to compare two
checkouts of the port on one card.

    python3 port_walls.py [--root DIR] [--queries 3,9,18] [--schema sf1] [--rounds 3]
    python3 port_walls.py --p14 all            # chip_smoke.py's phase-14 SQL instead

Imports ``presto_tpu_torch`` from ``--root`` (default: this script's
directory), builds its kernels, and runs each TPC-H query as SQL with
``hash_kernels="pallas"`` under the session defaults: once cold (the
resident page cache cleared) and ``--rounds`` times warm, each run ending
in ``torch.cuda.synchronize()``. Prints one ``WALLS`` JSON line per query
(the root, the cold wall, every warm wall and their median, in seconds)
and the card's name and power limit. ``--p14 LABELS`` (comma-separated,
or ``all``) runs the named entries of ``chip_smoke.P14_SQL`` (windows,
FULL joins, the dashboard and sketch groupings) the same way, which keeps
the cold SF1 walls that ``chip_smoke.py`` phase 14 no longer takes. To
compare two checkouts, run it
once per checkout in turns (A, B, B, A) in one call on one card. Exits
non-zero without CUDA. It imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--queries", default="3,9,18")
    ap.add_argument("--schema", default="sf1")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--p14", default="")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("port_walls: CUDA is not available", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from presto_tpu_torch import kernels
    from presto_tpu_torch.metadata import Session
    from presto_tpu_torch.models.tpch_sql import QUERIES
    from presto_tpu_torch.ops.scan import RESIDENT_CACHE
    from presto_tpu_torch.runner import LocalQueryRunner

    kernels.build(kernels.SOURCE)
    device = torch.device("cuda", 0)
    if args.p14:
        from chip_smoke import P14_SQL

        labels = list(P14_SQL) if args.p14 == "all" else args.p14.split(",")
        work = [(label, P14_SQL[label]) for label in labels]
    else:
        work = [(int(x), QUERIES[int(x)]) for x in args.queries.split(",")]
    for q, sql in work:
        runner = LocalQueryRunner(Session(catalog="tpch", schema=args.schema,
                                          properties={"hash_kernels": "pallas"}),
                                  device=device)
        walls = []
        RESIDENT_CACHE.clear()
        for _ in range(1 + args.rounds):
            t0 = time.perf_counter()
            runner.execute(sql)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        print("WALLS " + json.dumps({"root": root, "query": q, "schema": args.schema,
                                     "cold_s": walls[0], "warm_s": walls[1:],
                                     "warm_median_s": statistics.median(walls[1:])}),
              flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(smi or "nvidia-smi gave nothing")
    return 0


if __name__ == "__main__":
    sys.exit(main())
