#!/usr/bin/env python3
"""Walls of the file catalog's long-text path in the PyTorch port on one
NVIDIA GPU: TPC-H ``l_comment`` written to PCOL and scanned with a LIKE.

    python3 file_walls.py [--schema sf1] [--rounds 2]

Registers a ``FileConnector`` catalog (PCOL) in a temporary directory that
it removes, builds the port's kernels, then runs with
``hash_kernels="pallas"`` under the session defaults: one CTAS of
``l_orderkey, l_comment`` from ``tpch.<schema>.lineitem`` on the scaled
writers (each writer turns its share of the generator's packed comments
into strings, a dictionary and a JSON header), and ``COMMENT_SQL`` over
the written table once cold (the metadata load parses every header and
unions the files' dictionaries) and ``--rounds`` times warm, each run
ending in ``torch.cuda.synchronize()``. Every scan's rows must equal the
same query over ``tpch``, whose LIKE runs over the packed dictionary on
the card. Prints one ``FILEWALLS`` JSON line (the CTAS wall, files and
bytes, the scan walls in seconds) and the card's name and power limit.
Exits non-zero without CUDA or when the rows differ. It imports nothing
of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

COMMENT_SQL = ("select count(*), sum(l_orderkey) from {} "
               "where l_comment like '%special%requests%'")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--schema", default="sf1")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("file_walls: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from presto_tpu_torch import kernels
    from presto_tpu_torch.connectors.file import FileConnector
    from presto_tpu_torch.metadata import Session
    from presto_tpu_torch.runner import LocalQueryRunner

    kernels.build(kernels.SOURCE)
    runner = LocalQueryRunner(Session(catalog="tpch", schema=args.schema,
                                      properties={"hash_kernels": "pallas"}),
                              device=torch.device("cuda", 0))
    tmp = tempfile.mkdtemp(prefix="file-walls-")
    try:
        runner.catalogs.register("wh", FileConnector("wh", tmp))

        def timed(sql):
            t0 = time.perf_counter()
            res = runner.execute(sql)
            torch.cuda.synchronize()
            return res, time.perf_counter() - t0

        res, ctas_s = timed(f"create table wh.default.comments as select l_orderkey, "
                            f"l_comment from tpch.{args.schema}.lineitem")
        rows = res.rows[0][0]
        table = os.path.join(tmp, "default", "comments")
        files = {f: os.path.getsize(os.path.join(table, f)) for f in os.listdir(table)
                 if not f.startswith("00000000.")}
        want = runner.execute(COMMENT_SQL.format(f"tpch.{args.schema}.lineitem")).rows
        scans = []
        for _ in range(1 + args.rounds):
            res, s = timed(COMMENT_SQL.format("wh.default.comments"))
            if res.rows != want or not want[0][0]:
                print(f"file_walls: the file table gives {res.rows}, tpch {want}",
                      file=sys.stderr)
                return 1
            scans.append(s)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("FILEWALLS " + json.dumps({
        "schema": args.schema, "rows": rows, "files": len(files),
        "bytes": sum(files.values()), "ctas_s": ctas_s, "scan_cold_s": scans[0],
        "scan_warm_s": scans[1:], "rows_kept": want[0][0]}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(smi or "nvidia-smi gave nothing")
    return 0


if __name__ == "__main__":
    sys.exit(main())
