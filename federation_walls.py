#!/usr/bin/env python3
"""Walls of the federated catalogs' host conversions on one NVIDIA GPU, to
compare two checkouts of the port on one card.

    python3 federation_walls.py [--root DIR] [--schema sf1] [--rounds 3]
                                [--steps ctas,q3,perday,kafka,remote]

Imports ``presto_tpu_torch`` from ``--root`` (default: this script's
directory), builds its kernels, and runs the steps of ``chip_smoke.py``'s
phase 20 whose walls the connectors' value conversions move, each in a
runner with ``hash_kernels="pallas"`` under the session defaults and each
run ending in ``torch.cuda.synchronize()``:

- ``ctas``: the CTAS of ``orders`` (``chip_smoke.FED_ORDERS``) into a
  sqlite file, ``--rounds`` times (the table dropped between), the
  dbapi sink's conversion of every written value;
- ``q3``: TPC-H Q3 over the sqlite ``customer`` and ``orders``, cold and
  ``--rounds`` warm (``_typed_block`` over the fetched rows);
- ``perday``: the per-day grouping over the sqlite ``orders``, likewise;
- ``kafka``: the stream join over the JSON ``orders`` topic, ``--rounds``
  times, each through a new catalog over the same logs, so that each run
  decodes the topic (the record decoder), and after each the decode again
  alone (``decode_s``);
- ``remote``: Q3 with the remote service's ``customer``, cold and warm.

The ``q3``, ``perday`` and ``kafka`` rows are checked against the same
queries over ``tpch``. Prints one ``FEDWALLS`` JSON line per step (the
root, the walls in seconds, the median of those after the first) and the
card's name and power limit. To compare two checkouts, run it once per
checkout in turns (A, B, B, A) in one call on one card. Exits non-zero
without CUDA. It imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

STEPS = ("ctas", "q3", "perday", "kafka", "remote")


def main() -> int:
    ap = argparse.ArgumentParser()
    here = os.path.dirname(os.path.abspath(__file__))
    ap.add_argument("--root", default=here)
    ap.add_argument("--schema", default="sf1")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--steps", default=",".join(STEPS))
    args = ap.parse_args()
    steps = args.steps.split(",")
    if set(steps) - set(STEPS):
        ap.error(f"--steps takes {','.join(STEPS)}")
    import torch

    if not torch.cuda.is_available():
        print("federation_walls: CUDA is not available", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    sys.path.insert(1, here)
    import chip_smoke as cs
    from presto_tpu_torch import kernels
    from presto_tpu_torch.connectors.dbapi import sqlite_connector
    from presto_tpu_torch.connectors.kafka import KafkaConnector
    from presto_tpu_torch.connectors.remote import RemoteConnector
    from presto_tpu_torch.connectors.tpch.connector import SCHEMAS
    from presto_tpu_torch.models.tpch_sql import QUERIES
    from presto_tpu_torch.spi.connector import SchemaTableName

    kernels.build(kernels.SOURCE)
    device = torch.device("cuda", 0)
    schema, sf = args.schema, SCHEMAS[args.schema]
    runner = cs.sql_runner(device, "pallas", schema)
    tmp = tempfile.mkdtemp(prefix="federation-walls-")
    svc = dead_sock = None

    def timed(sql):
        t0 = time.perf_counter()
        res = runner.execute(sql)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    def report(step, walls, **extra):
        """``median_s``: the median of the walls after the first."""
        print("FEDWALLS " + json.dumps({"root": root, "step": step, "schema": schema,
                                        "walls_s": walls,
                                        "median_s": statistics.median(walls[1:] or walls),
                                        **extra}), flush=True)

    def check(step, got, want):
        if not cs.same_rows(got, want):
            raise AssertionError(f"{step}: rows differ: {got[:3]} want {want[:3]}")

    try:
        ext = sqlite_connector("ext", os.path.join(tmp, "ext.db"))
        runner.catalogs.register("ext", ext)
        q3_want = runner.execute(QUERIES[3]).rows
        if {"ctas", "q3", "perday"} & set(steps):
            walls = []
            for r in range(args.rounds if "ctas" in steps else 1):
                if r:
                    runner.execute("drop table ext.main.orders")
                walls.append(timed(f"create table ext.main.orders as select "
                                   f"{', '.join(cs.FED_ORDERS)} from tpch.{schema}.orders")[1])
            if "ctas" in steps:
                report("ctas", walls)
            runner.execute(f"create table ext.main.customer as select "
                           f"{', '.join(cs.FED_CUSTOMER)} from tpch.{schema}.customer")
        for step, sql, want in (
                ("q3", QUERIES[3].replace("from customer, orders, lineitem",
                                          f"from ext.main.customer, ext.main.orders, "
                                          f"tpch.{schema}.lineitem"), q3_want),
                ("perday", cs.FED_DAYS_SQL.format("ext.main.orders"),
                 runner.execute(cs.FED_DAYS_SQL.format(f"tpch.{schema}.orders")).rows
                 if "perday" in steps else None)):
            if step in steps:
                walls = []
                for _ in range(1 + args.rounds):
                    res, s = timed(sql)
                    check(step, res.rows, want)
                    walls.append(s)
                report(step, walls)
        if "kafka" in steps:
            log_dir = os.path.join(tmp, "logs")
            os.makedirs(log_dir)
            n_msgs, _bytes = cs._write_topic(log_dir, sf)
            want = runner.execute(cs.FED_STREAM_SQL.format(f"tpch.{schema}.orders",
                                                           schema)).rows
            walls, decodes = [], []
            for _ in range(args.rounds):
                kafka = KafkaConnector("kafka", log_dir)
                runner.catalogs.register("kafka", kafka)
                res, s = timed(cs.FED_STREAM_SQL.format("kafka.default.orders", schema))
                check("kafka", res.rows, want)
                walls.append(s)
                t0 = time.perf_counter()  # the same decode again, alone
                kafka.metadata()._data.clear()
                kafka.metadata().topic_data(SchemaTableName("default", "orders"))
                decodes.append(time.perf_counter() - t0)
            report("kafka", walls, decode_s=decodes, messages=n_msgs)
        if "remote" in steps:
            svc, endpoint = cs._remote_service(sf)
            dead, dead_sock = cs._closed_endpoint()
            runner.catalogs.register("svc", RemoteConnector("svc", [dead, endpoint],
                                                            timeout_s=60.0))
            sql = QUERIES[3].replace("from customer, orders, lineitem",
                                     f"from svc.sales.customer, tpch.{schema}.orders, "
                                     f"tpch.{schema}.lineitem")
            walls = []
            for _ in range(1 + args.rounds):
                res, s = timed(sql)
                check("remote", res.rows, q3_want)
                walls.append(s)
            report("remote", walls)
    finally:
        if svc is not None:
            svc.stop()
        if dead_sock is not None:
            dead_sock.close()
        shutil.rmtree(tmp, ignore_errors=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(smi or "nvidia-smi gave nothing")
    return 0


if __name__ == "__main__":
    sys.exit(main())
