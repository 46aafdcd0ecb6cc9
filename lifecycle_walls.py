#!/usr/bin/env python3
"""The port's cluster lifecycle at scale, and its server distribution booted
from a fresh unpack, on one NVIDIA GPU.

    python3 lifecycle_walls.py [--schema sf1] [--dist] [--drives churn,rolling,chaos,forensics]
                               [--device cuda|cpu] [--out walls_out/lifecycle_walls.jsonl]

Runs ``chip_smoke.py`` phase 26's drives (``lifecycle_churn``,
``lifecycle_rolling_upgrade``, ``lifecycle_chaos``, ``lifecycle_forensics``)
with every worker and the single-node run on ``--device``: churn and the
rolling upgrade at ``--schema``, chaos and forensics at ``tiny``, as the
reference's dry runs take them. Each drive fails on a broken invariant.

``--dist`` builds the tarball (``presto_tpu_torch.dist``), unpacks it into
``walls_out/dist/``, starts ``bin/launcher start`` on a free port with
``session.schema`` = ``--schema`` and ``session.hash_kernels=pallas``, and
serves TPC-H Q3 and Q6 through the port's ``StatementClient``, cold and
warm, with rows equal to the in-process runs; the first query builds the
hash-table kernels from the unpacked source. Then ``bin/launcher stop``
(``status`` must exit 3), a second start whose first Q3 finds the kernels
built, and a last stop.

Writes one JSON line per record to ``--out`` and ``DRIVE`` lines to
stdout, and closes with the card's name and power limit. Exits 2 without
CUDA unless ``--device cpu`` is given, non-zero on any failure. It imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import tarfile
import time
import urllib.request

HERE = os.path.dirname(os.path.abspath(__file__))
DRIVES = ("churn", "rolling", "chaos", "forensics")
# the scale of each drive the reference runs at tiny whatever --schema says
TINY_DRIVES = ("chaos", "forensics")
DIST_QUERIES = (3, 6)


def card_line(device) -> str:
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    return out[0] if out else "nvidia-smi gave nothing"


def _launcher(base: str, *args) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([os.path.join(base, "bin", "launcher"), *args], capture_output=True,
                          text=True, timeout=120, env=env, cwd=base)


def _ended(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split()[2] == "Z"
    except FileNotFoundError:
        return True


def _serve(base: str, port: int, device) -> float:
    """``bin/launcher start`` and wait until ``/v1/info`` answers; returns
    the seconds it took."""
    args = ["start"] + (["--device", "cpu"] if device.type != "cuda" else [])
    t0 = time.perf_counter()
    started = _launcher(base, *args)
    if started.returncode != 0:
        raise AssertionError(f"DIST: bin/launcher start: {started.stdout}{started.stderr}")
    deadline = time.monotonic() + 300.0
    while True:
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/info", timeout=2.0):
                return time.perf_counter() - t0
        except OSError:
            if time.monotonic() > deadline or _launcher(base, "status").returncode != 0:
                with open(os.path.join(base, "var", "log", "server.log")) as f:
                    raise AssertionError(f"DIST: the server never answered:\n{f.read()[-3000:]}")
            time.sleep(0.2)


def _stop(base: str) -> None:
    with open(os.path.join(base, "var", "run", "server.pid")) as f:
        pid = int(f.read())
    stopped = _launcher(base, "stop")
    status = _launcher(base, "status")
    if stopped.returncode != 0 or not _ended(pid) or status.returncode != 3:
        raise AssertionError(f"DIST: stop left the server running: {stopped.stdout} "
                             f"{status.returncode} {status.stdout}")


def dist_drive(device, schema: str, out_dir: str, card: str) -> dict:
    """The distribution booted from a fresh unpack (see the module
    docstring); returns its record."""
    import chip_smoke as cs
    from presto_tpu_torch import dist
    from presto_tpu_torch.client import StatementClient
    from presto_tpu_torch.models.tpch_sql import QUERIES

    root = os.path.join(out_dir, "dist")
    shutil.rmtree(root, ignore_errors=True)
    tar_path = dist.build(root)
    with tarfile.open(tar_path) as tar:
        tar.extractall(os.path.join(root, "unpacked"), filter="data")
    base = os.path.join(root, "unpacked", dist.NAME)
    build_dir = os.path.join(base, "lib", "presto_tpu_torch", "kernels", "build")
    if os.path.exists(build_dir):
        raise AssertionError("DIST: the unpacked package holds a kernel build")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    conf = os.path.join(base, "etc", "config.properties")
    with open(conf) as f:
        text = f.read().replace("http-server.http.port=8080", f"http-server.http.port={port}")
    text = text.replace("session.schema=tiny", f"session.schema={schema}")
    with open(conf, "w") as f:
        f.write(text + "session.hash_kernels=pallas\n")
    single = cs.sql_runner(device, "pallas", schema)
    want = {q: single.execute(QUERIES[q]).rows for q in DIST_QUERIES}
    del single
    uri = f"http://127.0.0.1:{port}"

    def served(q: int) -> float:
        t0 = time.perf_counter()
        rows = list(StatementClient(uri, QUERIES[q], poll_interval_s=0.01).rows())
        wall = time.perf_counter() - t0
        if not cs.same_json_rows(rows, want[q]):
            raise AssertionError(f"DIST Q{q}: the served rows differ from the in-process run's:"
                                 f"\n{rows}\n{want[q]}")
        return wall

    rec = {"schema": schema, "tarball_bytes": os.path.getsize(tar_path)}
    try:
        rec["start_s"] = _serve(base, port, device)
        for q in DIST_QUERIES:
            rec[f"q{q}_first_s"] = served(q)
            rec[f"q{q}_warm_s"] = served(q)
        built = sorted(os.listdir(build_dir)) if os.path.isdir(build_dir) else []
        if device.type == "cuda" and not any(n.endswith(".so") for n in built):
            raise AssertionError(f"DIST: no kernel was built in the unpacked tree: {built}")
        rec["built"] = built
    finally:
        _stop(base)
    try:
        rec["restart_s"] = _serve(base, port, device)
        rec["q3_first_after_restart_s"] = served(3)
    finally:
        _stop(base)
    cs.log(f"DRIVE dist {schema} ({card}): {dist.NAME}.tar.gz {rec['tarball_bytes']} bytes; "
           f"bin/launcher start answered in {rec['start_s']:.2f}s; Q3 first (builds "
           f"{rec['built']}) {rec['q3_first_s']:.4f}s, warm {rec['q3_warm_s']:.4f}s; Q6 first "
           f"{rec['q6_first_s']:.4f}s, warm {rec['q6_warm_s']:.4f}s; rows equal to the "
           f"in-process runs; stop ended the process and status exited 3; after a restart "
           f"({rec['restart_s']:.2f}s) Q3 first {rec['q3_first_after_restart_s']:.4f}s with the "
           f"kernels built; stopped again")
    return {"DIST": rec}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--schema", default="sf1")
    ap.add_argument("--dist", action="store_true")
    ap.add_argument("--drives", default=",".join(DRIVES))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=os.path.join(HERE, "walls_out", "lifecycle_walls.jsonl"))
    args = ap.parse_args()
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("lifecycle_walls: CUDA is not available (pass --device cpu to run on the CPU)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    device = torch.device("cuda", 0) if args.device == "cuda" else torch.device("cpu")
    card = card_line(device)
    if device.type == "cuda":
        cs.build_kernels()
    drives = {"churn": cs.lifecycle_churn, "rolling": cs.lifecycle_rolling_upgrade,
              "chaos": cs.lifecycle_chaos, "forensics": cs.lifecycle_forensics}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a") as out:
        def record(recs: dict) -> None:
            for key, rec in recs.items():
                line = {"drive": key, "card": card, **rec}
                out.write(json.dumps(line, default=str) + "\n")
                print("DRIVE " + json.dumps(line, default=str), flush=True)

        for name in args.drives.split(","):
            if not name:
                continue
            schema = "tiny" if name in TINY_DRIVES else args.schema
            t0 = time.perf_counter()
            record(drives[name](device, schema, card=card))
            cs.log(f"DRIVE {name} {schema}: {time.perf_counter() - t0:.1f}s")
        if args.dist:
            record(dist_drive(device, args.schema,
                              os.path.dirname(os.path.abspath(args.out)), card))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
