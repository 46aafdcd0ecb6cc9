"""Build a standalone server distribution tarball of the port: the
counterpart of ``tools/make_dist.py``, with its on-disk layout::

    presto-tpu-torch-server-<version>/
      bin/launcher            # run|start|stop|status, pid + log files
      lib/presto_tpu_torch/   # the package, with kernels/hash_table.cu and
                              # native/pcol.cpp; nothing built
      etc/config.properties   # template: port, node id, session defaults
      etc/catalog/tpch.properties
      plugin/                 # drop-in python plugins (load_plugins)
      README.txt

Run: ``python -m presto_tpu_torch.dist [--out dist/]``; it prints the
tarball's path and size on stderr. The launcher fronts
``python3 -m presto_tpu_torch.server --etc etc`` and passes any further
arguments through (``bin/launcher start --device cpu``). An unpacked
server builds its CUDA kernels and ``libpcol`` from its own sources, into
``lib/presto_tpu_torch/kernels/build/`` and ``native/build/``, at first use.
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
import tarfile

VERSION = "0.1"
NAME = f"presto-tpu-torch-server-{VERSION}"

LAUNCHER = """#!/bin/sh
# presto-tpu-torch server launcher: run|start|stop|status [server arguments]
BASE="$(cd "$(dirname "$0")/.." && pwd)"
PIDFILE="$BASE/var/run/server.pid"
LOGFILE="$BASE/var/log/server.log"
mkdir -p "$BASE/var/run" "$BASE/var/log"
export PYTHONPATH="$BASE/lib:$PYTHONPATH"
alive() {
  kill -0 "$1" 2>/dev/null || return 1
  # a process that ended but is not reaped yet is not running
  [ "$(cut -d' ' -f3 "/proc/$1/stat" 2>/dev/null)" != "Z" ]
}
CMD="$1"
[ $# -gt 0 ] && shift

case "$CMD" in
  run)
    exec python3 -m presto_tpu_torch.server --etc "$BASE/etc" "$@"
    ;;
  start)
    if [ -f "$PIDFILE" ] && alive "$(cat "$PIDFILE")"; then
      echo "already running (pid $(cat "$PIDFILE"))"; exit 0
    fi
    nohup python3 -m presto_tpu_torch.server --etc "$BASE/etc" "$@" \\
        >> "$LOGFILE" 2>&1 &
    echo $! > "$PIDFILE"
    echo "started (pid $(cat "$PIDFILE"))"
    ;;
  stop)
    if [ -f "$PIDFILE" ]; then
      PID="$(cat "$PIDFILE")"
      kill "$PID" 2>/dev/null
      # the process holds a CUDA context: stop returns once it is gone
      i=0
      while alive "$PID" && [ $i -lt 100 ]; do
        sleep 0.1; i=$((i + 1))
      done
      alive "$PID" && kill -9 "$PID" 2>/dev/null
      rm -f "$PIDFILE"; echo stopped
    else
      echo "not running"
    fi
    ;;
  status)
    if [ -f "$PIDFILE" ] && alive "$(cat "$PIDFILE")"; then
      echo "running (pid $(cat "$PIDFILE"))"
    else
      echo "not running"; exit 3
    fi
    ;;
  *)
    echo "usage: $0 {run|start|stop|status} [server arguments]"; exit 2
    ;;
esac
"""

CONFIG = """# presto-tpu-torch server configuration (etc/config.properties template)
http-server.http.port=8080
node.id=node-1
session.catalog=tpch
session.schema=tiny
# session.<property>=<value> sets a session default, e.g.
# session.hash_kernels=pallas
# http-server.authentication.type=PASSWORD
# password-authenticator.config-file=etc/password.db
"""

TPCH_CATALOG = "connector.name=tpch\n"

README = """presto-tpu-torch server distribution %s

  bin/launcher run      # foreground
  bin/launcher start    # background (var/log/server.log, var/run/server.pid)
  bin/launcher stop
  bin/launcher status   # exit 3 when not running

Further arguments go to the server: bin/launcher start --device cpu runs
without a GPU. By default queries run on CUDA device 0; the first query
that needs a hash-table kernel builds it with nvcc from
lib/presto_tpu_torch/kernels/hash_table.cu into kernels/build/, which must
be writable.

Catalogs live in etc/catalog/*.properties (connector.name= names a
factory: tpch, tpcds, memory, blackhole, file, hive, kafka, sqlite,
raptor, remote, or one contributed by a python plugin dropped into
plugin/ as presto_tpu_torch_plugin_<name>).
""" % VERSION

# what a copy of the package leaves out: caches and anything built
IGNORED = ("__pycache__", "*.pyc", "*.so", "*.tmp", "build")


def build(out_dir: str) -> str:
    """Stage the distribution under ``out_dir`` and pack it; returns the
    tarball's path."""
    package = os.path.dirname(os.path.abspath(__file__))
    stage = os.path.join(out_dir, NAME)
    if os.path.isdir(stage):
        shutil.rmtree(stage)
    os.makedirs(os.path.join(stage, "bin"))
    os.makedirs(os.path.join(stage, "etc", "catalog"))
    os.makedirs(os.path.join(stage, "plugin"))

    shutil.copytree(package, os.path.join(stage, "lib", "presto_tpu_torch"),
                    ignore=shutil.ignore_patterns(*IGNORED))
    launcher = os.path.join(stage, "bin", "launcher")
    with open(launcher, "w") as f:
        f.write(LAUNCHER)
    os.chmod(launcher, 0o755)
    with open(os.path.join(stage, "etc", "config.properties"), "w") as f:
        f.write(CONFIG)
    with open(os.path.join(stage, "etc", "catalog", "tpch.properties"), "w") as f:
        f.write(TPCH_CATALOG)
    with open(os.path.join(stage, "README.txt"), "w") as f:
        f.write(README)

    tar_path = os.path.join(out_dir, f"{NAME}.tar.gz")
    with tarfile.open(tar_path, "w:gz") as tar:
        tar.add(stage, arcname=NAME)
    return tar_path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m presto_tpu_torch.dist")
    ap.add_argument("--out", default="dist")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    tar_path = build(args.out)
    # on stderr, as the package's other non-renderer output
    print(f"{tar_path} ({os.path.getsize(tar_path) / 1e6:.1f} MB)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
