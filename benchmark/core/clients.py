"""The clients: one process, one thread per stream, the port's StatementClient.

Run as ``python clients.py <checkout root>``; it talks to the harness over
its standard input and output, one JSON object per line. It loads the
program's client module (``presto_tpu_torch/client/__init__.py``) by its
path, so this process imports neither torch nor the engine, as a user's
client would not.

Commands:
- ``{"cmd": "warm", "url", "rounds": [[lane, ...], ...]}``, a lane being
  ``[[key, sql], ...]``: in each round, every lane at once, each sending
  its statements in turn; rounds one after another. Replies ``{"warm":
  [[key, seconds, error or null], ...]}``.
- ``{"cmd": "run", "url", "seconds", "drain_s", "streams": [[[key, sql],
  ...], ...]}``: every stream at once, each sending its statements in turn,
  round after round, a statement when the one before has come back, until
  ``seconds`` have passed. Replies ``{"started": t}`` when the streams are
  released, then ``{"queries": [...], "window": [t0, t1]}``: every query
  sent, with its stream, key, server query id, post and end times (this
  process's clock), its rows or its error, and ``in_window`` (it came back
  before the window closed). A query still running at the close is waited
  for, ``drain_s`` at most.
- ``{"cmd": "quit"}``.
"""
from __future__ import annotations

import importlib.util
import json
import sys
import threading
import time
from pathlib import Path


def load_client_module(root: str):
    path = Path(root) / "presto_tpu_torch" / "client" / "__init__.py"
    spec = importlib.util.spec_from_file_location("presto_tpu_torch_client", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # its dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def make_client_class(mod):
    class IdClient(mod.StatementClient):
        """The program's StatementClient, keeping the server's query id."""

        query_id = None

        def _request(self, method, url, body=None):
            payload = super()._request(method, url, body)
            if self.query_id is None and isinstance(payload, dict):
                self.query_id = payload.get("id")
            return payload

    return IdClient


def run_one(client_cls, url: str, key: str, sql: str, timeout_s: float) -> dict:
    c = client_cls(url, sql, timeout_s=timeout_s)
    t0 = time.perf_counter()
    rec = {"key": key, "t0": t0}
    try:
        rec["rows"] = list(c.rows())
    except Exception as e:  # noqa: BLE001 - every failure is reported to the harness
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
    rec["t1"] = time.perf_counter()
    rec["query_id"] = c.query_id
    return rec


def warm(client_cls, cmd: dict) -> dict:
    out = []
    for lanes in cmd["rounds"]:
        recs = [[] for _ in lanes]

        def go(i, lane):
            for key, sql in lane:
                recs[i].append(run_one(client_cls, cmd["url"], key, sql, cmd["timeout_s"]))

        threads = [threading.Thread(target=go, args=(i, lane), daemon=True)
                   for i, lane in enumerate(lanes)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        out += [[r["key"], r["t1"] - r["t0"], r.get("error")] for lane in recs for r in lane]
    return {"warm": out}


def run(client_cls, cmd: dict, send) -> dict:
    seconds, drain = float(cmd["seconds"]), float(cmd["drain_s"])
    results = [[] for _ in cmd["streams"]]
    current = [None] * len(cmd["streams"])
    gate = threading.Event()
    start = {}

    def stream(s: int, statements):
        gate.wait()
        i = 0
        while time.perf_counter() < start["t1"]:
            key, sql = statements[i % len(statements)]
            current[s] = {"key": key, "t0": time.perf_counter(), "stream": s}
            rec = run_one(client_cls, cmd["url"], key, sql, seconds + drain + 60)
            rec["stream"] = s
            results[s].append(rec)
            current[s] = None
            i += 1

    threads = [threading.Thread(target=stream, args=(s, st), name=f"stream-{s}")
               for s, st in enumerate(cmd["streams"])]
    for t in threads:
        t.daemon = True
    for t in threads:
        t.start()
    start["t0"] = time.perf_counter()
    start["t1"] = start["t0"] + seconds
    gate.set()
    send({"started": start["t0"]})
    deadline = start["t1"] + drain
    for t in threads:
        t.join(timeout=max(0.0, deadline - time.perf_counter()))
    stuck = [t.name for t in threads if t.is_alive()]
    queries = []
    for recs in results:
        for r in list(recs):
            r["in_window"] = r["t1"] <= start["t1"]
            queries.append(r)
    for s, t in enumerate(threads):
        if t.is_alive() and current[s] is not None:
            # sent and never answered, not even in the drain
            queries.append(dict(current[s], in_window=False, never=True))
    return {"queries": queries, "window": [start["t0"], start["t1"]], "stuck": stuck}


def main(argv) -> int:
    client_cls = make_client_class(load_client_module(argv[1]))
    out = sys.stdout

    def send(obj) -> None:
        out.write(json.dumps(obj) + "\n")
        out.flush()

    for line in sys.stdin:
        cmd = json.loads(line)
        if cmd["cmd"] == "warm":
            send(warm(client_cls, cmd))
        elif cmd["cmd"] == "run":
            send(run(client_cls, cmd, send))
        elif cmd["cmd"] == "quit":
            return 0
        else:
            send({"error": f"unknown command {cmd['cmd']!r}"})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
