"""REST server of the PyTorch port: the engine's network boundary
(``presto_tpu/server/http_server.py``).

A stdlib ``ThreadingHTTPServer`` with thin JSON marshalling over
``QueryManager``; every query runs on the server's engine and its device
(``"cuda"`` unless the caller asks for the CPU).

Endpoints:
  POST   /v1/statement            body = SQL text -> QueryResults JSON
  GET    /v1/statement/{id}/{tok} page `tok` (follow nextUri)
  DELETE /v1/statement/{id}/{tok} cancel
  GET    /v1/info                 server info (open without credentials)
  GET    /ui, /                   the dashboard page (webui.html)
  GET    /v1/query                all queries
  GET    /v1/query/{id}           one query's info (+ live per-operator
                                  progress while RUNNING)
  GET    /v1/query/{id}/trace     the query's trace; for a FAILED query,
                                  its black-box forensic
  GET    /v1/metrics[/prefix][?format=prometheus|raw=1]   process metrics
  GET    /v1/cluster              queries and workers
  GET    /v1/cluster/metrics      every worker's metrics merged (counters
                                  summed, histogram buckets merged,
                                  percentiles re-derived)
  GET    /v1/events?query_id=&since=&kind=       the event journal
  POST   /v1/announcement         worker announcement (cluster mode)
  DELETE /v1/announcement/{id}    a worker leaves discovery now
  PUT    /v1/cluster/drain/{id}   drain one worker gracefully (202)

With an authenticator every endpoint but ``/v1/info`` takes HTTP Basic
credentials.

Run: python -m presto_tpu_torch.server [--etc DIR] [--device cuda|cpu]
    [--port 8080] [--distributed | --cluster] [--schema sf1]
    [--event-log events.jsonl]
"""
from __future__ import annotations

import os
import json
import re
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .protocol import QueryManager

_START_MONO = time.monotonic()
_VERSION = "presto-tpu-torch 0.1"


class _Handler(BaseHTTPRequestHandler):
    manager: QueryManager = None  # set by serve()
    authenticator = None          # PasswordAuthenticator (None = open server)
    protocol_version = "HTTP/1.1"

    # silence per-request stderr logging (the engine logs through its own path)
    def log_message(self, fmt, *args):  # noqa: A003
        pass

    _principal = ""

    def _authenticate(self):
        """HTTP Basic authentication against the configured password
        authenticator (server/security/ + presto-password-authenticators
        analogue). Guards EVERY endpoint except /v1/info (health probe):
        results/cancel/query-listing leak data and control without it.
        Returns the authenticated principal (stored on self._principal), or
        None after sending a 401/403 response. Open servers pass through."""
        if self.authenticator is None:
            return self.headers.get("X-Presto-User", "")
        import base64

        header = self.headers.get("Authorization", "")
        scheme, _, payload = header.partition(" ")
        if scheme.lower() != "basic" or not payload:
            self.send_response(401)
            self.send_header("WWW-Authenticate",
                             'Basic realm="presto-tpu"')
            self.send_header("Content-Length", "0")
            self.end_headers()
            return None
        try:
            user, _, password = base64.b64decode(payload).decode().partition(":")
            principal = self.authenticator.authenticate(user, password)
        except Exception:
            self.send_response(401)
            self.send_header("WWW-Authenticate",
                             'Basic realm="presto-tpu"')
            self.send_header("Content-Length", "0")
            self.end_headers()
            return None
        claimed = self.headers.get("X-Presto-User", "")
        if claimed and claimed != principal:
            # no impersonation support: the session user must be the principal
            self._send_json(
                {"error": {"message":
                           f"user {claimed!r} does not match authenticated "
                           f"principal {principal!r}"}}, status=403)
            return None
        self._principal = principal
        return principal

    # ------------------------------------------------------------- plumbing

    def _base_uri(self) -> str:
        host = self.headers.get("Host", "localhost")
        return f"http://{host}"

    def _send_json(self, payload, status: int = 200) -> None:
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _not_found(self) -> None:
        self._send_json({"error": {"message": f"no such resource {self.path}"}},
                        status=404)

    # ------------------------------------------------------------ endpoints

    def do_POST(self) -> None:  # noqa: N802 - http.server naming
        if self._authenticate() is None:
            return
        if self.path.rstrip("/") == "/v1/announcement":
            # worker service announcement (cluster mode: discovery endpoint)
            nodes = getattr(self.manager.runner, "nodes", None)
            if nodes is None:
                return self._not_found()
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length).decode())
            nodes.announce(body["nodeId"], body["uri"])
            return self._send_json({"announced": body["nodeId"]}, status=202)
        if self.path.rstrip("/") != "/v1/statement":
            return self._not_found()
        user = self.headers.get("X-Presto-User", "") \
            if self.authenticator is None else self._principal
        length = int(self.headers.get("Content-Length", 0))
        sql = self.rfile.read(length).decode().strip()
        if not sql:
            return self._send_json(
                {"error": {"message": "empty statement"}}, status=400)
        info = self.manager.submit(
            sql, user=user,
            source=self.headers.get("X-Presto-Source", ""),
            catalog=self.headers.get("X-Presto-Catalog", ""),
            schema=self.headers.get("X-Presto-Schema", ""),
            trace_token=self.headers.get("X-Presto-Trace-Token", ""))
        self._send_json(self.manager.results_payload(info, 0, self._base_uri()))

    def do_GET(self) -> None:  # noqa: N802
        if self.path.rstrip("/") == "/v1/info":
            # health probe stays open (load balancers / failure detector)
            return self._send_json({
                "nodeVersion": {"version": _VERSION},
                "uptime": round(time.monotonic() - _START_MONO, 1),
                "coordinator": True,
            })
        if self._authenticate() is None:
            return
        if self.path.rstrip("/") in ("", "/ui"):
            # cluster dashboard (the reference's webapp/ React SPA, served as
            # one static page over the same /v1/cluster + /v1/query API)
            path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "webui.html")
            with open(path, "rb") as f:
                body = f.read()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        m = re.fullmatch(r"/v1/statement/([^/]+)/(\d+)", self.path)
        if m:
            info = self.manager.get(m.group(1))
            if info is None:
                return self._not_found()
            return self._send_json(self.manager.results_payload(
                info, int(m.group(2)), self._base_uri()))
        if self.path.rstrip("/") == "/v1/cluster":
            # ClusterStatsResource.java analogue (feeds the web UI)
            queries = self.manager.list_queries()
            nodes = getattr(self.manager.runner, "nodes", None)
            return self._send_json({
                "runningQueries": sum(q.state == "RUNNING" for q in queries),
                "queuedQueries": sum(q.state == "QUEUED" for q in queries),
                "totalQueries": len(queries),
                "activeWorkers": len(nodes.active_nodes()) if nodes else 1,
                "nodes": [{"nodeId": n.node_id, "uri": n.uri,
                           "failureRatio": round(n.failure_ratio, 3)}
                          for n in (nodes.all_nodes() if nodes else [])],
            })
        path, _, qs = self.path.partition("?")
        if path.rstrip("/") == "/v1/cluster/metrics":
            return self._cluster_metrics(qs)
        if path.rstrip("/").startswith("/v1/metrics"):
            # JMX-analogue: flat counters/gauges as JSON; optional
            # /v1/metrics/<prefix> filters like an mbean-name lookup;
            # ?format=prometheus = text exposition, ?raw=1 = mergeable
            # bucket-level snapshot (what the cluster roll-up consumes)
            from ..utils.metrics import metrics_http_body

            prefix = path.rstrip("/")[len("/v1/metrics"):].lstrip("/")
            body, ctype = metrics_http_body(qs, prefix=prefix)
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if path.rstrip("/") == "/v1/events":
            # structured event journal (utils/events.py): ?query_id= scopes
            # to one query, ?since=<seq> pages forward, ?kind= prefix-filters
            from ..utils.events import events_http_body

            body, status = events_http_body(qs)
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if self.path.rstrip("/") == "/v1/query":
            return self._send_json([self._query_json(q)
                                    for q in self.manager.list_queries()])
        m = re.fullmatch(r"/v1/query/([^/]+)/trace", self.path)
        if m:
            # flight-recorder export (run the query with the `query_trace`
            # session knob / X-Presto-Session); the body is Chrome
            # trace-event JSON — save it and load in Perfetto
            info = self.manager.get(m.group(1))
            if info is None:
                return self._not_found()
            # opted-in full trace first; else the black-box forensic dump —
            # which is how a FAILED query that never set query_trace still
            # answers here with its last coarse timeline
            path = getattr(info, "trace_path", None)
            if not path or not os.path.exists(path):
                path = getattr(info, "failure_trace_path", None)
            if not path or not os.path.exists(path):
                return self._send_json(
                    {"error": {"message":
                               f"query {info.query_id} has no trace "
                               "(set session property query_trace=true; "
                               "failed queries export a forensic "
                               "automatically)"}},
                    status=404)
            with open(path, "rb") as f:
                body = f.read()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        m = re.fullmatch(r"/v1/query/([^/]+)", self.path)
        if m:
            info = self.manager.get(m.group(1))
            if info is None:
                return self._not_found()
            return self._send_json(self._query_json(info))
        self._not_found()

    def do_DELETE(self) -> None:  # noqa: N802
        if self._authenticate() is None:
            return
        m = re.fullmatch(r"/v1/statement/([^/]+)/(\d+)", self.path)
        if m and self.manager.cancel(m.group(1)):
            self.send_response(204)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        m = re.fullmatch(r"/v1/announcement/([^/]+)", self.path)
        if m:
            # explicit deregister: a DRAINED worker removes itself from
            # discovery instead of lingering until heartbeat decay
            nodes = getattr(self.manager.runner, "nodes", None)
            if nodes is None:
                return self._not_found()
            nodes.remove(m.group(1))
            self.send_response(204)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        self._not_found()

    def do_PUT(self) -> None:  # noqa: N802 — cluster lifecycle operations
        if self._authenticate() is None:
            return
        m = re.fullmatch(r"/v1/cluster/drain/([^/]+)", self.path)
        if m:
            # operator drain: kicks the graceful-removal sequence off in the
            # background (a drain can outlive any sane HTTP timeout) — 202,
            # then progress is observable via the worker's /v1/info/state
            # and the node.draining/node.drained journal events
            runner = self.manager.runner
            node_id = m.group(1)
            drain = getattr(runner, "drain_worker", None)
            nodes = getattr(runner, "nodes", None)
            if drain is None or nodes is None:
                return self._not_found()
            if nodes.get(node_id) is None:
                return self._send_json(
                    {"error": {"message": f"unknown worker {node_id}"}},
                    status=404)
            t = threading.Thread(
                target=lambda: drain(node_id,
                                     signal={"trigger": "operator"}),
                name=f"drain-{node_id}", daemon=True)
            # retained on the listener so stop() can join in-flight drains
            self.server._drain_threads.append(t)
            t.start()
            return self._send_json({"draining": node_id}, status=202)
        self._not_found()

    def _cluster_metrics(self, qs: str) -> None:
        """ClusterStatsResource-for-metrics: pull every active worker's
        mergeable snapshot (/v1/metrics?raw=1), merge (counters sum,
        histogram buckets add, percentiles re-derived from the merged
        buckets) and serve flat JSON or Prometheus text. A server without
        workers (local/mesh mode) serves its own process snapshot — the
        endpoint shape is uniform across deployment modes."""
        import urllib.parse
        import urllib.request

        from ..utils.metrics import (METRICS, flatten_raw,
                                     merge_raw_snapshots, prometheus_text)

        nodes = getattr(self.manager.runner, "nodes", None)
        active = nodes.active_nodes() if nodes else []

        def fetch(node):
            with urllib.request.urlopen(
                    f"{node.uri}/v1/metrics?raw=1", timeout=2.0) as resp:
                return json.loads(resp.read())

        # fetch CONCURRENTLY: the scrape must cost max(worker latency), not
        # the sum — one black-holed worker would otherwise stall the whole
        # endpoint past a Prometheus scrape timeout
        snaps = []
        workers = 0
        failed = 0
        if active:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=min(len(active), 16)) as ex:
                futures = [ex.submit(fetch, n) for n in active]
                for f in futures:
                    try:
                        snaps.append(f.result(timeout=5.0))
                        workers += 1
                    except Exception:  # noqa: BLE001 - dead workers are the detector's case
                        failed += 1
        if not snaps:
            snaps = [METRICS.raw_snapshot()]
        merged = merge_raw_snapshots(snaps)
        params = urllib.parse.parse_qs(qs or "")
        if params.get("format", [""])[0] == "prometheus":
            body = prometheus_text(merged).encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        out = flatten_raw(merged)
        out["cluster.workers_merged"] = workers
        if failed:
            out["cluster.workers_unreachable"] = failed
        self._send_json(out)

    @staticmethod
    def _query_json(info) -> dict:
        out = {
            "queryId": info.query_id,
            "state": info.state,
            "query": info.sql,
            "traceToken": getattr(info, "trace_token", ""),
            "rowCount": info.row_count,
            "elapsedMillis": info.elapsed_millis(),
            "hasTrace": bool(getattr(info, "trace_path", None)),
            "hasFailureTrace": bool(getattr(info, "failure_trace_path",
                                            None)),
            "error": info.error,
        }
        if info.state == "RUNNING":
            # live per-operator counters (exec/progress.py): rows in/out,
            # blocked ns, memory reservation, pool steps — progress visible
            # BEFORE completion on every runner tier
            from ..exec import progress

            prog = progress.snapshot(info.query_id)
            if prog is not None:
                out["progress"] = prog
        return out


class PrestoTpuServer:
    """Server handle: serve() blocks, start() runs on a daemon thread.

    Without a ``runner`` it serves a ``LocalQueryRunner`` on ``device``
    (default ``"cuda"``; it raises without CUDA unless asked for the CPU)."""

    def __init__(self, runner=None, port: int = 8080, page_rows: int = 1000,
                 resource_groups=None, listeners=None, access_control=None,
                 transactions=True, authenticator=None, device="cuda"):
        if runner is None:
            from ..runner import LocalQueryRunner
            runner = LocalQueryRunner(device=device)
        monitor = None
        if listeners:
            from ..spi.eventlistener import QueryMonitor
            monitor = QueryMonitor(list(listeners))
        tx_manager = None
        if transactions and getattr(runner, "catalogs", None) is not None:
            from ..transaction import TransactionManager
            tx_manager = TransactionManager(runner.catalogs)
        if access_control is not None:
            # table-level checks live on the LOCAL engine (the cluster
            # coordinator delegates its checks to runner.local)
            target = getattr(runner, "local", runner)
            target.access_control = access_control
        self.manager = QueryManager(runner, page_rows=page_rows,
                                    resource_groups=resource_groups,
                                    monitor=monitor,
                                    access_control=access_control,
                                    transactions=tx_manager)
        handler = type("BoundHandler", (_Handler,),
                       {"manager": self.manager,
                        "authenticator": authenticator})
        self.httpd = ThreadingHTTPServer(("0.0.0.0", port), handler)
        self.httpd._drain_threads = []  # in-flight operator drains
        self.port = self.httpd.server_address[1]

    def serve(self) -> None:
        self.httpd.serve_forever()

    def start(self) -> threading.Thread:
        t = threading.Thread(target=self.serve, daemon=True)
        t.start()
        return t

    def stop(self) -> None:
        try:
            self.httpd.shutdown()
            self.httpd.server_close()
        finally:
            # after the listener is down: no new submissions can race the
            # join — and a raising socket teardown must not skip it
            self.manager.close()
            for t in self.httpd._drain_threads:
                t.join(timeout=5.0)


def compile_ahead(runner, qids) -> None:
    """Run the TPC-H queries ``qids`` once through ``runner`` before the
    first tenant arrives: the CUDA kernels build at their first use, and a
    query that fails here is reported and skipped."""
    from ..models.tpch_sql import QUERIES

    for qid in qids:
        try:
            runner.execute(QUERIES[qid])
        except Exception as e:  # noqa: BLE001 - warm what we can
            print(f"compile-ahead q{qid}: FAILED {e!r}", file=sys.stderr)


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(prog="presto-tpu-torch-server")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--schema", default="tiny")
    ap.add_argument("--device", default="cuda",
                    help="where queries run: cuda (the default; fails without "
                         "CUDA) or cpu")
    ap.add_argument("--distributed", action="store_true",
                    help="serve queries through the multi-worker engine")
    ap.add_argument("--cluster", action="store_true",
                    help="coordinator role: execute on announced worker "
                         "processes (start them with python -m "
                         "presto_tpu_torch.cluster.worker --coordinator URI)")
    ap.add_argument("--min-workers", type=int, default=1)
    ap.add_argument("--etc", default=None,
                    help="config directory (config.properties + "
                         "catalog/*.properties, optional plugin/)")
    ap.add_argument("--compile-ahead", nargs="?", const="1,3,6", default=None,
                    metavar="QIDS",
                    help="run these TPC-H queries (comma-separated ids, "
                         "default 1,3,6) once before serving, so the kernels "
                         "are built before the first tenant")
    ap.add_argument("--event-log", default=None, metavar="PATH",
                    help="append the structured event journal as JSONL to "
                         "PATH (the durable half of GET /v1/events)")
    args = ap.parse_args(argv)

    from .. import resolve_device
    device = resolve_device(args.device)  # no CUDA: fail before anything loads
    if args.event_log:
        from ..utils.events import JOURNAL
        JOURNAL.set_log_path(args.event_log)

    from ..metadata import Session
    catalogs = None
    port = args.port
    authenticator = None
    if args.etc:
        from .config import (load_catalogs, load_config,
                             load_plugins_for_etc, session_from_config)

        conf = load_config(args.etc)
        # external plugins first: they may contribute the very connector
        # factories etc/catalog/*.properties name
        load_plugins_for_etc(args.etc)
        catalogs = load_catalogs(args.etc)
        session = session_from_config(conf)
        if session.catalog is None:
            session = Session(catalog="tpch",
                              schema=session.schema or args.schema,
                              properties=session.properties)
        port = int(conf.get("http-server.http.port", args.port))
        if conf.get("http-server.authentication.type", "").upper() == \
                "PASSWORD":
            from ..security import FileBasedPasswordAuthenticator

            pw_file = conf.get("password-authenticator.config-file")
            if not pw_file:
                raise ValueError(
                    "http-server.authentication.type=PASSWORD requires "
                    "password-authenticator.config-file")
            # no TLS listener here: Basic credentials would cross the wire
            # in the clear, so password auth takes an explicit opt-in
            if conf.get("http-server.authentication.allow-insecure-over-http",
                        "false").lower() != "true":
                raise ValueError(
                    "PASSWORD authentication over plain HTTP sends "
                    "credentials in cleartext; set http-server."
                    "authentication.allow-insecure-over-http=true to accept "
                    "that (e.g. behind a TLS-terminating proxy)")
            authenticator = FileBasedPasswordAuthenticator(pw_file)
    else:
        session = Session(catalog="tpch", schema=args.schema)
    if args.cluster:
        if authenticator is not None:
            # workers announce over the same HTTP surface and carry no
            # credentials; rejecting them would strand the cluster empty
            raise ValueError(
                "PASSWORD authentication is not yet supported in cluster "
                "mode: worker announcements cannot authenticate. Run the "
                "coordinator behind an authenticating proxy instead.")
        from ..cluster import ClusterQueryRunner
        runner = ClusterQueryRunner(session=session, catalogs=catalogs,
                                    min_workers=args.min_workers,
                                    device=device)
        mode = "cluster-coordinator"
    elif args.distributed:
        from ..parallel.mesh import MeshContext
        from ..parallel.runner import DistributedQueryRunner
        # four logical workers on the server's device
        runner = DistributedQueryRunner(MeshContext([device] * 4), session=session,
                                        catalogs=catalogs, device=device)
        mode = "distributed"
    else:
        from ..runner import LocalQueryRunner
        runner = LocalQueryRunner(session=session, catalogs=catalogs,
                                  device=device)
        mode = "local"
    if args.compile_ahead:
        compile_ahead(runner, [int(x) for x in args.compile_ahead.split(",") if x])
    server = PrestoTpuServer(runner, port=port, authenticator=authenticator)
    print(f"presto-tpu-torch server listening on :{server.port} "  # prestocheck: ignore[print-hygiene] - CLI startup banner
          f"({mode} on {device}, schema={args.schema}"
          f"{', password-auth' if authenticator else ''})", flush=True)
    server.serve()


if __name__ == "__main__":
    main()
