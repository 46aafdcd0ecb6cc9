"""Worker server: the task-execution HTTP endpoint of a cluster node.

The port's copy of ``presto_tpu/cluster/worker.py`` (Presto's worker role of
server/PrestoServer.java + server/TaskResource.java:84,122,245), whose tasks
run on the worker's ``device`` (default ``"cuda"``; it raises without CUDA):

  POST   /v1/task/{taskId}                         create/update (JSON
                                                   TaskUpdateRequest body)
  POST   /v1/task/{taskId}/sources                 rewire one exchange input
  GET    /v1/task/{taskId}                         TaskInfo (JSON)
  DELETE /v1/task/{taskId}[?abort=true]            cancel/abort
  GET    /v1/task/{taskId}/results/{buf}/{token}   pull one page frame
         (binary body; X-Next-Token / X-Complete headers; ?wait= long-poll)
  DELETE /v1/task/{taskId}/results/{buf}           release the client buffer
  GET    /v1/status                                heartbeat + node info
                                                   (+ per-task drain progress)
  GET    /v1/info/state                            drain-progress poll
  PUT    /v1/info/state                            "DRAINING" (or the legacy
                                                   "SHUTTING_DOWN") enters the
                                                   drain machine
  GET    /v1/metrics[/prefix][?raw=1|format=prometheus]  this process's metrics
  GET    /v1/events?query_id=&since=&kind=         the event journal

Lifecycle: ACTIVE → DRAINING → DRAINED → SHUT_DOWN (see _TRANSITIONS).

Every in-process worker of one machine may share its one card: a task lets
go of its device tensors when it ends, is cancelled, or its worker stops
(``SqlTask``); ``join_tasks`` waits for the task threads.

Control-plane bodies are structured JSON (cluster/codec.py allow-list
codec). Workers announce themselves to the coordinator (discovery.Announcer).
Run one as ``python -m presto_tpu_torch.cluster.worker --device cuda
--coordinator URI [--etc DIR]``; ``--etc`` loads the catalogs of
``DIR/catalog/*.properties`` (every node loads the same set)."""
from __future__ import annotations

import re
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .. import resolve_device
from ..metadata import CatalogManager, MetadataManager
from . import codec, faults
from .buffers import ReplayWindowLost
from .task import (DONE_STATES, SourceUpdateRequest, TaskUpdateRequest,
                   WorkerTaskManager)

ACTIVE = "ACTIVE"
DRAINING = "DRAINING"
DRAINED = "DRAINED"
SHUT_DOWN = "SHUT_DOWN"
# legacy protocol alias (GracefulShutdownHandler.java wire vocabulary): a
# PUT of "SHUTTING_DOWN" enters the drain machine at DRAINING
SHUTTING_DOWN = "SHUTTING_DOWN"

# the drain state machine: ACTIVE → DRAINING → DRAINED → SHUT_DOWN.
# DRAINING refuses new tasks but keeps serving live streams; DRAINED means
# every task reached a DONE state (finished, or its consumers were handed to
# replacements) and the node deregistered from discovery; SHUT_DOWN is the
# terminal hard stop. Anything else is an illegal transition.
_TRANSITIONS = {
    ACTIVE: {DRAINING, SHUT_DOWN},
    DRAINING: {DRAINED, SHUT_DOWN},
    DRAINED: {SHUT_DOWN},
    SHUT_DOWN: set(),
}


def default_catalogs() -> CatalogManager:
    """Every node builds the same static catalog set from its own process
    (the reference loads etc/catalog/*.properties per node)."""
    from ..connectors.blackhole import BlackholeConnector
    from ..connectors.tpcds.connector import TpcdsConnector
    from ..connectors.tpch.connector import TpchConnector

    catalogs = CatalogManager()
    catalogs.register("tpch", TpchConnector("tpch"))
    catalogs.register("tpcds", TpcdsConnector("tpcds"))
    catalogs.register("blackhole", BlackholeConnector("blackhole"))
    return catalogs


class _WorkerHandler(BaseHTTPRequestHandler):
    worker: "WorkerServer" = None  # bound per server instance
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # noqa: A003
        pass

    def _send(self, body: bytes, status: int = 200, headers=()) -> None:
        self.send_response(status)
        for k, v in headers:
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if body:
            self.wfile.write(body)

    def _send_codec(self, obj, status: int = 200) -> None:
        self._send(codec.dumps(obj), status,
                   [("Content-Type", "application/json")])

    def _inject(self, point: str, **ctx) -> bool:
        """Fault-injection hook (cluster/faults.py). True = the request was
        consumed by an injected fault and the caller must return."""
        try:
            faults.fire(point, node_id=self.worker.node_id, path=self.path,
                        **ctx)
        except faults.InjectedHTTPError as e:
            self._send(e.body.encode(), e.code)
            return True
        except faults.InjectedFault:
            # slam the connection: no status line, no body — the client sees
            # the peer reset a real worker crash would produce
            self.close_connection = True
            return True
        return False

    # ------------------------------------------------------------ endpoints

    def do_POST(self) -> None:  # noqa: N802
        m = re.fullmatch(r"/v1/task/([^/]+)/sources", self.path)
        if m:
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            task = self.worker.tasks.get(m.group(1))
            if task is None:
                return self._send(b"no such task", 404)
            try:
                update: SourceUpdateRequest = codec.loads(body)
                if not isinstance(update, SourceUpdateRequest):
                    # not an assert: those vanish under python -O and the
                    # AttributeError would then escape as a dropped
                    # connection the peer misreads as a transient fault
                    raise TypeError(
                        f"expected SourceUpdateRequest, got "
                        f"{type(update).__name__}")
            except Exception as e:
                return self._send(f"bad sources body: {e}".encode(), 400)
            if not task.update_sources(update):
                return self._send(
                    b"rewire rejected: stream already consumed", 409)
            return self._send(b"", 200)
        m = re.fullmatch(r"/v1/task/([^/]+)", self.path)
        if not m:
            return self._send(b"not found", 404)
        if self._inject("worker.task_create", task_id=m.group(1)):
            return
        if self.worker.state != ACTIVE:
            # draining/drained workers refuse placement; the scheduler
            # treats this 503 as "exclude + re-place NOW", not a transient
            return self._send(b"shutting down", 503)
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        try:
            request: TaskUpdateRequest = codec.loads(body)
        except Exception as e:  # non-JSON / unregistered class: reject
            return self._send(f"bad task body: {e}".encode(), 400)
        if not isinstance(request, TaskUpdateRequest):
            return self._send(b"bad task body: not a TaskUpdateRequest", 400)
        try:
            info = self.worker.tasks.create_or_update(request)
        except ValueError as e:
            return self._send(str(e).encode(), 409)
        self._send_codec(info)

    def do_GET(self) -> None:  # noqa: N802
        path, _, query = self.path.partition("?")
        m = re.fullmatch(r"/v1/task/([^/]+)/results/(\d+)/(\d+)", path)
        if m:
            if self._inject("worker.results", task_id=m.group(1)):
                return
            task = self.worker.tasks.get(m.group(1))
            if task is None:
                return self._send(b"no such task", 404)
            wait = float(urllib.parse.parse_qs(query).get("wait", ["1.0"])[0])
            buffer_id = int(m.group(2))
            if buffer_id >= task.output.n_buffers:
                return self._send(b"no such buffer", 404)
            try:
                frame, nxt, complete = task.output.get(
                    buffer_id, int(m.group(3)), wait_s=min(wait, 30.0))
            except ReplayWindowLost as e:
                # the requested chunk was retired from the replay spool
                # (overflow / nondeterministic sink / released buffer):
                # waiting would never produce it. 410 is a HARD error on the
                # consumer — mid-stream recovery is unsound here and must
                # escalate loudly to a query-level retry
                return self._send(str(e).encode(), 410)
            except Exception as e:
                # failed/poisoned buffer -> 500: consumers treat 5xx as
                # transient-within-budget, which is what keeps them alive
                # through the task-recovery rewire window; the body carries
                # the diagnostic PageBufferClient reports if the budget
                # exhausts, and the coordinator's monitor loop surfaces the
                # underlying task failure within one 0.5s tick anyway
                return self._send(str(e).encode(), 500)
            return self._send(
                frame or b"", 200,
                [("Content-Type", "application/octet-stream"),
                 ("X-Next-Token", str(nxt)),
                 ("X-Complete", "true" if complete else "false"),
                 ("X-Task-Instance-Id", task.instance_id)])
        m = re.fullmatch(r"/v1/task/([^/]+)", path)
        if m:
            if self._inject("worker.task_info", task_id=m.group(1)):
                return
            task = self.worker.tasks.get(m.group(1))
            if task is None:
                return self._send(b"no such task", 404)
            return self._send_codec(task.info())
        if path.rstrip("/") == "/v1/status":
            import json
            # a status poll doubles as a drain tick: DRAINING → DRAINED the
            # moment the last task reaches a DONE state, so pollers observe
            # the transition deterministically (no monitor-thread race)
            self.worker.maybe_complete_drain()
            active = 0
            query_mem = {}
            live_queries = set()
            spooled = 0
            drain_tasks = {}
            if self.worker.state != ACTIVE:
                # per-task drain progress: everything still pinning the node
                # — live tasks, plus DONE tasks whose streams consumers are
                # still pulling
                for tid, t in self.worker.tasks.tasks.items():
                    served = t.output.output_drained()
                    if t.state in DONE_STATES and served:
                        continue
                    drain_tasks[tid] = {
                        "state": t.state,
                        "spooledBytes": t.output.spooled_bytes(),
                        "retainedBytes": t.output.retained_bytes(),
                        "replayable": t.output.replayable_all(),
                        "outputDrained": served,
                    }
            for t in self.worker.tasks.tasks.values():
                if t.state in DONE_STATES:
                    continue
                active += 1
                qid = t.request.query_id
                live_queries.add(qid)
                # unacked output frames; spooled (acked, replayable) bytes
                # are already reserved in the shared pool under the query id
                query_mem[qid] = query_mem.get(qid, 0) + \
                    t.output.retained_bytes()
                spooled += t.output.spooled_bytes()
            # unified footprint: operator state + scan prefetch reserved in
            # the worker's shared pool (cluster/task._query_memory) — the
            # OOM killer must see the WHOLE per-query byte count, not just
            # output buffers. Done queries' residue is excluded.
            from ..memory import shared_general_pool
            pool = shared_general_pool()
            by_query = pool.by_query()
            revocable = pool.revocable_by_query()
            spill = pool.spill_by_query()
            # GC walks the UNION of the pool's ledgers: a dead query may
            # leave residue in only the spill (or revocable) ledger
            for qid in set(by_query) | set(revocable) | set(spill):
                if qid in live_queries:
                    if qid in by_query:
                        query_mem[qid] = query_mem.get(qid, 0) \
                            + int(by_query[qid])
                else:
                    # no live task of this query remains on the worker: any
                    # leftover reservation is a failed-teardown leak — clear
                    # it here (the memory manager polls status every second,
                    # so this doubles as the worker's pool GC)
                    pool.clear_query(qid)
            return self._send(json.dumps({
                "nodeId": self.worker.node_id,
                "state": self.worker.state,
                "activeTasks": active,
                # per-query reserved bytes — the ClusterMemoryManager's feed
                # (memory/RemoteNodeMemory.java analogue)
                "queryMemory": query_mem,
                # the revocable slice of queryMemory: what a revoke round
                # could move down the ladder (device->host->disk) instead of
                # killing — the manager's revoke-before-kill evidence
                "queryRevocable": {q: int(b) for q, b in revocable.items()
                                   if q in live_queries},
                # per-query on-disk spill bytes (exec/spill.py runs): the
                # disk rung, charged outside queryMemory so spilling
                # relieves reported pressure but stays observable
                "querySpill": {q: int(b) for q, b in spill.items()
                               if q in live_queries},
                # acked-frame replay spool across live tasks (also counted
                # inside queryMemory via the shared pool)
                "spooledBytes": spooled,
                # the high-water mark of the spool over every task held,
                # done ones too, since the worker started: a peak that no
                # poll has to land on
                "spooledBytesPeak": self.worker.tasks.spooled_bytes_peak,
                # per-task drain progress (empty map when ACTIVE): what an
                # operator watches while the node works toward DRAINED
                "drain": drain_tasks,
                "uptime": round(time.monotonic() - self.worker.start_mono, 1),
            }).encode(), 200, [("Content-Type", "application/json")])
        if path.rstrip("/") == "/v1/info/state":
            # drain-progress poll (the PUT's read side): state + what still
            # pins the node, without the /v1/status memory side channels
            import json
            self.worker.maybe_complete_drain()
            active = 0
            draining = 0
            spooled = 0
            tasks = {}
            for tid, t in self.worker.tasks.tasks.items():
                done = t.state in DONE_STATES
                served = t.output.output_drained()
                if done and served:
                    continue
                if not done:
                    active += 1
                draining += 1
                spooled += t.output.spooled_bytes()
                tasks[tid] = {
                    "state": t.state,
                    "spooledBytes": t.output.spooled_bytes(),
                    "replayable": t.output.replayable_all(),
                    "outputDrained": served,
                }
            return self._send(json.dumps({
                "state": self.worker.state,
                "activeTasks": active,
                # tasks that would pin a drain: live ones plus DONE tasks
                # whose streams consumers are still pulling
                "drainingTasks": draining,
                "spooledBytes": spooled,
                "tasks": tasks,
            }).encode(), 200, [("Content-Type", "application/json")])
        if path.rstrip("/").startswith("/v1/metrics"):
            # the coordinator's surface: flat JSON, ?raw=1 (the mergeable
            # snapshot GET /v1/cluster/metrics reads), ?format=prometheus
            from ..utils.metrics import metrics_http_body

            prefix = path.rstrip("/")[len("/v1/metrics"):].lstrip("/")
            body, ctype = metrics_http_body(query, prefix=prefix)
            return self._send(body, 200, [("Content-Type", ctype)])
        if path.rstrip("/") == "/v1/events":
            from ..utils.events import events_http_body

            body, status = events_http_body(query)
            return self._send(body, status, [("Content-Type", "application/json")])
        self._send(b"not found", 404)

    def do_HEAD(self) -> None:  # noqa: N802 — failure-detector ping
        if self.path.rstrip("/") == "/v1/status":
            if self._inject("worker.status"):
                return
            return self._send(b"", 200)
        self._send(b"", 404)

    def do_DELETE(self) -> None:  # noqa: N802
        m = re.fullmatch(r"/v1/task/([^/]+)/results/(\d+)", self.path)
        if m:
            task = self.worker.tasks.get(m.group(1))
            if task is not None:
                task.output.abort(int(m.group(2)))
            return self._send(b"", 204)
        path, _, query = self.path.partition("?")
        m = re.fullmatch(r"/v1/task/([^/]+)", path)
        if m:
            abort = "abort=true" in query
            self.worker.tasks.cancel(m.group(1), abort=abort)
            return self._send(b"", 204)
        self._send(b"not found", 404)

    def do_PUT(self) -> None:  # noqa: N802 — graceful shutdown / drain
        if self.path.rstrip("/") == "/v1/info/state":
            length = int(self.headers.get("Content-Length", 0))
            state = self.rfile.read(length).decode().strip().strip('"')
            if state in (DRAINING, SHUTTING_DOWN):
                # SHUTTING_DOWN is the legacy wire alias: both enter the
                # drain machine (idle workers reach DRAINED immediately)
                try:
                    reached = self.worker.begin_drain()
                except ValueError as e:
                    return self._send(str(e).encode(), 409)
                return self._send(f'"{reached}"'.encode(), 200,
                                  [("Content-Type", "application/json")])
            if state in (ACTIVE, DRAINED, SHUT_DOWN):
                # real states, but not externally settable: DRAINED is
                # earned by finishing tasks, SHUT_DOWN by stop()
                return self._send(
                    f"cannot request transition to {state}".encode(), 409)
            return self._send(b"bad state", 400)
        self._send(b"not found", 404)


class WorkerServer:
    """One worker node: HTTP server + task manager + announcer."""

    def __init__(self, port: int = 0,
                 catalogs: Optional[CatalogManager] = None,
                 coordinator_uri: Optional[str] = None,
                 node_id: Optional[str] = None,
                 host: str = "127.0.0.1",
                 announce_host: Optional[str] = None,
                 device="cuda"):
        """`host` is the bind address; `announce_host` is what peers dial
        (defaults to `host`) — a worker binding 0.0.0.0 must announce a
        routable address, not the wildcard. ``device``: where its tasks
        run (raises without CUDA unless "cpu")."""
        self.device = resolve_device(device)
        faults.install_from_env()  # PRESTO_TPU_FAULTS chaos knob (no-op unset)
        catalogs = catalogs or default_catalogs()
        self.metadata = MetadataManager(catalogs)
        self.tasks = WorkerTaskManager(self.metadata, device=self.device)
        self.state = ACTIVE
        self._state_lock = threading.RLock()
        self._drain_stop = threading.Event()
        self.start_time = time.time()      # wall timestamp (diagnostics)
        self.start_mono = time.monotonic()  # uptime duration base
        handler = type("BoundWorkerHandler", (_WorkerHandler,), {"worker": self})
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.port = self.httpd.server_address[1]
        announce = announce_host or host
        if announce == "0.0.0.0":
            # gethostbyname(hostname) often maps to 127.0.1.1 via /etc/hosts;
            # the source address of a UDP socket routed toward the
            # coordinator is the interface it reaches us on (a UDP connect
            # sends no packet). Without a coordinator, the host name's.
            import socket
            target = urllib.parse.urlsplit(coordinator_uri).hostname \
                if coordinator_uri else None
            announce = socket.gethostbyname(socket.gethostname())
            if target:
                s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                try:
                    s.connect((target, 80))
                    announce = s.getsockname()[0]
                except OSError:
                    pass
                finally:
                    s.close()
        self.uri = f"http://{announce}:{self.port}"
        self.node_id = node_id or f"worker-{self.port}"
        self._announcer = None
        if coordinator_uri:
            from .discovery import Announcer
            self._announcer = Announcer(coordinator_uri, self.node_id, self.uri)

    def start(self) -> "WorkerServer":
        self._serve_thread = threading.Thread(
            target=self.httpd.serve_forever,
            name=f"worker-{self.port}", daemon=True)
        self._serve_thread.start()
        if self._announcer:
            self._announcer.start()
        return self

    # ------------------------------------------------- drain state machine

    def transition(self, new_state: str) -> bool:
        """Move the node through ACTIVE → DRAINING → DRAINED → SHUT_DOWN.
        Same-state is an idempotent no-op (False); anything not in the
        transition map raises — an illegal transition is a caller bug, not
        a race to paper over."""
        with self._state_lock:
            if new_state == self.state:
                return False
            if new_state not in _TRANSITIONS.get(self.state, set()):
                raise ValueError(
                    f"illegal worker state transition "
                    f"{self.state} -> {new_state}")
            self.state = new_state
            return True

    def begin_drain(self, reason: str = "") -> str:
        """Enter DRAINING: refuse new tasks (503), pin every live task's
        output spool so its replay window stays complete for the consumer
        handoff, and watch for the last task to reach a DONE state. Returns
        the state reached NOW — an idle worker completes its drain
        synchronously and returns DRAINED. Idempotent while draining;
        raises from DRAINED/SHUT_DOWN (nothing left to drain)."""
        with self._state_lock:
            if self.state == DRAINING:
                return self.state
            self.transition(DRAINING)
        from ..utils import events
        events.emit("worker.draining", severity=events.WARN,
                    node=self.node_id, reason=reason,
                    active_tasks=self.active_task_count())
        for t in list(self.tasks.tasks.values()):
            # pin every spool (done tasks may still be serving): an acked
            # frame retired during the handoff window would turn a planned
            # drain into a 410 escalation
            t.output.pin_spool()
        if not self.maybe_complete_drain():
            self._drain_thread = threading.Thread(
                target=self._drain_loop, name=f"drain-{self.node_id}",
                daemon=True)
            self._drain_thread.start()
        return self.state

    def maybe_complete_drain(self) -> bool:
        """DRAINING → DRAINED when nothing pins the node: every task is in a
        DONE state (finished, or aborted after its consumers were handed to
        a replacement) AND its output streams are fully delivered — a
        FINISHED task still serving spooled chunks to live consumers keeps
        the node DRAINING until they catch up or are rewired elsewhere.
        Called by the drain monitor AND by the status/state endpoints so
        pollers never race the monitor thread."""
        with self._state_lock:
            if self.state != DRAINING or self.draining_task_count() > 0:
                return False
            self.transition(DRAINED)
        # the node is out of work: deregister EXPLICITLY so the scheduler
        # stops seeing it now, not a heartbeat-decay window later
        if self._announcer:
            self._announcer.stop()
            self._announcer.deregister()
        from ..utils import events
        events.emit("worker.drained", severity=events.INFO,
                    node=self.node_id)
        return True

    def _drain_loop(self) -> None:
        while not self._drain_stop.wait(0.1):
            if self.state != DRAINING or self.maybe_complete_drain():
                return

    def begin_shutdown(self) -> None:
        """Legacy entry point (the old one-flag shutdown): now an alias that
        enters the drain machine. The process exits when active tasks finish
        (GracefulShutdownHandler semantics) — and, unlike the old flag, the
        coordinator is TOLD when the node is out of work (deregister at
        DRAINED) instead of discovering it by heartbeat decay."""
        self.begin_drain(reason="begin_shutdown")

    def active_task_count(self) -> int:
        return sum(1 for t in self.tasks.tasks.values()
                   if t.state not in DONE_STATES)

    def draining_task_count(self) -> int:
        """Tasks that still pin a DRAINING node: live, or done but with
        consumers mid-pull on their output streams."""
        return sum(1 for t in self.tasks.tasks.values()
                   if t.state not in DONE_STATES
                   or not t.output.output_drained())

    def stop(self) -> None:
        with self._state_lock:
            self.state = SHUT_DOWN  # hard stop: bypasses transition checks
        self._drain_stop.set()
        if self._announcer:
            self._announcer.stop()
        for t in list(self.tasks.tasks.values()):
            t.cancel(abort=True)
        self.httpd.shutdown()
        self.httpd.server_close()
        serve = getattr(self, "_serve_thread", None)
        if serve is not None:
            serve.join(timeout=5.0)
        drain = getattr(self, "_drain_thread", None)
        if drain is not None:
            drain.join(timeout=5.0)

    def join_tasks(self, timeout_s: float = 60.0) -> bool:
        """Wait until every task thread of this worker has ended (its
        device tensors released); True when they all did in time."""
        deadline = time.monotonic() + timeout_s
        for t in list(self.tasks.tasks.values()):
            if not t.join(max(deadline - time.monotonic(), 0.0)):
                return False
        return True


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(prog="presto-tpu-torch-worker")
    ap.add_argument("--port", type=int, default=8081)
    ap.add_argument("--host", default="127.0.0.1",
                    help="bind address (0.0.0.0 to serve other hosts)")
    ap.add_argument("--announce-host", default=None,
                    help="address peers should dial (defaults to --host, or "
                         "this host's name when binding 0.0.0.0)")
    ap.add_argument("--node-id", default=None)
    ap.add_argument("--coordinator", default=None,
                    help="coordinator URI to announce to")
    ap.add_argument("--device", default="cuda",
                    help="where this worker's tasks run: cuda (the default; "
                         "fails without CUDA) or cpu")
    ap.add_argument("--etc", default=None,
                    help="config directory with catalog/*.properties (and an "
                         "optional plugin/) — every node must load the same "
                         "catalog set")
    ap.add_argument("--event-log", default=None, metavar="PATH",
                    help="append this worker's structured event journal "
                         "(task lifecycle, spills) as JSONL to PATH")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)  # no CUDA: fail before anything loads
    if args.event_log:
        from ..utils.events import JOURNAL
        JOURNAL.set_log_path(args.event_log)
    catalogs = None
    if args.etc:
        from ..server.config import load_catalogs, load_plugins_for_etc

        load_plugins_for_etc(args.etc)
        catalogs = load_catalogs(args.etc)
    server = WorkerServer(port=args.port, coordinator_uri=args.coordinator,
                          host=args.host, announce_host=args.announce_host,
                          node_id=args.node_id, catalogs=catalogs, device=device)
    if server._announcer:
        server._announcer.start()
    print(f"presto-tpu-torch worker {server.node_id} on {server.device} listening on "  # prestocheck: ignore[print-hygiene] - CLI startup banner
          f":{server.port}")
    server.httpd.serve_forever()


if __name__ == "__main__":
    main()
