"""ClusterQueryRunner: SQL over a cluster of worker servers.

The port's copy of ``presto_tpu/cluster/coordinator.py``, the third runner
of the port beside ``runner.LocalQueryRunner`` (one process, one device)
and ``parallel.DistributedQueryRunner`` (logical workers in one process):
a coordinator plans, fragments and schedules a query, and worker servers
(``cluster/worker.py``) run the fragments as tasks that ship pages to each
other over HTTP (Presto's execution/SqlQueryExecution.java:329: plan ->
fragment -> planDistribution -> schedule -> pull root output). The same
SubPlan the mesh runner runs is here lowered to remote tasks.

``device`` (default ``"cuda"``; raises without CUDA) is where the
coordinator's local engine runs the statements it keeps (DDL, writes,
EXPLAIN, SHOW) and plans the root fragment's output schema; the root
fragment itself runs as a task on a worker, on that worker's device.

Fault tolerance (retry_policy session property — see cluster/retry.py):
under QUERY/TASK policy a retryable failure (dead worker, dropped exchange,
transport fault) transparently re-plans and re-executes the query on the
surviving nodes — failed nodes are excluded from the next attempt's
placement, attempts are bounded by query_retry_attempts, and attempts are
separated by the shared jittered Backoff. Retry observability lands in
QueryResult.stats and the metrics counters (cluster.query_retries,
cluster.task_retries, cluster.backoff_seconds)."""
from __future__ import annotations

import itertools
import json
import threading
import time
import urllib.request
from typing import Dict, List, Optional, Set

from ..metadata import CatalogManager, Session
from ..runner import LocalQueryRunner, QueryResult
from ..sql import tree as t
from ..sql.planner.add_exchanges import add_exchanges
from ..sql.planner.fragmenter import SubPlan, fragment_plan
from ..sql.planner.optimizer import optimize
from ..sql.planner.planner import LogicalPlanner
from ..utils import trace
from ..utils.metrics import METRICS
from . import faults, retry
from .discovery import DiscoveryNodeManager, HeartbeatFailureDetector, NodeInfo
from .exchange_client import StreamingRemoteSource
from .retry import Backoff
from .scheduler import SqlQueryScheduler
from .task import FINISHED, plan_subplan


class ClusterQueryRunner:
    """Coordinator engine: plans locally, executes on announced workers."""

    def __init__(self, session: Optional[Session] = None,
                 catalogs: Optional[CatalogManager] = None,
                 min_workers: int = 1,
                 worker_wait_s: float = 30.0,
                 cluster_memory_limit_bytes: Optional[int] = None,
                 device="cuda"):
        self.local = LocalQueryRunner(session, catalogs, device)
        faults.install_from_env()  # PRESTO_TPU_FAULTS chaos knob (no-op unset)
        self.nodes = DiscoveryNodeManager()
        self.detector = HeartbeatFailureDetector(self.nodes).start()
        self.min_workers = min_workers
        self.worker_wait_s = worker_wait_s
        self._ids = itertools.count(1)
        self._schedulers: Dict[str, SqlQueryScheduler] = {}
        self.memory_manager = None
        if cluster_memory_limit_bytes is not None:
            from .memory_manager import ClusterMemoryManager

            self.memory_manager = ClusterMemoryManager(
                self.nodes, kill_query=self._kill_query,
                limit_bytes=cluster_memory_limit_bytes).start()

    def _kill_query(self, query_id: str) -> None:
        """OOM-killer target: abort every task of the victim query
        (ClusterMemoryManager -> LowMemoryKiller -> fail query)."""
        sched = self._schedulers.get(query_id)
        if sched is not None:
            sched.abort()

    # ------------------------------------------------------- cluster lifecycle

    def drain_worker(self, node_id: str, signal: Optional[dict] = None,
                     wait_s: float = 60.0) -> dict:
        """Gracefully remove one worker with zero queries lost: mark it
        unschedulable, tell it to DRAIN (refuse new tasks, pin spools),
        proactively hand its live tasks to replacements through the
        mid-stream replay path (exactly-once splice — a PLANNED drain never
        410-escalates), wait for the node to report DRAINED, then deregister
        it from discovery. `signal` is journaled on `node.draining` so the
        record says WHY the node was drained (autoscaler pressure reading,
        rolling upgrade, operator action)."""
        from ..utils import events

        node = self.nodes.get(node_id)
        if node is None:
            raise ValueError(f"unknown worker node {node_id!r}")
        self.nodes.set_draining(node_id, True)
        events.emit("node.draining", severity=events.WARN, node=node_id,
                    signal=signal or {})
        try:
            req = urllib.request.Request(f"{node.uri}/v1/info/state",
                                         data=b'"DRAINING"', method="PUT")
            urllib.request.urlopen(req, timeout=5.0).read()
        except Exception:  # noqa: BLE001 - unreachable worker: the
            pass           # schedulable gate + task sweep below still drain it

        def sweep() -> tuple:
            moved = left = 0
            active = self.nodes.active_nodes()
            for sched in list(self._schedulers.values()):
                m, l_ = sched.drain_node(node_id, active)
                moved += m
                left += l_
            return moved, left

        from .retry import Backoff

        moved, left = sweep()
        state = self._worker_state(node)
        deadline = time.monotonic() + wait_s
        backoff = Backoff(initial_delay_s=0.05, max_delay_s=0.25)
        while state == "DRAINING" and time.monotonic() < deadline:
            backoff.failure()
            backoff.wait()
            # keep sweeping: a task created between the gate and the first
            # sweep, or one whose handoff was refused, must not wedge the
            # drain while its query still runs
            m, left = sweep()
            moved += m
            state = self._worker_state(node)
        drained = state in ("DRAINED", "SHUT_DOWN")
        if drained:
            # its tasks' later loss (the node stopped) is planned, not a failure
            for sched in list(self._schedulers.values()):
                sched.drained_nodes.add(node_id)
        self.nodes.remove(node_id)
        events.emit("node.drained", severity=events.INFO, node=node_id,
                    drained=drained, state=state or "UNREACHABLE",
                    tasks_handed_off=moved, signal=signal or {})
        return {"node": node_id, "drained": drained,
                "state": state or "UNREACHABLE", "tasks_handed_off": moved,
                "tasks_left_in_place": left}

    @staticmethod
    def _worker_state(node: NodeInfo) -> Optional[str]:
        """GET /v1/info/state — the drain-progress poll. None = unreachable
        (a worker that died mid-drain; discovery expiry owns that case)."""
        try:
            with urllib.request.urlopen(f"{node.uri}/v1/info/state",
                                        timeout=2.0) as resp:
                return json.loads(resp.read()).get("state")
        except Exception:  # noqa: BLE001 - dead node reads as UNREACHABLE
            return None

    @property
    def metadata(self):
        return self.local.metadata

    @property
    def session(self):
        return self.local.session

    # ------------------------------------------------------------- planning

    def plan_sql(self, sql: str) -> SubPlan:
        stmt = self.local.parser.parse(sql)
        if not isinstance(stmt, t.Query):
            raise ValueError(f"cannot cluster-plan {type(stmt).__name__}")
        return self.plan_statement(stmt)

    def plan_statement(self, stmt: t.Query) -> SubPlan:
        planner = LogicalPlanner(self.metadata, self.session)
        plan = planner.plan(stmt)
        plan = optimize(plan, self.metadata, self.session)
        n = max(len(self.nodes.schedulable_nodes()), 1)
        plan = add_exchanges(plan, planner.symbols, self.metadata, self.session,
                             n_workers=n)
        return fragment_plan(plan)

    # ------------------------------------------------------------ execution

    def _wait_for_workers(self, min_needed: Optional[int] = None,
                          exclude: Optional[Set[str]] = None) -> List[NodeInfo]:
        from .retry import Backoff

        min_needed = self.min_workers if min_needed is None else min_needed
        deadline = time.monotonic() + self.worker_wait_s
        backoff = Backoff(initial_delay_s=0.02, max_delay_s=0.25)
        while True:
            # placement view: draining nodes are alive (they keep serving
            # their spooled streams) but never receive new tasks
            nodes = self.nodes.schedulable_nodes()
            if exclude:
                eligible = [n for n in nodes if n.node_id not in exclude]
                # all survivors excluded = exclusion starved placement;
                # trying suspect nodes beats certain failure
                nodes = eligible or nodes
            if len(nodes) >= min_needed:
                return sorted(nodes, key=lambda n: n.node_id)
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"only {len(nodes)} active workers "
                    f"(need {min_needed})")
            backoff.failure()
            backoff.wait()

    def execute(self, sql: str, user=None) -> QueryResult:
        stmt = self.local.parser.parse(sql)
        # access control is enforced at the coordinator for EVERY statement
        # (the local engine re-checks the ones it executes itself)
        self.local._check_access(stmt, user)
        explain_analyze = isinstance(stmt, t.Explain) and stmt.analyze and \
            isinstance(stmt.statement, t.Query)
        if not explain_analyze and not isinstance(stmt, t.Query):
            # DDL/DML/EXPLAIN/SHOW run on the coordinator's local engine
            return self.local.execute(sql, user=user)
        session = self.local.session
        spec = session.get("fault_injection")
        # session-spec injectors are scoped to THIS query: a process-global
        # leak would keep injecting chaos into every later query. A
        # programmatically installed injector (tests) or the env-var one
        # (worker processes) always wins and is left alone.
        installed_here = False
        if spec and faults.active() is None:
            faults.install(faults.FaultInjector.from_spec(
                str(spec), seed=int(session.get("fault_seed") or 0)))
            installed_here = True
        try:
            if explain_analyze:
                # distributed EXPLAIN ANALYZE: run on the workers and roll
                # their TaskInfo operator stats up per fragment (before
                # this, ANALYZE profiled the coordinator's local engine)
                return self._instrumented(
                    session, lambda: self._explain_analyze(stmt.statement))
            return self._execute_query(sql, session)
        finally:
            if installed_here:
                faults.clear()

    def _instrumented(self, session: Session, run) -> QueryResult:
        """Trace + wall-histogram wrapper: the coordinator's flight recorder
        captures lifecycle spans plus every task-create/poll and result-pull
        HTTP call (the `http` category). The lifecycle span only opens when
        THIS query's recorder actually installed — an untraced query running
        concurrently with a traced one must not write into its timeline.

        Correlation: with the protocol layer in front, the ambient progress
        scope already carries the client-visible query id and the recorder
        inherits it. Used directly (embedded coordinator, tests), no scope
        exists — bind the recorder's id so the internal per-attempt cq* ids
        journaled below it pick up a corr_id and one filter finds both."""
        import time as _time

        from ..exec import progress

        scope = None
        t0 = _time.perf_counter()
        rec = trace.maybe_recorder(session)
        installed = rec is not None and trace.install(rec)
        try:
            if rec is not None and rec.query_id \
                    and progress.current_query_id() is None:
                # bind scope only after a successful __enter__: the finally
                # below must not __exit__ a scope that was never entered
                s = progress.query_scope(rec.query_id)
                s.__enter__()
                scope = s
            if installed:
                with rec.span(trace.LIFECYCLE, "query"):
                    result = run()
            else:
                result = run()
        except BaseException as e:
            # failure forensics: a FAILED / OOM-killed / retry-exhausted
            # query dumps its always-on coarse ring (task-create/poll HTTP,
            # result pulls, retry lifecycle) pinned to the exception — the
            # protocol layer serves it at GET /v1/query/{id}/trace
            if installed:
                trace.attach_failure(e, rec, session)
            raise
        finally:
            if scope is not None:
                scope.__exit__(None, None, None)
            if installed:
                trace.uninstall(rec)
        METRICS.histogram("query.wall_s", _time.perf_counter() - t0)
        if installed and not rec.coarse:
            result.trace_path = trace.export(rec, session)
        return result

    def _execute_query(self, sql: str, session: Session) -> QueryResult:
        return self._instrumented(
            session, lambda: self._execute_with_retries(sql, session))

    def _execute_with_retries(self, sql: str, session: Session) -> QueryResult:
        def prop(name, default):
            # Session.DEFAULTS (metadata.py) is the canonical source; the
            # fallback here only guards a property explicitly set to None.
            # 0 is a valid value for every retry knob
            value = session.get(name)
            return default if value is None else value

        policy = retry.retry_policy(session)
        max_retries = int(prop("query_retry_attempts", 2)) \
            if policy != retry.NONE else 0
        backoff = Backoff(
            max_failure_interval_s=float("inf"),
            initial_delay_s=float(prop("retry_initial_delay_s", 0.1)),
            max_delay_s=float(prop("retry_max_delay_s", 2.0)))
        excluded: Set[str] = set()
        injector = faults.active()
        faults_before = injector.total_fired if injector else 0
        stats = {"retry_policy": policy, "query_attempts": 0,
                 "task_attempts": 0, "task_retries": 0,
                 "task_speculations": 0, "faults_injected": 0,
                 "backoff_s": 0.0}
        failure_trace: Optional[str] = None
        while True:
            stats["query_attempts"] += 1
            try:
                result = self._execute_attempt(
                    sql, policy, excluded, stats,
                    first_attempt=stats["query_attempts"] == 1)
                break
            except BaseException as e:  # noqa: BLE001 — classified below
                retryable = retry.is_retryable(e)
                # exclude on NODE-level evidence (death, rejected creates) —
                # a TaskFailedError's node is usually just where a dead
                # peer's stream failure SURFACED, not the culprit
                if isinstance(e, retry.ClusterExecutionError) and e.node_id \
                        and not isinstance(e, retry.TaskFailedError):
                    excluded.add(e.node_id)
                if not retryable \
                        or stats["query_attempts"] > max_retries:
                    raise
                METRICS.count("cluster.query_retries")
                # the query will be retried and may well SUCCEED — dump the
                # failed attempt's coarse ring now (first failure wins, it
                # saw the original fault) so the eventual QueryResult still
                # carries the forensic of what went wrong mid-flight
                rec = trace.active()
                if failure_trace is None and rec is not None:
                    try:
                        failure_trace = trace.export(rec, session,
                                                     suffix="-forensic")
                    except Exception:  # noqa: BLE001 - forensics best-effort
                        pass
                from ..utils import events
                events.emit("query.retry", severity=events.WARN,
                            attempt=stats["query_attempts"],
                            error=type(e).__name__, message=str(e)[:300],
                            excluded_nodes=sorted(excluded))
                backoff.failure()
                backoff.wait()
        stats["backoff_s"] = round(
            stats["backoff_s"] + backoff.total_backoff_s, 3)
        stats["faults_injected"] = (injector.total_fired - faults_before) \
            if injector else 0
        METRICS.count("cluster.backoff_seconds", stats["backoff_s"])
        result.stats = stats
        result.failure_trace_path = failure_trace
        return result

    def _execute_attempt(self, sql: str, policy: str, excluded: Set[str],
                         stats: dict, first_attempt: bool) -> QueryResult:
        """One full plan->schedule->pull attempt. Re-planning per attempt is
        deliberate: the surviving node count changes the exchange layout."""
        # a retry only needs SOME healthy workers, not the original quorum
        nodes = self._wait_for_workers(
            min_needed=self.min_workers if first_attempt else 1,
            exclude=excluded)
        sub = self.plan_sql(sql)
        query_id = f"cq{next(self._ids)}_{int(time.time())}"
        scheduler = SqlQueryScheduler(query_id, sub, nodes,
                                      self.local.session,
                                      retry_policy=policy,
                                      excluded_nodes=excluded)
        self._schedulers[query_id] = scheduler
        unregister = self._register_progress(query_id, scheduler)
        try:
            scheduler.schedule()
            return self._pull_results(scheduler, sub)
        except BaseException as e:
            from ..utils import events
            events.emit("query.attempt_failed", severity=events.ERROR,
                        query_id=query_id, error=type(e).__name__,
                        message=str(e)[:300])
            scheduler.abort()
            raise
        finally:
            unregister()
            stats["task_attempts"] += scheduler.task_attempts
            stats["task_retries"] += scheduler.task_retries
            stats["task_speculations"] += scheduler.task_speculations
            stats["backoff_s"] += scheduler.backoff_s
            self._schedulers.pop(query_id, None)
            # free finished tasks' buffers/state on the workers
            for task in scheduler.all_tasks():
                task.cancel(abort=False)

    @staticmethod
    def _register_progress(query_id: str, scheduler: SqlQueryScheduler):
        """Live progress (exec/progress.py): while the attempt runs, serve
        the freshest TaskInfo.operator_stats the monitor's 0.5s polls
        already collect, rolled up cluster-side — per-operator rows/blocked
        counters of a RUNNING query at GET /v1/query/{id}. No extra RPCs:
        the provider re-reads the cached infos."""
        from ..exec import progress

        def live() -> dict:
            ops = []
            for task in scheduler.all_tasks():
                info = task.info
                if info is not None and info.operator_stats:
                    ops.extend(info.operator_stats)
            return {"operators": ops}
        return progress.register(live)

    def _explain_analyze(self, stmt: t.Query) -> QueryResult:
        """Distributed EXPLAIN ANALYZE: schedule the inner query on the
        workers, pull its results, then render per-fragment per-operator
        stats (rows / wall / blocked / peak-mem) rolled up from every
        task's TaskInfo.operator_stats — the same table the local runner's
        _explain_analyze prints, via the shared exec/explain renderer.

        Deliberately single-attempt (no query-level retry): ANALYZE's whole
        point is the profile of the run that happened — transparently
        re-running after a mid-query failure would report a retry's stats
        as if they were the query's. A retryable failure surfaces to the
        caller, who re-issues for a fresh profile."""
        import time as _time

        from ..exec.explain import rollup, table

        session = self.local.session
        nodes = self._wait_for_workers()
        sub = self.plan_statement(stmt)
        query_id = f"cq{next(self._ids)}_{int(time.time())}"
        scheduler = SqlQueryScheduler(query_id, sub, nodes, session)
        self._schedulers[query_id] = scheduler
        t0 = _time.perf_counter()
        try:
            scheduler.schedule()
            self._pull_results(scheduler, sub)
            wall = _time.perf_counter() - t0
            lines = [f"Query: {wall * 1000:.0f}ms wall, "
                     f"{len(sub.fragments)} fragments, "
                     f"{len(scheduler.all_tasks())} tasks on "
                     f"{len(nodes)} workers", ""]
            # one shared re-poll budget for the whole stats render
            deadline = time.monotonic() + 5.0
            for frag in sub.fragments:
                stage = scheduler.stages.get(frag.id)
                tasks = stage.tasks if stage is not None else []
                head = f"Fragment {frag.id} [{frag.partitioning}]"
                if frag.output_kind:
                    head += f" output={frag.output_kind}"
                head += f" tasks={len(tasks)}"
                lines.append(head)
                stats = []
                for task in tasks:
                    # deterministic final-state stats: the cached info is
                    # usually a MID-RUN monitor poll (racing the scan's
                    # input accounting — the old `TableScan In=0` flake);
                    # re-poll until the task reports a DONE state, whose
                    # TaskInfo carries the stats snapshot SqlTask froze
                    # before its terminal transition. The budget is shared
                    # across the WHOLE render (one deadline, not 5s per
                    # task): tasks legitimately still RUNNING at render
                    # time (abandoned producers of a satisfied LIMIT) fall
                    # back to their freshest mid-run stats, as before.
                    info = self._final_task_info(task, deadline=deadline)
                    if info is not None and info.operator_stats:
                        stats.extend(info.operator_stats)
                if stats:
                    lines += table(rollup(stats), indent="  ")
                else:
                    lines.append("  (no operator stats reported)")
                lines.append("")
            return QueryResult([[line] for line in lines], ["Query Plan"])
        except BaseException:
            scheduler.abort()
            raise
        finally:
            self._schedulers.pop(query_id, None)
            for task in scheduler.all_tasks():
                task.cancel(abort=False)

    @staticmethod
    def _final_task_info(task, deadline: Optional[float] = None,
                         budget_s: float = 5.0):
        """The task's DONE-state TaskInfo (deterministic final stats), or
        the freshest available when `deadline` (shared by the caller across
        ALL its tasks — a per-task budget would stack) passes first. The
        root output was already fully consumed when this runs, so tasks are
        normally finishing and the re-poll window is one round trip; a task
        legitimately still RUNNING (an abandoned producer of a satisfied
        LIMIT) falls back to its freshest mid-run stats."""
        from .task import DONE_STATES

        info = task.info
        if info is not None and info.state in DONE_STATES:
            return info
        backoff = Backoff(initial_delay_s=0.01, max_delay_s=0.2)
        if deadline is None:
            deadline = time.monotonic() + budget_s
        while time.monotonic() < deadline:
            polled = task.poll_info()
            if polled is not None:
                info = polled
                if info.state in DONE_STATES:
                    return info
            backoff.failure()
            backoff.wait()
        return info

    def _root_schema(self, scheduler: SqlQueryScheduler, sub: SubPlan):
        """Derive the root fragment's output types + dictionaries by running
        the same deterministic local planning every worker runs — schema is a
        plan-time property, never shipped (see cluster.task.plan_subplan)."""
        task_counts = {f.id: len(s.tasks)
                       for f, s in ((st.fragment, st)
                                    for st in scheduler.stages.values())}
        plans = plan_subplan(sub, self.metadata, self.local.session,
                             task_counts, device=self.local.device)
        ep = plans[sub.root_fragment.id][1]
        return ep.output_types, ep.output_dicts

    def _pull_results(self, scheduler: SqlQueryScheduler,
                      sub: SubPlan) -> QueryResult:
        root = scheduler.root_task()
        types, dicts = self._root_schema(scheduler, sub)
        rows: List[list] = []
        done = threading.Event()
        error: List[BaseException] = []

        from .exchange_client import _MAX_ERROR_S
        budget = self.session.get("exchange_error_budget_s")

        def pull():
            try:
                source = StreamingRemoteSource(
                    [root.location], 0, types, dicts,
                    int(self.session.get("page_capacity") or (1 << 16)),
                    error_budget_s=float(
                        _MAX_ERROR_S if budget is None else budget))
                # hand the in-process consumer to the scheduler: root-task
                # recovery rewires its chunk cursor directly (there is no
                # worker-side /sources endpoint for the coordinator)
                scheduler.register_root_consumer(source)
                for page in source:
                    rows.extend(page.to_pylists())
            except BaseException as e:  # noqa: BLE001
                error.append(e)
            finally:
                done.set()

        puller = threading.Thread(target=pull, name="result-pull",
                                  daemon=True)
        puller.start()
        while not done.wait(timeout=0.5):
            active = self.nodes.active_nodes()
            scheduler.check_failures(active_nodes=active)
            scheduler.maybe_speculate(active)
        # `done` is set in pull()'s finally, so the thread is exiting: the
        # bounded join keeps it from outliving the query (and from racing a
        # teardown of `rows`/`error`, which it captured by closure)
        puller.join(timeout=5.0)
        if error:
            # surface the task/node failure that CAUSED the stream error if
            # there is one — it names the node, which retry placement and
            # fail-fast diagnostics both need. Diagnosis only: this attempt
            # is already lost, recovering a task here would be wasted work
            # that also swallows the node id
            scheduler.check_failures(active_nodes=self.nodes.active_nodes(),
                                     recover=False)
            raise error[0]
        info = root.poll_info()
        if info is not None and info.state != FINISHED:
            scheduler.check_failures()
        return QueryResult(rows, sub.column_names, types)
