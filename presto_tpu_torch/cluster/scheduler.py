"""Coordinator-side scheduling: node selection, remote tasks, stage execution.

The port's copy of ``presto_tpu/cluster/scheduler.py``, whole. Presto's
analogues:
  - execution/scheduler/NodeScheduler.java:59 + SimpleNodeSelector.java:45 —
    pick worker nodes for a stage's tasks
  - server/remotetask/HttpRemoteTask.java:103,491-541 — the coordinator's
    proxy for one worker task: POST updates, poll status with backoff
  - execution/scheduler/SqlQueryScheduler.java:114,549 + SqlStageExecution —
    create every stage's tasks (all-at-once policy: data streams between
    stages, so all tasks start together) and monitor them to completion
  - server/remotetask/Backoff.java — transient-failure retry budget
    (cluster/retry.Backoff here, shared by every retry loop on this tier)

Fault tolerance (retry_policy session property, cluster/retry.py):
  - every RemoteTask.create retries transient failures under one shared
    Backoff budget; 4xx rejections stay deterministic hard errors
  - TASK policy re-places a task whose create exhausted its budget onto
    another healthy node (consumers are created after producers, so their
    input_locations simply use the new location), and recovers failed tasks
    in place mid-query — leaf AND interior, mid-stream included, now that
    upstream buffers spool acked chunks (cluster/buffers.py): the
    replacement re-pulls its inputs from sequence 0, re-produces the same
    deterministic frame sequence, and every consumer keeps its chunk cursor
    across the POST /v1/task/{id}/sources rewire (the coordinator's own
    root pull rewires through register_root_consumer). A stream whose
    replay window was retired (HTTP 410) escalates to a query retry.
  - straggler speculation (speculative_execution knob): a task running
    far past its finished siblings gets a duplicate on another node;
    first to FINISH wins — the loser is aborted and the decision is
    journaled `task.speculated`
  - placement weighs the failure detector's decayed failure ratio
    (NodeScheduler.select / _pick_node) instead of excluding-or-round-robin
  - check_failures raises NodeDiedError/TaskFailedError with the node id
    so the coordinator can exclude failed nodes from the next attempt
"""
from __future__ import annotations

import dataclasses
import http.client
import statistics
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Set, Tuple

from ..metadata import Session
from ..sql.planner.fragmenter import Fragment, SINGLE_PART, SubPlan
from ..sql.planner.plan import RemoteSourceNode
from ..utils import trace
from ..utils.metrics import METRICS
from . import codec, faults, retry
from .discovery import NodeInfo
from .retry import Backoff, NodeDiedError, TaskFailedError
from .task import (DONE_STATES, FAILED, FINISHED, SourceUpdateRequest,
                   TaskInfo, TaskUpdateRequest)


class RemoteTask:
    """Coordinator proxy for one worker task (HttpRemoteTask analogue)."""

    def __init__(self, task_id: str, node: NodeInfo, attempt: int = 0):
        self.task_id = task_id
        self.node = node
        self.attempt = attempt
        # failures in this task's chain of replacements: what
        # task_retry_attempts bounds (a planned move is not one)
        self.failures = 0
        self.location = f"{node.uri}/v1/task/{task_id}"
        self.info: Optional[TaskInfo] = None
        self.request: Optional[TaskUpdateRequest] = None
        # wall tracking for straggler speculation: created here, done when a
        # poll first observes a terminal state
        self.created_mono = time.monotonic()
        self.done_mono: Optional[float] = None

    def wall_s(self) -> float:
        end = self.done_mono if self.done_mono is not None \
            else time.monotonic()
        return end - self.created_mono

    def create(self, request: TaskUpdateRequest,
               backoff: Optional[Backoff] = None) -> TaskInfo:
        """POST the task; transient failures (5xx, connection errors) retry
        under the shared Backoff budget, 4xx rejections are deterministic
        hard errors."""
        self.request = request
        body = codec.dumps(request)
        backoff = backoff or Backoff(max_failure_interval_s=10.0,
                                     initial_delay_s=0.1, max_delay_s=1.0)
        last: Optional[Exception] = None
        while True:
            req = urllib.request.Request(
                self.location, data=body, method="POST",
                headers={"Content-Type": "application/json"})
            try:
                faults.fire("client.task_create", node_id=self.node.node_id,
                            task_id=self.task_id)
                with trace.span(trace.HTTP, f"POST task {self.task_id}",
                                node=self.node.node_id):
                    with urllib.request.urlopen(req, timeout=30.0) as resp:
                        self.info = codec.loads(resp.read())
                backoff.success()
                return self.info
            except urllib.error.HTTPError as e:
                # 4xx = the worker REJECTED the request (bad body / conflicting
                # task content) — deterministic, so surface its diagnostic body
                # instead of retrying it as if it were a network blip
                detail = e.read().decode("utf-8", "replace")[:500]
                if 400 <= e.code < 500:
                    raise RuntimeError(
                        f"worker {self.node.node_id} rejected task "
                        f"{self.task_id} ({e.code}): {detail}") from None
                if e.code == 503 and "shutting down" in detail:
                    # a DRAINING worker refuses placement by POLICY, not by
                    # transient overload: retrying against it would burn the
                    # whole backoff budget before the re-place. Escalate now
                    # so _create_task excludes the node and re-places on a
                    # healthy one immediately.
                    raise retry.ClusterExecutionError(
                        f"worker {self.node.node_id} is draining "
                        f"(503 shutting down) for task {self.task_id}",
                        node_id=self.node.node_id, retryable=True)
                last = RuntimeError(f"HTTP {e.code}: {detail}")
            except (urllib.error.URLError, OSError) as e:
                last = e
            if backoff.failure():
                raise retry.ClusterExecutionError(
                    f"cannot create task {self.task_id} on "
                    f"{self.node.node_id} after {backoff.failure_count} "
                    f"tries: {last}", node_id=self.node.node_id,
                    retryable=True)
            backoff.wait()

    def poll_info(self) -> Optional[TaskInfo]:
        req = urllib.request.Request(self.location, method="GET")
        try:
            faults.fire("client.task_poll", node_id=self.node.node_id,
                        task_id=self.task_id)
            with trace.span(trace.HTTP, f"GET task {self.task_id}",
                            node=self.node.node_id):
                with urllib.request.urlopen(req, timeout=10.0) as resp:
                    self.info = codec.loads(resp.read())
            if self.info is not None and self.info.state in DONE_STATES \
                    and self.done_mono is None:
                self.done_mono = time.monotonic()
            return self.info
        except (urllib.error.URLError, OSError):
            return None  # judged by the failure detector, not one lost poll

    def update_sources(self, update: "SourceUpdateRequest") -> bool:
        """POST /sources: rewire one of this task's exchange inputs to a
        replacement producer. False = the worker rejected the rewire (data
        already consumed from the old location — caller must escalate)."""
        req = urllib.request.Request(
            self.location + "/sources", data=codec.dumps(update),
            method="POST", headers={"Content-Type": "application/json"})
        try:
            urllib.request.urlopen(req, timeout=10.0).read()
            return True
        except (urllib.error.URLError, OSError):
            return False

    def cancel(self, abort: bool = True) -> None:
        try:
            req = urllib.request.Request(
                self.location + ("?abort=true" if abort else ""),
                method="DELETE")
            urllib.request.urlopen(req, timeout=5.0).read()
        except (urllib.error.URLError, http.client.HTTPException, OSError):
            # cancel is best-effort: the task may already be done or its
            # node dead — teardown proceeds either way, and the worker's
            # own task GC reaps anything a lost DELETE leaves behind
            pass


class NodeScheduler:
    """SimpleNodeSelector.java:45 (narrowed): every active node runs one task
    of each distributed fragment; single-task fragments rotate by fragment id
    so consecutive SINGLE stages spread. Retry-aware placement: instead of
    excluding-or-round-robin, selection WEIGHS the failure detector's decayed
    failure ratio (discovery.HeartbeatFailureDetector) — a node with a flaky
    recent history stops receiving single-task fragments before it is sick
    enough to be expelled from active_nodes()."""

    def __init__(self, nodes: List[NodeInfo]):
        assert nodes, "no active worker nodes"
        self.nodes = nodes

    @staticmethod
    def _bucket(node: NodeInfo) -> int:
        # quarter-buckets so ordinary heartbeat jitter cannot reshuffle
        # placement between monitor ticks
        return int(min(max(node.failure_ratio, 0.0), 1.0) * 4)

    def ranked(self) -> List[NodeInfo]:
        """Nodes best-first by bucketed decayed failure ratio; the sort is
        stable, so announce order breaks ties (the pre-detector behavior)."""
        return sorted(self.nodes, key=self._bucket)

    def select(self, fragment: Fragment) -> List[NodeInfo]:
        if fragment.partitioning == SINGLE_PART:
            ranked = self.ranked()
            best = self._bucket(ranked[0])
            healthy = [n for n in ranked if self._bucket(n) == best]
            return [healthy[fragment.id % len(healthy)]]
        return list(self.nodes)


@dataclasses.dataclass
class StageExecution:
    fragment: Fragment
    tasks: List[RemoteTask]


class SqlQueryScheduler:
    """Create all stages' tasks, monitor to completion, expose root location.

    Stages are created bottom-up (producers first) so consumers' first pulls
    mostly find their sources; data still STREAMS between stages — no stage
    waits for another to finish before starting (all-at-once policy,
    AllAtOnceExecutionPolicy.java)."""

    def __init__(self, query_id: str, subplan: SubPlan,
                 nodes: List[NodeInfo], session: Session,
                 retry_policy: str = retry.NONE,
                 excluded_nodes: Optional[Set[str]] = None):
        self.query_id = query_id
        self.subplan = subplan
        self.session = session
        self.selector = NodeScheduler(nodes)
        self.retry_policy = retry_policy
        # shared with the coordinator's query-retry loop: nodes that failed
        # here are excluded from the NEXT attempt's placement too
        self.excluded_nodes: Set[str] = (
            excluded_nodes if excluded_nodes is not None else set())
        # nodes that left through a completed drain (the coordinator's
        # drain_worker adds them): a task lost with one was not a failure
        self.drained_nodes: Set[str] = set()
        self.stages: Dict[int, StageExecution] = {}
        self._consumer_tasks = self._consumer_task_counts()
        # observability (surfaced via QueryResult.stats + /v1/metrics)
        self.task_attempts = 0
        self.task_retries = 0
        self.task_speculations = 0
        self.backoff_s = 0.0
        # the coordinator's in-process root consumer (StreamingRemoteSource):
        # registered so root-task recovery can rewire its cursor directly —
        # there is no worker-side /sources endpoint for the coordinator
        self._root_consumer = None
        # straggler speculation: (fragment id, task index) -> (task_id of the
        # original at launch, speculative RemoteTask). Spec tasks are NOT in
        # self.stages, so check_failures never treats their failure as fatal.
        self._live_spec: Dict[Tuple[int, int], Tuple[str, RemoteTask]] = {}
        self._spec_done: Set[str] = set()  # base ids speculated once already
        # serializes stage.tasks mutations between the pull loop's monitor
        # (check_failures / maybe_speculate) and a concurrent planned drain
        # (drain_node, called from the coordinator/autoscaler thread)
        self._monitor_lock = threading.RLock()

    def _consumer_task_counts(self) -> Dict[int, int]:
        """fragment id -> number of tasks of its consuming fragment."""
        counts: Dict[int, int] = {}
        for frag in self.subplan.fragments:
            n_tasks = 1 if frag.partitioning == SINGLE_PART \
                else len(self.selector.nodes)
            for fid in _remote_source_ids(frag.root):
                counts[fid] = n_tasks
        counts[self.subplan.root_fragment.id] = 1  # the coordinator pulls root
        return counts

    def _new_backoff(self) -> Backoff:
        def prop(name, default):
            # 0.0 is a valid budget: it collapses the time window so the
            # budget exhausts after Backoff's min_tries (3) attempts
            value = self.session.get(name)
            return float(default if value is None else value)

        return Backoff(
            max_failure_interval_s=prop("remote_task_error_budget_s", 10.0),
            initial_delay_s=prop("retry_initial_delay_s", 0.1),
            max_delay_s=prop("retry_max_delay_s", 2.0))

    def schedule(self) -> None:
        task_counts = {
            f.id: (1 if f.partitioning == SINGLE_PART
                   else len(self.selector.nodes))
            for f in self.subplan.fragments}
        for frag in self.subplan.fragments:  # bottom-up order from fragmenter
            # a stage is made under the monitor's lock: a planned drain
            # (drain_node, on another thread) that moved a producer between
            # this read of its location and the stage's entry would rewire
            # no consumer of it, and the new tasks would pull from the
            # aborted producer
            with self._monitor_lock:
                self._schedule_stage(frag, task_counts)

    def _schedule_stage(self, frag: Fragment, task_counts: Dict[int, int]) -> None:
        nodes = self.selector.select(frag)
        input_locations = {
            fid: [t.location for t in self.stages[fid].tasks]
            for fid in _remote_source_ids(frag.root)}
        tasks: List[RemoteTask] = []
        try:
            for i, node in enumerate(nodes):
                tasks.append(self._create_task(frag, i, node, task_counts,
                                               input_locations))
        except BaseException:
            # a half-created stage is not in self.stages, so abort() and
            # the coordinator's cleanup would never see these tasks —
            # cancel them here or they leak on the workers per attempt
            for task in tasks:
                task.cancel(abort=True)
            raise
        self.stages[frag.id] = StageExecution(frag, tasks)

    def _build_request(self, task_id: str, frag: Fragment, index: int,
                      task_counts: Dict[int, int],
                      input_locations: Dict[int, List[str]]
                      ) -> TaskUpdateRequest:
        return TaskUpdateRequest(
            task_id=task_id,
            query_id=self.query_id,
            subplan=self.subplan,
            fragment_id=frag.id,
            worker_index=index,
            task_counts=task_counts,
            input_locations=input_locations,
            session=self.session,
            output_buffers=self._consumer_tasks[frag.id])

    def _create_task(self, frag: Fragment, index: int, node: NodeInfo,
                     task_counts: Dict[int, int],
                     input_locations: Dict[int, List[str]]) -> RemoteTask:
        """Create one task; under TASK policy a node whose create budget is
        exhausted is excluded and the task is re-placed on the next healthy
        node under a new attempt id."""
        base_id = f"{self.query_id}.{frag.id}.{index}"
        attempt = 0
        tried: Set[str] = set()
        while True:
            if self.retry_policy == retry.TASK \
                    and node.node_id in self.excluded_nodes:
                # a node already proven bad this query would burn a full
                # create budget per fragment before re-placing; skip it up
                # front (if every node is excluded, try anyway — the
                # starvation fallback)
                alternative = self._pick_node(
                    exclude=tried | {node.node_id})
                if alternative is not None:
                    node = alternative
            task_id = base_id if attempt == 0 else f"{base_id}.r{attempt}"
            task = RemoteTask(task_id, node, attempt=attempt)
            self.task_attempts += 1
            backoff = self._new_backoff()
            try:
                task.create(
                    self._build_request(task_id, frag, index, task_counts,
                                        input_locations),
                    backoff=backoff)
                return task
            except retry.ClusterExecutionError:
                tried.add(node.node_id)
                if self.retry_policy != retry.TASK:
                    raise
                self.excluded_nodes.add(node.node_id)
                replacement = self._pick_node(exclude=tried)
                if replacement is None:
                    raise
                METRICS.count("cluster.task_retries")
                from ..utils import events
                events.emit("task.retry", severity=events.WARN,
                            query_id=self.query_id, task_id=task_id,
                            retry_kind="re-placement", failed_node=node.node_id,
                            new_node=replacement.node_id,
                            attempt=attempt + 1)
                self.task_retries += 1
                node = replacement
                attempt += 1
            finally:
                self.backoff_s += backoff.total_backoff_s

    def _pick_node(self, exclude: Set[str]) -> Optional[NodeInfo]:
        candidates = [node for node in self.selector.nodes
                      if node.node_id not in exclude
                      and node.node_id not in self.excluded_nodes
                      and not node.draining]
        if not candidates:
            return None
        # weigh the decayed failure ratio: re-place onto the node with the
        # cleanest recent history (stable min keeps announce order on ties)
        return min(candidates, key=NodeScheduler._bucket)

    # ------------------------------------------------------------ monitoring

    def root_task(self) -> RemoteTask:
        return self.stages[self.subplan.root_fragment.id].tasks[0]

    def register_root_consumer(self, source) -> None:
        """The coordinator's pull thread hands over its StreamingRemoteSource
        so root-task recovery can rewire the in-process consumer's chunk
        cursor (workers rewire via POST /sources; the coordinator has no
        such endpoint — it IS the consumer)."""
        self._root_consumer = source

    def all_tasks(self) -> List[RemoteTask]:
        return [t for s in self.stages.values() for t in s.tasks]

    def check_failures(self,
                       active_nodes: Optional[List[NodeInfo]] = None,
                       recover: bool = True) -> None:
        """Poll task infos; raise on any FAILED task or dead node. Under TASK
        policy, first try in-place recovery (leaf AND interior, mid-stream:
        upstream spools + consumer cursors make the replay sound); what
        recovery cannot heal — a retired replay window, an exhausted attempt
        budget, a rejected rewire — raises a typed error the coordinator's
        query-retry loop classifies. Pass
        ``recover=False`` on diagnosis-only calls (an attempt already known
        lost): recovery there would build a replacement task just to throw
        it away, and a successful recovery would swallow the typed error
        whose node id the retry loop needs for placement exclusion."""
        active_ids = ({n.node_id for n in active_nodes}
                      if active_nodes is not None else None)
        pending: List[retry.ClusterExecutionError] = []
        with self._monitor_lock:
            self._check_failures_locked(active_ids, active_nodes, recover,
                                        pending)
        if pending:
            # a dead NODE is the root cause; a FAILED task on a healthy node
            # is often just a consumer of the dead node's stream — raise the
            # node death first so retry placement excludes the right node
            for failure in pending:
                if isinstance(failure, NodeDiedError):
                    raise failure
            raise pending[0]

    def _check_failures_locked(self, active_ids, active_nodes, recover,
                               pending) -> None:
        for stage in self.stages.values():
            for idx, task in enumerate(stage.tasks):
                info = task.poll_info()
                failure: Optional[retry.ClusterExecutionError] = None
                if info is not None and info.state == FAILED:
                    err = info.error or {}
                    failure = TaskFailedError(
                        f"task {task.task_id} failed on {task.node.node_id}: "
                        f"{err.get('message')}\n{err.get('stack', '')[-800:]}",
                        node_id=task.node.node_id,
                        retryable=retry.error_dict_retryable(err))
                elif active_ids is not None \
                        and task.node.node_id not in active_ids \
                        and (info is None or info.state not in DONE_STATES):
                    failure = NodeDiedError(
                        f"worker {task.node.node_id} died with task "
                        f"{task.task_id} in state "
                        f"{info.state if info else 'UNREACHABLE'}",
                        node_id=task.node.node_id)
                if failure is None:
                    continue
                if recover and self.retry_policy == retry.TASK \
                        and failure.retryable and active_nodes \
                        and self._recover_task(stage, idx, active_nodes,
                                               failure):
                    continue
                from ..utils import events
                events.emit(
                    "node.died" if isinstance(failure, NodeDiedError)
                    else "task.failed",
                    severity=events.ERROR, query_id=self.query_id,
                    task_id=task.task_id, node=task.node.node_id,
                    message=str(failure)[:300])
                pending.append(failure)

    # ---------------------------------------------------------------- drain

    def drain_node(self, node_id: str,
                   active_nodes: List[NodeInfo]) -> Tuple[int, int]:
        """Planned drain: proactively hand every live task on `node_id` to a
        replacement through the same mid-stream replay path failure recovery
        uses — exactly-once splice, consumers keep their chunk cursors, no
        410 escalation (the drained worker's spools are pinned and intact).
        Deliberately NOT gated on retry_policy: a drain is an operator
        action, and "zero queries lost" must hold for NONE-policy tenants
        too. A handoff spends none of the task's failure budget. Tasks
        recovery cannot move (root consumer not yet registered, no other
        node, a refused create or rewire) are left to finish naturally on
        the draining node — it keeps serving until they do.
        Returns (tasks handed off, live tasks left to finish in place)."""
        moved = 0
        left = 0
        with self._monitor_lock:
            candidates = [n for n in active_nodes
                          if n.node_id != node_id
                          and not getattr(n, "draining", False)]
            for stage in self.stages.values():
                for idx in range(len(stage.tasks)):
                    task = stage.tasks[idx]
                    if task.node.node_id != node_id:
                        continue
                    info = task.poll_info() or task.info
                    if info is not None and info.state in DONE_STATES:
                        continue
                    # the full active list, draining nodes included: the
                    # replacement's consumers on the draining node must be
                    # rewired too (a consumer left in place there would pull
                    # from the aborted producer); _recover_task places the
                    # replacement on a node that is not draining
                    if candidates and self._recover_task(
                            stage, idx, active_nodes, failure=None,
                            retry_kind="drain"):
                        moved += 1
                    else:
                        left += 1
        return moved, left

    def _recover_task(self, stage: StageExecution, idx: int,
                      active_nodes: List[NodeInfo],
                      failure: Optional[retry.ClusterExecutionError] = None,
                      retry_kind: str = "in-place-recovery") -> bool:
        """In-place recovery of one failed task — leaf OR interior, mid-stream
        included. The replacement re-derives its output deterministically
        (leaf fragments re-scan the connector; interior fragments re-pull
        their inputs from sequence 0 against the producers' spools), and
        every consumer keeps its chunk cursor across the rewire, skipping
        frames it already delivered. Unsound cases stay loud: a failure whose
        cause is a retired replay window (HTTP 410) cannot be healed by
        re-running the SAME stream, and a rejected rewire aborts the
        replacement — both escalate to the coordinator's query retry."""
        frag = stage.fragment
        old = stage.tasks[idx]
        message = str(failure).lower() if failure is not None else ""
        if "replay window lost" in message or "cannot replay" in message:
            # the task died because an UPSTREAM spool retired its window;
            # a replacement would re-pull the same 410
            return False
        if frag is self.subplan.root_fragment \
                and self._root_consumer is None:
            return False  # nobody registered to rewire the coordinator's pull
        # a drain's handoff, or the re-run of a task lost with a node that
        # had drained, is planned: it spends none of the failure budget, so
        # a rolling upgrade can move one task more often than that budget
        planned = failure is None or old.node.node_id in self.drained_nodes
        budget = self.session.get("task_retry_attempts")
        if not planned and old.failures >= int(2 if budget is None else budget):
            # a task that keeps dying would otherwise be recovered forever
            # (recovery resets nothing the failure reads); escalate to the
            # BOUNDED query-level retry instead
            return False
        # draining nodes never receive replacements: moving a task onto a
        # node that is itself leaving would just re-run this recovery
        healthy = [n for n in active_nodes
                   if n.node_id != old.node.node_id
                   and not getattr(n, "draining", False)]
        candidates = [n for n in healthy
                      if n.node_id not in self.excluded_nodes] or healthy
        if not candidates:
            return False
        attempt = old.attempt + 1
        base_id = f"{self.query_id}.{frag.id}.{old.request.worker_index}"
        new_task = None
        for node in sorted(candidates, key=NodeScheduler._bucket):
            new_task = self._launch_duplicate(
                frag, old, f"{base_id}.r{attempt}", node, attempt=attempt)
            # a node whose drain began after the candidates were read
            # refuses the create (503): place on the next one, or a
            # planned drain would turn this recovery into a query retry
            if new_task is not None or not getattr(node, "draining", False):
                break
        if new_task is None:
            return False
        if not self._rewire_consumers(frag, old, new_task, active_nodes):
            new_task.cancel(abort=True)
            return False
        old.cancel(abort=True)
        new_task.failures = old.failures + (0 if planned else 1)
        stage.tasks[idx] = new_task
        METRICS.count("cluster.task_retries")
        from ..utils import events
        events.emit("task.retry", severity=events.WARN,
                    query_id=self.query_id, task_id=new_task.task_id,
                    retry_kind=retry_kind, failed_task=old.task_id,
                    failed_node=old.node.node_id, new_node=node.node_id,
                    attempt=attempt)
        self.task_retries += 1
        return True

    def _launch_duplicate(self, frag: Fragment, old: RemoteTask,
                          task_id: str, node: NodeInfo,
                          attempt: int) -> Optional[RemoteTask]:
        """Create a copy of ``old`` under ``task_id`` on ``node``, with its
        remote-source inputs refreshed to the CURRENT producer locations
        (an earlier recovery in this same sweep may have moved them)."""
        input_locations = {
            fid: [t.location for t in self.stages[fid].tasks]
            for fid in _remote_source_ids(frag.root)}
        task = RemoteTask(task_id, node, attempt=attempt)
        self.task_attempts += 1
        backoff = self._new_backoff()
        try:
            task.create(
                dataclasses.replace(old.request, task_id=task_id,
                                    input_locations=input_locations),
                backoff=backoff)
        except (retry.ClusterExecutionError, RuntimeError):
            return None
        finally:
            self.backoff_s += backoff.total_backoff_s
        return task

    def _rewire_consumers(self, frag: Fragment, old: RemoteTask,
                          new_task: RemoteTask,
                          active_nodes: List[NodeInfo]) -> bool:
        """Point every live consumer of ``old`` at ``new_task``, cursors
        preserved. Consumers that are themselves dead or FAILED are skipped —
        stages iterate bottom-up, so this same check_failures sweep recovers
        them AFTER their producers, and _launch_duplicate hands the
        replacement the already-updated producer locations. The root
        fragment's single consumer is the coordinator's in-process source,
        rewired directly."""
        if frag is self.subplan.root_fragment:
            return bool(self._root_consumer) and \
                self._root_consumer.reset_location(old.location,
                                                   new_task.location)
        active_ids = {n.node_id for n in active_nodes}
        for consumer_stage in self.stages.values():
            if frag.id not in _remote_source_ids(consumer_stage.fragment.root):
                continue
            update = SourceUpdateRequest(
                fragment_id=frag.id, old_location=old.location,
                new_location=new_task.location)
            for consumer in consumer_stage.tasks:
                if consumer.node.node_id not in active_ids or (
                        consumer.info is not None
                        and consumer.info.state == FAILED):
                    continue  # recovered later this sweep, with new locations
                if not consumer.update_sources(update):
                    return False
        return True

    # ---------------------------------------------------------- speculation

    def maybe_speculate(self, active_nodes: List[NodeInfo]) -> None:
        """Straggler speculation (speculative_execution knob): a RUNNING task
        whose wall exceeds both a floor and a multiple of its finished
        siblings' median gets a duplicate on the cleanest other node; the
        first to FINISH wins and the loser is aborted. Losing original ==
        winning replay: the spool + cursor machinery rewires consumers
        exactly as in-place recovery does. Every decision is journaled
        ``task.speculated``."""
        if not self.session.get("speculative_execution") \
                or self.retry_policy != retry.TASK:
            return
        with self._monitor_lock:
            self._maybe_speculate_locked(active_nodes)

    def _maybe_speculate_locked(self, active_nodes: List[NodeInfo]) -> None:
        self._resolve_speculations(active_nodes)
        min_wall = float(self.session.get("speculation_min_wall_s") or 5.0)
        multiplier = float(self.session.get("speculation_multiplier") or 2.0)
        for stage in self.stages.values():
            frag = stage.fragment
            for idx, task in enumerate(stage.tasks):
                key = (frag.id, idx)
                base = f"{self.query_id}.{frag.id}.{idx}"
                if key in self._live_spec or base in self._spec_done:
                    continue
                info = task.info
                if info is None or info.state in DONE_STATES:
                    continue
                finished = [t.wall_s() for t in stage.tasks
                            if t.done_mono is not None
                            and t.info is not None
                            and t.info.state == FINISHED]
                if not finished:
                    continue  # no sibling baseline: nothing says "straggler"
                threshold = max(min_wall,
                                multiplier * statistics.median(finished))
                if task.wall_s() <= threshold:
                    continue
                candidates = [n for n in active_nodes
                              if n.node_id != task.node.node_id
                              and n.node_id not in self.excluded_nodes
                              and not getattr(n, "draining", False)]
                if not candidates:
                    continue
                node = min(candidates, key=NodeScheduler._bucket)
                spec = self._launch_duplicate(
                    frag, task, f"{base}.s1", node,
                    attempt=task.attempt + 1)
                self._spec_done.add(base)
                if spec is None:
                    continue
                self._live_spec[key] = (task.task_id, spec)
                self.task_speculations += 1
                METRICS.count("cluster.task_speculations")

    def _resolve_speculations(self, active_nodes: List[NodeInfo]) -> None:
        from ..utils import events
        for key, (orig_id, spec) in list(self._live_spec.items()):
            frag_id, idx = key
            stage = self.stages[frag_id]
            original = stage.tasks[idx]
            spec_info = spec.poll_info()
            winner = None
            if original.task_id != orig_id:
                # recovery replaced the original underneath us: the spec's
                # inputs/consumers may be stale — drop it
                winner = "original"
            elif spec_info is not None and spec_info.state == FAILED:
                winner = "original"  # spec failures never fail the query
            elif original.info is not None \
                    and original.info.state in DONE_STATES:
                winner = "original"
            elif spec_info is not None and spec_info.state == FINISHED:
                if self._rewire_consumers(stage.fragment, original, spec,
                                          active_nodes):
                    stage.tasks[idx] = spec
                    winner = "speculative"
                else:
                    winner = "original"  # unsound rewire: keep waiting it out
            if winner is None:
                continue
            del self._live_spec[key]
            loser = original if winner == "speculative" else spec
            loser.cancel(abort=True)
            events.emit("task.speculated", severity=events.INFO,
                        query_id=self.query_id, task_id=orig_id,
                        speculative_task_id=spec.task_id, winner=winner,
                        original_node=original.node.node_id,
                        speculative_node=spec.node.node_id)

    def is_finished(self) -> bool:
        info = self.root_task().info
        return info is not None and info.state == FINISHED

    def abort(self) -> None:
        for task in self.all_tasks():
            task.cancel(abort=True)
        for _, spec in self._live_spec.values():
            spec.cancel(abort=True)
        self._live_spec.clear()


def _remote_source_ids(node) -> List[int]:
    out: List[int] = []

    def walk(n):
        if isinstance(n, RemoteSourceNode):
            out.append(n.fragment_id)
            return
        for c in n.children():
            walk(c)
    walk(node)
    return out
