"""Worker task runtime: task state machine, output partitioning, task manager.

The port's copy of ``presto_tpu/cluster/task.py`` (Presto's
execution/TaskStateMachine.java, SqlTaskManager.java:84,351,
SqlTaskExecution.java:82, PartitionedOutputOperator.java:297,380-440 and
TaskOutputOperator.java:149), on the worker's ``device``.

A task executes ONE fragment of a query on ONE worker: it locally plans the
shipped SubPlan bottom-up (so string-dictionary identities stay coherent
within this process — the plan, not shipped dictionaries, is the source of
truth), wires RemoteSourceNodes to streaming HTTP exchange clients, replaces
the sink with a partitioned output buffer, and drives the pipelines on the
worker's task executor threads.

What differs from the reference:

- ``TaskOutputOperator`` routes on the device: the rows' partitions come
  from ``parallel/exchange.partition_ids`` over the null-safe combined key
  (the same ``_mix64`` bits as the reference's ``partition_ids_np``), the
  live rows are ordered by a stable sort on partition id there, and each
  column crosses to the host once per page (``serde.pages_to_columns``).
- ``plan_subplan`` hands every planner the fragments' roots
  (``remote_roots``), so a task that plans one fragment proves a join
  build's key unique across a remote source exactly as the mesh runner
  does.
- A task lets go of its drivers, and with them its device tensors, when it
  ends (finished, failed or cancelled); ``info()`` then serves the stats it
  froze before its terminal transition. ``join()`` waits for its thread.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import traceback
import uuid
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..block import Dictionary, Page
from ..exec.local_planner import LocalExecutionPlanner
from ..exec.task_executor import TaskExecutor
from ..metadata import MetadataManager, Session
from ..ops.hash_join import combined_key
from ..ops.operator import Operator, OperatorContext, OperatorFactory
from ..parallel.exchange import partition_ids
from ..sql.planner.fragmenter import SubPlan
from ..sql.planner.plan import BROADCAST, GATHER, REPARTITION, OutputNode
from ..types import Type
from . import buffers, codec, faults
from .exchange_client import StreamingRemoteSource
from .serde import pages_to_columns, serialize_columns

# TaskState vocabulary (execution/TaskState.java)
PLANNED = "PLANNED"
RUNNING = "RUNNING"
FINISHED = "FINISHED"
CANCELED = "CANCELED"
ABORTED = "ABORTED"
FAILED = "FAILED"
DONE_STATES = {FINISHED, CANCELED, ABORTED, FAILED}


def partition_rows(keys: Sequence[torch.Tensor], n_parts: int) -> torch.Tensor:
    """Each row's consumer: the null-safe int64 key columns combined as the
    join build hashes them, then ``partition_ids``, where the keys lie.
    Equal, row for row, to the reference's ``partition_ids_np(
    combined_key_np(keys), n_parts)``."""
    return partition_ids(combined_key([k.to(torch.int64) for k in keys]), n_parts)


@codec.register
@dataclasses.dataclass
class TaskUpdateRequest:
    """POST /v1/task/{taskId} body (JSON via cluster/codec) — the
    fragment+wiring a worker needs (server/TaskUpdateRequest.java analogue)."""
    task_id: str
    query_id: str
    subplan: SubPlan                      # the WHOLE query's fragments
    fragment_id: int                      # which fragment THIS task runs
    worker_index: int                     # this task's index in the fragment
    task_counts: Dict[int, int]           # fragment id -> task count
    # fragment id -> ordered producer-task result locations (".../results" base)
    input_locations: Dict[int, List[str]]
    session: Session
    output_buffers: int = 1               # consumer count for this task's output


@codec.register
@dataclasses.dataclass
class TaskInfo:
    task_id: str
    state: str
    error: Optional[dict] = None
    rows_out: int = 0
    instance_id: str = ""
    # per-operator stats of this task's drivers (exec/explain.driver_stats
    # dicts): the worker half of distributed EXPLAIN ANALYZE, rolled up per
    # fragment by the coordinator
    operator_stats: Optional[List[dict]] = None


@codec.register
@dataclasses.dataclass
class SourceUpdateRequest:
    """POST /v1/task/{taskId}/sources body: rewire one exchange input from a
    failed producer to its replacement (task-level retry)."""
    fragment_id: int
    old_location: str
    new_location: str


def plan_subplan(subplan: SubPlan, metadata: MetadataManager, session: Session,
                 task_counts: Dict[int, int], target_fragment_id=None,
                 sink_factory=None, memory=None, pool_key=None, device="cuda"):
    """Locally plan every fragment bottom-up on ``device``, threading
    producer output dictionaries into consumers (the mesh runner's
    pattern). Returns {fragment_id: (LocalExecutionPlanner,
    LocalExecutionPlan)}.

    Every cluster participant runs this same deterministic planning over its
    own metadata — schema (types + dictionary identities) is a plan-time
    property agreed by construction, so neither types nor dictionaries ever
    ride the wire."""
    from ..sql.planner.plan import MERGE, SortNode

    merge_frags = {f.id: f for f in subplan.fragments
                   if f.output_kind == MERGE and f.output_orderings}
    roots = {f.id: f.root for f in subplan.fragments}
    frag_dicts: Dict[int, List[Optional[Dictionary]]] = {}
    plans = {}
    for frag in subplan.fragments:
        # consumer half first: a Sort directly over a MERGE remote source is
        # the N-way merge — drop the full re-sort, record the merge spec so
        # the task wires a MergingRemoteSource into the slot
        merge_slots: Dict[int, list] = {}
        body = _strip_merge_sorts(frag.root, merge_frags, merge_slots)
        if frag.id in merge_frags:
            # producer half of the distributed sort: each task sorts ITS
            # rows locally so the consumer can heap-merge streams
            body = SortNode(body, list(frag.output_orderings))
        if frag is subplan.root_fragment:
            root = OutputNode(body, subplan.column_names, subplan.output_symbols)
        else:
            syms = body.outputs()
            root = OutputNode(body, [s.name for s in syms], syms)
        lp = LocalExecutionPlanner(metadata, session, device,
                                   n_workers=task_counts.get(frag.id, 1),
                                   remote_dicts=frag_dicts, pool_key=pool_key,
                                   remote_roots=roots)
        if memory is not None:
            # worker-side accounting: operator state AND scan prefetch of
            # this task reserve in the worker's shared pool under the query
            # id, which /v1/status ships to the cluster memory manager
            lp.attach_memory(*memory)
        sf = sink_factory if frag.id == target_fragment_id else None
        ep = lp.plan(root, sink_factory=sf)
        for fid, orderings in merge_slots.items():
            slot = lp.remote_slots.get(fid)
            if slot is not None:
                names = [s.name for s in merge_frags[fid].root.outputs()]
                slot.merge_orderings = [
                    (names.index(o.symbol.name), o.descending, o.nulls_first)
                    for o in orderings]
        frag_dicts[frag.id] = ep.output_dicts
        plans[frag.id] = (lp, ep)
    return plans


def _strip_merge_sorts(node, merge_frags, out: Dict[int, list]):
    """Replace SortNode(RemoteSourceNode(fid)) with the bare remote source
    when fragment fid's output is MERGE (its tasks pre-sorted), recording
    the orderings per fragment id."""
    from ..sql.planner.plan import RemoteSourceNode, SortNode

    if isinstance(node, SortNode) and \
            isinstance(node.source, RemoteSourceNode) and \
            node.source.fragment_id in merge_frags:
        out[node.source.fragment_id] = list(node.orderings)
        return node.source
    children = node.children()
    if not children:
        return node
    new_children = [_strip_merge_sorts(c, merge_frags, out) for c in children]
    if all(a is b for a, b in zip(children, new_children)):
        return node
    return node.with_children(new_children)


class TaskOutputOperator(Operator):
    """Sink: partition/broadcast this task's output pages into its
    OutputBuffer as serialized frames (PartitionedOutputOperator analogue;
    rows accumulate per consumer on the host and flush at ``flush_rows``)."""

    def __init__(self, context: OperatorContext, types: List[Type],
                 output: buffers.OutputBuffer, kind: str,
                 key_idx: Optional[List[int]], flush_rows: int,
                 cancelled: Optional[threading.Event] = None):
        super().__init__(context)
        self._types = types
        self.output = output
        self.kind = kind
        self.key_idx = key_idx
        self.flush_rows = flush_rows
        self.cancelled = cancelled
        ncols = len(types)
        self._acc: List[List[List[np.ndarray]]] = [
            [[] for _ in range(2 * ncols)] for _ in range(output.n_buffers)]
        self._acc_rows = [0] * output.n_buffers
        self.rows_out = 0

    @property
    def output_types(self) -> List[Type]:
        return self._types

    def add_input(self, page: Page) -> None:
        if self.cancelled is not None and self.cancelled.is_set():
            # a cancelled task stops at its next page instead of running its
            # scans to the end with nobody to read them
            raise RuntimeError("task cancelled")
        self.context.record_input(page, page.capacity)
        live = torch.nonzero(page.mask).squeeze(1)
        counts = None
        if self.kind != BROADCAST and self.kind != GATHER and \
                self.output.n_buffers > 1 and self.key_idx is not None:
            keys = []
            for i in self.key_idx:
                b = page.blocks[i]
                k = b.data[live]
                keys.append(k if b.nulls is None else torch.where(b.nulls[live], 0, k))
            pid = partition_rows(keys, self.output.n_buffers)
            live = live[torch.argsort(pid, stable=True)]
            counts = torch.bincount(pid.to(torch.int64), minlength=self.output.n_buffers)
        datas, nulls, nrows = pages_to_columns([page], self._types, rows=live)
        if nrows == 0:
            return
        self.rows_out += nrows
        nulls = [n if n is not None else np.zeros(nrows, dtype=bool) for n in nulls]
        if self.kind == BROADCAST:
            frame = serialize_columns(datas, [n if n.any() else None for n in nulls], nrows)
            self.output.enqueue_broadcast(frame)
            return
        if counts is None:
            # GATHER, and MERGE (key_idx is None): funnel to consumer 0,
            # which then merges — the range-split distributed sort is the
            # mesh runner's; the HTTP data plane keeps the reference's
            # single-merger shape
            self._append(0, datas, nulls, 0, nrows)
        else:
            bounds = np.concatenate([[0], np.cumsum(counts.cpu().numpy())])
            for b in range(self.output.n_buffers):
                if bounds[b + 1] > bounds[b]:
                    self._append(b, datas, nulls, int(bounds[b]), int(bounds[b + 1]))
        for b in range(self.output.n_buffers):
            if self._acc_rows[b] >= self.flush_rows:
                self._flush(b)

    def _append(self, b: int, datas, nulls, lo: int, hi: int) -> None:
        ncols = len(self._types)
        for c in range(ncols):
            self._acc[b][c].append(datas[c][lo:hi])
            self._acc[b][ncols + c].append(nulls[c][lo:hi])
        self._acc_rows[b] += hi - lo

    def _flush(self, b: int) -> None:
        if self._acc_rows[b] == 0:
            return
        ncols = len(self._types)
        datas = [np.concatenate(self._acc[b][c]) for c in range(ncols)]
        nulls = [np.concatenate(self._acc[b][ncols + c]) for c in range(ncols)]
        # emit in flush_rows-sized chunks: one frame = one replayable chunk
        # of the exchange protocol, even when a single upstream page carries
        # the whole partition (an aggregation flushing everything at finish)
        total = self._acc_rows[b]
        for lo in range(0, total, self.flush_rows):
            hi = min(lo + self.flush_rows, total)
            sliced = [n[lo:hi] for n in nulls]
            frame = serialize_columns(
                [d[lo:hi] for d in datas],
                [n if n.any() else None for n in sliced], hi - lo)
            self.output.enqueue(b, frame)
        self._acc[b] = [[] for _ in range(2 * ncols)]
        self._acc_rows[b] = 0

    def get_output(self) -> Optional[Page]:
        return None

    def finish(self) -> None:
        if not self._finishing:
            for b in range(self.output.n_buffers):
                self._flush(b)
            self.output.set_no_more_pages()
        super().finish()


class TaskOutputFactory(OperatorFactory):
    def __init__(self, operator_id: int, types: List[Type],
                 output: buffers.OutputBuffer, kind: str,
                 key_idx: Optional[List[int]], flush_rows: int = 1 << 14,
                 cancelled: Optional[threading.Event] = None):
        super().__init__(operator_id, "TaskOutput")
        self.types = types
        self.output = output
        self.kind = kind
        self.key_idx = key_idx
        self.flush_rows = flush_rows
        self.cancelled = cancelled
        self.operators: List[TaskOutputOperator] = []

    def create_operator(self, worker: int = 0) -> TaskOutputOperator:
        op = TaskOutputOperator(
            self.context(worker), self.types, self.output, self.kind, self.key_idx,
            self.flush_rows, self.cancelled)
        self.operators.append(op)
        if len(self.operators) > 1:
            # two sink drivers interleave their flushes nondeterministically:
            # a re-run would produce a DIFFERENT frame sequence, so cursor
            # replay against this stream would corrupt data — refuse loudly
            self.output.mark_nonreplayable(
                "multiple sink drivers (nondeterministic frame order)")
        return op


class SqlTask:
    """One fragment execution on this worker (execution/SqlTask.java:69)."""

    def __init__(self, request: TaskUpdateRequest, metadata: MetadataManager,
                 device="cuda", on_spool: Optional[Callable[[int], None]] = None):
        self.request = request
        self.metadata = metadata
        self.device = resolve_device(device)
        self.task_id = request.task_id
        # a recreated task restarts result tokens at 0; the instance id lets a
        # consumer detect that (reference: PRESTO_TASK_INSTANCE_ID header)
        self.instance_id = uuid.uuid4().hex
        self.state = PLANNED
        # guards `state`: _run (the task thread) and cancel (an HTTP handler
        # thread) both transition it
        self._state_lock = threading.Lock()
        self.error: Optional[dict] = None
        self.created = time.time()
        self.cancelled = threading.Event()
        self.output_types: List[Type] = []
        self.output_dicts: List[Optional[Dictionary]] = []
        self._sink: Optional[TaskOutputFactory] = None
        # exchange inputs are rewireable for task-level retry: the scheduler
        # may replace a failed producer's location (update_sources); sources
        # not yet constructed pick up the current list, live ones are reset
        self._src_lock = threading.Lock()
        self._input_locations: Dict[int, List[str]] = {
            fid: list(locs) for fid, locs in request.input_locations.items()}
        self._live_sources: Dict[int, List[object]] = {}
        # the drivers while the task runs (info() reads their stats live);
        # dropped when it ends, which frees the task's device tensors
        self._drivers: List[object] = []
        # this task's disk-spill manager, created by _query_memory when the
        # session enables the disk tier; closed in _run's finally
        self._spill = None
        # final-state stats snapshot, frozen BEFORE the terminal transition:
        # any TaskInfo that reports a DONE state carries complete stats
        self._final_stats: Optional[List[dict]] = None
        kind = self._output_kind()
        # acked frames retire into a bounded spool so consumers (or their
        # replacements) can replay from a chunk cursor; spooled bytes are
        # reserved in the worker's process-shared pool under the QUERY id
        from ..memory import shared_general_pool
        pool = shared_general_pool(int(request.session.get("memory_pool_bytes")))

        def reserve(delta: int) -> None:
            if on_spool is not None:
                on_spool(delta)  # the worker's own spool gauge
            pool.reserve(request.query_id, delta)
        self.output = buffers.OutputBuffer(
            buffers.BROADCAST if kind == BROADCAST else
            (buffers.GATHER if request.output_buffers == 1 else buffers.PARTITIONED),
            request.output_buffers,
            spool_max_bytes=int(request.session.get("exchange_spool_bytes") or 0),
            reserve=reserve)
        self.thread = threading.Thread(
            target=self._run, name=f"task-{self.task_id}", daemon=True)

    def _output_kind(self) -> str:
        return self._fragment().output_kind or GATHER

    def _query_memory(self):
        """This task's memory root in the worker's process-shared pool,
        keyed by QUERY id — every task of one query aggregates into one
        reservation the OOM killer can weigh. The task's disk tier rides
        along as ``memory.spill`` (per task, charged under the query id);
        ``_run``'s ``finally`` closes it."""
        from ..exec.spill import SpillManager
        from ..memory import QueryContextMemory, shared_general_pool

        req = self.request
        session_bytes = int(req.session.get("memory_pool_bytes"))
        pool = shared_general_pool(session_bytes)
        qmem = QueryContextMemory(req.query_id, pool,
                                  int(req.session.get("query_max_memory_bytes")))
        target = float(req.session.get("revoke_target_fraction"))
        if self._spill is None and bool(req.session.get("spill_to_disk")):
            self._spill = SpillManager(
                req.query_id, pool, spill_dir=str(req.session.get("spill_dir") or ""),
                max_bytes=int(req.session.get("spill_max_bytes") or 0))
        qmem.memory.spill = self._spill

        def over_target() -> bool:
            return (pool.reserved_bytes() > pool.max_bytes * target
                    or pool.query_bytes(req.query_id) > session_bytes * target)
        return qmem.memory, over_target

    def _fragment(self):
        for f in self.request.subplan.fragments:
            if f.id == self.request.fragment_id:
                return f
        raise KeyError(f"fragment {self.request.fragment_id} not in subplan")

    def start(self) -> None:
        self.thread.start()

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait for the task's thread; True when it has ended."""
        if self.thread.ident is not None:
            self.thread.join(timeout)
        return not self.thread.is_alive()

    # ------------------------------------------------------------ lifecycle

    def _transition(self, state: str) -> bool:
        """Move to `state` unless already terminal (a cancel/abort that beat
        this transition wins — it already poisoned the output buffer)."""
        with self._state_lock:
            if self.state in DONE_STATES:
                return False
            self.state = state
            return True

    def _run(self) -> None:
        from ..utils.metrics import METRICS
        t0 = time.perf_counter()
        try:
            self._transition(RUNNING)
            faults.fire("worker.task_run", task_id=self.task_id,
                        query_id=self.request.query_id)
            drivers = self._plan_drivers()
            self._drivers = drivers
            if self.cancelled.is_set():
                raise RuntimeError("task cancelled")
            concurrency = int(self.request.session.get("task_concurrency"))
            TaskExecutor(concurrency).execute(drivers)
            if self._sink is not None and not self._sink.operators:
                # fragment produced no sink operator — still close the
                # buffer so consumers terminate
                self.output.set_no_more_pages()
            # freeze the operator stats BEFORE the terminal transition
            self._snapshot_final_stats()
            METRICS.histogram("task.wall_s", time.perf_counter() - t0)
            self._transition(FINISHED if not self.cancelled.is_set() else CANCELED)
        except Exception as e:  # noqa: BLE001 — reported via TaskInfo
            self.error = {"message": str(e), "type": type(e).__name__,
                          "stack": traceback.format_exc()[-2000:]}
            self._snapshot_final_stats()
            if self._transition(FAILED):
                # a cancelled task that stopped at its sink is CANCELED or
                # ABORTED already, not a failure to journal
                from ..utils import events
                events.emit("task.failed", severity=events.ERROR,
                            query_id=self.request.query_id,
                            task_id=self.task_id, error=type(e).__name__,
                            message=str(e)[:500])
            # Set `cancelled` first: it marks the teardown abnormal, so
            # exchange sources skip their final acks — a failed consumer
            # must not release producer buffers its replacement still needs
            self.cancelled.set()
            for d in self._drivers:
                try:
                    d.close()
                except Exception:  # noqa: BLE001 - teardown best effort
                    pass
            self.output.fail(str(e))
        finally:
            # the task's device tensors go with its drivers, however it ended
            self._drivers = []
            # spill files must not outlive the task no matter how it ended
            if self._spill is not None:
                self._spill.close()

    def _snapshot_final_stats(self) -> None:
        from ..exec.explain import driver_stats
        try:
            if self._drivers:
                self._final_stats = driver_stats(self._drivers)
        except Exception:  # noqa: BLE001 - stats must never mask the run's outcome
            pass

    def _plan_drivers(self):
        req = self.request
        frag = self._fragment()
        plans = plan_subplan(req.subplan, self.metadata, req.session,
                             req.task_counts, target_fragment_id=req.fragment_id,
                             sink_factory=self._make_sink(frag),
                             memory=self._query_memory(),
                             # one fairness slot per QUERY on this worker
                             pool_key=f"cluster-{req.query_id}",
                             device=self.device)
        own_lp, own_plan = plans[req.fragment_id]
        self.output_types = own_plan.output_types
        self.output_dicts = own_plan.output_dicts
        # wire remote sources to streaming HTTP pulls
        from ..metadata import default_page_capacity
        page_cap = int(req.session.get("page_capacity") or default_page_capacity(self.device))
        from .exchange_client import _MAX_ERROR_S
        budget = req.session.get("exchange_error_budget_s")
        error_budget_s = float(_MAX_ERROR_S if budget is None else budget)
        for fid, slot in own_lp.remote_slots.items():
            dicts = plans[fid][1].output_dicts
            types = [s.type for s in self._producer_outputs(fid)]
            merge = slot.merge_orderings

            def factory(worker, _fid=fid, _t=types, _d=dicts, _m=merge):
                with self._src_lock:
                    locs = list(self._input_locations.get(_fid, []))
                    if _m:
                        from .exchange_client import MergingRemoteSource

                        src = MergingRemoteSource(
                            locs, req.worker_index, _t, _d, page_cap, _m,
                            cancelled=self.cancelled, error_budget_s=error_budget_s)
                    else:
                        src = StreamingRemoteSource(
                            locs, req.worker_index, _t, _d, page_cap,
                            cancelled=self.cancelled, error_budget_s=error_budget_s)
                    self._live_sources.setdefault(_fid, []).append(src)
                return src
            slot.source_factory = factory
        return own_plan.create_drivers(req.worker_index)

    def _producer_outputs(self, fragment_id: int):
        for f in self.request.subplan.fragments:
            if f.id == fragment_id:
                return f.root.outputs()
        raise KeyError(fragment_id)

    def _make_sink(self, frag):
        def make(types: List[Type], dicts) -> TaskOutputFactory:
            key_idx = None
            if frag.output_kind == REPARTITION and frag.output_keys:
                names = [s.name for s in frag.root.outputs()]
                key_idx = [names.index(k.name) for k in frag.output_keys]
            flush = self.request.session.get("exchange_flush_rows")
            self._sink = TaskOutputFactory(
                999, types, self.output, frag.output_kind or GATHER, key_idx,
                flush_rows=int(flush) if flush else 1 << 14, cancelled=self.cancelled)
            return self._sink
        return make

    # ------------------------------------------------------------------ api

    def update_sources(self, update: "SourceUpdateRequest") -> bool:
        """Rewire one exchange input to a replacement producer location.
        True only if EVERY live source for that fragment accepted the reset;
        the scheduler escalates to a query-level retry otherwise."""
        with self._src_lock:
            locs = self._input_locations.get(update.fragment_id)
            if locs is None:
                return False
            old = update.old_location.rstrip("/")
            if not any(loc.rstrip("/") == old for loc in locs):
                return False
            live = self._live_sources.get(update.fragment_id, [])
            # check-then-apply so a rejection mutates nothing
            if not all(src.can_reset_location(update.old_location) for src in live):
                return False
            for src in live:
                if not src.reset_location(update.old_location, update.new_location):
                    return False
            for i, loc in enumerate(locs):
                if loc.rstrip("/") == old:
                    locs[i] = update.new_location
        return True

    def cancel(self, abort: bool = False) -> None:
        self.cancelled.set()
        self._transition(ABORTED if abort else CANCELED)
        if abort:
            # poison BEFORE freeing: an aborted stream must read as a
            # failure, never as a clean end-of-stream
            self.output.fail(f"task {self.task_id} aborted")
        self.output.destroy()

    def info(self) -> TaskInfo:
        from ..exec.explain import driver_stats

        rows = self._sink.operators[0].rows_out \
            if self._sink and self._sink.operators else 0
        # DONE state -> the frozen final snapshot (deterministic); mid-run
        # -> a live racy read (what live progress wants)
        stats = self._final_stats
        drivers = self._drivers
        if stats is None:
            stats = driver_stats(drivers) if drivers else None
        return TaskInfo(self.task_id, self.state, self.error, rows,
                        self.instance_id, operator_stats=stats)


class WorkerTaskManager:
    """execution/SqlTaskManager.java:84 — owns this worker's tasks, which
    run on the worker's ``device``."""

    def __init__(self, metadata: MetadataManager, max_done_tasks: int = 200,
                 device="cuda"):
        self.metadata = metadata
        self.device = resolve_device(device)
        self.tasks: Dict[str, SqlTask] = {}
        self._lock = threading.Lock()
        self.max_done_tasks = max_done_tasks
        # the replay spool over every task held, done ones too, and its
        # high-water mark since the worker started (GET /v1/status)
        self.spooled_bytes = 0
        self.spooled_bytes_peak = 0
        self._spool_lock = threading.Lock()

    def _spooled(self, delta: int) -> None:
        with self._spool_lock:
            self.spooled_bytes += delta
            self.spooled_bytes_peak = max(self.spooled_bytes_peak, self.spooled_bytes)

    def create_or_update(self, request: TaskUpdateRequest) -> TaskInfo:
        created = False
        with self._lock:
            task = self.tasks.get(request.task_id)
            if task is None:
                task = SqlTask(request, self.metadata, self.device, on_spool=self._spooled)
                self.tasks[request.task_id] = task
                task.start()
                self._cleanup_locked()
                created = True
            elif (request.query_id, request.fragment_id,
                  request.worker_index) != (task.request.query_id,
                                            task.request.fragment_id,
                                            task.request.worker_index):
                # an update must describe the SAME work
                raise ValueError(
                    f"task {request.task_id} exists with different content "
                    f"(instance {task.instance_id})")
        if created:
            from ..utils import events
            events.emit("task.created", query_id=request.query_id,
                        task_id=request.task_id, fragment=request.fragment_id)
        return task.info()

    def get(self, task_id: str) -> Optional[SqlTask]:
        return self.tasks.get(task_id)

    def cancel(self, task_id: str, abort: bool = False) -> bool:
        task = self.tasks.get(task_id)
        if task is None:
            return False
        task.cancel(abort)
        return True

    def cancel_query(self, query_id: str) -> None:
        for task in list(self.tasks.values()):
            if task.request.query_id == query_id:
                task.cancel(abort=True)

    def _cleanup_locked(self) -> None:
        done = [t for t in self.tasks.values() if t.state in DONE_STATES]
        if len(done) <= self.max_done_tasks:
            return
        done.sort(key=lambda t: t.created)
        for t in done[:len(done) - self.max_done_tasks]:
            self.tasks.pop(t.task_id, None)
            self._spooled(-t.output.spooled_bytes())  # its spool leaves with it
