"""DistributedQueryRunner: SQL over the mesh of logical workers.

Counterpart of ``presto_tpu/parallel/runner.py``:

  parse -> plan -> optimize -> add_exchanges -> fragment_plan
  -> per fragment, each worker's drivers over its shard (its splits, or the
     exchange's pages for it)
  -> every fragment boundary an exchange between the workers
     (``parallel/exchange.py``: all_to_all repartition, all_gather
     broadcast, gather to worker 0, range repartition for ORDER BY)

Two data planes:

- STREAMING (default, ``streaming_exchange=True``): every fragment's drivers
  run together on one task executor, and each fragment boundary is a
  ``StreamingExchange`` moving fixed-capacity chunks while producers still
  run, with byte-bounded backpressure on both sides.
- BARRIER (``streaming_exchange=False``, the differential oracle):
  fragments run bottom-up, each draining fully before ``run_exchange``
  routes all of its output in one exchange.

Every worker's drivers share one task executor, so the workers' pipelines
time-slice across its runner threads. A mesh's workers may share a device:
the H100 runs four logical workers as ``MeshContext([cuda:0] * 4)``.
"""
from __future__ import annotations

import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..block import Block, Dictionary, Page, torch_dtype
from ..exec.local_planner import LocalExecutionPlanner
from ..exec.shared_pools import next_query_key
from ..exec.task_executor import TaskExecutor
from ..metadata import CatalogManager, Session
from ..runner import LocalQueryRunner, QueryResult
from ..sql import tree as t
from ..sql.planner.add_exchanges import add_exchanges
from ..sql.planner.fragmenter import SINGLE_PART, Fragment, SubPlan, fragment_plan
from ..sql.planner.optimizer import optimize
from ..sql.planner.plan import (BROADCAST, GATHER, MERGE, REPARTITION, OutputNode,
                                plan_to_text)
from ..sql.planner.planner import LogicalPlanner
from ..types import Type
from ..utils import trace
from ..utils.metrics import METRICS
from .exchange import (broadcast_gather, gather_to_single, partition_ids,
                       range_partition_ids, repartition_by_pid)
from .mesh import MeshContext
from .streaming_exchange import (EXCHANGE_STATS, ExchangeSinkOperatorFactory,  # noqa: F401
                                 ExchangeStatsBook, StreamingExchange, _combined, _compact_pad,
                                 _range_key_for, host_ints, is_host_upload,
                                 record_exchange_stat)


class DistributedQueryRunner:
    """The in-process multi-worker engine over a ``MeshContext``."""

    def __init__(self, mesh: Optional[MeshContext] = None, session: Optional[Session] = None,
                 catalogs: Optional[CatalogManager] = None, device="cuda",
                 page_capacity: int = 1 << 14):
        self.mesh = mesh if mesh is not None else MeshContext()
        self.local = LocalQueryRunner(session, catalogs, device)
        if page_capacity is not None and "page_capacity" not in self.local.session.properties:
            self.local.session = self.local.session.with_properties(page_capacity=page_capacity)

    @property
    def metadata(self):
        return self.local.metadata

    @property
    def session(self):
        return self.local.session

    # ------------------------------------------------------------------ api

    def plan_sql(self, sql: str) -> SubPlan:
        stmt = self.local.parser.parse(sql)
        if not isinstance(stmt, t.Query):
            raise ValueError(f"cannot plan {type(stmt).__name__}")
        return self.plan_statement(stmt)

    def plan_statement(self, stmt: t.Query) -> SubPlan:
        planner = LogicalPlanner(self.metadata, self.session)
        plan = optimize(planner.plan(stmt), self.metadata, self.session)
        plan = add_exchanges(plan, planner.symbols, self.metadata, self.session,
                             n_workers=self.mesh.n_workers)
        return fragment_plan(plan)

    def explain(self, sql: str) -> str:
        parts = []
        for f in self.plan_sql(sql).fragments:
            head = f"Fragment {f.id} [{f.partitioning}]"
            if f.output_kind:
                keys = f" keys={[k.name for k in f.output_keys]}" if f.output_keys else ""
                head += f" output={f.output_kind}{keys}"
            parts.append(head + "\n" + plan_to_text(f.root, indent=1))
        return "\n".join(parts)

    def execute(self, sql: str) -> QueryResult:
        stmt = self.local.parser.parse(sql)
        if isinstance(stmt, t.Explain) and stmt.analyze and isinstance(stmt.statement, t.Query):
            return self._explain_analyze(stmt.statement)
        if not isinstance(stmt, t.Query):
            return self.local.execute(sql)  # EXPLAIN, SHOW and writes stay local
        self.session.check_supported()
        return self._execute_subplan(self.plan_statement(stmt))

    # ------------------------------------------------------------ execution

    def _execute_subplan(self, sub: SubPlan,
                         frag_drivers: Optional[Dict[int, List[list]]] = None) -> QueryResult:
        """``frag_drivers``, when given, collects each fragment's per-worker
        driver lists for EXPLAIN ANALYZE."""
        book = ExchangeStatsBook()
        streaming = bool(self.session.get("streaming_exchange"))

        def run() -> QueryResult:
            if streaming:
                return self._execute_streaming(sub, book, frag_drivers)
            return self._execute_barrier(sub, book, frag_drivers)

        t0 = time.perf_counter()
        rec = trace.maybe_recorder(self.session)
        installed = rec is not None and trace.install(rec)
        try:
            if installed:
                with rec.span(trace.LIFECYCLE, "query"):
                    result = run()
            else:
                result = run()
        except BaseException as e:
            if installed:
                trace.attach_failure(e, rec, self.session)
            raise
        finally:
            if installed:
                trace.uninstall(rec)
        METRICS.histogram("query.wall_s", time.perf_counter() - t0)
        snap = book.snapshot()
        if snap:
            snap["mode"] = "streaming" if streaming else "barrier"
            result.stats = dict(result.stats or {}, exchange=snap)
            METRICS.count_many({k: v for k, v in snap.items() if isinstance(v, (int, float))},
                               prefix="exchange.")
        if installed and not rec.coarse:
            result.trace_path = trace.export(rec, self.session)
        return result

    def _fragment_root(self, sub: SubPlan, frag: Fragment) -> OutputNode:
        if frag is sub.root_fragment:
            return OutputNode(frag.root, sub.column_names, sub.output_symbols)
        syms = frag.root.outputs()
        return OutputNode(frag.root, [s.name for s in syms], syms)

    @staticmethod
    def _routing_spec(frag: Fragment):
        """-> (key channels, orderings) of the fragment's output exchange."""
        names = [s.name for s in frag.root.outputs()]
        key_idx = orderings = None
        if frag.output_kind == REPARTITION:
            key_idx = [names.index(k.name) for k in frag.output_keys]
        elif frag.output_kind == MERGE:
            orderings = tuple((names.index(o.symbol.name), o.descending, o.nulls_first)
                              for o in frag.output_orderings)
        return key_idx, orderings

    def _planner(self, sub: SubPlan, frag_dicts, pool_key) -> LocalExecutionPlanner:
        return LocalExecutionPlanner(self.metadata, self.session, n_workers=self.mesh.n_workers,
                                     devices=self.mesh.devices, remote_dicts=frag_dicts,
                                     pool_key=pool_key,
                                     remote_roots={f.id: f.root for f in sub.fragments})

    def _pool_key(self) -> Optional[str]:
        """One shared-pool fairness slot per query: every fragment's scans
        and every exchange pump of the query share it."""
        return next_query_key("mesh-q") if bool(self.session.get("shared_pools")) else None

    def _execute_streaming(self, sub: SubPlan, book: ExchangeStatsBook,
                           frag_drivers: Optional[dict] = None) -> QueryResult:
        """Plan every fragment, connect them with StreamingExchanges, then run
        every fragment's drivers in one task-executor pass while the pumps
        move chunks between them."""
        W = self.mesh.n_workers
        frag_dicts: Dict[int, List[Optional[Dictionary]]] = {}
        exchanges: Dict[int, StreamingExchange] = {}
        sink_facs: Dict[int, ExchangeSinkOperatorFactory] = {}
        mem, over_target, release = self.local._query_memory()
        chunk_rows = int(self.session.get("exchange_chunk_rows") or 0)
        inflight = int(self.session.get("exchange_inflight_bytes") or 0)
        page_cap = int(self.session.get("page_capacity") or (1 << 14))
        pool_key = self._pool_key()
        drivers = []
        root_ep = None
        planned = []
        try:
            for frag in sub.fragments:
                is_root = frag is sub.root_fragment
                root = self._fragment_root(sub, frag)
                workers = [0] if frag.partitioning == SINGLE_PART else list(range(W))
                lp = self._planner(sub, frag_dicts, pool_key)
                lp.attach_memory(mem, over_target)
                if is_root:
                    ep = lp.plan(root)
                else:
                    key_idx, orderings = self._routing_spec(frag)
                    holder: dict = {}

                    def sink_factory(types, dicts, _frag=frag, _key=key_idx, _ord=orderings,
                                     _holder=holder, _lp=lp):
                        ex = StreamingExchange(
                            self.mesh, _frag.id, _frag.output_kind, _key, types, dicts,
                            orderings=_ord, chunk_rows=chunk_rows, inflight_bytes=inflight,
                            page_capacity=page_cap, book=book, pool_key=pool_key,
                            memory=mem.user.new_local_memory_context(
                                f"exchange_inflight_f{_frag.id}"))
                        fac = ExchangeSinkOperatorFactory(next(_lp._ids), ex, types)
                        _holder["exchange"], _holder["factory"] = ex, fac
                        return fac

                    ep = lp.plan(root, sink_factory=sink_factory)
                    exchanges[frag.id] = holder["exchange"]
                    sink_facs[frag.id] = holder["factory"]
                    frag_dicts[frag.id] = ep.output_dicts
                # fragments are planned bottom-up: every stream a consumer
                # reads exists already
                for fid, slot in ep.remote_slots.items():
                    slot.stream = exchanges[fid]
                planned.append(ep)
                for w in workers:
                    worker_drivers = ep.create_drivers(w)
                    drivers.extend(worker_drivers)
                    if frag_drivers is not None:
                        frag_drivers.setdefault(frag.id, []).append(worker_drivers)
                if is_root:
                    root_ep = ep
            # pair each partitioned INNER join's exchanges before any pump runs
            if bool(self.session.get("skew_aware_exchange")):
                _wire_skew(planned, exchanges)
            for fid, ex in exchanges.items():
                ex.start(sink_facs[fid].created)
            from ..exec import progress
            from ..exec.explain import driver_stats
            from ..runner import _pool_steps

            unregister = progress.register(lambda: {
                "operators": driver_stats(drivers),
                "memory_reserved_bytes": mem.total_bytes(),
                "pool_steps": _pool_steps(pool_key)})
            try:
                # a parked consumer waits on a pump, which runs outside the
                # executor: the run polls while any pump is live
                TaskExecutor(int(self.session.get("task_concurrency"))).execute(
                    drivers, external=lambda: any(ex.pumping() for ex in exchanges.values()))
            finally:
                unregister()
            return QueryResult(root_ep.sink.rows(), sub.column_names, root_ep.output_types)
        finally:
            err = sys.exc_info()[1]
            for ex in exchanges.values():
                ex.close(error=err)
            if err is not None:
                for d in drivers:
                    try:
                        d.close()
                    except Exception:  # noqa: BLE001 - teardown is best effort
                        pass
            release()

    def _execute_barrier(self, sub: SubPlan, book: ExchangeStatsBook,
                         frag_drivers: Optional[dict] = None) -> QueryResult:
        """The stage-barrier oracle: each fragment drains fully, then one
        exchange routes all of its output. One memory root for the query."""
        W = self.mesh.n_workers
        mem, over_target, release = self.local._query_memory()
        frag_dicts: Dict[int, List[Optional[Dictionary]]] = {}
        routed: Dict[int, List[List[Page]]] = {}
        pool_key = self._pool_key()
        try:
            for frag in sub.fragments:
                is_root = frag is sub.root_fragment
                workers = [0] if frag.partitioning == SINGLE_PART else list(range(W))
                lp = self._planner(sub, frag_dicts, pool_key)
                lp.attach_memory(mem, over_target)
                ep = lp.plan(self._fragment_root(sub, frag))
                for fid, slot in ep.remote_slots.items():
                    for w in range(W):
                        slot.set_pages(w, routed[fid][w])
                per_worker = [ep.create_drivers(w) for w in workers]
                if frag_drivers is not None:
                    frag_drivers[frag.id] = per_worker
                drivers = [d for wd in per_worker for d in wd]
                try:
                    TaskExecutor(int(self.session.get("task_concurrency"))).execute(drivers)
                except BaseException:
                    for d in drivers:
                        d.close()
                    raise
                if is_root:
                    return QueryResult(ep.sink.rows(), sub.column_names, ep.output_types)
                key_idx, orderings = self._routing_spec(frag)
                routed[frag.id] = run_exchange(
                    self.mesh, frag.output_kind, key_idx,
                    [ep.sink.pages_for(w) for w in range(W)], ep.output_types,
                    ep.output_dicts, page_capacity=int(self.session.get("page_capacity")
                                                       or (1 << 14)),
                    orderings=orderings, book=book)
                frag_dicts[frag.id] = ep.output_dicts
            raise AssertionError("the root fragment ends execution")
        finally:
            release()

    # ------------------------------------------------------ EXPLAIN ANALYZE

    def _explain_analyze(self, stmt: t.Query) -> QueryResult:
        """Execute over the mesh, then each fragment's operator stats rolled
        up across its workers (``exec/explain.py``), and each fragment
        boundary's exchange counts."""
        from ..exec.explain import driver_stats, rollup, table

        sub = self.plan_statement(stmt)
        frag_drivers: Dict[int, List[list]] = {}
        t0 = time.perf_counter()
        result = self._execute_subplan(sub, frag_drivers)
        wall = time.perf_counter() - t0
        ex = (result.stats or {}).get("exchange", {})
        per_exchange = {e.get("fragment"): e for e in ex.get("per_exchange", [])}
        lines = [f"Query: {wall * 1000:.0f}ms wall, {len(sub.fragments)} fragments, "
                 f"{self.mesh.n_workers} workers, exchange={ex.get('mode', 'none')}", ""]
        for frag in sub.fragments:
            head = f"Fragment {frag.id} [{frag.partitioning}]"
            if frag.output_kind:
                head += f" output={frag.output_kind}"
            per_worker = frag_drivers.get(frag.id, [])
            lines.append(head + f" workers={len(per_worker)}")
            lines += table(rollup([s for wd in per_worker for s in driver_stats(wd)]),
                           indent="  ")
            exch = per_exchange.get(frag.id)
            if exch:
                lines.append(f"  exchange [{exch.get('kind')}]: chunks={exch.get('chunks', 0)} "
                             f"carry_rows={exch.get('carry_rows', 0)} "
                             f"rows_out={exch.get('rows_out', 0)} "
                             f"overlap_s={exch.get('overlap_s', 0)}")
            lines.append("")
        return QueryResult([[line] for line in lines], ["Query Plan"], stats=result.stats,
                           trace_path=result.trace_path)


# ---------------------------------------------------------------------------
# skew wiring: pair each INNER join's build and probe exchanges
# ---------------------------------------------------------------------------

def _pipeline_members(chain) -> list:
    """A factory chain with fused segments expanded to their members."""
    from ..ops.fused_segment import FusedSegmentOperatorFactory

    members = []
    for f in chain:
        if isinstance(f, FusedSegmentOperatorFactory):
            members.extend(f.mid_factories)
            if f.terminal_factory is not None:
                members.append(f.terminal_factory)
        else:
            members.append(f)
    return members


def _skew_pair_safe(build_members, probe_members, probe_join, build_src, exchanges) -> bool:
    """May this join's hot keys spray and replicate without anything else
    in the consumer fragment noticing? Skew routing breaks "all rows of key
    k on one partition", which the exchange planner may have relied on when
    it elided a later exchange. So the pair wires only when the build
    pipeline is remote source -> row-local* -> build, and everything after
    the probe join is partition-agnostic: row-local operators, PARTIAL
    aggregations, TopN/sort/limit, sinks, and joins whose build arrived by
    BROADCAST."""
    from ..ops.coalesce import CoalesceOperatorFactory
    from ..ops.filter_project import FilterProjectOperatorFactory
    from ..ops.hash_agg import PARTIAL, HashAggregationOperatorFactory
    from ..ops.hash_join import LookupJoinOperatorFactory
    from ..ops.topn import LimitOperatorFactory, OrderByOperatorFactory, TopNOperatorFactory
    from ..utils.testing import PageConsumerFactory

    row_local = (FilterProjectOperatorFactory, CoalesceOperatorFactory)
    if any(not isinstance(f, row_local) for f in build_members[:-1]):
        return False
    ji = probe_members.index(probe_join)
    if any(not isinstance(f, row_local) for f in probe_members[:ji]):
        return False
    for f in probe_members[ji + 1:]:
        if isinstance(f, row_local + (TopNOperatorFactory, OrderByOperatorFactory,
                                      LimitOperatorFactory, ExchangeSinkOperatorFactory,
                                      PageConsumerFactory)):
            continue
        if isinstance(f, HashAggregationOperatorFactory) and f.step == PARTIAL:
            continue
        if isinstance(f, LookupJoinOperatorFactory):
            bfid = build_src.get(id(f.lookup_factory))
            bex = exchanges.get(bfid) if bfid is not None else None
            if bex is not None and bex.kind == BROADCAST:
                continue
        return False
    return True


def _wire_skew(planned, exchanges) -> None:
    """For every partitioned INNER join of a consumer fragment, pair the
    REPARTITION exchange feeding its build with the one feeding its probe
    on one SkewCoordinator. INNER only (a replicated row would emit
    spurious unmatched rows under LEFT/FULL/semi semantics), unambiguous
    1:1 pairs only, and only where ``_skew_pair_safe`` holds."""
    from ..ops.hash_join import INNER, JoinBuildOperatorFactory, LookupJoinOperatorFactory
    from .streaming_exchange import SkewCoordinator

    build_src, build_info, probe_src = {}, {}, {}
    for ep in planned:
        for chain in ep.pipelines:
            fid = getattr(getattr(chain[0], "slot", None), "fragment_id", None)
            if fid is None:
                continue
            members = _pipeline_members(chain[1:])
            if members and isinstance(members[-1], JoinBuildOperatorFactory):
                build_src[id(members[-1].lookup_factory)] = fid
                build_info[id(members[-1].lookup_factory)] = members
            for f in members:
                if isinstance(f, LookupJoinOperatorFactory):
                    key = id(f.lookup_factory)
                    # two probe feeds of one build: ambiguous
                    probe_src[key] = None if key in probe_src else (fid, f, members)
    for key, bfid in build_src.items():
        pair = probe_src.get(key)
        if not pair:
            continue
        pfid, join_fac, probe_members = pair
        if join_fac.join_type != INNER or pfid == bfid:
            continue
        bex, pex = exchanges.get(bfid), exchanges.get(pfid)
        if bex is None or pex is None or bex.kind != REPARTITION or pex.kind != REPARTITION \
                or bex._skew is not None or pex._skew is not None:
            continue
        if not _skew_pair_safe(build_info[key], probe_members, join_fac, build_src, exchanges):
            continue
        coord = SkewCoordinator()
        bex.set_skew("build", coord)
        pex.set_skew("probe", coord)


# ---------------------------------------------------------------------------
# the barrier exchange: per-worker pages -> one exchange -> per-worker pages
# ---------------------------------------------------------------------------

# the floor of an exchange's per-worker buffer rows
_MIN_EXCHANGE_CAP = 1 << 9


def _pow2_floor(n: int) -> int:
    return max(1 << (max(n, 1) - 1).bit_length(), _MIN_EXCHANGE_CAP)


def _worker_device_columns(pages: List[Page], types: Sequence[Type], dev,
                           book: Optional[ExchangeStatsBook] = None):
    """One worker's pages concatenated and widened on its device ->
    (datas, nulls, mask, live count as a 0-d tensor). A page from host
    memory counts in host_uploads."""
    for p in pages:
        if is_host_upload(p, dev):
            record_exchange_stat("host_uploads", 1, book)
    mask = torch.cat([p.mask.to(dev) for p in pages])
    datas, nulls = [], []
    for c, t in enumerate(types):
        datas.append(torch.cat([p.blocks[c].data.to(dev, torch_dtype(t)) for p in pages]))
        nulls.append(torch.cat([p.blocks[c].nulls.to(dev) if p.blocks[c].nulls is not None
                                else torch.zeros(p.capacity, dtype=torch.bool, device=dev)
                                for p in pages]))
    return datas, nulls, mask, mask.sum()


def _exchange_program(kind: str, key_idx: Optional[Tuple[int, ...]], ncols: int, W: int,
                      out_cap: int, devices):
    """The exchange of one barrier routing, over per-worker lists:
    (arrays, masks[, range keys, splitters]) -> (arrays, masks, dropped)."""
    if kind == MERGE:
        def merge_stage(arrays, masks, range_keys, splitters):
            pids = [range_partition_ids(rk, splitters, m, W) for rk, m in zip(range_keys, masks)]
            return repartition_by_pid(arrays, masks, pids, W, out_cap, devices)
        return merge_stage

    def stage(arrays, masks):
        if kind == REPARTITION:
            pids = [torch.where(m, partition_ids(_combined(a[:ncols], a[ncols:], key_idx), W), W)
                    .to(torch.int32) for a, m in zip(arrays, masks)]
            return repartition_by_pid(arrays, masks, pids, W, out_cap, devices)
        if kind == BROADCAST:
            out, ms = broadcast_gather(arrays, masks, devices)
        elif kind == GATHER:
            out, ms = gather_to_single(arrays, masks, devices)
        else:
            raise AssertionError(kind)
        return out, ms, [torch.zeros((), dtype=torch.int64, device=d) for d in devices]
    return stage


def run_exchange(mesh: MeshContext, kind: str, key_idx: Optional[List[int]],
                 per_worker_pages: List[List[Page]], types: Sequence[Type],
                 dicts: Sequence[Optional[Dictionary]], page_capacity: int = 1 << 14,
                 orderings=None, book: Optional[ExchangeStatsBook] = None) -> List[List[Page]]:
    """Route every worker's output pages to their consumers in one exchange
    (REPARTITION = all_to_all, BROADCAST = all_gather, GATHER = all_gather
    masked to worker 0, MERGE = range all_to_all). Device-resident end to
    end: each worker's pages compact on its device, the exchange runs, and
    each worker's output is handed on as device pages of the standard pow2
    capacities. The host reads are the reference's: the live counts, the
    per-peer maxima that size the buffers, MERGE's splitter samples, the
    drop count and which output columns carry a NULL."""
    W = mesh.n_workers
    devices = mesh.devices
    ncols = len(types)
    record_exchange_stat("exchanges", 1, book)
    compacted = [_worker_device_columns(pages, types, devices[w], book) if pages else None
                 for w, pages in enumerate(per_worker_pages)]
    present = [w for w in range(W) if compacted[w] is not None]
    counts = host_ints([compacted[w][3] for w in present])
    live = [0] * W
    for w, n in zip(present, counts):
        live[w] = n
    # the fullest worker's live rows, bucketed to a power of two with a floor
    L = _pow2_floor(max(live))
    arrays, masks = [], []
    for w in range(W):
        dev = devices[w]
        if compacted[w] is None:
            arrays.append([torch.zeros(L, dtype=torch_dtype(t), device=dev) for t in types] +
                          [torch.zeros(L, dtype=torch.bool, device=dev) for _ in types])
            masks.append(torch.zeros(L, dtype=torch.bool, device=dev))
            continue
        datas, nulls, mask, _ = compacted[w]
        od, on, om = _compact_pad(datas, nulls, mask, L)
        arrays.append(list(od) + list(on))
        masks.append(om)
    # per-peer receive rows: L for a gather or broadcast; for a repartition
    # the largest (worker, peer) send count, so pages are sized to the data
    out_cap = L
    range_keys = splitters = None
    if kind == REPARTITION:
        maxes = []
        for w in present:
            pid = torch.where(masks[w], partition_ids(
                _combined(arrays[w][:ncols], arrays[w][ncols:], key_idx), W), W)
            maxes.append(torch.bincount(pid.long(), minlength=W + 1)[:W].max())
        out_cap = min(_pow2_floor(max(host_ints(maxes), default=1)), L)
    elif kind == MERGE:
        ch, desc, nf = orderings[0]
        range_keys = [_range_key_for(arrays[w][ch], arrays[w][ncols + ch], types[ch], dicts[ch],
                                     desc, nf) for w in range(W)]
        samples = []
        for w in range(W):
            if live[w]:
                stride = max(1, live[w] // 128)
                samples.append(range_keys[w][:live[w]:stride][:128].cpu())
        pooled = torch.sort(torch.cat(samples)).values if samples else \
            torch.zeros(1, dtype=range_keys[0].dtype)
        splitters = torch.stack([pooled[len(pooled) * i // W] for i in range(1, W)]) \
            if W > 1 else pooled[:0]
        maxes = []
        for w in present:
            pid = range_partition_ids(range_keys[w], splitters, masks[w], W)
            maxes.append(torch.bincount(pid.long(), minlength=W + 1)[:W].max())
        out_cap = min(_pow2_floor(max(host_ints(maxes), default=1)), L)
    program = _exchange_program(kind, tuple(key_idx) if key_idx is not None else None,
                                ncols, W, out_cap, devices)
    if kind == MERGE:
        out, out_masks, dropped = program(arrays, masks, range_keys, splitters)
    else:
        out, out_masks, dropped = program(arrays, masks)
    n_dropped = sum(host_ints(dropped))
    if n_dropped:
        # the buffers are sized to the fullest worker: a drop is a sizing bug
        raise RuntimeError(f"repartition exchange dropped {n_dropped} rows "
                           f"(capacity {L} per peer, {W} workers)")
    # each worker's output compacts on its device and goes on as pages of
    # the standard capacity
    out_compact = [_compact_pad(out[w][:ncols], out[w][ncols:], out_masks[w],
                                out_masks[w].shape[0]) for w in range(W)]
    flags = [c for _, nn, m in out_compact for c in [m.sum()] + [n.any() for n in nn]]
    vals = host_ints(flags)
    routed: List[List[Page]] = []
    for w in range(W):
        out_d, out_n, out_m = out_compact[w]
        live_w = vals[w * (ncols + 1)]
        has_nulls = vals[w * (ncols + 1) + 1:(w + 1) * (ncols + 1)]
        cap = min(max(page_capacity, _MIN_EXCHANGE_CAP), out_m.shape[0])
        pages: List[Page] = []
        for off in range(0, max(1, -(-live_w // cap)) * cap, cap):
            blocks = tuple(Block(types[c], out_d[c][off:off + cap],
                                 out_n[c][off:off + cap] if has_nulls[c] else None, dicts[c])
                           for c in range(ncols))
            pages.append(Page(blocks, out_m[off:off + cap]))
        routed.append(pages if live_w else [])
    return routed
