"""Local execution planner of the PyTorch port: logical plan -> driver pipelines.

Counterpart of ``presto_tpu/exec/local_planner.py`` for the plan shapes of
the 22 TPC-H queries, on an explicit ``device``:

- Filter/Project chains collapse into one PageProcessor, which runs inside
  the scan when the chain sits on a TableScanNode (``visit_fused_stage``).
- A join's build side becomes its own pipeline ending in a
  JoinBuildOperatorFactory, whose strategy ``hash_kernels`` picks
  (``_join_strategy``); the probe pipeline blocks on its lookup source.
  INNER and LEFT joins take any number of equi-keys, and builds that the
  connector's unique column sets do not prove unique expand.
- A semi join (IN / EXISTS) builds its filtering side sorted and probes
  SEMI or ANTI, null-aware for IN / NOT IN. A residual filter (a
  decorrelated EXISTS with non-equi conjuncts, Q21) is compiled over
  [probe columns, build columns] and checked per candidate pair; the build
  carries its columns as payload.
- A join with no criteria (a scalar subquery's cross join) joins on a
  constant BIGINT 0 key that both sides project; its build is sorted, and
  unique when it is an ``EnforceSingleRowNode``.
- A FULL join builds sorted with ``track_unmatched``; its probe emits the
  unmatched build rows at finish, so it never runs on more than one driver.
- A window is one WindowOperator over its source's rows.
- With ``coalesce_pages`` a filtered scan feeding either side of a join
  ends in a CoalesceOperator (``_maybe_coalesce``).
- With ``segment_fusion`` each maximal run of page-local operators becomes
  one FusedSegmentOperatorFactory (``_fuse_pipelines``), and every run
  considered, fused or not, is recorded with its reason in
  ``LocalExecutionPlan.segment_decisions``.
- Symbols resolve to channels here (SymbolRef -> InputRef).

- ``_add_pipeline`` cuts each pipeline that starts with a multi-split
  scan by the reference's rule: its stateless prefix (scan, filter/project,
  non-FULL join probes) runs as N producer drivers behind a bounded
  ``LocalExchange`` and the rest as one consumer driver; a pipeline ending
  in a join build runs whole as N build drivers, whose last finisher
  builds. N is ``driver_parallelism``: AUTO gives ``task_concurrency`` on a
  CUDA device and 1 on the CPU. Fusion runs after the cut.
- Every scan gets the session's pipeline knobs (``scan_options``), and a
  filtered scan the filter's column ranges (``_extract_constraint``), which
  its connector's split manager and page sources may prune with.
- A VALUES list (``SELECT`` without ``FROM``) is one literal host page,
  scanned once, by worker 0.
- UNION [ALL], INTERSECT, EXCEPT and grouping sets plan as a UnionNode:
  each branch drains, in one driver, into a page buffer, and a replay scan
  reads the buffers once every branch has finished. Branch dictionaries
  are unified first (a minority branch remaps its codes on the device).
- Distributed (``n_workers`` > 1, the mesh runner's fragments): one planner
  per fragment, shared by every worker. Worker w of n reads splits w, w+n,
  ... onto its own device (``devices``); a ``RemoteSourceNode`` plans into a
  ``RemoteSourceSlot`` that the runner fills (barrier mode) or attaches a
  streaming exchange to; PARTIAL and FINAL aggregation steps carry the
  intermediate state columns the exchange planner named.

Fusion, coalescing, the scan pipeline and parallel drivers are on by
default, as in the reference; turned off, the port runs the reference's
differential oracles. A plan node, a join shape or a session property the
port does not run raises ``NotImplementedError`` naming itself.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..block import Block, Dictionary, Page, block_from_strings
from ..metadata import MetadataManager, Session, default_page_capacity
from ..ops.aggregates import AggregateCall, resolve_aggregate
from ..ops.expressions import (Constant, ExpressionCompiler, InputLayout, RowExpression,
                               SymbolRef, input_ref, resolve_symbols, symbol_ref, symbols_in)
from ..ops.filter_project import FilterProjectOperatorFactory, PageProcessor
from ..ops.hash_agg import FINAL as OP_FINAL
from ..ops.hash_agg import PARTIAL as OP_PARTIAL
from ..ops.hash_agg import SINGLE, HashAggregationOperatorFactory
from ..ops.hash_join import (ANTI, FULL, INNER, LEFT, SEMI, JoinBuildOperatorFactory,
                             LookupJoinOperatorFactory, join_strategy)
from ..ops.scan import TableScanOperatorFactory
from ..ops.single_row import EnforceSingleRowOperatorFactory
from ..ops.topn import (LimitOperatorFactory, OrderByOperatorFactory, SortOrder,
                        TopNOperatorFactory)
from ..spi.connector import ConcatPageSource, ConnectorPageSource, Constraint, FixedPageSource
from ..sql.planner.optimizer import and_all, split_and, substitute
from ..sql.planner.plan import (AggregationNode, EnforceSingleRowNode, FilterNode, JoinNode,
                                LimitNode, OutputNode, PlanNode, ProjectNode, SemiJoinNode,
                                SortNode, Symbol, TableScanNode, TopNNode, UnionNode,
                                ValuesNode)
from ..sql.planner.plan import RemoteSourceNode
from ..sql.planner.plan import FINAL as P_FINAL
from ..sql.planner.plan import PARTIAL as P_PARTIAL
from ..types import BIGINT, BOOLEAN, Type, is_string
from ..utils.testing import PageConsumerFactory
from .driver import Driver


# union dictionaries interned by value, so that planning the same query
# again yields the same Dictionary object (its token keeps caches warm)
_UNION_DICTS: Dict[tuple, Dictionary] = {}


def _intern_union_dict(values: List[str]) -> Dictionary:
    key = tuple(values)
    d = _UNION_DICTS.get(key)
    if d is None:
        if len(_UNION_DICTS) > 256:
            _UNION_DICTS.clear()
        d = _UNION_DICTS[key] = Dictionary(values)
    return d


def _extract_constraint(filter_parts, scan: TableScanNode) -> Constraint:
    """Scan-filter conjuncts -> per-column [lo, hi] domains (TupleDomain
    extraction, narrowed to constant comparisons: what file and split
    pruning need). Bounds are in the column's substrate units (scaled
    decimal ints, date days, floats); a string constant gives no domain."""
    import math

    from ..ops.expressions import Call, Constant, InputRef
    from ..types import DecimalType

    cols = {i: col for i, (_s, col) in enumerate(scan.assignments)}
    domains: Dict[str, List] = {}

    def bound(v, vt, ct, kind: str):
        """Constant in ITS representation (scaled decimal int, date days,
        float) -> a domain bound in the COLUMN's substrate units.

        kind: lo_ge | lo_gt | hi_le | hi_lt — strict bounds tighten AFTER
        the exact conversion (tightening in the constant's coarser scale
        then upscaling would narrow the domain and drop satisfying rows).
        Integer paths use exact integer arithmetic — float round-trips
        above 2^53 could likewise narrow a domain."""
        if is_string(ct):
            fl = cl = v  # dictionary code compare: units already match
            exact = True
        else:
            s_from = vt.scale if isinstance(vt, DecimalType) else 0
            s_to = ct.scale if isinstance(ct, DecimalType) else 0
            if ct.name in ("double", "real"):
                # continuous substrate: strict bounds stay inclusive
                # (over-approximation, the engine filter refines)
                return float(v) / (10 ** s_from) if s_from else float(v)
            if isinstance(v, int):
                if s_to >= s_from:
                    fl = cl = v * 10 ** (s_to - s_from)
                    exact = True
                else:
                    q, r = divmod(v, 10 ** (s_from - s_to))  # // floors
                    fl, cl, exact = q, q + (1 if r else 0), r == 0
            else:
                x = v * (10 ** (s_to - s_from)) if s_to != s_from else v
                fl, cl = math.floor(x), math.ceil(x)
                exact = fl == cl
        if kind == "hi_le":
            return fl
        if kind == "hi_lt":
            return fl - 1 if exact else fl
        if kind == "lo_ge":
            return cl
        return cl + 1 if exact else cl  # lo_gt

    def note(ch: int, kind: str, v, vt):
        col = cols.get(ch)
        if col is None:
            return
        cur = domains.setdefault(col.name, [None, None])
        b = bound(v, vt, col.type, kind)
        if kind.startswith("lo"):
            cur[0] = b if cur[0] is None else max(cur[0], b)
        else:
            cur[1] = b if cur[1] is None else min(cur[1], b)

    # flatten AND trees first: a multi-conjunct WHERE arrives as ONE nested
    # conjunction, and every conjunct may contribute a domain bound (Q6's
    # shipdate and quantity ranges drive both split pruning and the file
    # scan's native pre-filter; its BETWEEN of computed bounds gives none)
    for part in (c for fp in filter_parts for c in split_and(fp)):
        if not isinstance(part, Call) or len(part.args) != 2:
            continue
        a, b = part.args
        if isinstance(a, Constant) and isinstance(b, InputRef):
            flip = {"less_than": "greater_than",
                    "less_than_or_equal": "greater_than_or_equal",
                    "greater_than": "less_than",
                    "greater_than_or_equal": "less_than_or_equal",
                    "equal": "equal"}.get(part.name)
            if flip is None:
                continue
            a, b, name = b, a, flip
        elif isinstance(a, InputRef) and isinstance(b, Constant):
            name = part.name
        else:
            continue
        v = b.value
        if v is None or isinstance(v, str):
            continue
        if name == "equal":
            note(a.channel, "lo_ge", v, b.type)
            note(a.channel, "hi_le", v, b.type)
        elif name == "less_than":
            note(a.channel, "hi_lt", v, b.type)
        elif name == "less_than_or_equal":
            note(a.channel, "hi_le", v, b.type)
        elif name == "greater_than":
            note(a.channel, "lo_gt", v, b.type)
        elif name == "greater_than_or_equal":
            note(a.channel, "lo_ge", v, b.type)
    return Constraint({k: tuple(v) for k, v in domains.items()}) \
        if domains else Constraint.all()


class _ReplaySource(ConnectorPageSource):
    """A union's output on one worker: the pages of each branch buffer, in
    branch order, read when the scan first asks (after every branch
    ended). It has no ``cache_token``, so its pages never enter the
    resident cache."""

    def __init__(self, buffers: List[PageConsumerFactory], worker: int):
        self.buffers = buffers
        self.worker = worker

    def __iter__(self):
        for b in self.buffers:
            yield from b.pages_for(self.worker)


@dataclasses.dataclass
class Chain:
    """A pipeline under construction + its output layout."""
    factories: List
    symbols: List[Symbol]
    dicts: List[Optional[Dictionary]]

    def channel(self, name: str) -> int:
        for i, s in enumerate(self.symbols):
            if s.name == name:
                return i
        raise KeyError(f"symbol {name} not in layout {[s.name for s in self.symbols]}")

    def channel_map(self) -> Dict[str, int]:
        return {s.name: i for i, s in enumerate(self.symbols)}

    def layout(self) -> InputLayout:
        return InputLayout([s.type for s in self.symbols], list(self.dicts))

    def meta(self, names: Sequence[str]) -> List[Tuple[Type, Optional[Dictionary]]]:
        idx = self.channel_map()
        return [(self.symbols[idx[n]].type, self.dicts[idx[n]]) for n in names]


class RemoteSourceSlot:
    """A fragment's exchange endpoint: the barrier runner deposits each
    worker's routed pages here after the collective ran; the streaming
    runner attaches its ``StreamingExchange`` (``stream``) before the
    drivers exist, and consumers then read the exchange's per-worker queue.

    The cluster's hooks (``cluster/task.py``): a task plugs an HTTP page
    source in as ``source_factory`` (worker -> ConnectorPageSource), and
    ``plan_subplan`` sets ``merge_orderings`` ([(channel, descending,
    nulls_first)]) on a MERGE input, whose source is then a merging one.
    The mesh runner sets neither."""

    def __init__(self, fragment_id: int):
        self.fragment_id = fragment_id
        self._pages_by_worker: Dict[int, List[Page]] = {}
        self.source_factory = None
        self.merge_orderings = None
        self.stream = None

    def set_pages(self, worker: int, pages: List[Page]) -> None:
        self._pages_by_worker[worker] = list(pages)

    def pages(self, worker: int) -> List[Page]:
        return self._pages_by_worker.get(worker, [])

    def make_source(self, worker: int) -> ConnectorPageSource:
        if self.source_factory is not None:
            return self.source_factory(worker)
        return FixedPageSource(self.pages(worker))


class RemoteSourceOperatorFactory(TableScanOperatorFactory):
    """Exchange endpoint factory. The mode is decided when the drivers are
    created, after the runner wired the slot: with a streaming exchange
    attached, each consumer is a ``StreamingExchangeSource`` over its
    worker's chunk queue; otherwise the scan replays the deposited pages."""

    def __init__(self, operator_id: int, slot: RemoteSourceSlot, types: List[Type], device):
        super().__init__(operator_id, lambda w: [slot.make_source(w)], types, None, device)
        self.name = "RemoteSource"
        self.slot = slot

    def create_operator(self, worker: int = 0):
        stream = self.slot.stream
        if stream is not None:
            from ..parallel.streaming_exchange import StreamingExchangeSource

            return StreamingExchangeSource(self.context(worker), stream.out_buffer(worker),
                                           list(self._types))
        return super().create_operator(worker)


@dataclasses.dataclass
class LocalExecutionPlan:
    pipelines: List[List[object]]   # factory chains, dependency order
    sink: PageConsumerFactory
    output_names: List[str]
    output_types: List[Type] = dataclasses.field(default_factory=list)
    # the segment compiler's decisions: one entry per run of page-local
    # operators it considered, fused or not, with the reason
    segment_decisions: List[dict] = dataclasses.field(default_factory=list)
    # the output columns' dictionaries (a CTAS copies them for its table)
    output_dicts: List[Optional[Dictionary]] = dataclasses.field(default_factory=list)
    # producer fragment id -> the exchange endpoint of its RemoteSourceNode
    remote_slots: Dict[int, RemoteSourceSlot] = dataclasses.field(default_factory=dict)

    def create_drivers(self, worker: int = 0) -> List[Driver]:
        """One driver set for ``worker``: ``parallel_drivers`` drivers per
        pipeline (one unless the head scan was cut for parallelism), in
        dependency order. The factories are shared by every worker;
        per-worker state (splits, lookup sources, sinks) keys off the index."""
        return [Driver([f.create_operator(worker) for f in chain])
                for chain in self.pipelines
                for _ in range(getattr(chain[0], "parallel_drivers", 1))]


class LocalExecutionPlanner:
    """Plans one query on ``device`` (default ``"cuda"``; raises without CUDA).
    ``bucket_filter``: grouped execution's lifespan, whose scans keep only
    the splits of that bucket (``exec/grouped.py``).

    Distributed: one planner per fragment, shared by its workers.
    ``n_workers`` scopes the scans (worker w of n reads splits w, w+n, ...),
    ``devices`` places worker w's scans and builds on ``devices[w]`` (and
    ``device`` becomes the first of them), ``remote_dicts`` holds each
    planned producer fragment's output dictionaries, ``remote_roots`` each
    fragment's plan (a build key's uniqueness proof follows a remote source
    into its producer), and ``pool_key`` is the query's one fairness slot
    on the shared pools."""

    def __init__(self, metadata: MetadataManager, session: Session, device="cuda",
                 bucket_filter: Optional[int] = None, n_workers: int = 1,
                 devices: Optional[Sequence] = None,
                 remote_dicts: Optional[Dict[int, List[Optional[Dictionary]]]] = None,
                 pool_key: Optional[str] = None,
                 remote_roots: Optional[Dict[int, PlanNode]] = None):
        session.check_supported()
        self.bucket_filter = bucket_filter
        self.metadata = metadata
        self.session = session
        self.devices = [resolve_device(d) for d in devices] if devices is not None else None
        self.device = self.devices[0] if self.devices else resolve_device(device)
        self.n_workers = n_workers
        self.remote_dicts = remote_dicts or {}
        self.remote_roots = remote_roots or {}
        self.remote_slots: Dict[int, RemoteSourceSlot] = {}
        cap = session.get("page_capacity")
        self.page_capacity = int(cap) if cap else default_page_capacity(self.device)
        self.hash_kernels = str(session.get("hash_kernels"))
        # the scan pipeline's knobs, resolved once per plan; 0/None fall
        # through to ScanPipeline's defaults, and re-batched pages take the
        # page capacity. Every scan of the query shares one pool key (one
        # fairness slot on the shared scan pool).
        threads = session.get("scan_reader_threads")
        rows = session.get("scan_target_page_rows")
        if not bool(session.get("shared_pools")):
            pool_key = None
        elif pool_key is None:
            from .shared_pools import next_query_key

            pool_key = next_query_key()
        self.scan_options = {
            "staged": bool(session.get("scan_pipeline")),
            "reader_threads": int(threads) if threads else None,
            "target_rows": int(rows) if rows else self.page_capacity,
            "prefetch_bytes": int(session.get("scan_prefetch_bytes") or 0) or None,
            "pool_key": pool_key,
        }
        self._ids = itertools.count()
        self.pipelines: List[List[object]] = []

    def attach_memory(self, memory, revoke_check=None) -> None:
        """Wire the query's MemoryTrackingContext, its pressure probe and its
        disk tier (the ``SpillManager`` the runner hung on ``memory.spill``)
        into every factory this planner plans: operators then account their
        bytes into the query's pool and revoke under pressure, down to disk
        when the manager is there."""
        self._memory_ctx = memory
        self._revoke_check = revoke_check

    def plan(self, root: OutputNode, sink_factory=None) -> LocalExecutionPlan:
        """``sink_factory``: a callable (types, dicts) -> OperatorFactory in
        place of the page-buffer sink (a streaming exchange's sink)."""
        chain = self.visit(root.source)
        # final projection into the user's column order
        if [s.name for s in root.symbols] != [s.name for s in chain.symbols]:
            chain = self._append_project(
                chain, [(s, symbol_ref(s.name, s.type)) for s in root.symbols])
        if sink_factory is not None:
            sink = sink_factory([s.type for s in chain.symbols], list(chain.dicts))
        else:
            sink = PageConsumerFactory(next(self._ids), [s.type for s in chain.symbols])
        self._add_pipeline(chain.factories + [sink])
        # fusion first: a fused factory forwards the memory to its terminal
        decisions = self._fuse_pipelines()
        mem = getattr(self, "_memory_ctx", None)
        for pipeline in self.pipelines:
            for fac in pipeline:
                if mem is not None:
                    fac.memory_ctx = mem
                    fac.revoke_check = self._revoke_check
                    fac.spill_manager = getattr(mem, "spill", None)
                fac.devices = self.devices
                if isinstance(fac, TableScanOperatorFactory) and fac.scan_options is None:
                    fac.scan_options = self.scan_options
        return LocalExecutionPlan(self.pipelines, sink, root.column_names,
                                  [s.type for s in chain.symbols], decisions, list(chain.dicts),
                                  self.remote_slots)

    # --------------------------------------------------- driver parallelism

    def driver_count(self) -> int:
        """``driver_parallelism``: AUTO (or None) is ``task_concurrency`` on
        a CUDA device and 1 on the CPU; an integer forces that count."""
        setting = self.session.get("driver_parallelism")
        if setting in (None, "AUTO", "auto"):
            return int(self.session.get("task_concurrency")) \
                if self.device.type == "cuda" else 1
        return int(setting)

    def _add_pipeline(self, factories: List) -> None:
        """Append a pipeline, cutting its stateless scan prefix into N
        producer drivers behind a local exchange where the reference does.

        The rule: the chain starts with a multi-split table scan, the
        prefix of {scan, filter/project, non-FULL join probe} is followed by
        at least one stateful operator, and the driver count allows more
        than one. Producers run the prefix, one split group each; the
        stateful tail runs as ONE consumer driver after the exchange. A
        chain that is all prefix up to a join build runs whole as N build
        drivers instead."""
        from ..ops.local_exchange import (LocalExchangeFactory, LocalExchangeSinkFactory,
                                          LocalExchangeSourceFactory)

        head = factories[0]
        n = min(self.driver_count(), getattr(head, "sources_per_worker", 1))
        if n <= 1 or not isinstance(head, TableScanOperatorFactory):
            self.pipelines.append(factories)
            return

        def prefix_safe(f) -> bool:
            if isinstance(f, FilterProjectOperatorFactory):
                return True
            if isinstance(f, LookupJoinOperatorFactory):
                # FULL joins emit unmatched build rows at probe finish: that
                # pass must run exactly once, so such probes stay single
                return f.join_type != FULL
            return False

        cut = 1
        while cut < len(factories) and prefix_safe(factories[cut]):
            cut += 1
        if cut == len(factories) - 1 and isinstance(factories[-1], JoinBuildOperatorFactory):
            # parallel build: n drivers, each collects its own pages; the
            # last to finish merges them and publishes the lookup source
            head.set_parallelism(n)
            head.parallel_drivers = n
            self.pipelines.append(factories)
            return
        if cut >= len(factories) - 1:
            self.pipelines.append(factories)   # nothing stateful before the sink
            return
        head.set_parallelism(n)
        head.parallel_drivers = n
        # bounded: the drivers run under the task executor, so a full buffer
        # parks the producers instead of piling up device pages
        lx = LocalExchangeFactory(n_producers=n, max_pages=2 * n + 2)
        sink = LocalExchangeSinkFactory(next(self._ids), lx, [])
        source = LocalExchangeSourceFactory(next(self._ids), lx, [])
        self.pipelines.append(factories[:cut] + [sink])
        self.pipelines.append([source] + factories[cut:])

    # ------------------------------------------------------ segment fusion

    def _fuse_pipelines(self) -> List[dict]:
        """Replace each maximal run of fusible page-local factories (filter/
        project and page-local join probes, then optionally a hash
        aggregation or TopN as the terminal) with one
        FusedSegmentOperatorFactory (``ops/fused_segment.py``). A run of one
        operator stays as it is; the source operator never fuses."""
        from ..ops.fused_segment import (FusedSegmentOperatorFactory, mid_stage_fusible,
                                         terminal_stage_fusible)

        decisions: List[dict] = []
        if not self.session.get("segment_fusion"):
            return decisions
        for pi, chain in enumerate(self.pipelines):
            out = [chain[0]]
            i = 1
            while i < len(chain):
                if not (mid_stage_fusible(chain[i]) or terminal_stage_fusible(chain[i])):
                    out.append(chain[i])
                    i += 1
                    continue
                run: List[object] = []
                while i < len(chain) and mid_stage_fusible(chain[i]):
                    run.append(chain[i])
                    i += 1
                terminal = None
                if i < len(chain) and terminal_stage_fusible(chain[i]):
                    terminal = chain[i]
                    i += 1
                members = run + ([terminal] if terminal is not None else [])
                entry = {"pipeline": pi, "operators": [m.name for m in members]}
                if len(members) >= 2:
                    out.append(FusedSegmentOperatorFactory(
                        next(self._ids), run, terminal, self._segment_output_types(members[-1])))
                    entry["fused"] = True
                else:
                    out.extend(members)
                    entry["fused"] = False
                    entry["reason"] = "single-operator run"
                decisions.append(entry)
            self.pipelines[pi] = out
        return decisions

    @staticmethod
    def _segment_output_types(last) -> List[Type]:
        """Output types of a segment: those of its last member (a PARTIAL
        aggregation's are its keys and state columns)."""
        if isinstance(last, HashAggregationOperatorFactory):
            out = list(last.key_types)
            for c in last.calls:
                if last.step == OP_PARTIAL:
                    out.extend(c.function.intermediate_types)
                else:
                    out.append(c.function.output_type)
            return out
        if isinstance(last, TopNOperatorFactory):
            return list(last.types)
        if isinstance(last, FilterProjectOperatorFactory):
            return list(last.processor.output_types)
        return list(last.output_types)

    # ------------------------------------------------------------ dispatch

    def visit(self, node: PlanNode) -> Chain:
        if isinstance(node, (FilterNode, ProjectNode)):
            return self.visit_fused_stage(node)
        m = getattr(self, f"visit_{type(node).__name__}", None)
        if m is None:
            raise NotImplementedError(
                f"{type(node).__name__} is not ported to presto_tpu_torch")
        return m(node)

    # ------------------------------------------------- scan + fused stages

    def visit_fused_stage(self, node: PlanNode) -> Chain:
        """Collapse a Filter/Project chain into one PageProcessor; run it in
        the scan when the chain bottoms out at a TableScanNode."""
        stack: List[PlanNode] = []
        cur = node
        while isinstance(cur, (FilterNode, ProjectNode)):
            stack.append(cur)
            cur = cur.children()[0]
        if isinstance(cur, TableScanNode):
            layout = self._scan_layout(cur)
            mapping = {s.name: input_ref(i, s.type)
                       for i, (s, _) in enumerate(cur.assignments)}
            out_symbols = cur.outputs()
        else:
            base = self.visit(cur)
            layout = base.layout()
            mapping = {s.name: input_ref(i, s.type) for i, s in enumerate(base.symbols)}
            out_symbols = base.symbols
        filter_parts: List[RowExpression] = []
        for n in reversed(stack):
            if isinstance(n, FilterNode):
                filter_parts.append(substitute(n.predicate, mapping))
            else:
                mapping = {s.name: substitute(e, mapping) for s, e in n.assignments}
                out_symbols = [s for s, _ in n.assignments]
        processor = PageProcessor(layout, and_all(filter_parts),
                                  [mapping[s.name] for s in out_symbols])
        if isinstance(cur, TableScanNode):
            sources, per_worker = self._page_sources(cur,
                                                     _extract_constraint(filter_parts, cur))
            fac = TableScanOperatorFactory(next(self._ids), sources, processor.output_types,
                                           processor, self.device,
                                           sources_per_worker=per_worker)
            return Chain([fac], list(out_symbols), processor.output_dicts)
        fac = FilterProjectOperatorFactory(next(self._ids), processor)
        return Chain(base.factories + [fac], list(out_symbols), processor.output_dicts)

    def _scan_layout(self, node: TableScanNode) -> InputLayout:
        meta = self.metadata.get_table_metadata(node.table)
        return InputLayout([s.type for s, _ in node.assignments],
                           [meta.column(col.name).dictionary for _, col in node.assignments])

    def _page_sources(self, node: TableScanNode, constraint: Constraint):
        """-> (callable worker -> [page source], splits per worker): the
        splits dealt round-robin over the fragment's workers, one
        concatenated source (one driver) each. ``constraint`` carries the scan filter's column ranges to the
        split manager and the page sources, which may prune with them (file
        statistics, range pre-filters)."""
        conn = self.metadata.connector(node.table.connector_id)
        splits = conn.split_manager().get_splits(node.table, constraint, 8)
        if self.bucket_filter is not None:
            splits = [s for s in splits if s.bucket == self.bucket_filter]
        cols = [c for _, c in node.assignments]
        provider = conn.page_source_provider()
        count = self.n_workers

        def for_worker(w: int):
            mine = [s for i, s in enumerate(splits) if i % count == w]
            return [ConcatPageSource(provider.create_page_source(s, cols, self.page_capacity,
                                                                 constraint)
                                     for s in mine)]
        return for_worker, -(-len(splits) // max(count, 1))

    def visit_TableScanNode(self, node: TableScanNode) -> Chain:
        processor = PageProcessor(self._scan_layout(node), None,
                                  [input_ref(i, s.type)
                                   for i, (s, _) in enumerate(node.assignments)])
        sources, per_worker = self._page_sources(node, Constraint.all())
        fac = TableScanOperatorFactory(next(self._ids), sources, processor.output_types,
                                       processor, self.device, sources_per_worker=per_worker)
        return Chain([fac], [s for s, _ in node.assignments], processor.output_dicts)

    def visit_RemoteSourceNode(self, node) -> Chain:
        """A producer fragment's routed pages on each worker: the endpoint of
        the exchange the runner runs between fragments."""
        slot = self.remote_slots.get(node.fragment_id)
        if slot is None:
            slot = self.remote_slots[node.fragment_id] = RemoteSourceSlot(node.fragment_id)
        fac = RemoteSourceOperatorFactory(next(self._ids), slot,
                                          [s.type for s in node.symbols], self.device)
        dicts = self.remote_dicts.get(node.fragment_id, [None] * len(node.symbols))
        out = Chain([fac], list(node.symbols), list(dicts))
        if node.fragment_id not in self.remote_dicts:
            # the producer's dictionaries are unknown here: a None entry
            # may hide live codes (read by the UNION's unification)
            out.unreliable_dicts = True
        return out

    def visit_ValuesNode(self, node: ValuesNode) -> Chain:
        """One literal host page of the rows; the scan uploads it once."""
        cap = max(len(node.rows), 1)
        blocks = []
        dicts: List[Optional[Dictionary]] = []
        for i, sym in enumerate(node.symbols):
            vals = [r[i] for r in node.rows]
            if is_string(sym.type):
                b = block_from_strings(vals, sym.type)
            else:
                arr = np.zeros(cap, dtype=sym.type.np_dtype)
                nulls = np.zeros(cap, dtype=np.bool_)
                for j, v in enumerate(vals):
                    if v is None:
                        nulls[j] = True
                    else:
                        arr[j] = v
                b = Block(sym.type, torch.from_numpy(arr),
                          torch.from_numpy(nulls) if nulls.any() else None, None)
            blocks.append(b)
            dicts.append(b.dictionary)
        page = Page(tuple(blocks), torch.arange(cap) < len(node.rows))
        # the rows exist once: only worker 0 emits them (a multi-worker
        # fragment would otherwise repeat them once per worker)
        fac = TableScanOperatorFactory(
            next(self._ids), lambda w: [FixedPageSource([page] if w == 0 else [])],
            [s.type for s in node.symbols], None, self.device)
        return Chain([fac], list(node.symbols), dicts)

    # ------------------------------------------------------------- joins

    def _maybe_coalesce(self, chain: Chain) -> Chain:
        """With ``coalesce_pages``, end a chain whose last factory is a
        filtered scan in a CoalesceOperator, so the join after it works on
        the filter's survivors. The operator passes pages through when the
        first page shows an unselective filter (``ops/coalesce.py``)."""
        last = chain.factories[-1]
        if not (self.session.get("coalesce_pages")
                and isinstance(last, TableScanOperatorFactory) and last.has_filter):
            return chain
        from ..ops.coalesce import CoalesceOperatorFactory

        fac = CoalesceOperatorFactory(next(self._ids), [s.type for s in chain.symbols])
        return Chain(chain.factories + [fac], chain.symbols, chain.dicts)

    def visit_JoinNode(self, node: JoinNode) -> Chain:
        jt = self._join_type(node)
        if not node.criteria:
            return self._plan_cross_join(node, jt)
        if node.residual is not None:
            raise NotImplementedError("join filters are not ported to presto_tpu_torch")
        probe_chain = self._maybe_coalesce(self.visit(node.left))
        build_chain = self._maybe_coalesce(self.visit(node.right))
        right_keys = [r for _, r in node.criteria]
        build_key_ch = [build_chain.channel(r.name) for r in right_keys]
        probe_key_ch = [probe_chain.channel(l.name) for l, _ in node.criteria]

        out_syms = node.outputs()
        probe_names = {s.name for s in probe_chain.symbols}
        probe_out = [s for s in out_syms if s.name in probe_names]
        build_out = [s for s in out_syms if s.name not in probe_names]
        payload_names = [s.name for s in build_out]
        payload_ch = [build_chain.channel(n) for n in payload_names]
        payload_meta = build_chain.meta(payload_names)

        unique = self._keys_unique(node.right, right_keys)
        build_fac = JoinBuildOperatorFactory(
            next(self._ids), build_key_ch, payload_ch, payload_meta,
            strategy=self._join_strategy(jt, build_key_ch, unique), unique=unique,
            device=self.device, track_unmatched=node.type == "full")
        self._add_pipeline(build_chain.factories + [build_fac])

        probe_out_ch = [probe_chain.channel(s.name) for s in probe_out]
        probe_meta = probe_chain.meta([s.name for s in probe_out])
        probe_fac = LookupJoinOperatorFactory(
            next(self._ids), build_fac.lookup_factory, probe_key_ch, probe_out_ch,
            probe_meta, list(range(len(payload_ch))), payload_meta, jt, unique_build=unique)
        out_dicts = [probe_chain.dicts[c] for c in probe_out_ch] + [d for _, d in payload_meta]
        return Chain(probe_chain.factories + [probe_fac], probe_out + build_out, out_dicts)

    def _plan_cross_join(self, node: JoinNode, jt: str) -> Chain:
        """A join with no criteria (scalar subqueries): both sides project a
        constant BIGINT 0 key and join on it; the build is expected tiny."""
        zero = Constant(BIGINT, 0)
        left = self.visit(node.left)
        right = self.visit(node.right)
        ck_l = Symbol("$xkey_probe", BIGINT)
        ck_r = Symbol("$xkey_build", BIGINT)
        left = self._append_project(
            left, [(s, symbol_ref(s.name, s.type)) for s in left.symbols] + [(ck_l, zero)])
        right = self._append_project(
            right, [(s, symbol_ref(s.name, s.type)) for s in right.symbols] + [(ck_r, zero)])
        out_syms = node.outputs()
        right_names = {s.name for s in node.right.outputs()}
        probe_out = [s for s in out_syms if s.name not in right_names]
        build_out = [s for s in out_syms if s.name in right_names]
        payload_ch = [right.channel(s.name) for s in build_out]
        payload_meta = right.meta([s.name for s in build_out])
        build_fac = JoinBuildOperatorFactory(
            next(self._ids), [right.channel(ck_r.name)], payload_ch, payload_meta,
            strategy="sorted", unique=isinstance(node.right, EnforceSingleRowNode),
            device=self.device)
        self._add_pipeline(right.factories + [build_fac])
        probe_out_ch = [left.channel(s.name) for s in probe_out]
        probe_fac = LookupJoinOperatorFactory(
            next(self._ids), build_fac.lookup_factory, [left.channel(ck_l.name)],
            probe_out_ch, left.meta([s.name for s in probe_out]),
            list(range(len(payload_ch))), payload_meta, jt, unique_build=build_fac.unique)
        out_dicts = [left.dicts[c] for c in probe_out_ch] + [d for _, d in payload_meta]
        return Chain(left.factories + [probe_fac], probe_out + build_out, out_dicts)

    def visit_SemiJoinNode(self, node: SemiJoinNode) -> Chain:
        """IN / EXISTS: the filtering side builds sorted (its keys are not
        proven unique) and the source probes SEMI, or ANTI when negated. A
        residual filter is compiled over [probe columns..., build columns...]
        (each side's symbols in name order) and checked per candidate pair;
        the build carries its filter columns as payload."""
        if node.mark is not None:
            raise NotImplementedError("mark semi joins are not ported to presto_tpu_torch")
        src = self.visit(node.source)
        filt = self.visit(node.filtering_source)
        filter_fn = None
        filter_probe_ch: List[int] = []
        filter_build_ch: List[int] = []
        payload_ch: List[int] = []
        payload_meta: List[Tuple[Type, Optional[Dictionary]]] = []
        if node.residual is not None:
            rsyms = symbols_in(node.residual)
            src_names = {s.name for s in src.symbols}
            probe_list = sorted(n for n in rsyms if n in src_names)
            build_list = sorted(n for n in rsyms if n not in src_names)
            filter_probe_ch = [src.channel(n) for n in probe_list]
            payload_ch = [filt.channel(n) for n in build_list]
            payload_meta = filt.meta(build_list)
            filter_build_ch = list(range(len(build_list)))
            mapping = {n: i for i, n in enumerate(probe_list + build_list)}
            layout = InputLayout(
                [src.symbols[c].type for c in filter_probe_ch] + [t for t, _ in payload_meta],
                [src.dicts[c] for c in filter_probe_ch] + [d for _, d in payload_meta])
            filter_fn = ExpressionCompiler(layout).compile(
                resolve_symbols(node.residual, mapping))
        build_fac = JoinBuildOperatorFactory(
            next(self._ids), [filt.channel(node.filtering_key.name)], payload_ch,
            payload_meta, strategy="sorted", unique=False, device=self.device)
        self._add_pipeline(filt.factories + [build_fac])
        fac = LookupJoinOperatorFactory(
            next(self._ids), build_fac.lookup_factory, [src.channel(node.source_key.name)],
            list(range(len(src.symbols))), src.meta([s.name for s in src.symbols]), [], [],
            ANTI if node.negated else SEMI, filter_fn=filter_fn,
            filter_probe_channels=filter_probe_ch, filter_build_channels=filter_build_ch,
            null_aware=node.null_aware)
        return Chain(src.factories + [fac], list(src.symbols), list(src.dicts))

    def _join_strategy(self, join_type: str, build_key_ch, unique: bool) -> str:
        """``hash_kernels`` -> the build strategy; ``auto`` means pallas
        exactly when the device is CUDA. Ineligible builds keep sorted."""
        return join_strategy(self.hash_kernels, self.device, join_type, build_key_ch, unique)

    @staticmethod
    def _join_type(node: JoinNode) -> str:
        if node.type == "inner":
            return INNER
        if node.type == "left":  # RIGHT was flipped to LEFT by the planner
            return LEFT
        if node.type == "full":
            return FULL
        raise NotImplementedError(f"{node.type.upper()} joins are not ported to presto_tpu_torch")

    def _keys_unique(self, node: PlanNode, keys: List[Symbol]) -> bool:
        """Conservative uniqueness proof for the build keys, from the
        connector's unique column sets. An exchange moves each row to one
        worker, or every row to each worker, so a remote source is unique
        where its producer fragment is; a PARTIAL aggregation's groups are
        not (each worker emits its own)."""
        if isinstance(node, RemoteSourceNode):
            root = self.remote_roots.get(node.fragment_id)
            return root is not None and self._keys_unique(root, keys)
        names = {k.name for k in keys}
        if isinstance(node, TableScanNode):
            by_symbol = {s.name: c.name for s, c in node.assignments}
            cols = {by_symbol[n] for n in names if n in by_symbol}
            if len(cols) != len(names):
                return False
            conn_meta = self.metadata.connector(node.table.connector_id).metadata()
            return any(set(uset) <= cols
                       for uset in conn_meta.get_unique_column_sets(node.table))
        if isinstance(node, FilterNode):
            return self._keys_unique(node.source, keys)
        if isinstance(node, ProjectNode):
            inner = []
            for k in keys:
                e = dict((s.name, x) for s, x in node.assignments).get(k.name)
                if not isinstance(e, SymbolRef):
                    return False
                inner.append(Symbol(e.name, e.type))
            return self._keys_unique(node.source, inner)
        if isinstance(node, SemiJoinNode):
            return self._keys_unique(node.source, keys)
        if isinstance(node, AggregationNode):
            return node.step != P_PARTIAL and {k.name for k in node.keys} <= names
        if isinstance(node, EnforceSingleRowNode):
            return True
        return False

    # ------------------------------------------------------- aggregation

    def visit_AggregationNode(self, node: AggregationNode) -> Chain:
        """SINGLE, PARTIAL or FINAL. A FINAL call reads the state columns
        the exchange planner named (``intermediate_symbols``); a PARTIAL one
        emits them, and a min/max state over a dictionary column keeps the
        dictionary on its first state column for the FINAL step."""
        src = self.visit(node.source)
        step = node.step
        key_ch = [src.channel(k.name) for k in node.keys]
        key_types = [k.type for k in node.keys]
        key_dicts = [src.dicts[c] for c in key_ch]
        domains = []
        for tt, d in zip(key_types, key_dicts):
            if d is not None and type(d).__name__ == "Dictionary":
                domains.append(len(d))
            elif tt is BOOLEAN:
                domains.append(2)
            else:
                domains.append(None)
        key_domains = domains if domains and all(x is not None for x in domains) else None
        calls = []
        out_dicts = list(key_dicts)
        out_syms = list(node.keys)
        for i, (sym, ac) in enumerate(node.aggregations):
            fn = resolve_aggregate(ac.name, [a.type for a in ac.args], ac.distinct,
                                   getattr(ac, "params", ()))
            if step == P_FINAL:
                inter_ch = [src.channel(s.name) for s in node.intermediate_symbols[i]]
                out_dict = src.dicts[inter_ch[0]] \
                    if ac.name in ("min", "max", "arbitrary", "any_value") and inter_ch \
                    and src.dicts[inter_ch[0]] is not None else None
                if fn.output_dict is not None:
                    out_dict = fn.output_dict
                calls.append(AggregateCall(fn, [], None, intermediate_channels=inter_ch,
                                           output_dictionary=out_dict))
                out_syms.append(sym)
                out_dicts.append(out_dict)
                continue
            arg_ch = [src.channel(a.name) for a in ac.args]
            mask_ch = src.channel(ac.filter.name) if ac.filter is not None else None
            # min/max/arbitrary and min_by/max_by over a dictionary column
            # pass its codes through
            out_dict = None
            if ac.name in ("min", "max", "arbitrary", "any_value", "min_by", "max_by") \
                    and arg_ch and src.dicts[arg_ch[0]] is not None:
                out_dict = src.dicts[arg_ch[0]]
            if fn.output_dict is not None:
                out_dict = fn.output_dict
            calls.append(AggregateCall(fn, arg_ch, mask_ch, output_dictionary=out_dict))
            if step == P_PARTIAL:
                isyms = node.intermediate_symbols[i]
                out_syms.extend(isyms)
                out_dicts.extend(out_dict if j == 0 else None for j in range(len(isyms)))
            else:
                out_syms.append(sym)
                out_dicts.append(out_dict)
        # hash_kernels -> the grouping builder's insert-or-accumulate mode
        hash_grouping = {"pallas": "force", "auto": "auto"}.get(self.hash_kernels, "off")
        op_step = {P_PARTIAL: OP_PARTIAL, P_FINAL: OP_FINAL}.get(step, SINGLE)
        fac = HashAggregationOperatorFactory(
            next(self._ids), key_ch, key_types, key_dicts, calls, op_step,
            self.page_capacity, max_groups=int(self.session.get("max_groups")),
            device=self.device, key_domains=key_domains, hash_grouping=hash_grouping)
        return Chain(src.factories + [fac], out_syms, out_dicts)

    # ------------------------------------------------------------ window

    def visit_WindowNode(self, node) -> Chain:
        """One WindowOperator after the source: a stateful operator, so a
        cut pipeline's producers end before it. ``avg`` over DECIMAL carries
        its scale divisor; min/max and the positional functions over a
        dictionary column carry its dictionary to the output."""
        from ..ops.window import WindowOperatorFactory
        from ..types import DecimalType

        src = self.visit(node.source)
        part_ch = [src.channel(k.name) for k in node.partition_keys]
        call_channels, call_meta = [], []
        for sym, call in node.calls:
            arg_chs = [src.channel(a.name) for a in call.args]
            scale_div = 1
            if call.name == "avg" and arg_chs:
                at = src.symbols[arg_chs[0]].type
                if isinstance(at, DecimalType):
                    scale_div = 10 ** at.scale
            out_dict = None
            if call.name in ("min", "max", "lag", "lead", "first_value", "last_value",
                             "nth_value") and arg_chs and src.dicts[arg_chs[0]] is not None:
                out_dict = src.dicts[arg_chs[0]]
            call_channels.append((call.name, arg_chs, call.frame_mode, scale_div, call.offset))
            call_meta.append((sym.type, out_dict))
        fac = WindowOperatorFactory(next(self._ids), part_ch, self._orders(src, node.orderings),
                                    call_channels, call_meta, [s.type for s in src.symbols])
        return Chain(src.factories + [fac], src.symbols + [s for s, _ in node.calls],
                     list(src.dicts) + [d for _, d in call_meta])

    # ------------------------------------------------- sort / limit

    def _orders(self, chain: Chain, orderings) -> List[SortOrder]:
        return [SortOrder(chain.channel(o.symbol.name), o.descending, o.nulls_first)
                for o in orderings]

    def visit_TopNNode(self, node: TopNNode) -> Chain:
        src = self.visit(node.source)
        fac = TopNOperatorFactory(next(self._ids), node.count,
                                  self._orders(src, node.orderings),
                                  [s.type for s in src.symbols])
        return Chain(src.factories + [fac], list(src.symbols), list(src.dicts))

    def visit_SortNode(self, node: SortNode) -> Chain:
        src = self.visit(node.source)
        fac = OrderByOperatorFactory(next(self._ids), self._orders(src, node.orderings),
                                     [s.type for s in src.symbols])
        return Chain(src.factories + [fac], list(src.symbols), list(src.dicts))

    def visit_LimitNode(self, node: LimitNode) -> Chain:
        src = self.visit(node.source)
        fac = LimitOperatorFactory(next(self._ids), node.count, [s.type for s in src.symbols])
        return Chain(src.factories + [fac], list(src.symbols), list(src.dicts))

    def visit_EnforceSingleRowNode(self, node: EnforceSingleRowNode) -> Chain:
        src = self.visit(node.source)
        fac = EnforceSingleRowOperatorFactory(next(self._ids), [s.type for s in src.symbols],
                                              list(src.dicts), self.device)
        return Chain(src.factories + [fac], list(src.symbols), list(src.dicts))

    # ---------------------------------------------------------------- union

    def visit_UnionNode(self, node: UnionNode) -> Chain:
        """Materialized concatenation: each branch drains into a page buffer
        in one driver; a replay scan reads the buffers once every branch
        has finished (the reference's ``visit_UnionNode``)."""
        chains: List[Chain] = []
        for child, mapping in zip(node.sources, node.symbol_mappings):
            chain = self.visit(child)
            if [s.name for s in chain.symbols] != [m.name for m in mapping]:
                chain = self._append_project(
                    chain, [(m, symbol_ref(m.name, m.type)) for m in mapping])
            chains.append(chain)
        dicts, remaps = self._unify_dictionaries(chains, len(node.symbol_mappings[0]))
        buffers: List[PageConsumerFactory] = []
        for bi, (chain, mapping) in enumerate(zip(chains, node.symbol_mappings)):
            facs = list(chain.factories)
            types = [m.type for m in mapping]
            needs_rebind = any(d is not None and chain.dicts[c] is not d
                               for c, d in enumerate(dicts))
            if needs_rebind or any(r is not None for r in remaps[bi]):
                from ..ops.coalesce import DictionaryRemapOperatorFactory

                facs.append(DictionaryRemapOperatorFactory(
                    next(self._ids), types, remaps[bi], target_dicts=dicts,
                    device=self.device))
            buf = PageConsumerFactory(next(self._ids), types)
            # one driver, not _add_pipeline: the replay keeps branch order
            self.pipelines.append(facs + [buf])
            buffers.append(buf)

        def ready(w: int):
            def all_branches_done() -> bool:
                return all(b.consumers_by_worker.get(w)
                           and all(c.is_finished() for c in b.consumers_by_worker[w])
                           for b in buffers)
            return all_branches_done

        fac = TableScanOperatorFactory(next(self._ids), lambda w: [_ReplaySource(buffers, w)],
                                       [s.type for s in node.symbols], None, self.device,
                                       ready=ready)
        return Chain([fac], list(node.symbols), dicts)

    @staticmethod
    def _unify_dictionaries(chains: List[Chain], ncols: int):
        """Per column, the union's dictionary, and per branch the remap
        tables (old code -> union code, None = none needed):

        - a branch with no dictionary (a grouping set's NULL constants)
          adopts its siblings': its codes are dead under the NULL mask;
        - two real dictionaries merge, in branch order, and a branch whose
          values are not the union's prefix remaps its codes;
        - distinct virtual (formatted) dictionaries cannot merge."""
        # adopting a sibling's dictionary is safe only for provably dead
        # codes (a grouping set's NULL constants); a remote source with
        # unknown producer dictionaries may carry live ones
        for ch in chains:
            if getattr(ch, "unreliable_dicts", False) and any(
                    ch.dicts[c] is None and any(o.dicts[c] is not None for o in chains)
                    for c in range(ncols)):
                raise NotImplementedError(
                    "UNION dictionary unification over a remote source "
                    "with unknown dictionaries")
        dicts: List[Optional[Dictionary]] = []
        remaps: List[List[Optional[np.ndarray]]] = [[None] * ncols for _ in chains]
        for c in range(ncols):
            branch_dicts = [ch.dicts[c] for ch in chains]
            real = [d for d in branch_dicts if d is not None]
            if not real:
                dicts.append(None)
                continue
            if all(d is real[0] for d in real):
                dicts.append(real[0])
                continue
            if any(not hasattr(d, "values") for d in real):
                raise NotImplementedError(
                    "UNION across distinct VIRTUAL dictionaries has no "
                    "re-encode (formatted columns must share one source)")
            seen: Dict[str, int] = {}
            values: List[str] = []
            for d in real:
                for v in d.values:
                    if v not in seen:
                        seen[v] = len(values)
                        values.append(v)
            for bi, d in enumerate(branch_dicts):
                if d is not None and list(d.values) != values:
                    remap = np.asarray([seen[v] for v in d.values], dtype=np.int32)
                    # a prefix of the union needs only the rebind, no gather
                    if not np.array_equal(remap, np.arange(len(remap), dtype=np.int32)):
                        remaps[bi][c] = remap
            dicts.append(_intern_union_dict(values))
        return dicts, remaps

    # ---------------------------------------------------------- helpers

    def _append_project(self, chain: Chain,
                        assignments: List[Tuple[Symbol, RowExpression]]) -> Chain:
        channels = chain.channel_map()
        processor = PageProcessor(chain.layout(), None,
                                  [resolve_symbols(e, channels) for _, e in assignments])
        fac = FilterProjectOperatorFactory(next(self._ids), processor)
        return Chain(chain.factories + [fac], [s for s, _ in assignments],
                     processor.output_dicts)
