"""Local execution planner of the PyTorch port: logical plan -> driver pipelines.

Counterpart of ``presto_tpu/exec/local_planner.py`` for the plan shapes of
TPC-H Q1, Q3 and Q6, on an explicit ``device``:

- Filter/Project chains collapse into one PageProcessor, which runs inside
  the scan when the chain sits on a TableScanNode (``visit_fused_stage``).
- A join's build side becomes its own pipeline ending in a
  JoinBuildOperatorFactory, whose strategy ``hash_kernels`` picks
  (``_join_strategy``); the probe pipeline blocks on its lookup source.
- Symbols resolve to channels here (SymbolRef -> InputRef).

Each pipeline is one driver, and nothing is fused across operators: the
port runs the reference's unfused, uncoalesced pipeline, which the reference
holds as the differential oracle of its default one. A plan node, a join
shape or a session property the port does not run raises
``NotImplementedError`` naming itself.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

from .. import resolve_device
from ..block import Dictionary
from ..metadata import MetadataManager, Session, default_page_capacity
from ..ops.aggregates import AggregateCall, resolve_aggregate
from ..ops.expressions import (InputLayout, RowExpression, SymbolRef, input_ref,
                               resolve_symbols, symbol_ref)
from ..ops.filter_project import FilterProjectOperatorFactory, PageProcessor
from ..ops.hash_agg import SINGLE, HashAggregationOperatorFactory
from ..ops.hash_join import (INNER, LEFT, JoinBuildOperatorFactory,
                             LookupJoinOperatorFactory, join_strategy)
from ..ops.scan import TableScanOperatorFactory
from ..ops.topn import (LimitOperatorFactory, OrderByOperatorFactory, SortOrder,
                        TopNOperatorFactory)
from ..spi.connector import ConcatPageSource, Constraint
from ..sql.planner.optimizer import and_all, substitute
from ..sql.planner.plan import (AggregationNode, FilterNode, JoinNode, LimitNode,
                                OutputNode, PlanNode, ProjectNode, SortNode, Symbol,
                                TableScanNode, TopNNode)
from ..sql.planner.plan import SINGLE as P_SINGLE
from ..types import BOOLEAN, Type
from ..utils.testing import PageConsumerFactory
from .driver import Driver


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


@dataclasses.dataclass
class LocalExecutionPlan:
    pipelines: List[List[object]]   # factory chains, dependency order
    sink: PageConsumerFactory
    output_names: List[str]
    output_types: List[Type] = dataclasses.field(default_factory=list)

    def create_drivers(self) -> List[Driver]:
        """One driver per pipeline, in dependency order."""
        return [Driver([f.create_operator() for f in chain]) for chain in self.pipelines]


class LocalExecutionPlanner:
    """Plans one query on ``device`` (default ``"cuda"``; raises without CUDA)."""

    def __init__(self, metadata: MetadataManager, session: Session, device="cuda"):
        session.check_supported()
        self.metadata = metadata
        self.session = session
        self.device = resolve_device(device)
        cap = session.get("page_capacity")
        self.page_capacity = int(cap) if cap else default_page_capacity(self.device)
        self.hash_kernels = str(session.get("hash_kernels"))
        self._ids = itertools.count()
        self.pipelines: List[List[object]] = []

    def plan(self, root: OutputNode) -> LocalExecutionPlan:
        chain = self.visit(root.source)
        # final projection into the user's column order
        if [s.name for s in root.symbols] != [s.name for s in chain.symbols]:
            chain = self._append_project(
                chain, [(s, symbol_ref(s.name, s.type)) for s in root.symbols])
        sink = PageConsumerFactory(next(self._ids), [s.type for s in chain.symbols])
        self.pipelines.append(chain.factories + [sink])
        return LocalExecutionPlan(self.pipelines, sink, root.column_names,
                                  [s.type for s in chain.symbols])

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
            fac = TableScanOperatorFactory(next(self._ids), self._page_sources(cur),
                                           processor.output_types, processor, self.device)
            return Chain([fac], list(out_symbols), processor.output_dicts)
        fac = FilterProjectOperatorFactory(next(self._ids), processor)
        return Chain(base.factories + [fac], list(out_symbols), processor.output_dicts)

    def _scan_layout(self, node: TableScanNode) -> InputLayout:
        meta = self.metadata.get_table_metadata(node.table)
        return InputLayout([s.type for s, _ in node.assignments],
                           [meta.column(col.name).dictionary for _, col in node.assignments])

    def _page_sources(self, node: TableScanNode):
        """One source over every split of the table (one scan driver)."""
        conn = self.metadata.connector(node.table.connector_id)
        constraint = Constraint.all()
        splits = conn.split_manager().get_splits(node.table, constraint, 8)
        cols = [c for _, c in node.assignments]
        provider = conn.page_source_provider()
        return [ConcatPageSource(provider.create_page_source(s, cols, self.page_capacity,
                                                             constraint)
                                 for s in splits)]

    def visit_TableScanNode(self, node: TableScanNode) -> Chain:
        processor = PageProcessor(self._scan_layout(node), None,
                                  [input_ref(i, s.type)
                                   for i, (s, _) in enumerate(node.assignments)])
        fac = TableScanOperatorFactory(next(self._ids), self._page_sources(node),
                                       processor.output_types, processor, self.device)
        return Chain([fac], [s for s, _ in node.assignments], processor.output_dicts)

    # ------------------------------------------------------------- joins

    def visit_JoinNode(self, node: JoinNode) -> Chain:
        jt = self._join_type(node)
        if len(node.criteria) != 1:
            raise NotImplementedError(
                f"{len(node.criteria)}-key joins are not ported to presto_tpu_torch "
                "(single-key INNER and LEFT joins are)")
        if node.residual is not None:
            raise NotImplementedError("join filters are not ported to presto_tpu_torch")
        probe_chain = self.visit(node.left)
        build_chain = self.visit(node.right)
        (left_key, right_key), = node.criteria
        build_key_ch = [build_chain.channel(right_key.name)]
        probe_key_ch = [probe_chain.channel(left_key.name)]

        out_syms = node.outputs()
        probe_names = {s.name for s in probe_chain.symbols}
        probe_out = [s for s in out_syms if s.name in probe_names]
        build_out = [s for s in out_syms if s.name not in probe_names]
        payload_names = [s.name for s in build_out]
        payload_ch = [build_chain.channel(n) for n in payload_names]
        payload_meta = build_chain.meta(payload_names)

        unique = self._keys_unique(node.right, [right_key])
        if not unique:
            raise NotImplementedError(
                "joins whose build keys are not provably unique are not ported to "
                "presto_tpu_torch")
        build_fac = JoinBuildOperatorFactory(
            next(self._ids), build_key_ch, payload_ch, payload_meta,
            strategy=self._join_strategy(jt, build_key_ch, unique), unique=unique,
            device=self.device)
        self.pipelines.append(build_chain.factories + [build_fac])

        probe_out_ch = [probe_chain.channel(s.name) for s in probe_out]
        probe_meta = probe_chain.meta([s.name for s in probe_out])
        probe_fac = LookupJoinOperatorFactory(
            next(self._ids), build_fac.lookup_factory, probe_key_ch, probe_out_ch,
            probe_meta, list(range(len(payload_ch))), payload_meta, jt)
        out_dicts = [probe_chain.dicts[c] for c in probe_out_ch] + [d for _, d in payload_meta]
        return Chain(probe_chain.factories + [probe_fac], probe_out + build_out, out_dicts)

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
        raise NotImplementedError(f"{node.type.upper()} joins are not ported to presto_tpu_torch")

    def _keys_unique(self, node: PlanNode, keys: List[Symbol]) -> bool:
        """Conservative uniqueness proof for the build keys, from the
        connector's unique column sets."""
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
        if isinstance(node, AggregationNode):
            return {k.name for k in node.keys} <= names
        return False

    # ------------------------------------------------------- aggregation

    def visit_AggregationNode(self, node: AggregationNode) -> Chain:
        if node.step != P_SINGLE:
            raise NotImplementedError(
                f"{node.step} aggregation steps are not ported to presto_tpu_torch")
        src = self.visit(node.source)
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
        for sym, ac in node.aggregations:
            fn = resolve_aggregate(ac.name, [a.type for a in ac.args], ac.distinct,
                                   getattr(ac, "params", ()))
            arg_ch = [src.channel(a.name) for a in ac.args]
            mask_ch = src.channel(ac.filter.name) if ac.filter is not None else None
            calls.append(AggregateCall(fn, arg_ch, mask_ch, output_dictionary=fn.output_dict))
            out_syms.append(sym)
            out_dicts.append(fn.output_dict)
        # hash_kernels -> the grouping builder's insert-or-accumulate mode
        hash_grouping = {"pallas": "force", "auto": "auto"}.get(self.hash_kernels, "off")
        fac = HashAggregationOperatorFactory(
            next(self._ids), key_ch, key_types, key_dicts, calls, SINGLE,
            self.page_capacity, max_groups=int(self.session.get("max_groups")),
            device=self.device, key_domains=key_domains, hash_grouping=hash_grouping)
        return Chain(src.factories + [fac], out_syms, out_dicts)

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

    # ---------------------------------------------------------- helpers

    def _append_project(self, chain: Chain,
                        assignments: List[Tuple[Symbol, RowExpression]]) -> Chain:
        channels = chain.channel_map()
        processor = PageProcessor(chain.layout(), None,
                                  [resolve_symbols(e, channels) for _, e in assignments])
        fac = FilterProjectOperatorFactory(next(self._ids), processor)
        return Chain(chain.factories + [fac], [s for s, _ in assignments],
                     processor.output_dicts)
