"""Logical plan nodes.

The PyTorch port's copy of ``presto_tpu/sql/planner/plan.py`` (plain Python, no torch): the
port keeps its own front end so that it imports nothing of ``presto_tpu``.

Analogue of presto-main sql/planner/plan/ (47 node classes) narrowed to the
relational core the executor implements. Nodes reference columns via `Symbol`s
(sql/planner/Symbol.java); expressions inside nodes are RowExpressions over
SymbolRef (sql/relational/RowExpression after SqlToRowExpressionTranslator) —
the local execution planner rewrites them to channel InputRefs.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

from ...ops.expressions import RowExpression
from ...spi.connector import ColumnHandle, TableHandle
from ...types import Type

_next_plan_id = itertools.count()


@dataclasses.dataclass(frozen=True)
class Symbol:
    name: str
    type: Type

    def __str__(self):
        return self.name


class SymbolAllocator:
    """sql/planner/SymbolAllocator — unique symbol names per plan."""

    def __init__(self):
        self._counts: Dict[str, int] = {}

    def new_symbol(self, hint: str, type_: Type) -> Symbol:
        base = "".join(c if (c.isalnum() or c == "_") else "_" for c in hint.lower()) or "expr"
        n = self._counts.get(base, 0)
        self._counts[base] = n + 1
        return Symbol(base if n == 0 else f"{base}_{n}", type_)


class PlanNode:
    """Base plan node; subclasses are dataclasses with a `source`/`sources`."""

    id: int

    def outputs(self) -> List[Symbol]:
        raise NotImplementedError

    def children(self) -> List["PlanNode"]:
        raise NotImplementedError

    def with_children(self, children: List["PlanNode"]) -> "PlanNode":
        raise NotImplementedError


def _node(cls):
    cls = dataclasses.dataclass(cls)
    return cls


@_node
class TableScanNode(PlanNode):
    """plan/TableScanNode — assignments map output symbols to connector columns."""
    table: TableHandle
    assignments: List[Tuple[Symbol, ColumnHandle]]

    def outputs(self):
        return [s for s, _ in self.assignments]

    def children(self):
        return []

    def with_children(self, children):
        return self


@_node
class FilterNode(PlanNode):
    source: PlanNode
    predicate: RowExpression

    def outputs(self):
        return self.source.outputs()

    def children(self):
        return [self.source]

    def with_children(self, children):
        return FilterNode(children[0], self.predicate)


@_node
class ProjectNode(PlanNode):
    source: PlanNode
    assignments: List[Tuple[Symbol, RowExpression]]

    def outputs(self):
        return [s for s, _ in self.assignments]

    def children(self):
        return [self.source]

    def with_children(self, children):
        return ProjectNode(children[0], self.assignments)

    def is_identity(self) -> bool:
        from ...ops.expressions import SymbolRef
        src = self.source.outputs()
        return len(self.assignments) == len(src) and all(
            isinstance(e, SymbolRef) and e.name == s.name and s == src[i]
            for i, (s, e) in enumerate(self.assignments))


@dataclasses.dataclass(frozen=True)
class AggregationCall:
    """One aggregate: resolved later against ops/aggregates.resolve_aggregate."""
    name: str                     # sum | avg | count | min | max | ...
    args: Tuple[Symbol, ...]      # pre-projected inputs ((), for count(*))
    distinct: bool = False
    filter: Optional[Symbol] = None  # boolean mask symbol (FILTER / mark-distinct)
    # literal (non-column) parameters, e.g. approx_percentile's fraction
    params: Tuple[object, ...] = ()


PARTIAL, FINAL, SINGLE = "partial", "final", "single"


@_node
class AggregationNode(PlanNode):
    """plan/AggregationNode: group keys + aggregate assignments.

    `intermediate_symbols` (set by the exchange planner for PARTIAL/FINAL pairs)
    names each call's state columns: a PARTIAL node OUTPUTS them, the matching
    FINAL node READS them from its child (the reference threads the same
    information through InternalAggregationFunction's intermediate type)."""
    source: PlanNode
    keys: List[Symbol]
    aggregations: List[Tuple[Symbol, AggregationCall]]
    step: str = SINGLE
    intermediate_symbols: Optional[List[List[Symbol]]] = None

    def outputs(self):
        if self.step == PARTIAL:
            flat = [s for group in (self.intermediate_symbols or [])
                    for s in group]
            return list(self.keys) + flat
        return list(self.keys) + [s for s, _ in self.aggregations]

    def children(self):
        return [self.source]

    def with_children(self, children):
        return AggregationNode(children[0], self.keys, self.aggregations,
                               self.step, self.intermediate_symbols)


INNER, LEFT, RIGHT, FULL = "inner", "left", "right", "full"


@_node
class JoinNode(PlanNode):
    """plan/JoinNode: left = probe, right = build (the reference's convention)."""
    type: str
    left: PlanNode
    right: PlanNode
    criteria: List[Tuple[Symbol, Symbol]]     # (left symbol, right symbol) equi pairs
    residual: Optional[RowExpression] = None  # non-equi filter over both sides
    output_symbols: Optional[List[Symbol]] = None  # pruned outputs; None = all

    def outputs(self):
        if self.output_symbols is not None:
            return list(self.output_symbols)
        return self.left.outputs() + self.right.outputs()

    def children(self):
        return [self.left, self.right]

    def with_children(self, children):
        return JoinNode(self.type, children[0], children[1], self.criteria,
                        self.residual, self.output_symbols)


@_node
class SemiJoinNode(PlanNode):
    """plan/SemiJoinNode: membership of source_key in filtering_source keys,
    optionally under a join `residual` filter evaluated per (source,filtering)
    candidate pair (decorrelated EXISTS with non-equi conjuncts, e.g. TPC-H Q21).
    Output = source outputs + mark symbol (when mark is not None); when mark is
    None the node *filters* (negated=False keeps members, True keeps
    non-members)."""
    source: PlanNode
    filtering_source: PlanNode
    source_key: Symbol
    filtering_key: Symbol
    mark: Optional[Symbol] = None
    negated: bool = False
    null_aware: bool = True  # IN/NOT IN three-valued semantics vs EXISTS
    residual: Optional[RowExpression] = None

    def outputs(self):
        out = list(self.source.outputs())
        if self.mark is not None:
            out.append(self.mark)
        return out

    def children(self):
        return [self.source, self.filtering_source]

    def with_children(self, children):
        return SemiJoinNode(children[0], children[1], self.source_key,
                            self.filtering_key, self.mark, self.negated,
                            self.null_aware, self.residual)


@dataclasses.dataclass(frozen=True)
class Ordering:
    symbol: Symbol
    descending: bool = False
    nulls_first: bool = False


@_node
class SortNode(PlanNode):
    source: PlanNode
    orderings: List[Ordering]

    def outputs(self):
        return self.source.outputs()

    def children(self):
        return [self.source]

    def with_children(self, children):
        return SortNode(children[0], self.orderings)


@dataclasses.dataclass(frozen=True)
class WindowCall:
    """One windowed function: rank()/row_number()/agg(x) OVER the node's spec.

    Reference: sql/planner/plan/WindowNode.java Function."""
    name: str
    args: List[Symbol]
    frame_mode: str = "range"  # range (peer groups share values) | rows
    offset: int = 1            # lag/lead distance (literal second argument)


@_node
class WindowNode(PlanNode):
    """WindowNode.java analogue: partition/order spec + function list; outputs
    = source outputs + one symbol per window call (row order preserved)."""
    source: PlanNode
    partition_keys: List[Symbol]
    orderings: List[Ordering]
    calls: List  # [(Symbol, WindowCall)]

    def outputs(self):
        return self.source.outputs() + [s for s, _ in self.calls]

    def children(self):
        return [self.source]

    def with_children(self, children):
        return WindowNode(children[0], self.partition_keys, self.orderings,
                          self.calls)


@_node
class TopNNode(PlanNode):
    source: PlanNode
    count: int
    orderings: List[Ordering]

    def outputs(self):
        return self.source.outputs()

    def children(self):
        return [self.source]

    def with_children(self, children):
        return TopNNode(children[0], self.count, self.orderings)


@_node
class LimitNode(PlanNode):
    source: PlanNode
    count: int

    def outputs(self):
        return self.source.outputs()

    def children(self):
        return [self.source]

    def with_children(self, children):
        return LimitNode(children[0], self.count)


@_node
class ValuesNode(PlanNode):
    symbols: List[Symbol]
    rows: List[List[object]]  # python values per row

    def outputs(self):
        return list(self.symbols)

    def children(self):
        return []

    def with_children(self, children):
        return self


# exchange kinds (SystemPartitioningHandle.java:59-65 vocabulary, TPU mapping:
# REPARTITION = all_to_all, BROADCAST = all_gather, GATHER = all_gather + mask,
# MERGE = range-repartition by the sort key (distributed ORDER BY: worker w
# holds the w-th value range, so worker-order concatenation IS global order —
# the TPU re-design of the reference's per-node sort + MergeOperator N-way
# merge, operator/MergeOperator.java / MergeHashSort.java)
REPARTITION, BROADCAST, GATHER, MERGE = \
    "repartition", "broadcast", "gather", "merge"


@_node
class ExchangeNode(PlanNode):
    """plan/ExchangeNode (REMOTE scope): the distribution boundary the fragmenter
    cuts at. `keys` drive hash routing for REPARTITION (empty for BROADCAST /
    GATHER); `orderings` drive range routing for MERGE —
    AddExchanges.java:132,205-253 analogue."""
    source: PlanNode
    kind: str                      # REPARTITION | BROADCAST | GATHER | MERGE
    keys: List[Symbol]
    orderings: Optional[List["Ordering"]] = None

    def outputs(self):
        return self.source.outputs()

    def children(self):
        return [self.source]

    def with_children(self, children):
        return ExchangeNode(children[0], self.kind, self.keys, self.orderings)


@_node
class RemoteSourceNode(PlanNode):
    """plan/RemoteSourceNode: a fragment's view of an upstream fragment's output
    (what ExchangeOperator + ExchangeClient read over HTTP in the reference; here
    the runner hands the collective's per-worker output pages to this node)."""
    fragment_id: int
    symbols: List[Symbol]

    def outputs(self):
        return list(self.symbols)

    def children(self):
        return []

    def with_children(self, children):
        return self


@_node
class OutputNode(PlanNode):
    """plan/OutputNode — the root: column names in user order."""
    source: PlanNode
    column_names: List[str]
    symbols: List[Symbol]

    def outputs(self):
        return list(self.symbols)

    def children(self):
        return [self.source]

    def with_children(self, children):
        return OutputNode(children[0], self.column_names, self.symbols)


@_node
class EnforceSingleRowNode(PlanNode):
    """plan/EnforceSingleRowNode — scalar subquery guard: exactly one row
    (pads with a single all-null row when empty)."""
    source: PlanNode

    def outputs(self):
        return self.source.outputs()

    def children(self):
        return [self.source]

    def with_children(self, children):
        return EnforceSingleRowNode(children[0])


@_node
class UnionNode(PlanNode):
    """plan/UnionNode — concatenation; symbol_mappings[i] maps output symbol
    position -> child i's symbol."""
    sources: List[PlanNode]
    symbols: List[Symbol]
    symbol_mappings: List[List[Symbol]]  # per child, aligned with symbols

    def outputs(self):
        return list(self.symbols)

    def children(self):
        return list(self.sources)

    def with_children(self, children):
        return UnionNode(list(children), self.symbols, self.symbol_mappings)


# ---------------------------------------------------------------------------
# traversal / pretty-print helpers
# ---------------------------------------------------------------------------

def rewrite_plan(node: PlanNode, fn) -> PlanNode:
    """Bottom-up plan rewrite: fn(node_with_rewritten_children) -> node."""
    children = [rewrite_plan(c, fn) for c in node.children()]
    node = node.with_children(children) if children else node
    out = fn(node)
    return node if out is None else out


def plan_to_text(node: PlanNode, indent: int = 0) -> str:
    """EXPLAIN rendering (sql/planner/planPrinter/PlanPrinter analogue)."""
    pad = "  " * indent
    name = type(node).__name__.replace("Node", "")
    detail = ""
    if isinstance(node, TableScanNode):
        detail = f" {node.table.schema_table}" \
                 f" [{', '.join(s.name for s, _ in node.assignments)}]"
    elif isinstance(node, FilterNode):
        detail = f" [{node.predicate}]"
    elif isinstance(node, ProjectNode):
        detail = " [" + ", ".join(f"{s.name} := {e}" for s, e in node.assignments) + "]"
    elif isinstance(node, AggregationNode):
        aggs = ", ".join(f"{s.name} := {c.name}({', '.join(a.name for a in c.args)})"
                         for s, c in node.aggregations)
        detail = f" [{node.step} keys={[k.name for k in node.keys]} {aggs}]"
    elif isinstance(node, JoinNode):
        crit = ", ".join(f"{l.name} = {r.name}" for l, r in node.criteria)
        detail = f" [{node.type} {crit}]" + (f" filter [{node.residual}]" if node.residual else "")
    elif isinstance(node, SemiJoinNode):
        sk = node.source_key.name
        fk = node.filtering_key.name
        detail = f" [{sk} in {fk}{' negated' if node.negated else ''}]" + \
                 (f" filter [{node.residual}]" if node.residual else "")
    elif isinstance(node, ExchangeNode):
        detail = f" [{node.kind}" + \
                 (f" keys={[k.name for k in node.keys]}" if node.keys else "") + "]"
    elif isinstance(node, RemoteSourceNode):
        detail = f" [fragment {node.fragment_id}]"
    elif isinstance(node, (TopNNode, SortNode)):
        o = ", ".join(f"{x.symbol.name}{' desc' if x.descending else ''}"
                      for x in node.orderings)
        n = f" n={node.count}" if isinstance(node, TopNNode) else ""
        detail = f" [{o}{n}]"
    elif isinstance(node, LimitNode):
        detail = f" [{node.count}]"
    elif isinstance(node, WindowNode):
        fns = ", ".join(f"{s.name} := {c.name}({', '.join(a.name for a in c.args)})"
                        for s, c in node.calls)
        o = ", ".join(f"{x.symbol.name}{' desc' if x.descending else ''}"
                      for x in node.orderings)
        detail = (f" [partition={[k.name for k in node.partition_keys]}"
                  f" order=[{o}] {fns}]")
    elif isinstance(node, OutputNode):
        detail = f" [{', '.join(node.column_names)}]"
    lines = [f"{pad}- {name}{detail}"]
    for c in node.children():
        lines.append(plan_to_text(c, indent + 1))
    return "\n".join(lines)
