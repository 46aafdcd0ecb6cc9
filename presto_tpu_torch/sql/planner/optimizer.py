"""Plan optimizer: predicate pushdown, join ordering, column pruning, TopN fusion.

The PyTorch port's copy of ``presto_tpu/sql/planner/optimizer.py`` (plain Python, no torch): the
port keeps its own front end so that it imports nothing of ``presto_tpu``.

Analogue of presto-main sql/planner/PlanOptimizers (the ~10 passes TPC needs, per
the reference's PredicatePushDown.java, iterative/rule/ReorderJoins.java,
PruneUnreferencedOutputs, MergeLimitWithSort -> TopNNode). Cost model: connector
row counts (spi/statistics/TableStatistics) with fixed filter selectivities —
the CBO (cost/StatsCalculator) analogue, narrowed to what join ordering needs.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ...metadata import MetadataManager, Session
from ...ops.expressions import (Call, Constant, RowExpression, SpecialForm,
                                SymbolRef, rewrite_expression, special,
                                symbols_in, symbol_ref)
from ...types import BOOLEAN
from .plan import (AggregationNode, EnforceSingleRowNode, FilterNode, JoinNode,
                   LimitNode, Ordering, OutputNode, PlanNode, ProjectNode,
                   SemiJoinNode, SortNode, Symbol, TableScanNode, TopNNode,
                   UnionNode, ValuesNode, rewrite_plan)

FILTER_SELECTIVITY = 0.25
SEMI_SELECTIVITY = 0.5

_DISTINCT_CTR = itertools.count()


def optimize(plan: PlanNode, metadata: MetadataManager,
             session: Session) -> PlanNode:
    """PlanOptimizers.java pipeline: visitor passes (pushdown, cost-driven
    join reorder, pruning) interleaved with the iterative rule engine
    (iterative.py — the IterativeOptimizer.java analogue), mirroring how the
    reference alternates visitor optimizers and rule batches."""
    from .iterative import DEFAULT_RULES, IterativeOptimizer, RuleContext

    rules = IterativeOptimizer(DEFAULT_RULES)
    ctx = RuleContext(metadata, session)
    plan = implement_distinct_aggregations(plan)
    plan = push_down_predicates(plan)
    plan = reorder_joins(plan, metadata)
    plan = push_down_predicates(plan)
    plan = normalize_residuals(plan)
    plan = rules.optimize(plan, ctx)   # limit/sort fusion, project merging, ...
    plan = prune_columns(plan)
    plan = rules.optimize(plan, ctx)   # identity projects the pruner exposed
    return plan


# ---------------------------------------------------------------------------
# conjunct utilities
# ---------------------------------------------------------------------------

def split_and(expr: RowExpression) -> List[RowExpression]:
    if isinstance(expr, SpecialForm) and expr.form == "AND":
        out: List[RowExpression] = []
        for a in expr.args:
            out.extend(split_and(a))
        return out
    return [expr]


def and_all(parts: Sequence[RowExpression]) -> Optional[RowExpression]:
    parts = list(parts)
    if not parts:
        return None
    out = parts[0]
    for p in parts[1:]:
        out = special("AND", BOOLEAN, out, p)
    return out


def substitute(expr: RowExpression,
               mapping: Dict[str, RowExpression]) -> RowExpression:
    def visit(e):
        if isinstance(e, SymbolRef) and e.name in mapping:
            return mapping[e.name]
        return None
    return rewrite_expression(expr, visit)


# ---------------------------------------------------------------------------
# predicate pushdown (PredicatePushDown.java analogue)
# ---------------------------------------------------------------------------

def factor_or(expr: RowExpression) -> List[RowExpression]:
    """(a AND x AND y) OR (a AND z) -> a AND ((x AND y) OR z).

    The ExtractCommonPredicatesExpressionRewriter analogue — without it, TPC-H Q19's
    join key equality stays trapped inside the OR and the join degenerates to a
    cross product."""
    if not (isinstance(expr, SpecialForm) and expr.form == "OR"):
        return [expr]
    branches = []

    def collect(e):
        if isinstance(e, SpecialForm) and e.form == "OR":
            for a in e.args:
                collect(a)
        else:
            branches.append(split_and(e))
    collect(expr)
    common = set(branches[0])
    for b in branches[1:]:
        common &= set(b)
    if not common:
        return [expr]
    out = [c for c in branches[0] if c in common]  # keep deterministic order
    rest_branches = []
    for b in branches:
        rest = [c for c in b if c not in common]
        if not rest:
            return out  # one branch is fully common -> OR is implied
        rest_branches.append(and_all(rest))
    rest_or = rest_branches[0]
    for rb in rest_branches[1:]:
        rest_or = special("OR", BOOLEAN, rest_or, rb)
    return out + [rest_or]


def push_down_predicates(plan: PlanNode) -> PlanNode:
    return _pushdown(plan, [])


def _pushdown(node: PlanNode, conjuncts: List[RowExpression]) -> PlanNode:
    """Push `conjuncts` (over node's output symbols) into/below `node`."""
    conjuncts = [f for c in conjuncts for f in factor_or(c)]
    if isinstance(node, FilterNode):
        return _pushdown(node.source, conjuncts + split_and(node.predicate))

    if isinstance(node, ProjectNode):
        mapping = {s.name: e for s, e in node.assignments}
        inlined = [substitute(c, mapping) for c in conjuncts]
        src = _pushdown(node.source, inlined)
        return ProjectNode(src, node.assignments)

    if isinstance(node, JoinNode) and node.type == "inner":
        left_syms = {s.name for s in node.left.outputs()}
        right_syms = {s.name for s in node.right.outputs()}
        to_left, to_right, keep = [], [], []
        for c in conjuncts:
            syms = symbols_in(c)
            if syms <= left_syms:
                to_left.append(c)
            elif syms <= right_syms:
                to_right.append(c)
            else:
                keep.append(c)
        residual = split_and(node.residual) if node.residual is not None else []
        left = _pushdown(node.left, to_left)
        right = _pushdown(node.right, to_right)
        out = JoinNode(node.type, left, right, node.criteria,
                       and_all(residual), node.output_symbols)
        return _wrap_filter(out, keep)

    if isinstance(node, JoinNode) and node.type == "left":
        left_syms = {s.name for s in node.left.outputs()}
        to_left, keep = [], []
        for c in conjuncts:
            if symbols_in(c) <= left_syms:
                to_left.append(c)
            else:
                keep.append(c)
        # ON-clause conjuncts that reference only the build side filter which build
        # rows can match — safe to push into the right child for LEFT joins
        residual_keep, to_right = [], []
        for c in (split_and(node.residual) if node.residual is not None else []):
            if symbols_in(c) <= {s.name for s in node.right.outputs()}:
                to_right.append(c)
            else:
                residual_keep.append(c)
        left = _pushdown(node.left, to_left)
        right = _pushdown(node.right, to_right)
        out = JoinNode(node.type, left, right, node.criteria,
                       and_all(residual_keep), node.output_symbols)
        return _wrap_filter(out, keep)

    if isinstance(node, SemiJoinNode):
        src_syms = {s.name for s in node.source.outputs()}
        to_src, keep = [], []
        for c in conjuncts:
            (to_src if symbols_in(c) <= src_syms else keep).append(c)
        src = _pushdown(node.source, to_src)
        filt = _pushdown(node.filtering_source, [])
        out = SemiJoinNode(src, filt, node.source_key, node.filtering_key,
                           node.mark, node.negated, node.null_aware,
                           node.residual)
        return _wrap_filter(out, keep)

    if isinstance(node, AggregationNode):
        key_syms = {k.name for k in node.keys}
        below, keep = [], []
        for c in conjuncts:
            (below if symbols_in(c) <= key_syms else keep).append(c)
        src = _pushdown(node.source, below)
        out = AggregationNode(src, node.keys, node.aggregations, node.step)
        return _wrap_filter(out, keep)

    if isinstance(node, UnionNode):
        new_sources = []
        for child, mapping in zip(node.sources, node.symbol_mappings):
            m = {s.name: symbol_ref(cs.name, cs.type)
                 for s, cs in zip(node.symbols, mapping)}
            new_sources.append(_pushdown(child, [substitute(c, m)
                                                 for c in conjuncts]))
        return UnionNode(new_sources, node.symbols, node.symbol_mappings)

    # barrier nodes: recurse into children with no conjuncts, re-wrap here
    children = [_pushdown(c, []) for c in node.children()]
    node = node.with_children(children) if children else node
    return _wrap_filter(node, conjuncts)


def _wrap_filter(node: PlanNode, conjuncts: List[RowExpression]) -> PlanNode:
    pred = and_all(conjuncts)
    return node if pred is None else FilterNode(node, pred)


# ---------------------------------------------------------------------------
# cardinality estimation (cost/StatsCalculator analogue, heavily narrowed)
# ---------------------------------------------------------------------------

def _resolve_scan_column(node: PlanNode, name: str):
    """Follow identity projections/filters down to (TableScanNode, column
    name), or None when the symbol is computed (the reference's
    symbol-to-source-column provenance in cost/ScalarStatsCalculator)."""
    if isinstance(node, TableScanNode):
        for s, ch in node.assignments:
            if s.name == name:
                return node, ch.name
        return None
    if isinstance(node, ProjectNode):
        for s, e in node.assignments:
            if s.name == name:
                if isinstance(e, SymbolRef):
                    return _resolve_scan_column(node.source, e.name)
                return None
        return None
    if isinstance(node, FilterNode):
        return _resolve_scan_column(node.source, name)
    return None


def _column_stats(source: PlanNode, name: str, metadata: MetadataManager):
    """-> spi ColumnStatistics for the symbol, or None."""
    hit = _resolve_scan_column(source, name)
    if hit is None:
        return None
    scan, col = hit
    stats = metadata.get_table_statistics(scan.table)
    return stats.columns.get(col)


def _const_value(e) -> Optional[float]:
    if isinstance(e, Constant) and isinstance(e.value, (int, float)) \
            and not isinstance(e.value, bool):
        return float(e.value)
    return None


_CMP_FLIP = {"less_than": "greater_than",
             "less_than_or_equal": "greater_than_or_equal",
             "greater_than": "less_than",
             "greater_than_or_equal": "less_than_or_equal",
             "equal": "equal", "not_equal": "not_equal"}


def conjunct_selectivity(e: RowExpression, source: PlanNode,
                         metadata: MetadataManager) -> float:
    """FilterStatsCalculator.java analogue: per-conjunct selectivity from
    connector column statistics (min/max for ranges, NDV for equality,
    null fraction for IS NULL), falling back to the fixed default."""
    if isinstance(e, SpecialForm):
        if e.form == "AND":
            out = 1.0
            for a in e.args:
                out *= conjunct_selectivity(a, source, metadata)
            return out
        if e.form == "OR":
            miss = 1.0
            for a in e.args:
                miss *= 1.0 - conjunct_selectivity(a, source, metadata)
            return 1.0 - miss
        if e.form == "NOT":
            return 1.0 - conjunct_selectivity(e.args[0], source, metadata)
        if e.form == "IS_NULL" and isinstance(e.args[0], SymbolRef):
            cs = _column_stats(source, e.args[0].name, metadata)
            return cs.null_fraction if cs is not None else 0.1
        if e.form == "BETWEEN" and isinstance(e.args[0], SymbolRef):
            lo = _range_selectivity(source, e.args[0].name,
                                    "greater_than_or_equal", e.args[1],
                                    metadata)
            hi = _range_selectivity(source, e.args[0].name,
                                    "less_than_or_equal", e.args[2], metadata)
            if lo is not None and hi is not None:
                return max(0.0, lo + hi - 1.0)
            return FILTER_SELECTIVITY
        if e.form == "IN" and isinstance(e.args[0], SymbolRef):
            cs = _column_stats(source, e.args[0].name, metadata)
            if cs is not None and cs.distinct_count:
                return min(1.0, (len(e.args) - 1) / cs.distinct_count)
            return FILTER_SELECTIVITY
        return FILTER_SELECTIVITY
    if isinstance(e, Call) and e.name in _CMP_FLIP and len(e.args) == 2:
        a, b = e.args
        op = e.name
        if isinstance(b, SymbolRef) and not isinstance(a, SymbolRef):
            a, b, op = b, a, _CMP_FLIP[op]
        if isinstance(a, SymbolRef) and isinstance(b, Constant):
            cs = _column_stats(source, a.name, metadata)
            if op == "equal":
                if cs is not None and cs.distinct_count:
                    return min(1.0, 1.0 / cs.distinct_count)
                return FILTER_SELECTIVITY
            if op == "not_equal":
                if cs is not None and cs.distinct_count:
                    return max(0.0, 1.0 - 1.0 / cs.distinct_count)
                return 1.0 - FILTER_SELECTIVITY
            s = _range_selectivity(source, a.name, op, b, metadata)
            if s is not None:
                return s
    return FILTER_SELECTIVITY


def _range_selectivity(source, name, op, const_expr,
                       metadata) -> Optional[float]:
    cs = _column_stats(source, name, metadata)
    v = _const_value(const_expr)
    if cs is None or v is None or cs.min_value is None or \
            cs.max_value is None or cs.max_value <= cs.min_value:
        return None
    span = cs.max_value - cs.min_value
    frac = (v - cs.min_value) / span
    if op in ("less_than", "less_than_or_equal"):
        out = frac
    else:
        out = 1.0 - frac
    return float(min(1.0, max(0.0, out)))


def _join_key_ndv(node: PlanNode, sym: Symbol, metadata) -> Optional[float]:
    cs = _column_stats(node, sym.name, metadata)
    return cs.distinct_count if cs is not None else None


def estimate_rows(node: PlanNode, metadata: MetadataManager) -> float:
    if isinstance(node, TableScanNode):
        stats = metadata.get_table_statistics(node.table)
        return stats.row_count or 1e6
    if isinstance(node, FilterNode):
        src = estimate_rows(node.source, metadata)
        sel = 1.0
        for conj in split_and(node.predicate):
            sel *= conjunct_selectivity(conj, node.source, metadata)
        return src * sel
    if isinstance(node, (ProjectNode, SortNode)):
        return estimate_rows(node.children()[0], metadata)
    if isinstance(node, AggregationNode):
        if not node.keys:
            return 1.0
        src = estimate_rows(node.source, metadata)
        ndv = 1.0
        known = False
        for k in node.keys:
            d = _join_key_ndv(node.source, k, metadata)
            if d:
                ndv *= d
                known = True
        if known:
            return max(1.0, min(src, ndv))
        return max(1.0, src * 0.1)
    if isinstance(node, JoinNode):
        l = estimate_rows(node.left, metadata)
        r = estimate_rows(node.right, metadata)
        if not node.criteria:
            return l * r
        # JoinStatsRule.java: |L x R| / max(NDV(lk), NDV(rk)) per equi-clause
        out = l * r
        known = False
        for (lk, rk) in node.criteria:
            ndv_l = _join_key_ndv(node.left, lk, metadata)
            ndv_r = _join_key_ndv(node.right, rk, metadata)
            ndv = max(ndv_l or 0.0, ndv_r or 0.0)
            if ndv > 0:
                out /= ndv
                known = True
        if known:
            return max(1.0, out)
        return max(l, r)
    if isinstance(node, SemiJoinNode):
        return estimate_rows(node.source, metadata) * SEMI_SELECTIVITY
    if isinstance(node, EnforceSingleRowNode):
        return 1.0
    if isinstance(node, ValuesNode):
        return float(len(node.rows))
    if isinstance(node, (TopNNode, LimitNode)):
        return float(min(node.count,
                         estimate_rows(node.children()[0], metadata)))
    if isinstance(node, UnionNode):
        return sum(estimate_rows(c, metadata) for c in node.sources)
    children = node.children()
    return estimate_rows(children[0], metadata) if children else 1.0


# ---------------------------------------------------------------------------
# join reordering (iterative/rule/ReorderJoins + DetermineJoinDistributionType)
# ---------------------------------------------------------------------------

def reorder_joins(plan: PlanNode, metadata: MetadataManager) -> PlanNode:
    """Greedy left-deep reordering of inner-join regions.

    A region = maximal tree of inner JoinNodes and FilterNodes. The spine (probe
    side) starts at the largest relation; each step joins the smallest relation
    equi-connected to the spine (the reference's greedy fallback when the
    exhaustive ReorderJoins search is off). Build sides end up small -> they fit
    the TPU-resident hash table; the big fact table streams through as probe."""
    def visit(node: PlanNode) -> Optional[PlanNode]:
        # region roots: an inner join, or a filter stack sitting on one (equality
        # conjuncts that pushdown could not sink into one side land there)
        root = node
        while isinstance(root, FilterNode):
            root = root.source
        if isinstance(root, JoinNode) and root.type == "inner":
            relations: List[PlanNode] = []
            conjuncts: List[RowExpression] = []
            _flatten_region(node, relations, conjuncts)
            if len(relations) < 2:
                return None
            return _greedy_join(relations, conjuncts, metadata)
        return None

    return _rewrite_topdown_regions(plan, visit)


def _rewrite_topdown_regions(node: PlanNode, visit) -> PlanNode:
    out = visit(node)
    if out is not None:
        # recurse into the new children (region leaves), not the join tree we built
        return out
    children = [_rewrite_topdown_regions(c, visit) for c in node.children()]
    return node.with_children(children) if children else node


def _flatten_region(node: PlanNode, relations: List[PlanNode],
                    conjuncts: List[RowExpression]) -> None:
    if isinstance(node, JoinNode) and node.type == "inner":
        for l, r in node.criteria:
            conjuncts.append(Call(BOOLEAN, "equal",
                                  (symbol_ref(l.name, l.type),
                                   symbol_ref(r.name, r.type))))
        if node.residual is not None:
            conjuncts.extend(split_and(node.residual))
        _flatten_region(node.left, relations, conjuncts)
        _flatten_region(node.right, relations, conjuncts)
        return
    if isinstance(node, FilterNode):
        conjuncts.extend(split_and(node.predicate))
        _flatten_region(node.source, relations, conjuncts)
        return
    relations.append(node)


def _greedy_join(relations: List[PlanNode], conjuncts: List[RowExpression],
                 metadata: MetadataManager) -> PlanNode:
    rel_syms: List[Set[str]] = [{s.name for s in r.outputs()} for r in relations]
    sym_types: Dict[str, Symbol] = {}
    for r in relations:
        for s in r.outputs():
            sym_types[s.name] = s
    sizes = [estimate_rows(r, metadata) for r in relations]

    # recurse into the relation subtrees first (nested regions below barriers)
    relations = [reorder_joins(r, metadata) for r in relations]

    pending = list(conjuncts)
    remaining = set(range(len(relations)))

    # spine = largest relation (streams as probe)
    spine_i = max(remaining, key=lambda i: sizes[i])
    remaining.discard(spine_i)
    spine: PlanNode = relations[spine_i]
    avail: Set[str] = set(rel_syms[spine_i])

    def equi_pairs_for(i: int) -> List[Tuple[Symbol, Symbol]]:
        pairs = []
        for c in pending:
            p = _as_equi(c)
            if p is None:
                continue
            a, b = p
            if a.name in avail and b.name in rel_syms[i]:
                pairs.append((a, b))
            elif b.name in avail and a.name in rel_syms[i]:
                pairs.append((b, a))
        return pairs

    def apply_ready_filters():
        nonlocal spine, pending
        ready = [c for c in pending if symbols_in(c) <= avail]
        if ready:
            spine = FilterNode(spine, and_all(ready))
            pending = [c for c in pending if c not in ready]

    apply_ready_filters()
    # cost-driven next-join pick (ReorderJoins' cost comparator +
    # CostCalculatorUsingExchanges terms, via cost.join_step_cost): each
    # candidate is priced as one hash-join step — probe the current spine,
    # build the candidate, emit the estimated output — and the cheapest
    # joins next. Build memory weighs double (HBM is the TPU's wall).
    from .cost import join_step_cost

    spine_rows = sizes[spine_i]
    while remaining:
        connected = [i for i in remaining if equi_pairs_for(i)]
        pool = connected or list(remaining)

        def step_cost(i: int) -> float:
            out_rows = max(spine_rows, sizes[i]) if equi_pairs_for(i) \
                else spine_rows * sizes[i]
            return join_step_cost(spine_rows, sizes[i], out_rows).total()

        nxt = min(pool, key=step_cost)
        spine_rows = max(spine_rows, sizes[nxt]) if equi_pairs_for(nxt) \
            else spine_rows * sizes[nxt]
        pairs = equi_pairs_for(nxt)
        used = []
        for c in pending:
            p = _as_equi(c)
            if p is None:
                continue
            a, b = p
            if (a.name in avail and b.name in rel_syms[nxt]) or \
                    (b.name in avail and a.name in rel_syms[nxt]):
                used.append(c)
        pending = [c for c in pending if c not in used]
        spine = JoinNode("inner", spine, relations[nxt], pairs, None)
        avail |= rel_syms[nxt]
        remaining.discard(nxt)
        apply_ready_filters()

    if pending:
        spine = FilterNode(spine, and_all(pending))
    return spine


def _as_equi(c: RowExpression) -> Optional[Tuple[Symbol, Symbol]]:
    if isinstance(c, Call) and c.name == "equal":
        a, b = c.args
        if isinstance(a, SymbolRef) and isinstance(b, SymbolRef) and a.name != b.name:
            return (Symbol(a.name, a.type), Symbol(b.name, b.type))
    return None


# ---------------------------------------------------------------------------
# residual normalization
# ---------------------------------------------------------------------------

def normalize_residuals(plan: PlanNode) -> PlanNode:
    """INNER join residuals become filters above the join (the executor evaluates
    them on the joined page). LEFT-join residuals over the build side were pushed
    down already; anything left is unsupported this round."""
    def visit(node):
        if isinstance(node, JoinNode) and node.residual is not None:
            if node.type == "inner":
                return FilterNode(
                    JoinNode(node.type, node.left, node.right, node.criteria,
                             None, node.output_symbols),
                    node.residual)
            raise NotImplementedError(
                f"{node.type} join residual filter {node.residual} not supported")
        return None
    return rewrite_plan(plan, visit)


# ---------------------------------------------------------------------------
# TopN fusion (MergeLimitWithSort)
# ---------------------------------------------------------------------------


def prune_columns(plan: PlanNode) -> PlanNode:
    if isinstance(plan, OutputNode):
        required = {s.name for s in plan.symbols}
        src = _prune(plan.source, required)
        return OutputNode(src, plan.column_names, plan.symbols)
    return _prune(plan, {s.name for s in plan.outputs()})


def _prune(node: PlanNode, required: Set[str]) -> PlanNode:
    if isinstance(node, TableScanNode):
        assigns = [(s, c) for s, c in node.assignments if s.name in required]
        return TableScanNode(node.table, assigns or node.assignments[:1])

    if isinstance(node, FilterNode):
        need = required | symbols_in(node.predicate)
        return FilterNode(_prune(node.source, need), node.predicate)

    if isinstance(node, ProjectNode):
        assigns = [(s, e) for s, e in node.assignments if s.name in required]
        need: Set[str] = set()
        for _, e in assigns:
            need |= symbols_in(e)
        return ProjectNode(_prune(node.source, need), assigns)

    if isinstance(node, JoinNode):
        need = set(required)
        for l, r in node.criteria:
            need.add(l.name)
            need.add(r.name)
        if node.residual is not None:
            need |= symbols_in(node.residual)
        left = _prune(node.left, need)
        right = _prune(node.right, need)
        outs = [s for s in left.outputs() + right.outputs() if s.name in required]
        return JoinNode(node.type, left, right, node.criteria, node.residual, outs)

    if isinstance(node, SemiJoinNode):
        need = set(required) | {node.source_key.name}
        fneed = {node.filtering_key.name}
        if node.residual is not None:
            rsyms = symbols_in(node.residual)
            need |= rsyms
            fneed |= rsyms
        src = _prune(node.source, need)
        filt = _prune(node.filtering_source, fneed)
        return SemiJoinNode(src, filt, node.source_key, node.filtering_key,
                            node.mark, node.negated, node.null_aware,
                            node.residual)

    if isinstance(node, AggregationNode):
        aggs = [(s, c) for s, c in node.aggregations if s.name in required] \
            if node.keys or node.aggregations else []
        if not aggs and node.aggregations:
            aggs = node.aggregations[:1]  # keep one (e.g. count) for EXISTS shapes
        need = {k.name for k in node.keys}
        for _, c in aggs:
            need |= {a.name for a in c.args}
            if c.filter is not None:
                need.add(c.filter.name)
        return AggregationNode(_prune(node.source, need), node.keys, aggs,
                               node.step)

    if isinstance(node, (SortNode, TopNNode)):
        need = set(required) | {o.symbol.name for o in node.orderings}
        src = _prune(node.children()[0], need)
        if isinstance(node, SortNode):
            return SortNode(src, node.orderings)
        return TopNNode(src, node.count, node.orderings)

    if isinstance(node, LimitNode):
        return LimitNode(_prune(node.source, required), node.count)

    if isinstance(node, EnforceSingleRowNode):
        return EnforceSingleRowNode(_prune(node.source, required))

    if isinstance(node, UnionNode):
        keep_idx = [i for i, s in enumerate(node.symbols) if s.name in required]
        if not keep_idx:
            keep_idx = [0]
        new_sources = []
        for child, mapping in zip(node.sources, node.symbol_mappings):
            need = {mapping[i].name for i in keep_idx}
            new_sources.append(_prune(child, need))
        return UnionNode(new_sources,
                         [node.symbols[i] for i in keep_idx],
                         [[m[i] for i in keep_idx] for m in node.symbol_mappings])

    children = [_prune(c, {s.name for s in c.outputs()})
                for c in node.children()]
    return node.with_children(children) if children else node


# ---------------------------------------------------------------------------
# identity project removal
# ---------------------------------------------------------------------------


def implement_distinct_aggregations(plan: PlanNode) -> PlanNode:
    """agg(DISTINCT x) -> aggregate over (keys, x)-deduplicated rows.

    The reference implements distinct aggregates with MarkDistinctOperator
    (streaming per-group hash sets); this engine's page kernels are
    reduction-shaped, so distinct is desugared structurally instead:

        Agg[k; f(DISTINCT x), g(y)]
          -> Join on k of
               Agg[k; g(y)](src)                              # plain branch
               Agg[k; f(x)](Agg[k, x; ](src))                 # dedup branch

    One dedup branch per distinct argument tuple; branches join on the group
    keys (cross join when global). The single-branch case (all aggregates
    distinct over one argument list — the common COUNT(DISTINCT x) shape)
    needs no join at all. The multi-branch join is NULL-safe: each side joins
    on (COALESCE(k, 0), CAST(k IS NULL AS BIGINT)) pairs, so NULL group keys
    match their counterparts instead of dropping (IS NOT DISTINCT FROM).
    """

    def fn(node):
        if not isinstance(node, AggregationNode) or \
                not any(c.distinct for _, c in node.aggregations):
            return None
        src = node.source
        keys = list(node.keys)
        plain = [(s, c) for s, c in node.aggregations if not c.distinct]
        dgroups: Dict[tuple, list] = {}
        for s, c in node.aggregations:
            if c.distinct:
                dgroups.setdefault((tuple(c.args), c.filter), []).append((s, c))

        branches = []          # (node, agg_output_syms)
        if plain:
            branches.append((AggregationNode(src, keys, plain),
                             [s for s, _ in plain]))
        for (args, filt), calls in dgroups.items():
            dd_keys = list(keys)
            for a in list(args) + ([filt] if filt is not None else []):
                if a not in dd_keys:
                    dd_keys.append(a)
            dedup = AggregationNode(src, dd_keys, [])
            calls2 = [(s, dataclasses.replace(c, distinct=False))
                      for s, c in calls]
            branches.append((AggregationNode(dedup, keys, calls2),
                             [s for s, _ in calls2]))

        # NULL-key note: this engine's aggregation outputs carry no null masks
        # on key columns (NULL keys group with their zero data value — the
        # same conflation in EVERY branch), so the value join below loses no
        # groups relative to the engine's own grouping semantics; when
        # null-distinct grouping lands, these criteria must become
        # IS NOT DISTINCT FROM.
        result, _ = branches[0]
        for br, br_aggs in branches[1:]:
            if keys:
                fresh = [Symbol(f"{k.name}$dd{next(_DISTINCT_CTR)}", k.type)
                         for k in keys]
                proj = ProjectNode(br, [
                    (fk, SymbolRef(k.type, k.name))
                    for fk, k in zip(fresh, keys)
                ] + [(s, SymbolRef(s.type, s.name)) for s in br_aggs])
                result = JoinNode("inner", result, proj,
                                  list(zip(keys, fresh)))
            else:
                result = JoinNode("inner", result, br, [])
        return ProjectNode(
            result, [(s, SymbolRef(s.type, s.name)) for s in node.outputs()])

    return rewrite_plan(plan, fn)
