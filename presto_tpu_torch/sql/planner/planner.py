"""Logical planner: AST -> symbol-based logical plan.

The PyTorch port's copy of ``presto_tpu/sql/planner/planner.py`` (plain Python, no torch): the
port keeps its own front end so that it imports nothing of ``presto_tpu``.

Analogue of presto-main sql/planner/LogicalPlanner.java:108 + RelationPlanner.java +
QueryPlanner.java (AST walk, scope threading, aggregate extraction) and
SubqueryPlanner (uncorrelated IN -> SemiJoin, scalar subquery ->
EnforceSingleRow + cross join). Where the reference produces symbol-annotated AST
expressions and lowers later, we emit RowExpressions over SymbolRef immediately
(see sql/analyzer.py).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from ...metadata import MetadataManager, Session
from ...ops.expressions import (Call, Constant, RowExpression, SpecialForm,
                                SymbolRef, special, symbol_ref)
from ...types import BIGINT, BOOLEAN, DecimalType, Type, UNKNOWN
from .. import tree as t
from ..analyzer import (AGGREGATE_NAMES, ExpressionTranslator, Field, Scope,
                        SemanticError, aggregate_output_type, cast_to, common_type,
                        contains_aggregates, extract_aggregates,
                        extract_windows, rewrite_ast)
from .plan import (AggregationCall, AggregationNode, EnforceSingleRowNode,
                   FilterNode, JoinNode, LimitNode, Ordering, OutputNode, PlanNode,
                   ProjectNode, SemiJoinNode, SortNode, Symbol, SymbolAllocator,
                   TableScanNode, UnionNode, ValuesNode)


@dataclasses.dataclass
class RelationPlan:
    """RelationPlanner's (node, scope) pair."""
    node: PlanNode
    scope: Scope


from .optimizer import and_all as _and_all, split_and as _split_and


def _conjuncts(expr: Optional[t.Expression]) -> List[t.Expression]:
    if expr is None:
        return []
    if isinstance(expr, t.LogicalBinary) and expr.op.upper() == "AND":
        return _conjuncts(expr.left) + _conjuncts(expr.right)
    return [expr]


class LogicalPlanner:
    """One instance per query (owns the symbol allocator)."""

    def __init__(self, metadata: MetadataManager, session: Session):
        self.metadata = metadata
        self.session = session
        self.symbols = SymbolAllocator()
        self._ctes: Dict[str, t.Query] = {}

    # ------------------------------------------------------------------ top

    def plan(self, stmt: t.Statement) -> OutputNode:
        if isinstance(stmt, t.Query):
            plan, names = self.plan_root_query(stmt)
            return OutputNode(plan.node, names, [f.symbol for f in plan.scope.fields])
        raise SemanticError(f"cannot plan statement {type(stmt).__name__}")

    def plan_root_query(self, q: t.Query) -> Tuple[RelationPlan, List[str]]:
        plan = self.plan_query(q)
        names = [f.name or f"_col{i}" for i, f in enumerate(plan.scope.fields)]
        return plan, names

    # ---------------------------------------------------------------- query

    def plan_query(self, q: t.Query) -> RelationPlan:
        saved = dict(self._ctes)
        try:
            if q.with_ is not None:
                for name, cte in q.with_.queries:
                    self._ctes[name.lower()] = cte
            plan = self.plan_relation(q.body)
            if q.order_by or q.limit is not None:
                # outer ORDER BY/LIMIT around a set-op or bare spec body
                plan = self._plan_order_limit(plan, q.order_by, q.limit, None)
            return plan
        finally:
            self._ctes = saved

    def plan_relation(self, rel: t.Relation) -> RelationPlan:
        if isinstance(rel, t.QuerySpecification):
            return self.plan_query_spec(rel)
        if isinstance(rel, t.Table):
            return self.plan_table(rel)
        if isinstance(rel, t.AliasedRelation):
            return self.plan_aliased(rel)
        if isinstance(rel, t.TableSubquery):
            inner = self.plan_query(rel.query)
            return inner
        if isinstance(rel, t.Join):
            return self.plan_join(rel)
        if isinstance(rel, t.Values):
            return self.plan_values(rel)
        if isinstance(rel, t.SetOperation):
            return self.plan_set_operation(rel)
        if isinstance(rel, t.Unnest):
            return self.plan_unnest(rel, None)
        raise SemanticError(f"unsupported relation {type(rel).__name__}")

    # --------------------------------------------------------------- UNNEST

    def plan_unnest(self, rel: t.Unnest,
                    source: Optional[RelationPlan]) -> RelationPlan:
        """UNNEST over ARRAY[..] constructors, lowered STATICALLY (the TPU
        re-design of operator/UnnestOperator.java): the constructor's length
        is a plan-time constant, so

          FROM UNNEST(ARRAY[c1..cK])            -> K-row ValuesNode
          FROM src, UNNEST(ARRAY[e1..eK])       -> K-branch union of projects
                                                   (each branch emits element i
                                                   per source row)

        No ragged array block ever reaches the device — element expressions
        compile into the branches' projection kernels directly. Multiple
        arrays zip with NULL padding; WITH ORDINALITY appends 1-based i."""
        scope = source.scope if source is not None else Scope([])
        tr = ExpressionTranslator(scope)
        arrays = []
        for e in rel.expressions:
            ir = tr.translate(e)
            if not (isinstance(ir, Call) and ir.name == "array"):
                raise SemanticError(
                    "UNNEST supports ARRAY[..] constructors (dynamic arrays "
                    "have no device representation in this engine)")
            arrays.append(ir)
        K = max(len(a.args) for a in arrays)
        elem_types = [a.type.element for a in arrays]

        def element(a, i):
            if i < len(a.args):
                return a.args[i]
            return Constant(UNKNOWN, None)  # shorter arrays pad with NULL

        if source is None:
            # element expressions must be literals (no row context exists)
            rows = []
            for i in range(K):
                row = []
                for a, et in zip(arrays, elem_types):
                    v = element(a, i)
                    if not isinstance(v, Constant):
                        raise SemanticError(
                            "standalone UNNEST requires literal array "
                            "elements (join it to a relation otherwise)")
                    val = v.value
                    if isinstance(et, DecimalType) and val is not None and \
                            isinstance(v.type, DecimalType):
                        val = val * 10 ** (et.scale - v.type.scale)
                    row.append(val)
                if rel.with_ordinality:
                    row.append(i + 1)
                rows.append(row)
            syms = [self.symbols.new_symbol(f"col{i}", et)
                    for i, et in enumerate(elem_types)]
            if rel.with_ordinality:
                syms.append(self.symbols.new_symbol("ordinality", BIGINT))
            fields = [Field(f"_col{i}", s, None) for i, s in enumerate(syms)]
            return RelationPlan(ValuesNode(syms, rows), Scope(fields))

        # lateral: cross-join the source ONCE to a K-row ordinality values
        # relation, then select element i by ordinality per output row —
        # the source subtree executes a single time (a K-branch union would
        # re-run it K times), and every shape stays static
        src_fields = source.scope.fields
        ord_sym = self.symbols.new_symbol("unnest_ord", BIGINT)
        values = ValuesNode([ord_sym], [[i + 1] for i in range(K)])
        joined = JoinNode("inner", source.node, values, [], None)
        ord_ref = symbol_ref(ord_sym.name, BIGINT)
        assigns = [(f.symbol, symbol_ref(f.symbol.name, f.type))
                   for f in src_fields]
        fields = list(src_fields)
        col_i = 0
        for a, et in zip(arrays, elem_types):
            expr: RowExpression = Constant(UNKNOWN, None)
            for i in range(len(a.args) - 1, -1, -1):
                cond = Call(BOOLEAN, "equal",
                            (ord_ref, Constant(BIGINT, i + 1)))
                expr = special("IF", et, cond, cast_to(element(a, i), et),
                               expr)
            s = self.symbols.new_symbol("unnest", et)
            assigns.append((s, expr))
            fields.append(Field(f"_col{col_i}", s, None))
            col_i += 1
        if rel.with_ordinality:
            s = self.symbols.new_symbol("ordinality", BIGINT)
            assigns.append((s, ord_ref))
            fields.append(Field(f"_col{col_i}", s, None))
        node = ProjectNode(joined, assigns)
        return RelationPlan(node, Scope(fields))

    # ---------------------------------------------------------------- FROM

    def plan_table(self, rel: t.Table) -> RelationPlan:
        name_parts = tuple(p.lower() for p in rel.name)
        if len(name_parts) == 1 and name_parts[0] in self._ctes:
            cte_plan = self.plan_query(self._ctes[name_parts[0]])
            fields = [Field(f.name, f.symbol, name_parts[0])
                      for f in cte_plan.scope.fields]
            return RelationPlan(cte_plan.node, Scope(fields))
        qname = self.metadata.resolve_table_name(self.session, name_parts)
        handle = self.metadata.get_table_handle(self.session, qname)
        if handle is None:
            raise SemanticError(f"table {qname} does not exist")
        columns = self.metadata.get_column_handles(handle)
        meta = self.metadata.get_table_metadata(handle)
        assignments = []
        fields = []
        for cm in meta.columns:
            sym = self.symbols.new_symbol(cm.name, cm.type)
            assignments.append((sym, columns[cm.name]))
            fields.append(Field(cm.name, sym, qname.table, hidden=cm.hidden))
        return RelationPlan(TableScanNode(handle, assignments), Scope(fields))

    def plan_aliased(self, rel: t.AliasedRelation) -> RelationPlan:
        inner = self.plan_relation(rel.relation)
        alias = rel.alias.lower()
        fields = []
        for i, f in enumerate(inner.scope.fields):
            name = rel.column_names[i].lower() if rel.column_names else f.name
            fields.append(Field(name, f.symbol, alias, hidden=f.hidden))
        return RelationPlan(inner.node, Scope(fields))

    def plan_values(self, rel: t.Values) -> RelationPlan:
        rows = []
        types: List[Type] = []
        for r in rel.rows:
            items = r.items if isinstance(r, t.Row) else (r,)
            tr = ExpressionTranslator(Scope([]))
            vals = [tr.translate(i) for i in items]
            if not types:
                types = [v.type for v in vals]
            else:
                types = [common_type(a, v.type) for a, v in zip(types, vals)]
            rows.append(vals)
        pyrows = []
        for vals in rows:
            out = []
            for v, tt in zip(vals, types):
                if not isinstance(v, Constant):
                    raise SemanticError("VALUES entries must be literals")
                val = v.value
                # unscaled decimal ints must be rescaled to the COMMON scale:
                # VALUES (1.5),(1.25) has common decimal(18,2); storing 15 raw
                # for the first row would decode as 0.15 instead of 1.50
                if isinstance(tt, DecimalType) and val is not None:
                    from_scale = (v.type.scale if isinstance(v.type, DecimalType)
                                  else 0)
                    val = val * 10 ** (tt.scale - from_scale)
                out.append(val)
            pyrows.append(out)
        syms = [self.symbols.new_symbol(f"col{i}", tt) for i, tt in enumerate(types)]
        fields = [Field(f"_col{i}", s, None) for i, s in enumerate(syms)]
        return RelationPlan(ValuesNode(syms, pyrows), Scope(fields))

    def plan_join(self, rel: t.Join) -> RelationPlan:
        # lateral UNNEST on the right side: its array expressions may
        # reference left columns, so it plans against the LEFT scope
        right_rel = rel.right
        alias, colnames = None, None
        if isinstance(right_rel, t.AliasedRelation) and \
                isinstance(right_rel.relation, t.Unnest):
            alias, colnames = right_rel.alias, right_rel.column_names
            right_rel = right_rel.relation
        if isinstance(right_rel, t.Unnest):
            left = self.plan_relation(rel.left)
            plan = self.plan_unnest(right_rel, left)
            nsrc = len(left.scope.fields)
            fields = list(plan.scope.fields[:nsrc])
            for i, f in enumerate(plan.scope.fields[nsrc:]):
                name = colnames[i].lower() if colnames and i < len(colnames) \
                    else f.name
                fields.append(Field(name, f.symbol,
                                    alias.lower() if alias else None))
            return RelationPlan(plan.node, Scope(fields))

        left = self.plan_relation(rel.left)
        right = self.plan_relation(rel.right)
        scope = Scope(left.scope.fields + right.scope.fields)
        jtype = rel.type.upper()
        if jtype in ("CROSS", "IMPLICIT"):
            node = JoinNode("inner", left.node, right.node, [], None)
            return RelationPlan(node, scope)
        if jtype == "RIGHT":
            # RIGHT = LEFT with sides swapped; field order stays user-visible via scope
            left, right = right, left
            jtype = "LEFT"
        criteria: List[Tuple[Symbol, Symbol]] = []
        residual_parts: List[RowExpression] = []
        if rel.using:
            for col in rel.using:
                lf = left.scope.resolve(col.lower())
                rf = right.scope.resolve(col.lower())
                criteria.append((lf.symbol, rf.symbol))
        elif rel.criteria is not None:
            tr = ExpressionTranslator(scope)
            predicate = tr.translate(rel.criteria)
            left_syms = {f.symbol.name for f in left.scope.fields}
            right_syms = {f.symbol.name for f in right.scope.fields}
            for c in _split_and(predicate):
                pair = _equi_pair(c, left_syms, right_syms)
                if pair is not None:
                    criteria.append(pair)
                else:
                    residual_parts.append(c)
        node = JoinNode(jtype.lower(), left.node, right.node, criteria,
                        _and_all(residual_parts))
        return RelationPlan(node, scope)

    def plan_set_operation(self, rel: t.SetOperation) -> RelationPlan:
        op = rel.op.upper()
        if op in ("INTERSECT", "EXCEPT") and not rel.distinct:
            raise SemanticError(f"{op} ALL is not supported")
        left = self.plan_relation(rel.left)
        right = self.plan_relation(rel.right)
        lf, rf = left.scope.fields, right.scope.fields
        if len(lf) != len(rf):
            raise SemanticError(f"{op} children must have the same arity")
        types = [common_type(a.type, b.type) for a, b in zip(lf, rf)]
        # INTERSECT/EXCEPT desugar to union + marker counting (the reference's
        # ImplementIntersectAndExceptAsUnion rule, built directly): each side
        # contributes a 0/1 marker column, the union is grouped on the value
        # columns, and marker sums decide membership.
        markers = op != "UNION"
        sides = []
        for side_idx, (plan, fields) in enumerate(((left, lf), (right, rf))):
            assigns = []
            syms = []
            for f, tt in zip(fields, types):
                e = cast_to(symbol_ref(f.symbol.name, f.type), tt)
                s = f.symbol if isinstance(e, SymbolRef) else \
                    self.symbols.new_symbol(f.name or "col", tt)
                assigns.append((s, e))
                syms.append(s)
            node = plan.node
            if markers:
                for m in range(2):
                    ms = self.symbols.new_symbol(f"mark{m}", BIGINT)
                    assigns.append(
                        (ms, Constant(BIGINT, 1 if m == side_idx else 0)))
                    syms.append(ms)
                node = ProjectNode(node, assigns)
            elif any(not isinstance(e, SymbolRef) for _, e in assigns):
                node = ProjectNode(node, assigns)
            sides.append((node, syms))
        out_syms = [self.symbols.new_symbol(f.name or f"col{i}", tt)
                    for i, (f, tt) in enumerate(zip(lf, types))]
        union_syms = list(out_syms)
        if markers:
            union_syms = out_syms + [self.symbols.new_symbol("lmark", BIGINT),
                                     self.symbols.new_symbol("rmark", BIGINT)]
        union = UnionNode([n for n, _ in sides], union_syms,
                          [syms for _, syms in sides])
        node: PlanNode = union
        if markers:
            lc = self.symbols.new_symbol("lcount", BIGINT)
            rc = self.symbols.new_symbol("rcount", BIGINT)
            node = AggregationNode(node, out_syms, [
                (lc, AggregationCall("sum", (union_syms[-2],))),
                (rc, AggregationCall("sum", (union_syms[-1],)))])
            one = Constant(BIGINT, 1)
            lref = SymbolRef(BIGINT, lc.name)
            rref = SymbolRef(BIGINT, rc.name)
            have_left = Call(BOOLEAN, "greater_than_or_equal", (lref, one))
            right_pred = Call(BOOLEAN, "greater_than_or_equal", (rref, one)) \
                if op == "INTERSECT" else \
                Call(BOOLEAN, "equal", (rref, Constant(BIGINT, 0)))
            node = FilterNode(node, special("AND", BOOLEAN, have_left,
                                            right_pred))
            node = ProjectNode(
                node, [(s, SymbolRef(s.type, s.name)) for s in out_syms])
        elif rel.distinct:
            node = AggregationNode(node, out_syms, [])
        fields = [Field(f.name, s, None) for f, s in zip(lf, out_syms)]
        return RelationPlan(node, Scope(fields))

    # ------------------------------------------------------- query spec core

    def plan_query_spec(self, spec: t.QuerySpecification) -> RelationPlan:
        if spec.from_ is not None:
            source = self.plan_relation(spec.from_)
        else:
            source = RelationPlan(ValuesNode([], [[]]), Scope([]))

        # WHERE (with subquery conjunct planning)
        node, scope = source.node, source.scope
        node = self._plan_where(node, scope, spec.where)

        # expand stars into explicit select items
        select_items = self._expand_select(spec.select_items, scope)

        grouped = bool(spec.group_by) or \
            any(contains_aggregates(i.expression) for i in select_items) or \
            (spec.having is not None and contains_aggregates(spec.having))

        has_window = any(extract_windows(i.expression) for i in select_items)
        if has_window:
            if grouped:
                raise SemanticError(
                    "window functions over aggregated queries are not "
                    "supported yet — wrap the aggregation in a subquery")
            node, scope, select_items = self._plan_windows(node, scope,
                                                           select_items)

        if grouped:
            return self._plan_grouped(node, scope, spec, select_items)
        return self._plan_ungrouped(node, scope, spec, select_items)

    def _plan_windows(self, node: PlanNode, scope: Scope,
                      select_items: List[t.SelectItem]):
        """Plan SELECT-item window expressions into WindowNodes; each window
        expression is replaced by an identifier over its output symbol
        (sql/planner/WindowPlanner + QueryPlanner.window analogue)."""
        from .plan import WindowCall, WindowNode
        from ...types import BIGINT, DOUBLE

        wins: List[t.WindowExpression] = []
        for item in select_items:
            for w in extract_windows(item.expression):
                if w not in wins:
                    wins.append(w)

        tr = ExpressionTranslator(scope)
        pre_assigns: List[Tuple[Symbol, RowExpression]] = []
        pre_seen: Dict[str, Symbol] = {}
        for f in scope.fields:
            if f.symbol.name not in pre_seen:
                pre_seen[f.symbol.name] = f.symbol
                pre_assigns.append(
                    (f.symbol, symbol_ref(f.symbol.name, f.symbol.type)))

        def as_sym(ast: t.Expression, hint: str) -> Symbol:
            e = tr.translate(ast)
            if isinstance(e, SymbolRef):
                return Symbol(e.name, e.type)
            sym = self.symbols.new_symbol(hint, e.type)
            pre_assigns.append((sym, e))
            return sym

        spec_map: Dict[tuple, List] = {}
        mapping: Dict[t.Node, t.Node] = {}
        extra_fields: List[Field] = []
        for i, w in enumerate(wins):
            psyms = tuple(as_sym(p, "wpart") for p in w.window.partition_by)
            # same null-placement default as top-level ORDER BY: NULLs are
            # largest (nulls last ASC, nulls first DESC)
            ords = tuple(Ordering(as_sym(s.sort_key, "word"), s.descending,
                                  s.nulls_first if s.nulls_first is not None
                                  else s.descending)
                         for s in w.window.order_by)
            fname = w.call.name.lower()
            if w.call.distinct:
                raise SemanticError(
                    f"DISTINCT in window function {fname} is not supported")
            if w.call.filter is not None:
                raise SemanticError(
                    f"FILTER on window function {fname} is not supported")
            if fname in ("row_number", "rank", "dense_rank", "count", "ntile"):
                out_type = BIGINT
            elif fname in ("avg", "percent_rank", "cume_dist"):
                out_type = DOUBLE
            elif fname in ("sum", "min", "max", "lag", "lead",
                           "first_value", "last_value", "nth_value"):
                if not w.call.args:
                    raise SemanticError(f"{fname}() needs an argument")
                out_type = tr.translate(w.call.args[0]).type
            else:
                raise SemanticError(f"unknown window function {fname}")

            def literal_arg(ast, what):
                off = tr.translate(ast)
                if not isinstance(off, Constant) or off.value is None:
                    raise SemanticError(f"{fname} {what} must be a literal")
                return int(off.value)

            offset = 1
            value_args = list(w.call.args)
            if fname in ("lag", "lead"):
                if len(value_args) > 3:
                    raise SemanticError(f"{fname} takes at most 3 arguments")
                if len(value_args) == 3:
                    raise SemanticError(
                        f"{fname} default-value argument is not supported")
                if len(value_args) == 2:
                    offset = literal_arg(value_args[1], "offset")
                    value_args = value_args[:1]
            elif fname in ("percent_rank", "cume_dist"):
                if value_args:
                    raise SemanticError(f"{fname} takes no arguments")
            elif fname == "ntile":
                if len(value_args) != 1:
                    raise SemanticError("ntile takes exactly one argument")
                offset = literal_arg(value_args[0], "bucket count")
                if offset < 1:
                    raise SemanticError("ntile bucket count must be positive")
                value_args = []
            elif fname == "nth_value":
                if len(value_args) != 2:
                    raise SemanticError("nth_value takes exactly two arguments")
                offset = literal_arg(value_args[1], "position")
                if offset < 1:
                    raise SemanticError("nth_value position must be positive")
                value_args = value_args[:1]
            args = [as_sym(a, "warg") for a in value_args]
            if fname in ("rank", "dense_rank", "ntile", "percent_rank",
                         "cume_dist") and not ords:
                raise SemanticError(f"{fname}() requires ORDER BY in its "
                                    "window specification")
            wsym = self.symbols.new_symbol(fname, out_type)
            key = (psyms, ords, w.window.frame_mode)
            spec_map.setdefault(key, []).append(
                (wsym, WindowCall(fname, args, w.window.frame_mode, offset)))
            placeholder = f"$win{i}"
            mapping[w] = t.Identifier(placeholder)
            extra_fields.append(Field(placeholder, wsym, None))

        node = ProjectNode(node, pre_assigns)
        for (psyms, ords, fm), calls in spec_map.items():
            node = WindowNode(node, list(psyms), list(ords), calls)
        new_scope = Scope(scope.fields + extra_fields)
        new_items = []
        for i, item in enumerate(select_items):
            alias = item.alias or _name_of(item.expression, i)
            new_items.append(t.SelectItem(
                rewrite_ast(item.expression, mapping), alias))
        return node, new_scope, new_items

    def _expand_select(self, items: Sequence[t.SelectItem],
                       scope: Scope) -> List[t.SelectItem]:
        out = []
        for item in items:
            if isinstance(item.expression, t.Star):
                q = item.expression.qualifier
                q = q.lower() if q else None
                for f in scope.fields:
                    if (q is None or f.qualifier == q) and not f.hidden:
                        out.append(t.SelectItem(t.Identifier(f.name), f.name))
            else:
                out.append(item)
        return out

    def _plan_where(self, node: PlanNode, scope: Scope,
                    where: Optional[t.Expression]) -> PlanNode:
        plain: List[t.Expression] = []
        for conj in _conjuncts(where):
            planned = self._try_plan_subquery_conjunct(node, scope, conj)
            if planned is not None:
                node = planned
            else:
                plain.append(conj)
        if plain:
            tr = ExpressionTranslator(scope)
            pred = _and_all([tr.translate(c) for c in plain])
            node = FilterNode(node, pred)
        return node

    def _try_plan_subquery_conjunct(self, node: PlanNode, scope: Scope,
                                    conj: t.Expression) -> Optional[PlanNode]:
        """SubqueryPlanner analogue for WHERE conjuncts. Returns the new source node
        or None when the conjunct has no subquery."""
        negated = False
        inner = conj
        if isinstance(inner, t.NotExpression):
            negated, inner = True, inner.value

        # [NOT] IN (subquery)
        if isinstance(inner, t.InPredicate) and \
                isinstance(inner.value_list, t.SubqueryExpression):
            tr = ExpressionTranslator(scope)
            value = tr.translate(inner.value)
            sub = self.plan_query(inner.value_list.query)
            if len(sub.scope.fields) != 1:
                raise SemanticError("IN subquery must return one column")
            node, src_sym = self._as_symbol(node, value, "inkey")
            return SemiJoinNode(node, sub.node, src_sym,
                                sub.scope.fields[0].symbol, mark=None,
                                negated=negated, null_aware=True)

        # [NOT] EXISTS (subquery)
        if isinstance(inner, t.ExistsPredicate):
            sub_ast = inner.subquery.query
            corr = self._speculate(self._decorrelate_exists, node, scope,
                                   sub_ast, negated)
            if corr is not None:
                return corr
            try:
                self.plan_query(sub_ast)
            except SemanticError as e:
                if self._is_correlated_error(e, scope):
                    raise SemanticError(
                        "correlated EXISTS of this shape is not supported yet — "
                        "only outer=inner equality correlation is decorrelated "
                        f"({e})") from e
                raise
            raise SemanticError("uncorrelated EXISTS not yet supported")

        # scalar subquery comparison: x <op> (subquery)
        if isinstance(inner, t.ComparisonExpression) and not negated:
            for value_side, sub_side, flip in ((inner.left, inner.right, False),
                                               (inner.right, inner.left, True)):
                if isinstance(sub_side, t.SubqueryExpression):
                    return self._plan_scalar_compare(node, scope, value_side,
                                                    sub_side, inner.op, flip)
        if _contains_subquery(conj):
            raise SemanticError(f"unsupported subquery form: {conj}")
        return None

    def _plan_scalar_compare(self, node: PlanNode, scope: Scope,
                             value_ast: t.Expression, sub: t.SubqueryExpression,
                             op: str, flipped: bool) -> PlanNode:
        from ..analyzer import _CMP_NAMES
        dec = self._speculate(self._decorrelate_scalar_agg, node, scope, sub.query)
        if dec is not None:
            joined, val_sym = dec
            value = ExpressionTranslator(scope).translate(value_ast)
            sref = symbol_ref(val_sym.name, val_sym.type)
            left, right = (sref, value) if flipped else (value, sref)
            pred = Call(BOOLEAN, _CMP_NAMES[op], (left, right))
            return FilterNode(joined, pred)
        try:
            subplan = self.plan_query(sub.query)
        except SemanticError as e:
            if self._is_correlated_error(e, scope):
                raise SemanticError(
                    "correlated scalar subquery is not supported yet "
                    f"(outer reference: {e})") from e
            raise
        if len(subplan.scope.fields) != 1:
            raise SemanticError("scalar subquery must return one column")
        sub_sym = subplan.scope.fields[0].symbol
        enforced = EnforceSingleRowNode(subplan.node)
        joined = JoinNode("inner", node, enforced, [], None)
        tr = ExpressionTranslator(scope)
        value = tr.translate(value_ast)
        sref = symbol_ref(sub_sym.name, sub_sym.type)
        left, right = (sref, value) if flipped else (value, sref)
        from ..analyzer import _CMP_NAMES
        pred = Call(BOOLEAN, _CMP_NAMES[op], (left, right))
        return FilterNode(joined, pred)

    def _speculate(self, fn, *args):
        """Run a speculative decorrelation attempt; on bail-out (None) restore the
        symbol allocator so the discarded sub-plan doesn't consume names that the
        generic re-planning path would then uglify with _1 suffixes."""
        saved = dict(self.symbols._counts)
        out = fn(*args)
        if out is None:
            self.symbols._counts = saved
        return out

    def _decorrelate_scalar_agg(self, node: PlanNode, scope: Scope,
                                sub: t.Query) -> Optional[Tuple[PlanNode, Symbol]]:
        """Correlated scalar aggregate subquery (TPC-H Q2/Q17/Q20 shape):
        value <op> (SELECT f(agg(..)) FROM .. WHERE outer=inner [AND inner-only..])
        -> group the subquery by its correlation keys and inner-join the outer
        side on them (the reference's
        iterative/rule/TransformCorrelatedScalarAggregationToJoin.java).

        The inner join is exact here: a correlation key with no inner rows makes
        the scalar subquery yield NULL, and NULL satisfies no comparison, so
        dropping the key via the join matches. That argument fails for count-like
        aggregates (0 on empty input), which bail out to the generic error path."""
        if sub.with_ is not None or sub.order_by or sub.limit is not None:
            return None
        body = sub.body
        if not isinstance(body, t.QuerySpecification) or body.group_by or \
                body.having is not None or body.from_ is None or \
                len(body.select_items) != 1 or body.distinct:
            return None
        item = body.select_items[0]
        if not contains_aggregates(item.expression):
            return None
        aggs = extract_aggregates(item.expression)
        if any(a.name.lower() in ("count", "count_if") for a in aggs):
            return None
        # the inner-join argument also requires the select expression to be
        # NULL-strict in the aggregates: coalesce(sum(y), 0)-style wrappers give
        # empty groups a non-NULL value, which the join would wrongly drop
        if _contains_null_masking(item.expression):
            return None
        inner_plan = self.plan_relation(body.from_)
        inner_scope = inner_plan.scope
        corr_pairs: List[Tuple[RowExpression, Symbol]] = []
        inner_conjs: List[RowExpression] = []
        for conj in _conjuncts(body.where):
            # innermost scope wins: only a conjunct that does NOT resolve against
            # the subquery's own relations can be a correlation predicate
            try:
                inner_conjs.append(ExpressionTranslator(inner_scope).translate(conj))
                continue
            except SemanticError:
                pass
            pair = self._split_correlated_eq(conj, scope, inner_scope)
            if pair is not None:
                corr_pairs.append(pair)
                continue
            return None  # correlation shape we cannot decorrelate yet
        if not corr_pairs:
            return None  # uncorrelated: generic scalar path handles it
        inner_node = inner_plan.node
        pred = _and_all(inner_conjs)
        if pred is not None:
            inner_node = FilterNode(inner_node, pred)

        key_syms = [sym for _, sym in corr_pairs]
        tr = ExpressionTranslator(inner_scope)
        pre_assigns: List[Tuple[Symbol, RowExpression]] = []
        pre_index: Dict[RowExpression, Symbol] = {}

        def pre_project(e: RowExpression, hint: str) -> Symbol:
            if isinstance(e, SymbolRef):
                sym = Symbol(e.name, e.type)
            elif e in pre_index:
                return pre_index[e]
            else:
                sym = self.symbols.new_symbol(hint, e.type)
            if e not in pre_index:
                pre_index[e] = sym
                pre_assigns.append((sym, e))
            return sym

        for sym in key_syms:
            pre_project(symbol_ref(sym.name, sym.type), sym.name)
        ast_subst: Dict[t.Node, t.Node] = {}
        aggregations: List[Tuple[Symbol, AggregationCall]] = []
        post_fields: List[Field] = []
        for j, a in enumerate(aggs):
            if a in ast_subst:
                continue
            name = a.name.lower()
            params, value_args = _extract_agg_params(name, list(a.args), tr)
            arg_syms, arg_types = [], []
            for arg in value_args:
                ae = tr.translate(arg)
                arg_syms.append(pre_project(ae, _name_of(arg, j)))
                arg_types.append(ae.type)
            filt = None
            if a.filter is not None:
                filt = pre_project(tr.translate(a.filter), f"filter{j}")
            out_t = aggregate_output_type(name, arg_types)
            asym = self.symbols.new_symbol(name, out_t)
            aggregations.append(
                (asym, AggregationCall(name, tuple(arg_syms), a.distinct, filt,
                                       params)))
            marker = f"$cagg{j}"
            ast_subst[a] = t.Identifier(marker)
            post_fields.append(Field(marker, asym, None))

        agg = AggregationNode(ProjectNode(inner_node, pre_assigns), key_syms,
                              aggregations)
        post_tr = ExpressionTranslator(Scope(post_fields))
        val_expr = post_tr.translate(rewrite_ast(item.expression, ast_subst))
        val_sym = self.symbols.new_symbol("subqval", val_expr.type)
        assigns = [(s, symbol_ref(s.name, s.type)) for s in key_syms]
        assigns.append((val_sym, val_expr))
        sub_node: PlanNode = ProjectNode(agg, assigns)

        criteria: List[Tuple[Symbol, Symbol]] = []
        for outer_expr, inner_sym in corr_pairs:
            node, osym = self._as_symbol(node, outer_expr, "corrkey")
            criteria.append((osym, inner_sym))
        return JoinNode("inner", node, sub_node, criteria, None), val_sym

    def _decorrelate_exists(self, node: PlanNode, scope: Scope, sub: t.Query,
                            negated: bool) -> Optional[PlanNode]:
        """Correlated EXISTS where the subquery's WHERE contains outer = inner
        equi-conjuncts (TPC-H Q4/Q21/Q22 shape) -> SemiJoin on the correlation key."""
        body = sub.body
        if not isinstance(body, t.QuerySpecification) or body.group_by or \
                body.having is not None or body.from_ is None:
            return None
        inner_plan = self.plan_relation(body.from_)
        inner_scope = inner_plan.scope
        corr_pairs: List[Tuple[RowExpression, Symbol]] = []  # (outer expr, inner sym)
        inner_conjs: List[RowExpression] = []
        residual_parts: List[RowExpression] = []  # over outer+inner symbols
        for conj in _conjuncts(body.where):
            # innermost scope wins (same rule as _decorrelate_scalar_agg)
            try:
                inner_conjs.append(ExpressionTranslator(inner_scope).translate(conj))
                continue
            except SemanticError:
                pass
            pair = self._split_correlated_eq(conj, scope, inner_scope)
            if pair is not None:
                corr_pairs.append(pair)
                continue
            # general correlated conjunct (e.g. Q21's l2.l_suppkey <> l1.l_suppkey):
            # keep as a semi-join residual evaluated per (source,filtering) pair
            try:
                combined = ExpressionTranslator(
                    Scope(list(scope.fields) + list(inner_scope.fields)))
                residual_parts.append(combined.translate(conj))
            except SemanticError:
                return None  # correlation shape we cannot decorrelate yet
        if not corr_pairs:
            return None
        inner_node = inner_plan.node
        pred = _and_all(inner_conjs)
        if pred is not None:
            inner_node = FilterNode(inner_node, pred)
        if len(corr_pairs) != 1:
            # multi-key correlation: combine via projection on both sides later rev
            return None
        outer_expr, inner_sym = corr_pairs[0]
        node, src_sym = self._as_symbol(node, outer_expr, "existskey")
        # EXISTS ignores NULL-key three-valued subtleties (no membership marker)
        return SemiJoinNode(node, inner_node, src_sym, inner_sym, mark=None,
                            negated=negated, null_aware=False,
                            residual=_and_all(residual_parts))

    @staticmethod
    def _is_correlated_error(e: SemanticError, outer: Scope) -> bool:
        """Did a standalone subquery plan fail on a column the OUTER scope knows?

        Structural: UnresolvedColumnError carries the identifier (SQL semantics
        make any inner-unresolved name that the outer scope CAN resolve a
        correlated reference)."""
        from ..analyzer import UnresolvedColumnError
        return (isinstance(e, UnresolvedColumnError)
                and outer.try_resolve(e.name, e.qualifier) is not None)

    def _split_correlated_eq(self, conj: t.Expression, outer: Scope,
                             inner: Scope) -> Optional[Tuple[RowExpression, Symbol]]:
        if not (isinstance(conj, t.ComparisonExpression) and conj.op == "="):
            return None
        for a, b in ((conj.left, conj.right), (conj.right, conj.left)):
            try:
                ae = ExpressionTranslator(inner).translate(a)
            except SemanticError:
                continue
            if not isinstance(ae, SymbolRef):
                continue
            try:
                be = ExpressionTranslator(outer).translate(b)
            except SemanticError:
                continue
            return (be, Symbol(ae.name, ae.type))
        return None

    def _as_symbol(self, node: PlanNode, expr: RowExpression,
                   hint: str) -> Tuple[PlanNode, Symbol]:
        if isinstance(expr, SymbolRef):
            return node, Symbol(expr.name, expr.type)
        sym = self.symbols.new_symbol(hint, expr.type)
        assigns = [(s, symbol_ref(s.name, s.type)) for s in node.outputs()]
        assigns.append((sym, expr))
        return ProjectNode(node, assigns), sym

    # --------------------------------------------------------- ungrouped

    def _plan_ungrouped(self, node: PlanNode, scope: Scope,
                        spec: t.QuerySpecification,
                        select_items: List[t.SelectItem]) -> RelationPlan:
        assigns: List[Tuple[Symbol, RowExpression]] = []
        out_fields: List[Field] = []
        tr = ExpressionTranslator(scope)
        for i, item in enumerate(select_items):
            e = tr.translate(item.expression)
            name = item.alias.lower() if item.alias else _name_of(item.expression, i)
            if isinstance(e, SymbolRef):
                sym = Symbol(e.name, e.type)
            else:
                sym = self.symbols.new_symbol(name, e.type)
            assigns.append((sym, e))
            out_fields.append(Field(name, sym, None))
        proj = ProjectNode(node, assigns)
        out = RelationPlan(proj, Scope(out_fields))
        if spec.distinct:
            out = RelationPlan(
                AggregationNode(out.node, [f.symbol for f in out_fields], []),
                out.scope)
        return self._plan_order_limit(out, spec.order_by, spec.limit,
                                      pre_scope=scope, select_items=select_items,
                                      pre_node=node)

    # ----------------------------------------------------------- grouped

    def _plan_grouped(self, node: PlanNode, scope: Scope,
                      spec: t.QuerySpecification,
                      select_items: List[t.SelectItem]) -> RelationPlan:
        tr = ExpressionTranslator(scope)

        # resolve group-by expressions (ordinals + select aliases allowed)
        key_asts: List[t.Expression] = []
        for g in spec.group_by:
            if isinstance(g, t.LongLiteral):
                if not 1 <= g.value <= len(select_items):
                    raise SemanticError(
                        f"GROUP BY position {g.value} is not in select list "
                        f"(1..{len(select_items)})")
                key_asts.append(select_items[g.value - 1].expression)
                continue
            if isinstance(g, t.Identifier) and scope.try_resolve(g.name.lower()) is None:
                match = [i for i in select_items
                         if i.alias and i.alias.lower() == g.name.lower()]
                if match:
                    key_asts.append(match[0].expression)
                    continue
            key_asts.append(g)

        pre_assigns: List[Tuple[Symbol, RowExpression]] = []
        pre_index: Dict[RowExpression, Symbol] = {}

        def pre_project(e: RowExpression, hint: str) -> Symbol:
            if isinstance(e, SymbolRef):
                sym = Symbol(e.name, e.type)
                if e not in pre_index:
                    pre_index[e] = sym
                    pre_assigns.append((sym, e))
                return sym
            if e in pre_index:
                return pre_index[e]
            sym = self.symbols.new_symbol(hint, e.type)
            pre_index[e] = sym
            pre_assigns.append((sym, e))
            return sym

        # group keys
        ast_subst: Dict[t.Node, t.Node] = {}
        post_fields: List[Field] = []
        key_syms: List[Symbol] = []
        for i, ka in enumerate(key_asts):
            e = tr.translate(ka)
            sym = pre_project(e, _name_of(ka, i))
            key_syms.append(sym)
            marker = f"$gk{i}"
            ast_subst[ka] = t.Identifier(marker)
            post_fields.append(Field(marker, sym, None))
            if isinstance(ka, t.Identifier):
                post_fields.append(Field(ka.name.lower(), sym, None))
            elif isinstance(ka, t.DereferenceExpression) and \
                    isinstance(ka.base, t.Identifier):
                post_fields.append(
                    Field(ka.field.lower(), sym, ka.base.name.lower()))

        # aggregates from select + having + order by
        agg_asts: List[t.FunctionCall] = []
        sources = [i.expression for i in select_items]
        if spec.having is not None:
            sources.append(spec.having)
        for s in spec.order_by:
            sources.append(s.sort_key)
        for src in sources:
            for a in extract_aggregates(src):
                if a not in ast_subst:
                    agg_asts.append(a)

        # grouping(key) markers: 0 when the key is present in a branch's
        # grouping set, 1 otherwise (GroupingOperationRewriter analogue)
        grouping_markers: List[Tuple[Symbol, int]] = []
        for src in sources:
            for g in _find_grouping_calls(src):
                if g in ast_subst:
                    continue
                if len(g.args) != 1 or g.args[0] not in key_asts:
                    raise SemanticError(
                        "grouping() takes exactly one grouping-key expression")
                key_idx = key_asts.index(g.args[0])
                gsym = self.symbols.new_symbol("grouping", BIGINT)
                ast_subst[g] = t.Identifier(f"$grouping{len(grouping_markers)}")
                post_fields.append(
                    Field(f"$grouping{len(grouping_markers)}", gsym, None))
                grouping_markers.append((gsym, key_idx))

        aggregations: List[Tuple[Symbol, AggregationCall]] = []
        for j, a in enumerate(agg_asts):
            if a in ast_subst:
                continue
            name = a.name.lower()
            params, value_args = _extract_agg_params(name, list(a.args), tr)
            arg_syms = []
            arg_types = []
            for arg in value_args:
                ae = tr.translate(arg)
                arg_syms.append(pre_project(ae, _name_of(arg, j)))
                arg_types.append(ae.type)
            filt = None
            if a.filter is not None:
                fe = tr.translate(a.filter)
                filt = pre_project(fe, f"filter{j}")
            out_t = aggregate_output_type(name, arg_types)
            sym = self.symbols.new_symbol(name, out_t)
            aggregations.append(
                (sym, AggregationCall(name, tuple(arg_syms), a.distinct, filt,
                                      params)))
            marker = f"$agg{j}"
            ast_subst[a] = t.Identifier(marker)
            post_fields.append(Field(marker, sym, None))

        pre = ProjectNode(node, pre_assigns)
        gsets = spec.grouping_sets
        full = tuple(range(len(key_syms)))
        if gsets is None or tuple(gsets) == (full,):
            agg: PlanNode = AggregationNode(pre, key_syms, aggregations)
            if grouping_markers:  # plain GROUP BY: grouping() is always 0
                agg = ProjectNode(agg, [
                    (s, SymbolRef(s.type, s.name))
                    for s in key_syms + [a for a, _ in aggregations]
                ] + [(gs, Constant(BIGINT, 0)) for gs, _ in grouping_markers])
        else:
            # GROUPING SETS / ROLLUP / CUBE: one aggregation per set over the
            # shared pre-projected source, absent keys padded with typed
            # NULLs, branches concatenated (the reference plans a GroupIdNode
            # + single agg; the union form trades one extra source pass per
            # set for zero new operator kinds — sets are few in practice)
            agg_out = [s for s, _ in aggregations]
            union_syms = key_syms + [gs for gs, _ in grouping_markers] + agg_out
            branches: List[PlanNode] = []
            for sset in gsets:
                present = set(sset)
                agg_b = AggregationNode(
                    pre, [key_syms[i] for i in sset], aggregations)
                assigns_b: List[Tuple[Symbol, RowExpression]] = []
                for i, ks in enumerate(key_syms):
                    assigns_b.append(
                        (ks, SymbolRef(ks.type, ks.name) if i in present
                         else Constant(ks.type, None)))
                for gs, key_idx in grouping_markers:
                    assigns_b.append(
                        (gs, Constant(BIGINT, 0 if key_idx in present else 1)))
                for s in agg_out:
                    assigns_b.append((s, SymbolRef(s.type, s.name)))
                branches.append(ProjectNode(agg_b, assigns_b))
            agg = UnionNode(branches, union_syms,
                            [list(union_syms)] * len(branches))
        post_scope = Scope(post_fields)
        node2: PlanNode = agg

        if spec.having is not None:
            h_ast = rewrite_ast(spec.having, ast_subst)
            node2 = self._plan_where(node2, post_scope, h_ast)

        # output projection
        post_tr = ExpressionTranslator(post_scope)
        assigns: List[Tuple[Symbol, RowExpression]] = []
        out_fields: List[Field] = []
        rewritten_items: List[t.SelectItem] = []
        for i, item in enumerate(select_items):
            ast = rewrite_ast(item.expression, ast_subst)
            rewritten_items.append(t.SelectItem(ast, item.alias))
            e = post_tr.translate(ast)
            name = item.alias.lower() if item.alias else _name_of(item.expression, i)
            if isinstance(e, SymbolRef):
                sym = Symbol(e.name, e.type)
            else:
                sym = self.symbols.new_symbol(name, e.type)
            assigns.append((sym, e))
            out_fields.append(Field(name, sym, None))
        proj = ProjectNode(node2, assigns)
        out = RelationPlan(proj, Scope(out_fields))
        if spec.distinct:
            out = RelationPlan(
                AggregationNode(out.node, [f.symbol for f in out_fields], []),
                out.scope)
        order_by = tuple(t.SortItem(rewrite_ast(s.sort_key, ast_subst),
                                    s.descending, s.nulls_first)
                         for s in spec.order_by)
        return self._plan_order_limit(out, order_by, spec.limit,
                                      pre_scope=post_scope,
                                      select_items=rewritten_items,
                                      pre_node=node2)

    # ------------------------------------------------------ order/limit

    def _plan_order_limit(self, out: RelationPlan,
                          order_by: Sequence[t.SortItem], limit: Optional[int],
                          pre_scope: Optional[Scope] = None,
                          select_items: Optional[List[t.SelectItem]] = None,
                          pre_node: Optional[PlanNode] = None) -> RelationPlan:
        node = out.node
        if order_by:
            orderings = []
            extra_assigns: List[Tuple[Symbol, RowExpression]] = []
            out_syms = {f.symbol.name for f in out.scope.fields}
            for s in order_by:
                sym = self._resolve_sort_key(s.sort_key, out, select_items,
                                             pre_scope)
                if sym is None:
                    # expression over the pre-projection scope: hidden sort column
                    if pre_scope is None:
                        raise SemanticError(f"cannot order by {s.sort_key}")
                    e = ExpressionTranslator(pre_scope).translate(s.sort_key)
                    sym = self.symbols.new_symbol("sortkey", e.type)
                    extra_assigns.append((sym, e))
                nf = s.nulls_first if s.nulls_first is not None else s.descending
                orderings.append(Ordering(sym, s.descending, nf))
            if extra_assigns:
                # widen the output projection with hidden sort symbols
                if not isinstance(node, ProjectNode):
                    raise SemanticError("hidden sort keys need a projection root")
                node = ProjectNode(node.source,
                                   list(node.assignments) + extra_assigns)
            node = SortNode(node, orderings)
            if extra_assigns:
                keep = [(f.symbol, symbol_ref(f.symbol.name, f.symbol.type))
                        for f in out.scope.fields]
                node = ProjectNode(node, keep)
        if limit is not None:
            node = LimitNode(node, limit)
        return RelationPlan(node, out.scope)

    def _resolve_sort_key(self, key: t.Expression, out: RelationPlan,
                          select_items: Optional[List[t.SelectItem]],
                          pre_scope: Optional[Scope]) -> Optional[Symbol]:
        fields = out.scope.fields
        if isinstance(key, t.LongLiteral):
            if not 1 <= key.value <= len(fields):
                raise SemanticError(
                    f"ORDER BY position {key.value} is not in select list "
                    f"(1..{len(fields)})")
            return fields[key.value - 1].symbol
        if isinstance(key, t.Identifier):
            n = key.name.lower()
            for f in fields:
                if f.name == n:
                    return f.symbol
        if select_items is not None:
            for i, item in enumerate(select_items):
                if item.expression == key:
                    return fields[i].symbol
        # try translating against the output scope (plain column passthrough)
        try:
            e = ExpressionTranslator(out.scope).translate(key)
            if isinstance(e, SymbolRef):
                return Symbol(e.name, e.type)
        except SemanticError:
            pass
        return None


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _equi_pair(expr: RowExpression, left_syms: set,
               right_syms: set) -> Optional[Tuple[Symbol, Symbol]]:
    if not (isinstance(expr, Call) and expr.name == "equal"):
        return None
    a, b = expr.args
    if not (isinstance(a, SymbolRef) and isinstance(b, SymbolRef)):
        return None
    if a.name in left_syms and b.name in right_syms:
        return (Symbol(a.name, a.type), Symbol(b.name, b.type))
    if b.name in left_syms and a.name in right_syms:
        return (Symbol(b.name, b.type), Symbol(a.name, a.type))
    return None


def _contains_null_masking(node: t.Node) -> bool:
    """Does the expression contain a construct that can map NULL to non-NULL
    (COALESCE / CASE / IS [NOT] NULL)? Such expressions are not NULL-strict, so
    scalar-agg decorrelation via inner join is unsound for them."""
    if isinstance(node, (t.CoalesceExpression, t.SearchedCaseExpression,
                         t.SimpleCaseExpression, t.IsNullPredicate,
                         t.IsNotNullPredicate)):
        return True
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if isinstance(v, t.Node) and _contains_null_masking(v):
            return True
        if isinstance(v, tuple):
            for x in v:
                if isinstance(x, t.Node) and _contains_null_masking(x):
                    return True
    return False


def _contains_subquery(node: t.Node) -> bool:
    if isinstance(node, (t.SubqueryExpression, t.ExistsPredicate)):
        return True
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if isinstance(v, t.Node) and _contains_subquery(v):
            return True
        if isinstance(v, tuple):
            for x in v:
                if isinstance(x, t.Node) and _contains_subquery(x):
                    return True
    return False


def _name_of(expr: t.Expression, i: int) -> str:
    if isinstance(expr, t.Identifier):
        return expr.name.lower()
    if isinstance(expr, t.DereferenceExpression):
        return expr.field.lower()
    if isinstance(expr, t.FunctionCall):
        return expr.name.lower()
    return f"_col{i}"


def _find_grouping_calls(ast: t.Node) -> List[t.FunctionCall]:
    """All grouping(...) calls in an expression tree. Shares the analyzer's
    child walk and, like extract_aggregates/extract_windows, does NOT descend
    into subqueries (an inner query's grouping() belongs to that query)."""
    from ..analyzer import _ast_children

    out: List[t.FunctionCall] = []

    def walk(n):
        if isinstance(n, t.FunctionCall) and n.name.lower() == "grouping":
            out.append(n)
            return
        if isinstance(n, (t.SubqueryExpression, t.WindowExpression)):
            return
        for c in _ast_children(n):
            walk(c)

    walk(ast)
    return out


def _extract_agg_params(name: str, value_args: list, tr) -> Tuple[Tuple, list]:
    """Pull literal (non-column) aggregate parameters out of the argument list
    (approx_percentile's fraction), validating at ANALYSIS time so users get a
    SemanticError rather than an internal error from the exchange planner."""
    if name != "approx_percentile":
        return (), value_args
    if len(value_args) != 2:
        raise SemanticError("approx_percentile takes (value, fraction)")
    frac = tr.translate(value_args[1])
    if not isinstance(frac, Constant) or frac.value is None:
        raise SemanticError("approx_percentile fraction must be a literal")
    v = frac.value
    if isinstance(frac.type, DecimalType):
        v = v / 10 ** frac.type.scale
    v = float(v)
    if not 0.0 < v <= 1.0:
        raise SemanticError("approx_percentile fraction must be in (0, 1]")
    return (v,), value_args[:1]
