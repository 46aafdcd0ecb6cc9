"""Iterative rule-based optimizer: pattern -> rule -> fixpoint.

The PyTorch port's copy of ``presto_tpu/sql/planner/iterative.py`` (plain Python, no torch): the
port keeps its own front end so that it imports nothing of ``presto_tpu``.

Analogue of the reference's rule engine — sql/planner/iterative/
IterativeOptimizer.java:50 driving rules from iterative/rule/ against a Memo,
with patterns from presto-matching (matching/Pattern.java). Re-designed lean:
plans here are small trees (no memo groups needed), so the engine rewrites the
tree bottom-up and loops to a fixpoint with a hard iteration bound. Each Rule
declares a Pattern (node type + optional predicates, optionally over a child)
and an apply() that returns a replacement subtree or None.

The rules migrated from the previous fixed passes (each names its reference
counterpart in iterative/rule/):
  MergeAdjacentFilters         (MergeFilters.java)
  MergeAdjacentProjects        (MergeAdjacentProjects — via InlineProjections)
  MergeLimitWithSort           (MergeLimitWithSort.java -> TopNNode)
  MergeAdjacentLimits          (MergeLimits.java)
  PushLimitThroughProject      (PushLimitThroughProject.java)
  RemoveTrivialFilter          (RemoveTrivialFilters.java)
  EvaluateEmptyLimit           (EvaluateZeroLimit.java)
  RemoveIdentityProject        (RemoveRedundantIdentityProjections.java)
  MergeTopNWithSort            (sort under an existing TopN is redundant)
  PushTopNThroughProject       (PushTopNThroughProject.java)
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

from ...ops.expressions import (Constant, RowExpression, SymbolRef,
                                rewrite_expression, symbols_in)
from .plan import (FilterNode, LimitNode, PlanNode, ProjectNode, SortNode,
                   TopNNode, ValuesNode, rewrite_plan)


# ---------------------------------------------------------------------------
# patterns (presto-matching Pattern.java, lean)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Pattern:
    """Matches a node by type, optional predicate, optional source pattern."""

    node_type: type
    where: Optional[Callable[[PlanNode], bool]] = None
    source: Optional["Pattern"] = None

    def matches(self, node: PlanNode) -> bool:
        if not isinstance(node, self.node_type):
            return False
        if self.where is not None and not self.where(node):
            return False
        if self.source is not None:
            children = node.children()
            if len(children) != 1 or not self.source.matches(children[0]):
                return False
        return True

    def with_source(self, source: "Pattern") -> "Pattern":
        return Pattern(self.node_type, self.where, source)


def node(node_type: type, where=None, source: Optional[Pattern] = None
         ) -> Pattern:
    return Pattern(node_type, where, source)


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------

class Rule:
    """One rewrite: pattern + apply(node, context) -> replacement | None."""

    pattern: Pattern

    def apply(self, n: PlanNode, context: "RuleContext") -> Optional[PlanNode]:
        raise NotImplementedError


@dataclasses.dataclass
class RuleContext:
    """What rules may consult: stats + session (CostCalculator rides here)."""

    metadata: object = None
    session: object = None


class IterativeOptimizer:
    """Fixpoint driver: bottom-up sweeps until no rule fires (bounded)."""

    def __init__(self, rules: Sequence[Rule], max_iterations: int = 20):
        self.rules = list(rules)
        self.max_iterations = max_iterations

    def optimize(self, plan: PlanNode, context: Optional[RuleContext] = None
                 ) -> PlanNode:
        context = context or RuleContext()
        for _ in range(self.max_iterations):
            fired = [False]

            def visit(n: PlanNode) -> Optional[PlanNode]:
                for rule in self.rules:
                    if rule.pattern.matches(n):
                        out = rule.apply(n, context)
                        if out is not None and out is not n:
                            fired[0] = True
                            return out
                return None

            plan = rewrite_plan(plan, visit)
            if not fired[0]:
                return plan
        return plan


# ---------------------------------------------------------------------------
# the migrated rules
# ---------------------------------------------------------------------------

def _and(a: RowExpression, b: RowExpression) -> RowExpression:
    from ...ops.expressions import special
    from ...types import BOOLEAN

    return special("AND", BOOLEAN, a, b)


class MergeAdjacentFilters(Rule):
    pattern = node(FilterNode, source=node(FilterNode))

    def apply(self, n, ctx):
        inner = n.source
        return FilterNode(inner.source, _and(inner.predicate, n.predicate))


_CMP_OPS = {"equal": lambda a, b: a == b,
            "not_equal": lambda a, b: a != b,
            "less_than": lambda a, b: a < b,
            "less_than_or_equal": lambda a, b: a <= b,
            "greater_than": lambda a, b: a > b,
            "greater_than_or_equal": lambda a, b: a >= b}

_ARITH_OPS = {"add": lambda a, b: a + b,
              "subtract": lambda a, b: a - b,
              "multiply": lambda a, b: a * b}


def fold_constants(e: RowExpression) -> RowExpression:
    """Constant-fold comparisons/arithmetic/boolean forms over literal args
    (the SimplifyExpressions rule's core — sql/planner/iterative/rule/
    SimplifyExpressions.java over our IR)."""
    from ...ops.expressions import Call, SpecialForm
    from ...types import BOOLEAN

    def visit(x):
        if isinstance(x, Call) and len(x.args) == 2 and \
                all(isinstance(a, Constant) and a.value is not None
                    for a in x.args):
            a, b = (arg.value for arg in x.args)
            if x.name in _CMP_OPS and type(a) is type(b):
                return Constant(BOOLEAN, _CMP_OPS[x.name](a, b))
            if x.name in _CMP_OPS and isinstance(a, (int, float)) and \
                    isinstance(b, (int, float)):
                return Constant(BOOLEAN, _CMP_OPS[x.name](a, b))
            if x.name in _ARITH_OPS and isinstance(a, (int, float)) and \
                    isinstance(b, (int, float)):
                return Constant(x.type, _ARITH_OPS[x.name](a, b))
        if isinstance(x, SpecialForm) and x.form in ("AND", "OR"):
            vals = [a.value for a in x.args if isinstance(a, Constant)]
            others = [a for a in x.args if not isinstance(a, Constant)]
            if x.form == "AND":
                if any(v is False for v in vals):
                    return Constant(BOOLEAN, False)
                if len(others) == 0:
                    return Constant(BOOLEAN, True)
                if len(others) == 1 and len(vals) == len(x.args) - 1:
                    return others[0]
            else:
                if any(v is True for v in vals):
                    return Constant(BOOLEAN, True)
                if len(others) == 0:
                    return Constant(BOOLEAN, False)
                if len(others) == 1 and len(vals) == len(x.args) - 1:
                    return others[0]
        if isinstance(x, SpecialForm) and x.form == "NOT" and \
                isinstance(x.args[0], Constant) and \
                isinstance(x.args[0].value, bool):
            return Constant(BOOLEAN, not x.args[0].value)
        return None

    return rewrite_expression(e, visit)


class SimplifyFilterPredicate(Rule):
    """Fold the filter predicate; trivial outcomes then fire
    RemoveTrivialFilter on the next sweep (SimplifyExpressions.java)."""

    pattern = node(FilterNode)

    def apply(self, n, ctx):
        folded = fold_constants(n.predicate)
        if folded == n.predicate:
            return None
        return FilterNode(n.source, folded)


class RemoveTrivialFilter(Rule):
    pattern = node(FilterNode,
                   where=lambda n: isinstance(n.predicate, Constant))

    def apply(self, n, ctx):
        if n.predicate.value is True:
            return n.source
        if n.predicate.value in (False, None):
            syms = n.outputs()
            return ValuesNode(list(syms), [])
        return None


class MergeLimitWithSort(Rule):
    pattern = node(LimitNode, source=node(SortNode))

    def apply(self, n, ctx):
        return TopNNode(n.source.source, n.count, n.source.orderings)


class MergeTopNWithSort(Rule):
    """TopN over Sort: the inner sort is redundant (TopN re-sorts)."""

    pattern = node(TopNNode, source=node(SortNode))

    def apply(self, n, ctx):
        return TopNNode(n.source.source, n.count, n.orderings)


class MergeAdjacentLimits(Rule):
    pattern = node(LimitNode, source=node(LimitNode))

    def apply(self, n, ctx):
        return LimitNode(n.source.source, min(n.count, n.source.count))


class EvaluateEmptyLimit(Rule):
    pattern = node(LimitNode, where=lambda n: n.count == 0)

    def apply(self, n, ctx):
        return ValuesNode(list(n.outputs()), [])


class PushLimitThroughProject(Rule):
    pattern = node(LimitNode, source=node(ProjectNode))

    def apply(self, n, ctx):
        proj = n.source
        return ProjectNode(LimitNode(proj.source, n.count), proj.assignments)


class PushTopNThroughProject(Rule):
    """TopN over a renaming-only Project commutes (orderings re-mapped)."""

    pattern = node(TopNNode, source=node(
        ProjectNode,
        where=lambda p: all(isinstance(e, SymbolRef)
                            for _, e in p.assignments)))

    def apply(self, n, ctx):
        proj = n.source
        mapping = {s.name: e.name for s, e in proj.assignments}
        if any(o.symbol.name not in mapping for o in n.orderings):
            return None
        from .plan import Ordering, Symbol

        orderings = [Ordering(Symbol(mapping[o.symbol.name], o.symbol.type),
                              o.descending, o.nulls_first)
                     for o in n.orderings]
        return ProjectNode(TopNNode(proj.source, n.count, orderings),
                           proj.assignments)


class MergeAdjacentProjects(Rule):
    """Project(Project(x)) -> one Project with inner expressions inlined."""

    pattern = node(ProjectNode, source=node(ProjectNode))

    def apply(self, n, ctx):
        inner = n.source
        inner_map = {s.name: e for s, e in inner.assignments}
        # only inline when every outer reference resolves in the inner map and
        # no inner expression would be duplicated into a non-trivial context
        refs = set()
        for _, e in n.assignments:
            refs |= symbols_in(e)
        if not refs <= set(inner_map):
            return None
        # count references: duplicating a non-symbol expression re-computes it
        counts = {}
        for _, e in n.assignments:
            for s in symbols_in(e):
                counts[s] = counts.get(s, 0) + 1
        for name, cnt in counts.items():
            if cnt > 1 and not isinstance(inner_map[name], SymbolRef):
                return None

        def subst(e):
            def visit(x):
                if isinstance(x, SymbolRef):
                    return inner_map[x.name]
                return None
            return rewrite_expression(e, visit)

        return ProjectNode(inner.source,
                           [(s, subst(e)) for s, e in n.assignments])


class RemoveIdentityProject(Rule):
    pattern = node(ProjectNode, where=lambda n: (
        len(n.assignments) == len(n.source.outputs()) and
        all(isinstance(e, SymbolRef) and e.name == s.name
            for s, e in n.assignments) and
        [s.name for s, _ in n.assignments] ==
        [s.name for s in n.source.outputs()]))

    def apply(self, n, ctx):
        return n.source


DEFAULT_RULES: List[Rule] = [
    MergeAdjacentFilters(),
    SimplifyFilterPredicate(),
    RemoveTrivialFilter(),
    MergeLimitWithSort(),
    MergeTopNWithSort(),
    MergeAdjacentLimits(),
    EvaluateEmptyLimit(),
    PushLimitThroughProject(),
    PushTopNThroughProject(),
    MergeAdjacentProjects(),
    RemoveIdentityProject(),
]
