"""Semantic analysis: scopes, name resolution, expression typing + translation.

The PyTorch port's copy of ``presto_tpu/sql/analyzer.py`` (plain Python, no torch): the
port keeps its own front end so that it imports nothing of ``presto_tpu``.

Analogue of presto-main sql/analyzer/ (StatementAnalyzer.java:217,
ExpressionAnalyzer.java, Scope/RelationType/Field) fused with the reference's
sql/relational/SqlToRowExpressionTranslator: instead of producing an annotated AST
and translating later, `ExpressionTranslator` resolves names against a `Scope`,
types every node, inserts coercions, and emits RowExpressions over SymbolRef in one
pass. The planner (sql/planner/planner.py) owns statement-level structure.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..ops.expressions import (Call, Constant, RowExpression, SpecialForm, SymbolRef,
                               arithmetic_result_type, days_from_civil, special,
                               symbol_ref)
from ..types import (BIGINT, BOOLEAN, DATE, DOUBLE, INTEGER, REAL, SMALLINT,
                     TIMESTAMP, Type,
                     UNKNOWN, VARCHAR, DecimalType, is_floating, is_integral,
                     is_numeric, is_string)
from . import tree as t
from .planner.plan import Symbol

AGGREGATE_NAMES = {"count", "sum", "avg", "min", "max", "stddev", "stddev_samp",
                   "stddev_pop", "variance", "var_samp", "var_pop", "corr",
                   "covar_samp", "covar_pop", "approx_distinct", "count_if",
                   "bool_and", "bool_or", "every", "arbitrary", "any_value",
                   "approx_percentile", "min_by", "max_by",
                   "array_agg", "map_agg", "histogram"}

# pluggable scalar functions (the FunctionManager/function-namespace
# analogue, metadata/FunctionManager.java): plugin modules register a typer
# `(name, args) -> RowExpression` here; ops/expressions.py holds the
# matching compiler registry. presto_tpu.functions.* self-register on import.
EXTERNAL_FUNCTIONS: Dict[str, "Callable"] = {}


# every scalar function of the reference's plugin libraries
# (presto_tpu/functions/): geospatial, teradata and ml
PLUGIN_FUNCTIONS = frozenset({
    "st_point", "st_geometryfromtext", "st_geometry_from_text", "st_x", "st_y",
    "st_distance", "st_contains", "st_within", "st_area", "great_circle_distance",
    "index", "strpos", "char2hexint", "reverse", "trim", "ltrim", "rtrim",
    "char_length", "character_length", "regress", "classify"})


def register_scalar_function(name: str, typer) -> None:
    EXTERNAL_FUNCTIONS[name.lower()] = typer  # prestocheck: ignore[unbounded-cache] - plugin registry: one entry per registered function, not per request


def register_aggregate_name(name: str, output_typer=None) -> None:
    """Route `name(...)` through aggregation planning (pair with
    ops/aggregates.register_aggregate, which supplies the resolver).
    `output_typer(arg_types) -> Type` feeds aggregate_output_type."""
    AGGREGATE_NAMES.add(name.lower())
    if output_typer is not None:
        EXTERNAL_AGGREGATE_TYPES[name.lower()] = output_typer  # prestocheck: ignore[unbounded-cache] - plugin registry, bounded by plugin count


_ARITH_NAMES = {"+": "add", "-": "subtract", "*": "multiply", "/": "divide",
                "%": "modulus"}
_CMP_NAMES = {"=": "equal", "<>": "not_equal", "!=": "not_equal", "<": "less_than",
              "<=": "less_than_or_equal", ">": "greater_than",
              ">=": "greater_than_or_equal"}


class SemanticError(Exception):
    pass


class AmbiguousColumnError(SemanticError):
    pass


class UnresolvedColumnError(SemanticError):
    """Structured resolution failure: carries the identifier so callers (the
    subquery planner's correlation check) need not parse the message."""

    def __init__(self, name: str, qualifier: Optional[str] = None):
        q = f"{qualifier}." if qualifier else ""
        super().__init__(f"column '{q}{name}' cannot be resolved")
        self.name = name
        self.qualifier = qualifier


@dataclasses.dataclass(frozen=True)
class Field:
    """analyzer/Field: a named output column of a relation, bound to a symbol."""
    name: Optional[str]
    symbol: Symbol
    qualifier: Optional[str] = None  # table alias / table name
    # hidden columns (connector internal columns like _partition_offset)
    # resolve by name but are excluded from SELECT * expansion
    hidden: bool = False

    @property
    def type(self) -> Type:
        return self.symbol.type


class Scope:
    """analyzer/Scope + RelationType: visible fields for name resolution."""

    def __init__(self, fields: Sequence[Field], parent: Optional["Scope"] = None):
        self.fields = list(fields)
        self.parent = parent  # correlated outer scope

    def resolve(self, name: str, qualifier: Optional[str] = None) -> Field:
        matches = [f for f in self.fields
                   if f.name == name and (qualifier is None or f.qualifier == qualifier)]
        if len(matches) == 1:
            return matches[0]
        if len(matches) > 1:
            raise AmbiguousColumnError(f"column '{name}' is ambiguous")
        if self.parent is not None:
            return self.parent.resolve(name, qualifier)
        raise UnresolvedColumnError(name, qualifier)

    def try_resolve(self, name: str, qualifier: Optional[str] = None) -> Optional[Field]:
        try:
            return self.resolve(name, qualifier)
        except AmbiguousColumnError:
            raise
        except UnresolvedColumnError:
            return None

    def with_parent(self, parent: "Scope") -> "Scope":
        return Scope(self.fields, parent)


# ---------------------------------------------------------------------------
# type utilities
# ---------------------------------------------------------------------------

def type_from_name(tn: t.TypeName) -> Type:
    name = tn.name.lower()
    if name in ("bigint", "long"):
        return BIGINT
    if name in ("integer", "int"):
        return INTEGER
    if name == "smallint":
        return SMALLINT
    if name in ("double", "float64"):
        return DOUBLE
    if name == "real":
        return REAL
    if name == "boolean":
        return BOOLEAN
    if name == "date":
        return DATE
    if name == "timestamp":
        return TIMESTAMP
    if name in ("varchar", "char", "string"):
        return VARCHAR
    if name == "decimal":
        p = tn.parameters[0] if tn.parameters else 38
        s = tn.parameters[1] if len(tn.parameters) > 1 else 0
        return DecimalType(min(p, 18), s)
    raise SemanticError(f"unknown type {tn}")


def common_type(a: Type, b: Type) -> Type:
    """Least common super type for CASE/COALESCE/set-op coercion
    (type/TypeCoercion in the reference)."""
    if a == b:
        return a
    if a is UNKNOWN:
        return b
    if b is UNKNOWN:
        return a
    if is_string(a) and is_string(b):
        from ..types import WIDE_VARCHAR
        return WIDE_VARCHAR if (getattr(a, "wide", False) or
                                getattr(b, "wide", False)) else VARCHAR
    if is_numeric(a) and is_numeric(b):
        if is_floating(a) or is_floating(b):
            return DOUBLE
        if isinstance(a, DecimalType) or isinstance(b, DecimalType):
            da = a if isinstance(a, DecimalType) else DecimalType(18, 0)
            db = b if isinstance(b, DecimalType) else DecimalType(18, 0)
            return DecimalType(18, max(da.scale, db.scale))
        order = {"smallint": 0, "integer": 1, "bigint": 2}
        return a if order[a.name] >= order[b.name] else b
    if a is DATE and b is DATE:
        return DATE
    raise SemanticError(f"no common type for {a} and {b}")


def cast_to(expr: RowExpression, target: Type) -> RowExpression:
    if expr.type == target:
        return expr
    if isinstance(expr, Constant) and expr.value is None:
        return Constant(target, None)
    return special("CAST", target, expr)


def _parse_date(text: str) -> int:
    d = datetime.date.fromisoformat(text.strip())
    return days_from_civil(d.year, d.month, d.day)


def _decimal_of(text: str) -> Tuple[int, DecimalType]:
    txt = text.strip()
    neg = txt.startswith("-")
    txt = txt.lstrip("+-")
    if "." in txt:
        whole, frac = txt.split(".", 1)
    else:
        whole, frac = txt, ""
    scale = len(frac)
    digits = (whole + frac).lstrip("0") or "0"
    value = int(whole + frac or "0")
    if neg:
        value = -value
    return value, DecimalType(min(18, max(len(digits), scale + 1)), scale)


# ---------------------------------------------------------------------------
# aggregate extraction (AggregationAnalyzer analogue)
# ---------------------------------------------------------------------------

def _ast_children(node):
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if isinstance(v, t.Node):
            yield v
        elif isinstance(v, tuple):
            for x in v:
                if isinstance(x, t.Node):
                    yield x


def extract_aggregates(expr: t.Expression) -> List[t.FunctionCall]:
    """All aggregate FunctionCalls in the tree (not descending into subqueries
    or window expressions — `sum(x) OVER (...)` is a window, not an aggregate)."""
    out = []

    def walk(node):
        if isinstance(node, t.WindowExpression):
            return
        if isinstance(node, t.FunctionCall) and node.name.lower() in AGGREGATE_NAMES:
            out.append(node)
            return  # no nested aggregates
        if isinstance(node, t.SubqueryExpression):
            return
        for c in _ast_children(node):
            walk(c)
    walk(expr)
    return out


def extract_windows(expr: t.Expression) -> List["t.WindowExpression"]:
    """All window expressions in the tree (not descending into subqueries)."""
    out = []

    def walk(node):
        if isinstance(node, t.WindowExpression):
            out.append(node)
            return
        if isinstance(node, t.SubqueryExpression):
            return
        for c in _ast_children(node):
            walk(c)
    walk(expr)
    return out


def contains_aggregates(expr: t.Expression) -> bool:
    return bool(extract_aggregates(expr))


def rewrite_ast(node, mapping: Dict[t.Node, t.Node]):
    """Replace AST subtrees per `mapping` (top-down, first match wins).

    Does NOT descend into subqueries: a structurally equal aggregate inside a
    scalar subquery (TPC-H Q11's HAVING) belongs to the subquery's own plan, not
    to the outer aggregation."""
    if node in mapping:
        return mapping[node]
    if not isinstance(node, t.Node):
        return node
    if isinstance(node, (t.SubqueryExpression, t.ExistsPredicate)):
        return node
    kwargs = {}
    changed = False
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if isinstance(v, t.Node):
            nv = rewrite_ast(v, mapping)
        elif isinstance(v, tuple):
            nv = tuple(rewrite_ast(x, mapping) if isinstance(x, t.Node) else x
                       for x in v)
        else:
            nv = v
        if nv is not v and nv != v:
            changed = True
        kwargs[f.name] = nv
    return type(node)(**kwargs) if changed else node


# ---------------------------------------------------------------------------
# expression translation
# ---------------------------------------------------------------------------

class ExpressionTranslator:
    """ExpressionAnalyzer + SqlToRowExpressionTranslator in one pass."""

    def __init__(self, scope: Scope):
        self.scope = scope

    def translate(self, expr: t.Expression) -> RowExpression:
        m = getattr(self, f"_t_{type(expr).__name__}", None)
        if m is None:
            raise SemanticError(f"unsupported expression {type(expr).__name__}: {expr}")
        return m(expr)

    # --- leaf nodes --------------------------------------------------------

    def _t_Identifier(self, e: t.Identifier) -> RowExpression:
        f = self.scope.resolve(e.name.lower())
        return symbol_ref(f.symbol.name, f.type)

    def _t_DereferenceExpression(self, e: t.DereferenceExpression) -> RowExpression:
        if not isinstance(e.base, t.Identifier):
            raise SemanticError(f"unsupported dereference base {e.base}")
        f = self.scope.resolve(e.field.lower(), e.base.name.lower())
        return symbol_ref(f.symbol.name, f.type)

    def _t_LongLiteral(self, e: t.LongLiteral) -> RowExpression:
        return Constant(BIGINT, int(e.value))

    def _t_DoubleLiteral(self, e: t.DoubleLiteral) -> RowExpression:
        return Constant(DOUBLE, float(e.value))

    def _t_DecimalLiteral(self, e: t.DecimalLiteral) -> RowExpression:
        value, dt = _decimal_of(e.text)
        return Constant(dt, value)

    def _t_StringLiteral(self, e: t.StringLiteral) -> RowExpression:
        return Constant(VARCHAR, e.value)

    def _t_BooleanLiteral(self, e: t.BooleanLiteral) -> RowExpression:
        return Constant(BOOLEAN, bool(e.value))

    def _t_NullLiteral(self, e: t.NullLiteral) -> RowExpression:
        return Constant(UNKNOWN, None)

    def _t_DateLiteral(self, e: t.DateLiteral) -> RowExpression:
        return Constant(DATE, _parse_date(e.text))

    # --- date arithmetic / intervals --------------------------------------

    def _fold_date_arith(self, e: t.ArithmeticBinary) -> Optional[RowExpression]:
        """date_literal ± interval_literal folded host-side (calendar-correct for
        month/year units, which have no fixed day width)."""
        left, right = e.left, e.right
        if isinstance(left, t.ArithmeticBinary):
            folded = self._fold_date_arith(left)
            if folded is not None:
                left = t.DateLiteral(_date_text(folded.value))
        if not isinstance(right, t.IntervalLiteral):
            return None
        base = None
        if isinstance(left, t.DateLiteral):
            base = datetime.date.fromisoformat(left.text.strip())
        if base is None:
            return None
        n = int(right.value) * right.sign * (-1 if e.op == "-" else 1)
        unit = right.unit.upper()
        if unit == "DAY":
            out = base + datetime.timedelta(days=n)
        elif unit == "MONTH":
            mo = base.month - 1 + n
            out = base.replace(year=base.year + mo // 12, month=mo % 12 + 1)
        elif unit == "YEAR":
            out = base.replace(year=base.year + n)
        else:
            raise SemanticError(f"unsupported interval unit {unit}")
        return Constant(DATE, days_from_civil(out.year, out.month, out.day))

    def _t_IntervalLiteral(self, e: t.IntervalLiteral) -> RowExpression:
        if e.unit.upper() == "DAY":
            return Constant(BIGINT, int(e.value) * e.sign)
        raise SemanticError("month/year intervals only fold against date literals")

    # --- operators ---------------------------------------------------------

    def _t_ArithmeticBinary(self, e: t.ArithmeticBinary) -> RowExpression:
        folded = self._fold_date_arith(e)
        if folded is not None:
            return folded
        left = self.translate(e.left)
        right = self.translate(e.right)
        name = _ARITH_NAMES[e.op]
        # date ± day interval/integer stays a date
        if left.type is DATE and is_integral(right.type):
            return Call(DATE, name, (left, right))
        out = arithmetic_result_type(name, left.type, right.type)
        return Call(out, name, (left, right))

    def _t_ArithmeticUnary(self, e: t.ArithmeticUnary) -> RowExpression:
        v = self.translate(e.value)
        if e.op == "+":
            return v
        if isinstance(v, Constant) and v.value is not None:
            return Constant(v.type, -v.value)
        return Call(v.type, "negate", (v,))

    def _t_ComparisonExpression(self, e: t.ComparisonExpression) -> RowExpression:
        left = self.translate(e.left)
        right = self.translate(e.right)
        return Call(BOOLEAN, _CMP_NAMES[e.op], (left, right))

    def _t_LogicalBinary(self, e: t.LogicalBinary) -> RowExpression:
        return special(e.op.upper(), BOOLEAN,
                       self.translate(e.left), self.translate(e.right))

    def _t_NotExpression(self, e: t.NotExpression) -> RowExpression:
        return special("NOT", BOOLEAN, self.translate(e.value))

    def _t_IsNullPredicate(self, e: t.IsNullPredicate) -> RowExpression:
        return special("IS_NULL", BOOLEAN, self.translate(e.value))

    def _t_IsNotNullPredicate(self, e: t.IsNotNullPredicate) -> RowExpression:
        return special("NOT", BOOLEAN,
                       special("IS_NULL", BOOLEAN, self.translate(e.value)))

    def _t_BetweenPredicate(self, e: t.BetweenPredicate) -> RowExpression:
        return special("BETWEEN", BOOLEAN, self.translate(e.value),
                       self.translate(e.min), self.translate(e.max))

    def _t_LikePredicate(self, e: t.LikePredicate) -> RowExpression:
        args = [self.translate(e.value), self.translate(e.pattern)]
        if e.escape is not None:
            args.append(self.translate(e.escape))
        return Call(BOOLEAN, "like", tuple(args))

    def _t_InPredicate(self, e: t.InPredicate) -> RowExpression:
        if not isinstance(e.value_list, t.InListExpression):
            raise SemanticError("IN subquery must be planned, not translated")
        value = self.translate(e.value)
        items = tuple(self.translate(i) for i in e.value_list.values)
        return special("IN", BOOLEAN, value, *items)

    def _t_Cast(self, e: t.Cast) -> RowExpression:
        target = type_from_name(e.type)
        inner = self.translate(e.expression)
        if isinstance(inner, Constant) and is_string(inner.type):
            if target is DATE:
                return Constant(DATE, _parse_date(inner.value))
            if isinstance(target, DecimalType):
                # exact string -> scaled-int constant (a runtime CAST from
                # a dictionary code cannot recover the digits); HALF_UP
                # like the engine's runtime decimal rounding
                from decimal import (Decimal, InvalidOperation, ROUND_HALF_UP)
                try:
                    v = Decimal(str(inner.value).strip()).scaleb(
                        target.scale).quantize(Decimal(1), ROUND_HALF_UP)
                except InvalidOperation:
                    raise SemanticError(
                        f"cannot cast {inner.value!r} to {target}")
                return Constant(target, int(v))
        return cast_to(inner, target)

    def _t_Extract(self, e: t.Extract) -> RowExpression:
        field = e.field.lower()
        if field not in ("year", "month", "day"):
            raise SemanticError(f"extract({field}) not supported")
        return Call(BIGINT, field, (self.translate(e.expression),))

    def _t_SearchedCaseExpression(self, e: t.SearchedCaseExpression) -> RowExpression:
        whens = [(self.translate(w.operand), self.translate(w.result))
                 for w in e.when_clauses]
        default = self.translate(e.default) if e.default is not None \
            else Constant(UNKNOWN, None)
        out_t = default.type
        for _, r in whens:
            out_t = common_type(out_t, r.type)
        args = []
        for c, r in whens:
            args.append(c)
            args.append(cast_to(r, out_t))
        args.append(cast_to(default, out_t))
        return SpecialForm(out_t, "SWITCH", tuple(args))

    def _t_SimpleCaseExpression(self, e: t.SimpleCaseExpression) -> RowExpression:
        # CASE x WHEN v THEN r ... -> searched form on x = v
        whens = tuple(
            t.WhenClause(t.ComparisonExpression("=", e.operand, w.operand), w.result)
            for w in e.when_clauses)
        return self._t_SearchedCaseExpression(
            t.SearchedCaseExpression(whens, e.default))

    def _t_CoalesceExpression(self, e: t.CoalesceExpression) -> RowExpression:
        parts = [self.translate(o) for o in e.operands]
        out_t = parts[0].type
        for p in parts[1:]:
            out_t = common_type(out_t, p.type)
        return SpecialForm(out_t, "COALESCE",
                           tuple(cast_to(p, out_t) for p in parts))

    def _t_ArrayConstructor(self, e) -> RowExpression:
        """ARRAY[e1..eK] -> Call("array", ArrayType(common)) — a PLAN-time
        value only (unnest/cardinality lower it statically; see types.ArrayType)."""
        from ..types import ArrayType

        items = tuple(self.translate(i) for i in e.items)
        if not items:
            raise SemanticError("empty ARRAY[] requires an explicit cast")
        elem = items[0].type
        for it in items[1:]:
            elem = common_type(elem, it.type)
        return Call(ArrayType(elem), "array", items)

    def _t_FunctionCall(self, e: t.FunctionCall) -> RowExpression:
        name = e.name.lower()
        if name in AGGREGATE_NAMES:
            raise SemanticError(
                f"aggregate {name}() must be planned through an Aggregation node")
        args = tuple(self.translate(a) for a in e.args)
        if name == "cardinality":
            # over the fixed-length constructor the length is a literal
            if args and isinstance(args[0], Call) and args[0].name == "array":
                return Constant(BIGINT, len(args[0].args))
            from ..types import ArrayType, MapType
            if args and isinstance(args[0].type, (ArrayType, MapType)):
                # dynamic array/map HANDLE column (array_agg output): the
                # compiler gathers lengths from the host ArrayValues store
                return Call(BIGINT, "cardinality", args)
            raise SemanticError(
                "cardinality() supports ARRAY[..] constructors and "
                "array_agg/map_agg columns")
        if name in ("substr", "substring"):
            return Call(VARCHAR, "substr", args)
        if name == "abs":
            return Call(args[0].type, "abs", args)
        if name in ("year", "month", "day"):
            return Call(BIGINT, name, args)
        if name in ("sqrt", "ln", "log10", "log2", "exp", "cbrt"):
            return Call(DOUBLE, name, tuple(cast_to(a, DOUBLE) for a in args))
        if name in ("floor", "ceil", "ceiling", "round", "truncate"):
            if name == "round" and len(args) == 2:
                # negative digits round integral columns too (round(1234,-2))
                return Call(args[0].type, "round2", args)
            if is_integral(args[0].type):
                return args[0]
            return Call(args[0].type, name, args)
        if name in ("power", "pow"):
            return Call(DOUBLE, "power", tuple(cast_to(a, DOUBLE) for a in args))
        if name == "mod":
            return Call(common_type(args[0].type, args[1].type), "modulus", args)
        if name == "sign":
            out_t = DOUBLE if is_floating(args[0].type) else BIGINT
            return Call(out_t, "sign", args)
        if name == "pi":
            return Constant(DOUBLE, math.pi)
        if name in ("greatest", "least"):
            for a in args:
                if is_string(a.type):
                    # varchar would compare dictionary CODES across unrelated
                    # dictionaries — meaningless; reject until re-encode lands
                    raise SemanticError(
                        f"{name}() over varchar is not supported")
            out_t = args[0].type
            for a in args[1:]:
                out_t = common_type(out_t, a.type)
            return Call(out_t, name, tuple(cast_to(a, out_t) for a in args))
        if name == "length":
            if not is_string(args[0].type):
                raise SemanticError("length() expects a varchar argument")
            return Call(BIGINT, "length", args)
        if name in ("upper", "lower"):
            if not is_string(args[0].type):
                raise SemanticError(f"{name}() expects a varchar argument")
            return Call(args[0].type, name, args)
        if name in ("quarter", "week", "day_of_week", "dow", "day_of_year",
                    "doy"):
            return Call(BIGINT, name, args)
        if name == "date_add":
            # date_add(unit, value, date) — day unit only (int date substrate)
            unit = args[0]
            if not isinstance(unit, Constant) or unit.value not in ("day",):
                raise SemanticError("date_add supports the 'day' unit")
            return Call(args[2].type, "add",
                        (args[2], cast_to(args[1], BIGINT)))
        if name == "if":
            cond, then = args[0], args[1]
            els = args[2] if len(args) > 2 else Constant(UNKNOWN, None)
            out_t = common_type(then.type, els.type)
            return SpecialForm(out_t, "IF",
                               (cond, cast_to(then, out_t), cast_to(els, out_t)))
        typer = EXTERNAL_FUNCTIONS.get(name)
        if typer is not None:
            return typer(name, args)
        if name in PLUGIN_FUNCTIONS:
            # a function of the reference's plugin libraries whose port is
            # not registered: the port's rule is to refuse, naming it
            raise NotImplementedError(
                f"function {name}: its library of presto_tpu_torch.functions "
                f"is not registered")
        raise SemanticError(f"unknown function {name}")

    def _t_SubqueryExpression(self, e: t.SubqueryExpression) -> RowExpression:
        raise SemanticError("subquery must be planned, not translated")

    def _t_ExistsPredicate(self, e: t.ExistsPredicate) -> RowExpression:
        raise SemanticError("EXISTS must be planned, not translated")


def _date_text(days: int) -> str:
    return (datetime.date(1970, 1, 1) + datetime.timedelta(days=int(days))).isoformat()


def aggregate_output_type(name: str, arg_types: Sequence[Type]) -> Type:
    """Output type of an aggregate (mirrors ops/aggregates.resolve_aggregate)."""
    name = name.lower()
    if name in ("count", "count_if", "approx_distinct"):
        return BIGINT
    if name == "sum":
        tt = arg_types[0]
        if isinstance(tt, DecimalType):
            return DecimalType(18, tt.scale)
        if is_floating(tt):
            return DOUBLE
        return BIGINT
    if name == "avg":
        return DOUBLE
    if name in ("min", "max", "arbitrary", "any_value"):
        return arg_types[0]
    if name in ("min_by", "max_by"):
        if len(arg_types) != 2:
            raise SemanticError(
                f"{name} takes exactly 2 arguments (the {name}(x, y, n) "
                f"top-n form is not supported)")
        return arg_types[0]
    if name == "array_agg":
        from ..types import ArrayType
        return ArrayType(arg_types[0])
    if name == "map_agg":
        from ..types import MapType
        return MapType(arg_types[0], arg_types[1])
    if name == "histogram":
        from ..types import MapType
        return MapType(arg_types[0], BIGINT)
    if name == "approx_percentile":
        return DOUBLE if is_floating(arg_types[0]) else arg_types[0]
    if name in ("stddev", "stddev_samp", "stddev_pop", "variance", "var_samp",
                "var_pop", "corr", "covar_samp", "covar_pop"):
        return DOUBLE
    if name in ("bool_and", "bool_or", "every"):
        return BOOLEAN
    typer = EXTERNAL_AGGREGATE_TYPES.get(name)
    if typer is not None:
        return typer(arg_types)
    raise SemanticError(f"unknown aggregate {name}")


# output-type resolvers for externally registered aggregates
EXTERNAL_AGGREGATE_TYPES: Dict[str, Callable] = {}
