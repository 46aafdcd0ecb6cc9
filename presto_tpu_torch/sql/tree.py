"""SQL abstract syntax tree.

The PyTorch port's copy of ``presto_tpu/sql/tree.py`` (plain Python, no torch): the
port keeps its own front end so that it imports nothing of ``presto_tpu``.

Analogue of presto-parser's AST (presto-parser/src/main/java/com/facebook/presto/sql/
tree/ — 164 node classes). Narrowed to the relational core the engine executes
(SELECT-FROM-WHERE-GROUP-HAVING-ORDER-LIMIT, joins, subqueries, CASE, CAST, EXTRACT,
LIKE, IN, EXISTS, BETWEEN, interval/date literals, set operations, EXPLAIN, SHOW) —
the surface TPC-H and TPC-DS exercise. Nodes are frozen dataclasses; the parser
(sql/parser.py) plays the role of SqlParser + AstBuilder.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple


class Node:
    """Base AST node."""
    __slots__ = ()


class Expression(Node):
    __slots__ = ()


class Relation(Node):
    __slots__ = ()


class Statement(Node):
    __slots__ = ()


def _dc(cls):
    return dataclasses.dataclass(frozen=True)(cls)


# ---------------------------------------------------------------------------
# expressions
# ---------------------------------------------------------------------------

@_dc
class Identifier(Expression):
    name: str

    def __str__(self):
        return self.name


@_dc
class DereferenceExpression(Expression):
    """qualified name: base.field (tree/DereferenceExpression.java)."""
    base: Expression
    field: str

    def __str__(self):
        return f"{self.base}.{self.field}"


@_dc
class LongLiteral(Expression):
    value: int


@_dc
class DoubleLiteral(Expression):
    value: float


@_dc
class DecimalLiteral(Expression):
    text: str  # keep exact text; analyzer scales it


@_dc
class StringLiteral(Expression):
    value: str


@_dc
class BooleanLiteral(Expression):
    value: bool


@_dc
class NullLiteral(Expression):
    pass


@_dc
class DateLiteral(Expression):
    """DATE 'yyyy-mm-dd' (tree/GenericLiteral with type=date in the reference)."""
    text: str


@_dc
class TimestampLiteral(Expression):
    text: str


@_dc
class IntervalLiteral(Expression):
    """INTERVAL '<n>' <unit> (tree/IntervalLiteral.java)."""
    value: str
    unit: str          # DAY | MONTH | YEAR
    sign: int = 1


@_dc
class TypeName(Node):
    """Parsed type, e.g. decimal(12,2), varchar, bigint."""
    name: str
    parameters: Tuple[int, ...] = ()

    def __str__(self):
        if self.parameters:
            return f"{self.name}({','.join(map(str, self.parameters))})"
        return self.name


@_dc
class Cast(Expression):
    expression: Expression
    type: TypeName
    # TRY_CAST returns null instead of failing
    safe: bool = False


@_dc
class ArithmeticBinary(Expression):
    op: str  # + - * / %
    left: Expression
    right: Expression


@_dc
class ArithmeticUnary(Expression):
    op: str  # + -
    value: Expression


@_dc
class ComparisonExpression(Expression):
    op: str  # = <> < <= > >=
    left: Expression
    right: Expression


@_dc
class LogicalBinary(Expression):
    op: str  # AND | OR
    left: Expression
    right: Expression


@_dc
class NotExpression(Expression):
    value: Expression


@_dc
class IsNullPredicate(Expression):
    value: Expression


@_dc
class IsNotNullPredicate(Expression):
    value: Expression


@_dc
class BetweenPredicate(Expression):
    value: Expression
    min: Expression
    max: Expression


@_dc
class LikePredicate(Expression):
    value: Expression
    pattern: Expression
    escape: Optional[Expression] = None


@_dc
class InListExpression(Expression):
    values: Tuple[Expression, ...]


@_dc
class InPredicate(Expression):
    value: Expression
    value_list: Expression  # InListExpression | SubqueryExpression


@_dc
class ExistsPredicate(Expression):
    subquery: "SubqueryExpression"


@_dc
class SubqueryExpression(Expression):
    query: "Query"


@_dc
class FunctionCall(Expression):
    name: str
    args: Tuple[Expression, ...]
    distinct: bool = False
    # aggregate FILTER (WHERE ...) — also used for `count(*)` marker via args=()
    filter: Optional[Expression] = None


@_dc
class WindowSpec(Node):
    """OVER (...) clause (tree/Window.java analogue, frames narrowed to the
    two the engine executes: RANGE/ROWS UNBOUNDED PRECEDING..CURRENT ROW)."""
    partition_by: Tuple[Expression, ...] = ()
    order_by: Tuple["SortItem", ...] = ()
    frame_mode: str = "range"  # range | rows


@_dc
class WindowExpression(Expression):
    call: FunctionCall
    window: WindowSpec


@_dc
class Extract(Expression):
    field: str  # YEAR | MONTH | DAY | ...
    expression: Expression


@_dc
class WhenClause(Node):
    operand: Expression
    result: Expression


@_dc
class SearchedCaseExpression(Expression):
    when_clauses: Tuple[WhenClause, ...]
    default: Optional[Expression]


@_dc
class SimpleCaseExpression(Expression):
    operand: Expression
    when_clauses: Tuple[WhenClause, ...]
    default: Optional[Expression]


@_dc
class CoalesceExpression(Expression):
    operands: Tuple[Expression, ...]


@_dc
class Star(Expression):
    """`*` or `t.*` select item."""
    qualifier: Optional[str] = None


@_dc
class Row(Expression):
    items: Tuple[Expression, ...]


# ---------------------------------------------------------------------------
# relations
# ---------------------------------------------------------------------------

@_dc
class Table(Relation):
    name: Tuple[str, ...]  # possibly qualified: (catalog, schema, table) suffix

    def __str__(self):
        return ".".join(self.name)


@_dc
class AliasedRelation(Relation):
    relation: Relation
    alias: str
    column_names: Tuple[str, ...] = ()


@_dc
class TableSubquery(Relation):
    query: "Query"


@_dc
class Join(Relation):
    type: str  # INNER | LEFT | RIGHT | FULL | CROSS | IMPLICIT
    left: Relation
    right: Relation
    criteria: Optional[Expression] = None   # ON <expr>
    using: Tuple[str, ...] = ()             # USING (cols)


@_dc
class Unnest(Relation):
    expressions: Tuple[Expression, ...]
    with_ordinality: bool = False


@_dc
class Values(Relation):
    rows: Tuple[Expression, ...]  # each Row or single expression


# ---------------------------------------------------------------------------
# query structure
# ---------------------------------------------------------------------------

@_dc
class SelectItem(Node):
    expression: Expression
    alias: Optional[str] = None


@_dc
class SortItem(Node):
    sort_key: Expression
    descending: bool = False
    nulls_first: Optional[bool] = None


@_dc
class QuerySpecification(Relation):
    """One SELECT block (tree/QuerySpecification.java)."""
    select_items: Tuple[SelectItem, ...]
    distinct: bool = False
    from_: Optional[Relation] = None
    where: Optional[Expression] = None
    group_by: Tuple[Expression, ...] = ()
    having: Optional[Expression] = None
    order_by: Tuple[SortItem, ...] = ()
    limit: Optional[int] = None
    # GROUPING SETS / ROLLUP / CUBE: tuples of indices into group_by (which
    # holds the distinct key expressions in canonical order); None = plain
    grouping_sets: Optional[Tuple[Tuple[int, ...], ...]] = None


@_dc
class SetOperation(Relation):
    op: str  # UNION | INTERSECT | EXCEPT
    distinct: bool
    left: Relation
    right: Relation


@_dc
class With(Node):
    queries: Tuple[Tuple[str, "Query"], ...]  # (name, query)


@_dc
class Query(Statement):
    """Top-level query: optional WITH + body + outer ORDER BY/LIMIT."""
    body: Relation
    with_: Optional[With] = None
    order_by: Tuple[SortItem, ...] = ()
    limit: Optional[int] = None


@_dc
class Explain(Statement):
    statement: Statement
    analyze: bool = False
    type: str = "LOGICAL"  # LOGICAL | DISTRIBUTED


@_dc
class ShowTables(Statement):
    schema: Optional[Tuple[str, ...]] = None


@_dc
class ShowSchemas(Statement):
    catalog: Optional[str] = None


@_dc
class ShowColumns(Statement):
    table: Tuple[str, ...] = ()


@_dc
class ShowSession(Statement):
    pass


@_dc
class SetSession(Statement):
    name: str = ""
    value: object = None


@_dc
class CreateTableAsSelect(Statement):
    name: Tuple[str, ...] = ()
    query: Optional[Query] = None
    not_exists: bool = False
    # WITH (k = v, ...) table properties, evaluated to python constants
    # (strings, numbers, lists of strings) — the reference's
    # ConnectorMetadata table-property flow (e.g. hive partitioned_by)
    properties: Tuple[Tuple[str, object], ...] = ()


@_dc
class Insert(Statement):
    name: Tuple[str, ...] = ()
    columns: Tuple[str, ...] = ()  # () = positional over the table schema
    query: Optional[Query] = None


@_dc
class DropTable(Statement):
    name: Tuple[str, ...] = ()
    exists_ok: bool = False


@_dc
class ArrayConstructor(Expression):
    """ARRAY[e1, ..., eK] — fixed-length constructor (spi ArrayBlock's
    constructor form; the engine lowers unnest/cardinality over it
    statically, see sql/planner/planner.py plan_unnest)."""
    items: Tuple[Expression, ...]
