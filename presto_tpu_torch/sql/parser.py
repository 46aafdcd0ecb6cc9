"""SQL parser: hand-written lexer + recursive-descent/Pratt parser.

The PyTorch port's copy of ``presto_tpu/sql/parser.py`` (plain Python, no torch): the
port keeps its own front end so that it imports nothing of ``presto_tpu``.

Analogue of presto-parser's ANTLR stack (SqlBase.g4, 802 lines + AstBuilder.java,
2,291 LoC). The grammar subset is the relational core that TPC-H/TPC-DS exercises;
operator precedence follows SqlBase.g4's expression hierarchy:

    OR < AND < NOT < predicate (comparison/BETWEEN/IN/LIKE/IS NULL)
       < additive < multiplicative < unary < primary

Errors raise ParsingException with line/column, like the reference's
ParsingException (presto-parser/.../parser/ParsingException.java).
"""
from __future__ import annotations

import dataclasses
import re
from typing import List, Optional, Tuple

from . import tree as t


class ParsingException(Exception):
    def __init__(self, message: str, line: int = 0, col: int = 0):
        super().__init__(f"line {line}:{col}: {message}")
        self.line = line
        self.col = col


# ---------------------------------------------------------------------------
# lexer
# ---------------------------------------------------------------------------

KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "order", "limit", "offset",
    "as", "on", "using", "join", "inner", "left", "right", "full", "outer", "cross",
    "and", "or", "not", "in", "exists", "between", "like", "escape", "is", "null",
    "true", "false", "case", "when", "then", "else", "end", "cast", "try_cast",
    "date", "time", "timestamp", "interval", "year", "month", "day", "hour",
    "minute", "second", "quarter", "week", "extract", "distinct", "all", "union",
    "intersect", "except", "with", "values", "asc", "desc", "nulls", "first",
    "last", "explain", "analyze", "show", "tables", "schemas", "columns", "session",
    "set", "create", "table", "row", "unnest", "ordinality", "coalesce", "filter",
    "substring", "for", "count", "exists", "insert", "into", "drop",
    "over", "partition", "rows", "range", "unbounded", "preceding", "current",
    "following", "grouping", "sets", "rollup", "cube", "array",
}

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+|--[^\n]*|/\*.*?\*/)
  | (?P<number>(\d+\.\d*|\.\d+)([eE][+-]?\d+)?|\d+[eE][+-]?\d+|\d+)
  | (?P<qident>"(?:[^"]|"")*")
  | (?P<string>'(?:[^']|'')*')
  | (?P<ident>[A-Za-z_][A-Za-z0-9_$]*)
  | (?P<op><>|!=|>=|<=|\|\||[=<>+\-*/%(),.;\[\]])
""", re.VERBOSE | re.DOTALL)


# truly reserved words (SqlBase.g4 nonReserved lists the opposite set — these may
# NOT be used as bare identifiers; soft keywords like YEAR/COUNT/TABLES may)
RESERVED = {
    "select", "from", "where", "group", "having", "order", "on", "using", "join",
    "inner", "left", "right", "full", "outer", "cross", "and", "or", "not", "in",
    "exists", "between", "like", "escape", "is", "null", "true", "false", "case",
    "when", "then", "else", "end", "cast", "distinct", "union", "intersect",
    "except", "with", "values", "as", "by", "interval",
}


class Token:
    __slots__ = ("kind", "text", "line", "col")

    def __init__(self, kind: str, text: str, line: int, col: int):
        self.kind = kind   # number | string | ident | qident | op | kw:<word> | eof
        self.text = text
        self.line = line
        self.col = col

    def __repr__(self):
        return f"Token({self.kind!r}, {self.text!r})"


def tokenize(sql: str) -> List[Token]:
    tokens: List[Token] = []
    pos, line, line_start = 0, 1, 0
    while pos < len(sql):
        m = _TOKEN_RE.match(sql, pos)
        if not m:
            raise ParsingException(f"unexpected character {sql[pos]!r}", line, pos - line_start)
        text = m.group(0)
        col = pos - line_start
        if m.lastgroup == "ws":
            pass
        elif m.lastgroup == "number":
            tokens.append(Token("number", text, line, col))
        elif m.lastgroup == "string":
            tokens.append(Token("string", text[1:-1].replace("''", "'"), line, col))
        elif m.lastgroup == "qident":
            tokens.append(Token("ident", text[1:-1].replace('""', '"'), line, col))
        elif m.lastgroup == "ident":
            low = text.lower()
            kind = f"kw:{low}" if low in KEYWORDS else "ident"
            tokens.append(Token(kind, text, line, col))
        else:
            tokens.append(Token("op", text, line, col))
        nl = text.count("\n")
        if nl:
            line += nl
            line_start = pos + text.rfind("\n") + 1
        pos = m.end()
    tokens.append(Token("eof", "", line, pos - line_start))
    return tokens


# ---------------------------------------------------------------------------
# parser
# ---------------------------------------------------------------------------

class SqlParser:
    """presto-parser/.../parser/SqlParser.java analogue."""

    def parse(self, sql: str) -> t.Statement:
        p = _Parser(tokenize(sql))
        stmt = p.parse_statement()
        p.skip_semicolons()
        p.expect_eof()
        return stmt

    def parse_expression(self, sql: str) -> t.Expression:
        p = _Parser(tokenize(sql))
        e = p.parse_expr()
        p.expect_eof()
        return e


class _Parser:
    def __init__(self, tokens: List[Token]):
        self.toks = tokens
        self.i = 0

    # -- token utilities ----------------------------------------------------

    def peek(self, ahead: int = 0) -> Token:
        return self.toks[min(self.i + ahead, len(self.toks) - 1)]

    def next(self) -> Token:
        tok = self.toks[self.i]
        if tok.kind != "eof":
            self.i += 1
        return tok

    def at_kw(self, *words: str) -> bool:
        return self.peek().kind in tuple(f"kw:{w}" for w in words)

    def at_op(self, *ops: str) -> bool:
        tok = self.peek()
        return tok.kind == "op" and tok.text in ops

    def accept_kw(self, *words: str) -> bool:
        if self.at_kw(*words):
            self.next()
            return True
        return False

    def accept_op(self, op: str) -> bool:
        if self.at_op(op):
            self.next()
            return True
        return False

    def expect_kw(self, word: str) -> Token:
        if not self.at_kw(word):
            self.error(f"expected {word.upper()}")
        return self.next()

    def expect_op(self, op: str) -> Token:
        if not self.at_op(op):
            self.error(f"expected {op!r}")
        return self.next()

    def expect_ident(self) -> str:
        tok = self.peek()
        # soft keywords usable as identifiers (column names like `year`, `count`)
        if tok.kind == "ident" or (tok.kind.startswith("kw:") and tok.kind[3:] not in RESERVED):
            self.next()
            return tok.text
        self.error("expected identifier")

    def error(self, msg: str):
        tok = self.peek()
        raise ParsingException(f"{msg}, found {tok.text!r}", tok.line, tok.col)

    def expect_eof(self):
        if self.peek().kind != "eof":
            self.error("expected end of statement")

    def skip_semicolons(self):
        while self.accept_op(";"):
            pass

    # -- statements ---------------------------------------------------------

    def parse_statement(self) -> t.Statement:
        if self.at_kw("explain"):
            return self.parse_explain()
        if self.at_kw("show"):
            return self.parse_show()
        if self.at_kw("set"):
            return self.parse_set_session()
        if self.at_kw("create"):
            return self.parse_create()
        if self.at_kw("insert"):
            return self.parse_insert()
        if self.at_kw("drop"):
            return self.parse_drop()
        return self.parse_query()

    def parse_create(self) -> t.Statement:
        self.expect_kw("create")
        self.expect_kw("table")
        # IF NOT EXISTS ("if" stays a plain identifier so if(c,a,b) keeps
        # working, and a table actually NAMED if is disambiguated by lookahead)
        not_exists = False
        if self.peek().kind == "ident" and self.peek().text.lower() == "if" \
                and self.peek(1).kind == "kw:not":
            self.next()
            self.expect_kw("not")
            self.expect_kw("exists")
            not_exists = True
        name = self.parse_qualified_name()
        properties: Tuple[Tuple[str, object], ...] = ()
        if self.accept_kw("with"):
            self.expect_op("(")
            props = []
            while True:
                key = self.expect_ident().lower()
                self.expect_op("=")
                props.append((key, self._parse_property_value()))
                if not self.accept_op(","):
                    break
            self.expect_op(")")
            properties = tuple(props)
        if self.accept_kw("as"):
            return t.CreateTableAsSelect(name, self.parse_query(),
                                         not_exists=not_exists,
                                         properties=properties)
        self.error("only CREATE TABLE ... AS SELECT is supported")

    def _parse_property_value(self):
        """Constant table-property value: string/number/boolean literal or
        ARRAY['a', ...] of strings (partitioned_by/bucketed_by lists)."""
        tok = self.peek()
        if tok.kind == "kw:array" or (tok.kind == "ident" and
                                      tok.text.lower() == "array"):
            self.next()
            self.expect_op("[")
            items = []
            if not self.at_op("]"):
                while True:
                    items.append(self._parse_property_value())
                    if not self.accept_op(","):
                        break
            self.expect_op("]")
            return items
        if tok.kind == "string":
            self.next()
            return tok.text
        if tok.kind == "number":
            self.next()
            return int(tok.text) if re.fullmatch(r"\d+", tok.text) \
                else float(tok.text)
        if self.accept_kw("true"):
            return True
        if self.accept_kw("false"):
            return False
        self.error("table property values must be constants "
                   "(string, number, boolean or ARRAY[...])")

    def parse_insert(self) -> t.Statement:
        self.expect_kw("insert")
        self.expect_kw("into")
        name = self.parse_qualified_name()
        columns: Tuple[str, ...] = ()
        if self.at_op("("):
            # lookahead: a '(' here could open a column list OR the query body
            save = self.i
            self.next()
            if (self.peek().kind == "ident" or
                    (self.peek().kind.startswith("kw:") and
                     self.peek().kind[3:] not in RESERVED)):
                cols = [self.expect_ident().lower()]
                while self.accept_op(","):
                    cols.append(self.expect_ident().lower())
                if self.accept_op(")"):
                    columns = tuple(cols)
                else:
                    self.i = save
            else:
                self.i = save
        return t.Insert(name, columns, self.parse_query())

    def parse_drop(self) -> t.Statement:
        self.expect_kw("drop")
        self.expect_kw("table")
        exists_ok = False
        if self.peek().kind == "ident" and self.peek().text.lower() == "if" \
                and self.peek(1).kind == "kw:exists":
            self.next()
            self.expect_kw("exists")
            exists_ok = True
        return t.DropTable(self.parse_qualified_name(), exists_ok=exists_ok)

    def parse_explain(self) -> t.Explain:
        self.expect_kw("explain")
        analyze = self.accept_kw("analyze")
        etype = "LOGICAL"
        if self.accept_op("("):
            while not self.accept_op(")"):
                word = self.expect_ident().lower()
                if word == "type":
                    etype = self.expect_ident().upper()
                self.accept_op(",")
        return t.Explain(self.parse_query(), analyze=analyze, type=etype)

    def parse_show(self) -> t.Statement:
        self.expect_kw("show")
        if self.accept_kw("tables"):
            schema = None
            if self.accept_kw("from"):
                schema = self.parse_qualified_name()
            return t.ShowTables(schema)
        if self.accept_kw("schemas"):
            catalog = None
            if self.accept_kw("from"):
                catalog = self.expect_ident()
            return t.ShowSchemas(catalog)
        if self.accept_kw("columns"):
            self.expect_kw("from")
            return t.ShowColumns(self.parse_qualified_name())
        if self.accept_kw("session"):
            return t.ShowSession()
        self.error("unsupported SHOW")

    def parse_set_session(self) -> t.SetSession:
        self.expect_kw("set")
        self.expect_kw("session")
        name = ".".join(self.parse_qualified_name())
        self.expect_op("=")
        val = self.parse_expr()
        return t.SetSession(name, val)

    # -- query --------------------------------------------------------------

    def parse_query(self) -> t.Query:
        with_ = None
        if self.accept_kw("with"):
            entries = []
            while True:
                name = self.expect_ident()
                self.expect_kw("as")
                self.expect_op("(")
                q = self.parse_query()
                self.expect_op(")")
                entries.append((name.lower(), q))
                if not self.accept_op(","):
                    break
            with_ = t.With(tuple(entries))
        body = self.parse_query_body()
        order_by, limit = self.parse_order_limit()
        # if the body is a bare QuerySpecification, fold outer order/limit into it
        if isinstance(body, t.QuerySpecification) and (order_by or limit is not None):
            body = dataclasses.replace(
                body, order_by=order_by or body.order_by,
                limit=limit if limit is not None else body.limit)
            order_by, limit = (), None
        return t.Query(body, with_, order_by, limit)

    def parse_order_limit(self) -> Tuple[Tuple[t.SortItem, ...], Optional[int]]:
        order_by: Tuple[t.SortItem, ...] = ()
        limit = None
        if self.accept_kw("order"):
            self.expect_kw("by")
            items = []
            while True:
                key = self.parse_expr()
                desc = False
                if self.accept_kw("asc"):
                    pass
                elif self.accept_kw("desc"):
                    desc = True
                nulls_first = None
                if self.accept_kw("nulls"):
                    if self.accept_kw("first"):
                        nulls_first = True
                    else:
                        self.expect_kw("last")
                        nulls_first = False
                items.append(t.SortItem(key, desc, nulls_first))
                if not self.accept_op(","):
                    break
            order_by = tuple(items)
        if self.accept_kw("limit"):
            tok = self.next()
            if tok.kind == "number":
                limit = int(tok.text)
            elif tok.kind == "kw:all":
                limit = None
            else:
                self.error("expected LIMIT count")
        return order_by, limit

    def parse_query_body(self) -> t.Relation:
        left = self.parse_query_term()
        while self.at_kw("union", "intersect", "except"):
            op = self.next().text.upper()
            distinct = True
            if self.accept_kw("all"):
                distinct = False
            else:
                self.accept_kw("distinct")
            right = self.parse_query_term()
            left = t.SetOperation(op, distinct, left, right)
        return left

    def parse_query_term(self) -> t.Relation:
        if self.accept_op("("):
            body = self.parse_query_body()
            # allow (SELECT ...) with trailing order/limit inside parens
            order_by, limit = self.parse_order_limit()
            if order_by or limit is not None:
                if isinstance(body, t.QuerySpecification):
                    body = dataclasses.replace(
                        body, order_by=order_by, limit=limit)
                else:
                    # ordered/limited set operation or VALUES as a term: wrap as
                    # a subquery so the ordering binds to the whole parenthesized
                    # body instead of being dropped
                    body = t.TableSubquery(t.Query(body, None, order_by, limit))
            self.expect_op(")")
            return body
        if self.at_kw("values"):
            return self.parse_values()
        return self.parse_query_spec()

    def parse_values(self) -> t.Values:
        self.expect_kw("values")
        rows = []
        while True:
            rows.append(self.parse_expr())
            if not self.accept_op(","):
                break
        return t.Values(tuple(rows))

    def parse_query_spec(self) -> t.QuerySpecification:
        self.expect_kw("select")
        distinct = False
        if self.accept_kw("distinct"):
            distinct = True
        else:
            self.accept_kw("all")
        items = [self.parse_select_item()]
        while self.accept_op(","):
            items.append(self.parse_select_item())

        from_: Optional[t.Relation] = None
        if self.accept_kw("from"):
            from_ = self.parse_relation()
            while self.accept_op(","):
                from_ = t.Join("IMPLICIT", from_, self.parse_relation())

        where = self.parse_expr() if self.accept_kw("where") else None

        group_by: Tuple[t.Expression, ...] = ()
        grouping_sets: Optional[Tuple[Tuple[int, ...], ...]] = None
        if self.accept_kw("group"):
            self.expect_kw("by")
            group_by, grouping_sets = self.parse_group_by_clause()

        having = self.parse_expr() if self.accept_kw("having") else None
        # ORDER BY / LIMIT are NOT part of a query term: in
        # `select a union all select b order by 1` the ordering binds to the
        # whole set operation (parse_query / the parenthesized-term branch
        # attach them at the right level)
        return t.QuerySpecification(tuple(items), distinct, from_, where, group_by,
                                    having, (), None, grouping_sets)

    def parse_group_by_clause(self):
        """GROUP BY exprs | GROUPING SETS ((..),..) | ROLLUP(..) | CUBE(..).

        Returns (key_exprs, grouping_sets) where grouping_sets is a tuple of
        index-tuples into key_exprs (None for a plain GROUP BY). Reference:
        SqlBase.g4 groupingElement / sql/analyzer GroupingOperationRewriter.
        """
        def parse_expr_list():
            self.expect_op("(")
            if self.accept_op(")"):
                return []
            out = [self.parse_expr()]
            while self.accept_op(","):
                out.append(self.parse_expr())
            self.expect_op(")")
            return out

        def canon(sets_exprs):
            keys: List[t.Expression] = []
            sets = []
            for exprs in sets_exprs:
                idxs = []
                for e in exprs:
                    if e in keys:
                        idxs.append(keys.index(e))
                    else:
                        idxs.append(len(keys))
                        keys.append(e)
                sets.append(tuple(idxs))
            return tuple(keys), tuple(sets)

        def parse_set_element():
            # a grouping set is `(e, ...)` OR a bare expression (one-key set)
            if self.at_op("("):
                return parse_expr_list()
            return [self.parse_expr()]

        # grouping/rollup/cube are soft keywords: commit to the construct only
        # with the right lookahead so `group by cube` (a column) still parses
        if self.at_kw("grouping") and self.peek(1).kind == "kw:sets":
            self.next()
            self.next()
            self.expect_op("(")
            sets_exprs = [parse_set_element()]
            while self.accept_op(","):
                sets_exprs.append(parse_set_element())
            self.expect_op(")")
            return canon(sets_exprs)
        if self.at_kw("rollup") and self.peek(1).kind == "op" \
                and self.peek(1).text == "(":
            self.next()
            exprs = parse_expr_list()
            sets_exprs = [exprs[:k] for k in range(len(exprs), -1, -1)]
            return canon(sets_exprs)
        if self.at_kw("cube") and self.peek(1).kind == "op" \
                and self.peek(1).text == "(":
            self.next()
            exprs = parse_expr_list()
            n = len(exprs)
            sets_exprs = [[exprs[i] for i in range(n) if m & (1 << i)]
                          for m in range(2 ** n - 1, -1, -1)]
            return canon(sets_exprs)
        gb = [self.parse_expr()]
        while self.accept_op(","):
            gb.append(self.parse_expr())
        return tuple(gb), None

    def parse_select_item(self) -> t.SelectItem:
        if self.at_op("*"):
            self.next()
            return t.SelectItem(t.Star())
        # t.*  — lookahead ident . *
        if (self.peek().kind == "ident" and self.peek(1).kind == "op"
                and self.peek(1).text == "." and self.peek(2).kind == "op"
                and self.peek(2).text == "*"):
            qual = self.next().text.lower()
            self.next()
            self.next()
            return t.SelectItem(t.Star(qual))
        expr = self.parse_expr()
        alias = None
        if self.accept_kw("as"):
            alias = self.expect_ident().lower()
        elif self.peek().kind == "ident":
            alias = self.next().text.lower()
        return t.SelectItem(expr, alias)

    # -- relations ----------------------------------------------------------

    def parse_relation(self) -> t.Relation:
        rel = self.parse_sampled_relation()
        while True:
            if self.accept_kw("cross"):
                self.expect_kw("join")
                right = self.parse_sampled_relation()
                rel = t.Join("CROSS", rel, right)
                continue
            jtype = None
            if self.at_kw("join", "inner"):
                jtype = "INNER"
                self.accept_kw("inner")
                self.expect_kw("join")
            elif self.at_kw("left", "right", "full"):
                jtype = self.next().text.upper()
                self.accept_kw("outer")
                self.expect_kw("join")
            if jtype is None:
                return rel
            right = self.parse_sampled_relation()
            if self.accept_kw("on"):
                rel = t.Join(jtype, rel, right, criteria=self.parse_expr())
            elif self.accept_kw("using"):
                self.expect_op("(")
                cols = [self.expect_ident().lower()]
                while self.accept_op(","):
                    cols.append(self.expect_ident().lower())
                self.expect_op(")")
                rel = t.Join(jtype, rel, right, using=tuple(cols))
            else:
                self.error("expected ON or USING")

    def parse_sampled_relation(self) -> t.Relation:
        rel = self.parse_relation_primary()
        # optional alias
        alias = None
        cols: Tuple[str, ...] = ()
        if self.accept_kw("as"):
            alias = self.expect_ident().lower()
        elif self.peek().kind == "ident":
            alias = self.next().text.lower()
        if alias is not None:
            if self.accept_op("("):
                cl = [self.expect_ident().lower()]
                while self.accept_op(","):
                    cl.append(self.expect_ident().lower())
                self.expect_op(")")
                cols = tuple(cl)
            return t.AliasedRelation(rel, alias, cols)
        return rel

    def parse_relation_primary(self) -> t.Relation:
        if self.accept_op("("):
            # subquery or parenthesized join
            if self.at_kw("select", "with", "values") or self.at_op("("):
                save = self.i
                try:
                    q = self.parse_query()
                    self.expect_op(")")
                    return t.TableSubquery(q)
                except ParsingException:
                    self.i = save
            rel = self.parse_relation()
            self.expect_op(")")
            return rel
        if self.accept_kw("unnest"):
            self.expect_op("(")
            exprs = [self.parse_expr()]
            while self.accept_op(","):
                exprs.append(self.parse_expr())
            self.expect_op(")")
            with_ord = False
            if self.accept_kw("with"):
                self.expect_kw("ordinality")
                with_ord = True
            return t.Unnest(tuple(exprs), with_ord)
        name = self.parse_qualified_name()
        return t.Table(name)

    def parse_qualified_name(self) -> Tuple[str, ...]:
        parts = [self.expect_ident().lower()]
        while self.at_op(".") and self.peek(1).kind != "op":
            self.next()
            parts.append(self.expect_ident().lower())
        return tuple(parts)

    # -- expressions (precedence climbing, SqlBase.g4 booleanExpression..) --

    def parse_expr(self) -> t.Expression:
        return self.parse_or()

    def parse_or(self) -> t.Expression:
        left = self.parse_and()
        while self.accept_kw("or"):
            left = t.LogicalBinary("OR", left, self.parse_and())
        return left

    def parse_and(self) -> t.Expression:
        left = self.parse_not()
        while self.accept_kw("and"):
            left = t.LogicalBinary("AND", left, self.parse_not())
        return left

    def parse_not(self) -> t.Expression:
        if self.accept_kw("not"):
            return t.NotExpression(self.parse_not())
        return self.parse_predicate()

    def parse_predicate(self) -> t.Expression:
        left = self.parse_additive()
        while True:
            if self.at_op("=", "<>", "!=", "<", "<=", ">", ">="):
                op = self.next().text
                op = "<>" if op == "!=" else op
                right = self.parse_additive()
                left = t.ComparisonExpression(op, left, right)
                continue
            negated = False
            save = self.i
            if self.accept_kw("not"):
                if not self.at_kw("between", "in", "like"):
                    self.i = save
                    return left
                negated = True
            if self.accept_kw("between"):
                lo = self.parse_additive()
                self.expect_kw("and")
                hi = self.parse_additive()
                node: t.Expression = t.BetweenPredicate(left, lo, hi)
            elif self.accept_kw("in"):
                self.expect_op("(")
                if self.at_kw("select", "with"):
                    node = t.InPredicate(left, t.SubqueryExpression(self.parse_query()))
                else:
                    vals = [self.parse_expr()]
                    while self.accept_op(","):
                        vals.append(self.parse_expr())
                    node = t.InPredicate(left, t.InListExpression(tuple(vals)))
                self.expect_op(")")
            elif self.accept_kw("like"):
                pattern = self.parse_additive()
                escape = None
                if self.accept_kw("escape"):
                    escape = self.parse_additive()
                node = t.LikePredicate(left, pattern, escape)
            elif self.accept_kw("is"):
                neg = self.accept_kw("not")
                self.expect_kw("null")
                node = t.IsNotNullPredicate(left) if neg else t.IsNullPredicate(left)
            else:
                return left
            left = t.NotExpression(node) if negated else node

    def parse_additive(self) -> t.Expression:
        left = self.parse_multiplicative()
        while True:
            if self.at_op("+", "-"):
                op = self.next().text
                left = t.ArithmeticBinary(op, left, self.parse_multiplicative())
            elif self.at_op("||"):
                self.next()
                left = t.FunctionCall("concat", (left, self.parse_multiplicative()))
            else:
                return left

    def parse_multiplicative(self) -> t.Expression:
        left = self.parse_unary()
        while self.at_op("*", "/", "%"):
            op = self.next().text
            left = t.ArithmeticBinary(op, left, self.parse_unary())
        return left

    def parse_unary(self) -> t.Expression:
        if self.at_op("-", "+"):
            op = self.next().text
            value = self.parse_unary()
            if op == "-" and isinstance(value, t.LongLiteral):
                return t.LongLiteral(-value.value)
            if op == "-" and isinstance(value, t.DoubleLiteral):
                return t.DoubleLiteral(-value.value)
            return t.ArithmeticUnary(op, value)
        return self.parse_primary()

    def parse_primary(self) -> t.Expression:
        tok = self.peek()

        if tok.kind == "number":
            self.next()
            if re.fullmatch(r"\d+", tok.text):
                return t.LongLiteral(int(tok.text))
            if "e" in tok.text.lower():
                return t.DoubleLiteral(float(tok.text))
            return t.DecimalLiteral(tok.text)
        if tok.kind == "string":
            self.next()
            return t.StringLiteral(tok.text)
        if self.accept_kw("true"):
            return t.BooleanLiteral(True)
        if self.accept_kw("false"):
            return t.BooleanLiteral(False)
        if self.accept_kw("null"):
            return t.NullLiteral()

        if self.at_kw("date") and self.peek(1).kind == "string":
            self.next()
            return t.DateLiteral(self.next().text)
        if self.at_kw("timestamp") and self.peek(1).kind == "string":
            self.next()
            return t.TimestampLiteral(self.next().text)
        if self.accept_kw("interval"):
            sign = 1
            if self.at_op("-"):
                self.next()
                sign = -1
            vtok = self.next()
            if vtok.kind not in ("string", "number"):
                self.error("expected interval value")
            unit = self.next().text.lower()
            if unit not in ("day", "month", "year", "hour", "minute", "second", "week"):
                self.error(f"unsupported interval unit {unit!r}")
            return t.IntervalLiteral(vtok.text, unit, sign)

        if self.at_kw("cast", "try_cast"):
            safe = tok.kind == "kw:try_cast"
            self.next()
            self.expect_op("(")
            e = self.parse_expr()
            self.expect_kw("as")
            tn = self.parse_type_name()
            self.expect_op(")")
            return t.Cast(e, tn, safe)

        if self.accept_kw("extract"):
            self.expect_op("(")
            field = self.next().text.upper()
            self.expect_kw("from")
            e = self.parse_expr()
            self.expect_op(")")
            return t.Extract(field, e)

        if self.accept_kw("case"):
            if self.at_kw("when"):
                whens = []
                while self.accept_kw("when"):
                    cond = self.parse_expr()
                    self.expect_kw("then")
                    whens.append(t.WhenClause(cond, self.parse_expr()))
                default = self.parse_expr() if self.accept_kw("else") else None
                self.expect_kw("end")
                return t.SearchedCaseExpression(tuple(whens), default)
            operand = self.parse_expr()
            whens = []
            while self.accept_kw("when"):
                val = self.parse_expr()
                self.expect_kw("then")
                whens.append(t.WhenClause(val, self.parse_expr()))
            default = self.parse_expr() if self.accept_kw("else") else None
            self.expect_kw("end")
            return t.SimpleCaseExpression(operand, tuple(whens), default)

        if self.accept_kw("coalesce"):
            self.expect_op("(")
            ops = [self.parse_expr()]
            while self.accept_op(","):
                ops.append(self.parse_expr())
            self.expect_op(")")
            return t.CoalesceExpression(tuple(ops))

        if self.accept_kw("exists"):
            self.expect_op("(")
            q = self.parse_query()
            self.expect_op(")")
            return t.ExistsPredicate(t.SubqueryExpression(q))

        if self.accept_kw("substring"):
            self.expect_op("(")
            e = self.parse_expr()
            if self.accept_kw("from"):
                start = self.parse_expr()
                length = self.parse_expr() if self.accept_kw("for") else None
            else:
                self.expect_op(",")
                start = self.parse_expr()
                length = self.parse_expr() if self.accept_op(",") else None
            self.expect_op(")")
            args = (e, start) + ((length,) if length is not None else ())
            return t.FunctionCall("substring", args)

        if self.accept_kw("row"):
            self.expect_op("(")
            items = [self.parse_expr()]
            while self.accept_op(","):
                items.append(self.parse_expr())
            self.expect_op(")")
            return t.Row(tuple(items))

        if self.at_kw("array") and self.peek(1).kind == "op" and \
                self.peek(1).text == "[":
            self.next()  # array
            self.next()  # [
            items = []
            if not self.at_op("]"):
                items.append(self.parse_expr())
                while self.accept_op(","):
                    items.append(self.parse_expr())
            self.expect_op("]")
            return t.ArrayConstructor(tuple(items))

        if self.accept_op("("):
            if self.at_kw("select", "with"):
                q = self.parse_query()
                self.expect_op(")")
                return t.SubqueryExpression(q)
            e = self.parse_expr()
            if self.at_op(","):  # bare row constructor (a, b, ...)
                items = [e]
                while self.accept_op(","):
                    items.append(self.parse_expr())
                self.expect_op(")")
                return t.Row(tuple(items))
            self.expect_op(")")
            return e

        # identifier / function call / qualified name
        if tok.kind == "ident" or tok.kind.startswith("kw:"):
            name = self.expect_ident()
            if self.at_op("(" ):
                return self.parse_call(name)
            expr: t.Expression = t.Identifier(name.lower())
            while self.at_op(".") and not (self.peek(1).kind == "op" and self.peek(1).text == "*"):
                self.next()
                field = self.expect_ident()
                if self.at_op("("):
                    return self.parse_call(field)  # schema-qualified fn: use base name
                expr = t.DereferenceExpression(expr, field.lower())
            return expr

        self.error("unexpected token in expression")

    def parse_call(self, name: str) -> t.Expression:
        self.expect_op("(")
        distinct = False
        args: List[t.Expression] = []
        if self.at_op("*"):
            self.next()
            self.expect_op(")")
            call: t.Expression = t.FunctionCall(name.lower(), ())
        else:
            if not self.at_op(")"):
                distinct = self.accept_kw("distinct")
                self.accept_kw("all")
                args.append(self.parse_expr())
                while self.accept_op(","):
                    args.append(self.parse_expr())
            self.expect_op(")")
            call = t.FunctionCall(name.lower(), tuple(args), distinct)
        if self.accept_kw("filter"):
            self.expect_op("(")
            self.expect_kw("where")
            cond = self.parse_expr()
            self.expect_op(")")
            assert isinstance(call, t.FunctionCall)
            call = t.FunctionCall(call.name, call.args, call.distinct, cond)
        if self.at_kw("over"):
            assert isinstance(call, t.FunctionCall)
            return t.WindowExpression(call, self.parse_window_spec())
        return call

    def parse_window_spec(self) -> t.WindowSpec:
        self.expect_kw("over")
        self.expect_op("(")
        partition: List[t.Expression] = []
        if self.accept_kw("partition"):
            self.expect_kw("by")
            partition.append(self.parse_expr())
            while self.accept_op(","):
                partition.append(self.parse_expr())
        order_by, limit = (), None
        if self.at_kw("order"):
            order_by, limit = self.parse_order_limit()
            if limit is not None:
                self.error("LIMIT not allowed in window specification")
        frame_mode = "range"
        if self.at_kw("rows", "range"):
            frame_mode = self.next().text.lower()
            # only the default frame shape executes:
            #   [ROWS|RANGE] BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW
            self.expect_kw("between")
            self.expect_kw("unbounded")
            self.expect_kw("preceding")
            self.expect_kw("and")
            self.expect_kw("current")
            self.expect_kw("row")
        self.expect_op(")")
        return t.WindowSpec(tuple(partition), tuple(order_by), frame_mode)

    def parse_type_name(self) -> t.TypeName:
        name = self.expect_ident().lower()
        if name == "double" and self.at_kw("all") is False and self.peek().kind == "ident" \
                and self.peek().text.lower() == "precision":
            self.next()
        params: List[int] = []
        if self.accept_op("("):
            while not self.accept_op(")"):
                tok = self.next()
                if tok.kind == "number":
                    params.append(int(tok.text))
                self.accept_op(",")
        return t.TypeName(name, tuple(params))
