"""Row-expression IR and its compiler to torch closures.

Counterpart of ``presto_tpu/ops/expressions.py`` for the functions that TPC-H
Q1, Q3 and Q6 use. The IR is the same; the compiler composes closures over
tensors instead of jnp arrays. Its rules are the reference's:

- every compiled node yields ``(data, nulls)``, with ``nulls=None`` meaning
  provably non-null;
- DECIMAL is a scaled int64: multiply adds scales and rescales with floor
  division, add/subtract align scales first, comparisons align scales;
- VARCHAR is dictionary codes, and string predicates resolve the literal
  against the column's dictionary when the expression is compiled;
- DATE is int32 days, with the reference's civil-date helpers.

Anything else raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..block import Dictionary, torch_dtype
from ..types import (BIGINT, DATE, DOUBLE, INTEGER, DecimalType, Type,
                     is_floating, is_integral, is_string)

CompiledValue = Tuple[torch.Tensor, Optional[torch.Tensor]]  # (data, null_mask)


# ---------------------------------------------------------------------------
# IR
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RowExpression:
    type: Type


@dataclasses.dataclass(frozen=True)
class InputRef(RowExpression):
    channel: int

    def __str__(self):
        return f"#{self.channel}"


@dataclasses.dataclass(frozen=True)
class Constant(RowExpression):
    value: Any  # python value; strings raw (encoded at compile), decimals unscaled int

    def __str__(self):
        return repr(self.value)


@dataclasses.dataclass(frozen=True)
class SymbolRef(RowExpression):
    """Planner-level column reference by symbol name. The local execution
    planner rewrites every SymbolRef to a channel InputRef against the
    child operator's layout (``resolve_symbols``)."""
    name: str

    def __str__(self):
        return self.name


@dataclasses.dataclass(frozen=True)
class Call(RowExpression):
    name: str
    args: Tuple[RowExpression, ...]

    def __str__(self):
        return f"{self.name}({', '.join(map(str, self.args))})"


@dataclasses.dataclass(frozen=True)
class SpecialForm(RowExpression):
    """AND / OR / NOT / IN / BETWEEN / CAST."""
    form: str
    args: Tuple[RowExpression, ...]

    def __str__(self):
        return f"{self.form}({', '.join(map(str, self.args))})"


def input_ref(channel: int, type_: Type) -> InputRef:
    return InputRef(type_, channel)


def symbol_ref(name: str, type_: Type) -> SymbolRef:
    return SymbolRef(type_, name)


def rewrite_expression(expr: RowExpression, fn) -> RowExpression:
    """Bottom-up rewrite: fn(node) -> replacement or None (keep). Children first."""
    if isinstance(expr, Call):
        expr = Call(expr.type, expr.name,
                    tuple(rewrite_expression(a, fn) for a in expr.args))
    elif isinstance(expr, SpecialForm):
        expr = SpecialForm(expr.type, expr.form,
                           tuple(rewrite_expression(a, fn) for a in expr.args))
    out = fn(expr)
    return expr if out is None else out


def symbols_in(expr: RowExpression) -> set:
    """Names of all SymbolRefs in the tree."""
    out = set()

    def visit(e):
        if isinstance(e, SymbolRef):
            out.add(e.name)
        return None
    rewrite_expression(expr, visit)
    return out


def resolve_symbols(expr: RowExpression, channels: Dict[str, int]) -> RowExpression:
    """SymbolRef -> InputRef via a symbol->channel map (local-planning step)."""
    def visit(e):
        if isinstance(e, SymbolRef):
            return InputRef(e.type, channels[e.name])
        return None
    return rewrite_expression(expr, visit)


def constant(value: Any, type_: Type) -> Constant:
    return Constant(type_, value)


def call(name: str, type_: Type, *args: RowExpression) -> Call:
    return Call(type_, name, tuple(args))


def special(form: str, type_: Type, *args: RowExpression) -> SpecialForm:
    return SpecialForm(type_, form, tuple(args))


# ---------------------------------------------------------------------------
# type rules (the reference's built-in operator resolution)
# ---------------------------------------------------------------------------

def arithmetic_result_type(op: str, a: Type, b: Type) -> Type:
    if is_string(a) or is_string(b):
        raise TypeError(f"cannot {op} strings")
    if op == "divide":
        if isinstance(a, DecimalType) or isinstance(b, DecimalType) or \
                is_floating(a) or is_floating(b):
            return DOUBLE
        return BIGINT if (a is BIGINT or b is BIGINT) else INTEGER
    if isinstance(a, DecimalType) and isinstance(b, DecimalType):
        if op == "multiply":
            return DecimalType(min(18, a.precision + b.precision), a.scale + b.scale)
        return DecimalType(min(18, max(a.precision, b.precision) + 1), max(a.scale, b.scale))
    if isinstance(a, DecimalType):
        if is_floating(b):
            return DOUBLE
        return a
    if isinstance(b, DecimalType):
        if is_floating(a):
            return DOUBLE
        return b
    if is_floating(a) or is_floating(b):
        return DOUBLE
    if a is DATE or b is DATE:
        return DATE  # date +/- interval days
    order = ["smallint", "integer", "bigint"]
    return a if order.index(a.name) >= order.index(b.name) else b


# ---------------------------------------------------------------------------
# compiler
# ---------------------------------------------------------------------------

class InputLayout:
    """Static description of the input page: types + dictionaries per channel."""

    def __init__(self, types: Sequence[Type], dictionaries: Sequence[Optional[Dictionary]]):
        self.types = list(types)
        self.dictionaries = list(dictionaries)

    def dictionary(self, ch: int) -> Optional[Dictionary]:
        return self.dictionaries[ch]


class CompiledExpression:
    """fn(blocks_data: tuple, blocks_nulls: tuple) -> (data, nulls), plus the
    output dictionary when the expression passes a varchar column through."""

    def __init__(self, fn, type_: Type, dictionary: Optional[Dictionary] = None):
        self.fn = fn
        self.type = type_
        self.dictionary = dictionary

    def __call__(self, datas, nulls) -> CompiledValue:
        return self.fn(datas, nulls)


_CMP_OPS = {"equal": torch.eq, "not_equal": torch.ne, "less_than": torch.lt,
            "less_than_or_equal": torch.le, "greater_than": torch.gt,
            "greater_than_or_equal": torch.ge}
_ARITH = {"add", "subtract", "multiply", "negate"}


class ExpressionCompiler:
    """Compiles a RowExpression against a static InputLayout."""

    def __init__(self, layout: InputLayout):
        self.layout = layout

    def compile(self, expr: RowExpression) -> CompiledExpression:
        fn, dict_ = self._compile(expr)
        return CompiledExpression(fn, expr.type, dict_)

    def _compile(self, expr: RowExpression):
        """-> (fn, output_dictionary)."""
        if isinstance(expr, InputRef):
            ch = expr.channel
            return (lambda datas, nulls: (datas[ch], nulls[ch])), \
                self.layout.dictionary(ch)
        if isinstance(expr, Constant):
            return self._compile_constant(expr)
        if isinstance(expr, SpecialForm):
            return self._compile_special(expr), None
        if isinstance(expr, Call):
            return self._compile_call(expr), None
        raise TypeError(f"unknown expression node {expr!r}")

    def _compile_constant(self, expr: Constant):
        # 0-d CPU tensors: torch treats them as scalars next to device tensors
        if expr.value is None:
            raise NotImplementedError("NULL literals are not ported yet")
        if is_string(expr.type):
            # kept python-side: comparisons resolve it against the other
            # side's dictionary; a projected string constant gets its own
            # single-entry dictionary
            zero = torch.zeros((), dtype=torch.int32)
            return (lambda datas, nulls: (zero, None)), Dictionary([expr.value])
        v = expr.value
        if isinstance(expr.type, DecimalType) and not isinstance(v, (int, np.integer)):
            v = round(float(v) * 10 ** expr.type.scale)
        c = torch.tensor(np.asarray(v, dtype=expr.type.np_dtype))
        return (lambda datas, nulls: (c, None)), None

    # --- special forms ------------------------------------------------------

    def _compile_special(self, expr: SpecialForm):
        form = expr.form
        if form in ("AND", "OR"):
            parts = [self._compile(a)[0] for a in expr.args]
            is_and = form == "AND"

            def fn(datas, nulls):
                acc_d, acc_n = parts[0](datas, nulls)
                for p in parts[1:]:
                    d, n = p(datas, nulls)
                    new_d = (acc_d & d) if is_and else (acc_d | d)
                    acc_n = _logic_nulls(is_and, acc_d, acc_n, d, n)
                    acc_d = new_d
                return acc_d, acc_n
            return fn

        if form == "NOT":
            f = self._compile(expr.args[0])[0]

            def fn(datas, nulls):
                d, n = f(datas, nulls)
                return ~d, n
            return fn

        if form == "IN":
            return self._compile_in(expr)

        if form == "BETWEEN":
            v, lo, hi = expr.args
            ge = self._compile_comparison("greater_than_or_equal", v, lo)
            le = self._compile_comparison("less_than_or_equal", v, hi)

            def fn(datas, nulls):
                g, gn = ge(datas, nulls)
                l, ln = le(datas, nulls)
                return g & l, _combine_nulls(gn, ln)
            return fn

        if form == "CAST":
            return self._compile_cast(expr)

        raise NotImplementedError(f"special form {form} is not ported yet")

    def _compile_in(self, expr: SpecialForm):
        value, items = expr.args[0], expr.args[1:]
        if is_string(value.type) and all(isinstance(i, Constant) for i in items):
            d = self._compile(value)[1]
            codes = sorted(c for c in (d.code_of(i.value) for i in items) if c >= 0) \
                if d else []
            vfn = self._compile(value)[0]

            def fn(datas, nulls):
                vd, vn = vfn(datas, nulls)
                acc = torch.zeros(vd.shape, dtype=torch.bool, device=vd.device)
                for c in codes:
                    acc = acc | (vd == c)
                return acc, vn
            return fn
        ors = [self._compile_comparison("equal", value, i) for i in items]

        def fn(datas, nulls):
            d, n = ors[0](datas, nulls)
            for o in ors[1:]:
                od, on = o(datas, nulls)
                d = d | od
                n = _combine_nulls(n, on)
            return d, n
        return fn

    def _compile_cast(self, expr: SpecialForm):
        src, target = expr.args[0], expr.type
        f = self._compile(src)[0]
        st = src.type
        if st == target:
            return f
        if isinstance(st, DecimalType) and is_floating(target):
            conv = lambda d: _unscale(d, st.scale)  # noqa: E731
        elif isinstance(target, DecimalType) and isinstance(st, DecimalType):
            shift = target.scale - st.scale
            mul = 10 ** abs(shift)
            conv = (lambda d: d.to(torch.int64) * mul) if shift >= 0 \
                else (lambda d: d.to(torch.int64) // mul)
        elif isinstance(target, DecimalType) and is_integral(st):
            mul = 10 ** target.scale
            conv = lambda d: d.to(torch.int64) * mul  # noqa: E731
        elif isinstance(target, DecimalType) and is_floating(st):
            fmul = 10.0 ** target.scale
            conv = lambda d: torch.round(d * fmul).to(torch.int64)  # noqa: E731
        else:
            dtype = torch_dtype(target)
            conv = lambda d: d.to(dtype)  # noqa: E731

        def fn(datas, nulls):
            d, n = f(datas, nulls)
            return conv(d), n
        return fn

    # --- calls --------------------------------------------------------------

    def _compile_call(self, expr: Call):
        name = expr.name
        if name in _CMP_OPS:
            return self._compile_comparison(name, expr.args[0], expr.args[1])
        if name in _ARITH:
            return self._compile_arithmetic(expr)
        if name in ("year", "month", "day"):
            f = self._compile(expr.args[0])[0]
            part = ("year", "month", "day").index(name)

            def fn(datas, nulls):
                d, n = f(datas, nulls)
                return _civil_from_days(d.to(torch.int32))[part].to(torch.int64), n
            return fn
        raise NotImplementedError(f"function {name} is not ported yet")

    def _compile_comparison(self, op: str, left: RowExpression, right: RowExpression):
        if is_string(left.type) or is_string(right.type):
            return self._compile_string_comparison(op, left, right)
        cmp = _CMP_OPS[op]
        lf = self._compile(left)[0]
        rf = self._compile(right)[0]
        lt, rt = left.type, right.type
        lscale = lt.scale if isinstance(lt, DecimalType) else 0
        rscale = rt.scale if isinstance(rt, DecimalType) else 0
        # align decimal scales; mixed decimal/float compares in float space
        mixed_float = (is_floating(lt) and isinstance(rt, DecimalType)) or \
                      (is_floating(rt) and isinstance(lt, DecimalType))

        def fn(datas, nulls):
            ld, ln = lf(datas, nulls)
            rd, rn = rf(datas, nulls)
            if mixed_float:
                if lscale:
                    ld = _unscale(ld, lscale)
                if rscale:
                    rd = _unscale(rd, rscale)
            elif lscale < rscale:
                ld = ld.to(torch.int64) * (10 ** (rscale - lscale))
            elif rscale < lscale:
                rd = rd.to(torch.int64) * (10 ** (lscale - rscale))
            return cmp(ld, rd), _combine_nulls(ln, rn)
        return fn

    def _compile_string_comparison(self, op: str, left: RowExpression, right: RowExpression):
        if isinstance(left, Constant) and not isinstance(right, Constant) \
                and op in ("equal", "not_equal"):
            left, right = right, left
        if op not in ("equal", "not_equal"):
            raise NotImplementedError(f"string comparison {op} is not ported yet")
        neq = op == "not_equal"
        lf, ld_ = self._compile(left)
        if isinstance(right, Constant):
            # literal vs column: the literal's code in the column's dictionary
            code = ld_.code_of(right.value) if ld_ else -1

            def fn(datas, nulls):
                ld, ln = lf(datas, nulls)
                if code < 0:
                    r = torch.full(ld.shape, neq, dtype=torch.bool, device=ld.device)
                    return r, ln
                return ((ld != code) if neq else (ld == code)), ln
            return fn
        rf, rd_ = self._compile(right)
        if ld_ is not rd_:
            raise NotImplementedError(
                "cross-dictionary string comparison requires a re-encode")

        def fn(datas, nulls):
            ld, ln = lf(datas, nulls)
            rd, rn = rf(datas, nulls)
            return ((ld != rd) if neq else (ld == rd)), _combine_nulls(ln, rn)
        return fn

    def _compile_arithmetic(self, expr: Call):
        name = expr.name
        if name == "negate":
            f = self._compile(expr.args[0])[0]

            def neg(datas, nulls):
                d, n = f(datas, nulls)
                return -d, n
            return neg
        left, right = expr.args
        lf = self._compile(left)[0]
        rf = self._compile(right)[0]
        lt, rt = left.type, right.type
        out = expr.type
        lscale = lt.scale if isinstance(lt, DecimalType) else 0
        rscale = rt.scale if isinstance(rt, DecimalType) else 0
        oscale = out.scale if isinstance(out, DecimalType) else 0

        def fn(datas, nulls):
            ld, ln = lf(datas, nulls)
            rd, rn = rf(datas, nulls)
            n = _combine_nulls(ln, rn)
            if isinstance(out, DecimalType):
                a = ld.to(torch.int64)
                b = rd.to(torch.int64)
                if name == "multiply":
                    # scales add: (a*10^-ls)*(b*10^-rs) = ab * 10^-(ls+rs)
                    d = a * b
                    if lscale + rscale < oscale:
                        d = d * (10 ** (oscale - lscale - rscale))
                    elif lscale + rscale > oscale:
                        d = d // (10 ** (lscale + rscale - oscale))
                    return d, n
                a = a * (10 ** (oscale - lscale))
                b = b * (10 ** (oscale - rscale))
                return (a + b if name == "add" else a - b), n
            if not is_integral(out):
                raise NotImplementedError(f"{name} on {out.display_name()} is not ported yet")
            d = {"add": torch.add, "subtract": torch.sub, "multiply": torch.mul}[name](ld, rd)
            return d.to(torch_dtype(out)), n
        return fn


def _unscale(d: torch.Tensor, scale: int) -> torch.Tensor:
    """Scaled decimal -> float64. The reference divides by 10**scale inside a
    jitted function, which XLA folds into a multiply by the reciprocal; the
    port multiplies the same way so DOUBLE results agree bit for bit."""
    d = d.to(torch.float64)
    return d * (1.0 / 10 ** scale) if scale else d


def _combine_nulls(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a | b


def _logic_nulls(is_and: bool, ad, an, bd, bn):
    """3-valued AND/OR null mask."""
    if an is None and bn is None:
        return None
    ann = an if an is not None else torch.zeros(ad.shape, dtype=torch.bool, device=ad.device)
    bnn = bn if bn is not None else torch.zeros(bd.shape, dtype=torch.bool, device=bd.device)
    if is_and:
        # null AND true = null; null AND false = false
        return (ann & (bnn | bd)) | (bnn & (ann | ad))
    # null OR false = null; null OR true = true
    return (ann & (bnn | ~bd)) | (bnn & (ann | ~ad))


def _civil_from_days(days: torch.Tensor):
    """days since 1970-01-01 -> (year, month, day), Howard Hinnant's
    branch-free algorithm (the reference's ``_civil_from_days``)."""
    z = days.to(torch.int32) + 719468
    era = torch.where(z >= 0, z, z - 146096) // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = torch.where(m <= 2, y + 1, y)
    return y, m, d


def days_from_civil(y: int, m: int, d: int) -> int:
    """Host-side inverse of ``_civil_from_days``, for date literals."""
    y -= m <= 2
    era = (y if y >= 0 else y - 399) // 400
    yoe = y - era * 400
    doy = (153 * (m + (-3 if m > 2 else 9)) + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468
