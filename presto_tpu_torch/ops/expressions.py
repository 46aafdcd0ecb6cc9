"""Row-expression IR and its compiler to torch closures.

Counterpart of ``presto_tpu/ops/expressions.py`` for the functions that the
22 TPC-H queries use. The IR is the same; the compiler composes closures over
tensors instead of jnp arrays. Its rules are the reference's:

- every compiled node yields ``(data, nulls)``, with ``nulls=None`` meaning
  provably non-null;
- DECIMAL is a scaled int64: multiply adds scales and rescales with floor
  division, add/subtract align scales first, comparisons align scales;
- VARCHAR is dictionary codes, and string predicates resolve the literal
  against the column's dictionary when the expression is compiled; LIKE
  resolves to the set of matching codes, or, over a
  ``PackedWordsDictionary``, to a dynamic program over the packed word
  fields (``_packed_like``);
- DATE is int32 days, with the reference's civil-date helpers;
- ``divide`` with a DECIMAL or floating operand, and any arithmetic where a
  DECIMAL meets a DOUBLE, runs in float64 on the unscaled values; integral
  ``divide`` truncates toward zero and ``modulus`` takes the dividend's sign;
- IF, SWITCH (searched CASE) and COALESCE select per row with
  ``torch.where``; a NULL condition counts as false, and the branches'
  dictionaries must be one dictionary (``_merge_dicts``);
- ``substr`` over a dictionary column rewrites the dictionary on the host
  and remaps the codes; over a virtual dictionary it takes the generator's
  ``substr_rules``.

Anything else raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..block import Dictionary, torch_dtype
from ..types import (BIGINT, DATE, DOUBLE, INTEGER, REAL, UNKNOWN, DecimalType, Type,
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
    """AND / OR / NOT / IN / BETWEEN / CAST / IS_NULL / IF / COALESCE / SWITCH."""
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
_ARITH = {"add", "subtract", "multiply", "divide", "modulus", "negate"}


# pluggable scalar-function compilers, keyed by Call name: each maps
# ``(compiler, call_expr) -> (closure, output_dictionary)``. They pair with
# sql/analyzer.py's EXTERNAL_FUNCTIONS typers; the libraries of
# ``presto_tpu_torch.functions`` register both on import. Looked up after
# every built-in, as the reference does.
EXTERNAL_COMPILERS: Dict[str, Callable] = {}


def register_compiler(name: str, fn) -> None:
    EXTERNAL_COMPILERS[name.lower()] = fn  # prestocheck: ignore[unbounded-cache] - plugin registry: one entry per registered function, not per request


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
            return self._compile_special(expr)
        if isinstance(expr, Call):
            return self._compile_call(expr)
        raise TypeError(f"unknown expression node {expr!r}")

    def _compile_constant(self, expr: Constant):
        # 0-d CPU tensors: torch treats them as scalars next to device tensors
        if expr.value is None:
            z = torch.tensor(np.asarray(0, dtype=(BIGINT if expr.type is UNKNOWN
                                                   else expr.type).np_dtype))
            null = torch.tensor(True)
            return (lambda datas, nulls: (z, null)), None
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
        """-> (fn, output_dictionary)."""
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
            return fn, None

        if form == "NOT":
            f = self._compile(expr.args[0])[0]

            def fn(datas, nulls):
                d, n = f(datas, nulls)
                return ~d, n
            return fn, None

        if form == "IS_NULL":
            f = self._compile(expr.args[0])[0]

            def fn(datas, nulls):
                d, n = f(datas, nulls)
                if n is None:
                    return torch.zeros(d.shape, dtype=torch.bool, device=d.device), None
                return n, None
            return fn, None

        if form == "IF":
            c = self._compile(expr.args[0])[0]
            t, td = self._compile(expr.args[1])
            e, ed = self._compile(expr.args[2])
            out_dict = _merge_dicts(td, ed)
            dtype = _value_dtype(expr.type)

            def fn(datas, nulls):
                cond = _true(*c(datas, nulls))
                td_, tn = t(datas, nulls)
                ed_, en = e(datas, nulls)
                return _where(cond, td_, ed_, dtype), _where_nulls(cond, tn, en)
            return fn, out_dict

        if form == "COALESCE":
            parts = [self._compile(a) for a in expr.args]
            out_dict = None
            for _, d in parts:
                out_dict = _merge_dicts(out_dict, d)
            dtype = _value_dtype(expr.type)

            def fn(datas, nulls):
                data, n = parts[0][0](datas, nulls)
                data = data.to(dtype)
                for p, _ in parts[1:]:
                    if n is None:
                        break
                    pd, pn = p(datas, nulls)
                    data = _where(n, pd, data, dtype)
                    n = pn if pn is None else (n & pn)
                return data, n
            return fn, out_dict

        if form == "IN":
            return self._compile_in(expr), None

        if form == "BETWEEN":
            v, lo, hi = expr.args
            ge = self._compile_comparison("greater_than_or_equal", v, lo)
            le = self._compile_comparison("less_than_or_equal", v, hi)

            def fn(datas, nulls):
                g, gn = ge(datas, nulls)
                l, ln = le(datas, nulls)
                return g & l, _combine_nulls(gn, ln)
            return fn, None

        if form == "CAST":
            return self._compile_cast(expr)

        if form == "SWITCH":
            # searched CASE, flattened: cond1, val1, cond2, val2, ..., default
            pairs, default = expr.args[:-1], expr.args[-1]
            conds = [self._compile(pairs[i])[0] for i in range(0, len(pairs), 2)]
            vals = [self._compile(pairs[i + 1]) for i in range(0, len(pairs), 2)]
            dflt, out_dict = self._compile(default)
            for _, vd in vals:
                out_dict = _merge_dicts(out_dict, vd)
            dtype = _value_dtype(expr.type)

            def fn(datas, nulls):
                data, n = dflt(datas, nulls)
                data = data.to(dtype)
                # in reverse, so that the first match wins
                for c, (v, _) in zip(reversed(conds), reversed(vals)):
                    cond = _true(*c(datas, nulls))
                    vd_, vn = v(datas, nulls)
                    data = _where(cond, vd_, data, dtype)
                    n = _where_nulls(cond, vn, n)
                return data, n
            return fn, out_dict

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
        f, d = self._compile(src)
        st = src.type
        if st == target:
            return f, d
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
        return fn, None

    # --- calls --------------------------------------------------------------

    def _compile_call(self, expr: Call):
        """-> (fn, output_dictionary)."""
        name = expr.name
        if name in _CMP_OPS:
            return self._compile_comparison(name, expr.args[0], expr.args[1]), None
        if name in _ARITH:
            return self._compile_arithmetic(expr), None
        if name == "like":
            return self._compile_like(expr), None
        if name in ("year", "month", "day"):
            f = self._compile(expr.args[0])[0]
            part = ("year", "month", "day").index(name)

            def fn(datas, nulls):
                d, n = f(datas, nulls)
                return _civil_from_days(d.to(torch.int32))[part].to(torch.int64), n
            return fn, None
        if name in ("substr", "substring"):
            return self._compile_substr(expr)
        if name == "cardinality":
            return self._compile_cardinality(expr), None
        if name in _NUMERIC:
            return self._compile_math(expr), None
        if name in ("greatest", "least"):
            fns = [self._compile(a)[0] for a in expr.args]
            pick = torch.maximum if name == "greatest" else torch.minimum
            dtype = _value_dtype(expr.type)

            def fn(datas, nulls):
                d, n = fns[0](datas, nulls)
                d = d.to(dtype)
                for g in fns[1:]:
                    d2, n2 = g(datas, nulls)
                    d = pick(d, d2.to(dtype))
                    n = _combine_nulls(n, n2)  # NULL if any argument is
                return d, n
            return fn, None
        if name in _DATE_PARTS:
            return self._compile_date_part(expr), None
        if name in ("length", "upper", "lower"):
            return self._compile_string_function(expr)
        plugin = EXTERNAL_COMPILERS.get(name)
        if plugin is not None:
            return plugin(self, expr)
        raise NotImplementedError(f"function {name} is not ported yet")

    def _dictionary_of(self, expr: RowExpression) -> Optional[Dictionary]:
        """The dictionary ``expr`` produces (None for a non-string value)."""
        return self._compile(expr)[1]

    def _compile_cardinality(self, expr: Call):
        """cardinality of an ARRAY/MAP handle column: each entry's length,
        gathered from the store's contents when the expression is compiled
        (the page processor recompiles when the store's size changes); a
        NULL handle (-1) is NULL."""
        f, d = self._compile(expr.args[0])
        if d is None or not hasattr(d, "values"):
            raise NotImplementedError("cardinality() needs an array/map handle column")
        lengths = _DeviceTable(np.asarray([len(v) for v in d.values] + [0], dtype=np.int64))

        def fn(datas, nulls):
            data, n = f(datas, nulls)
            codes = data.to(torch.int64)
            out = lengths.on(codes.device)[codes.clamp(0, len(lengths) - 1)]
            neg = codes < 0
            return out, neg if n is None else (n | neg)
        return fn

    def _compile_math(self, expr: Call):
        """The numeric built-ins, with the reference's formulas: DECIMAL
        round/floor/ceil/truncate work exactly on the scaled integers, and
        round rounds half away from zero. DOUBLE functions agree with the
        reference's XLA to within an ulp or two (XLA's transcendental
        functions are its own, not libm's); log2 is its log(x) * (1/ln 2)."""
        name = expr.name
        f = self._compile(expr.args[0])[0]
        at = expr.args[0].type
        if name == "round" and isinstance(at, DecimalType):
            def unary(d, _m=10 ** at.scale):
                return _round_scaled(d, _m)
        elif name in ("floor", "ceil", "ceiling") and isinstance(at, DecimalType):
            m = 10 ** at.scale

            def unary(d, _m=m, _floor=name == "floor"):
                a = torch.abs(d)
                if _floor:
                    q = torch.where(d >= 0, a // _m, -((a + _m - 1) // _m))
                else:
                    q = torch.where(d >= 0, (a + _m - 1) // _m, -(a // _m))
                return (q * _m).to(torch.int64)
        elif name == "truncate" and isinstance(at, DecimalType):
            m = 10 ** at.scale

            def unary(d, _m=m):  # toward zero on the scaled integers
                return (torch.sign(d) * (torch.abs(d) // _m) * _m).to(torch.int64)
        elif name == "round":
            def unary(d):  # half away from zero, not half to even
                return torch.sign(d) * torch.floor(torch.abs(d) + 0.5)
        elif name == "round2":
            dig = expr.args[1]
            if not isinstance(dig, Constant):
                raise NotImplementedError("round() digits must be a literal")
            digits = int(dig.value)
            if is_integral(at) or isinstance(at, DecimalType):
                shift = (at.scale if isinstance(at, DecimalType) else 0) - digits
                if shift <= 0:
                    return f  # already finer than the requested digits
                def unary(d, _m=10 ** shift):
                    return _round_scaled(d, _m)
            else:
                mul = 10.0 ** digits

                def unary(d, _mul=mul):
                    return torch.sign(d) * torch.floor(torch.abs(d) * _mul + 0.5) / _mul
        elif name == "sign":
            if is_floating(at):
                def unary(d):  # sign(double) is double; NaN stays NaN
                    return torch.where(torch.isnan(d), d, torch.sign(d))
            else:
                def unary(d):
                    return torch.sign(d).to(torch.int64)
        elif name == "power":
            g = self._compile(expr.args[1])[0]

            def fn(datas, nulls):
                a, na = f(datas, nulls)
                b, nb = g(datas, nulls)
                return torch.pow(a, b), _combine_nulls(na, nb)
            return fn
        else:
            unary = _hash64 if name == "hash_code" else _MATH[name]

        def fn(datas, nulls):
            d, n = f(datas, nulls)
            return unary(d), n
        return fn

    def _compile_date_part(self, expr: Call):
        """quarter, ISO week, day_of_week (1 = Monday) and day_of_year of a
        DATE, with the reference's civil-date arithmetic."""
        f = self._compile(expr.args[0])[0]
        part = expr.name

        def fn(datas, nulls):
            d, n = f(datas, nulls)
            days = d.to(torch.int32)
            d64 = days.to(torch.int64)
            if part == "quarter":
                _, m, _ = _civil_from_days(days)
                out = (m - 1) // 3 + 1
            elif part in ("day_of_week", "dow"):
                out = (d64 + 3) % 7 + 1
            else:
                y, _, _ = _civil_from_days(days)
                doy = d64 - _days_from_civil_vec(y, 1, 1) + 1
                if part in ("day_of_year", "doy"):
                    out = doy
                else:  # ISO 8601 week of the year
                    w = (doy - ((d64 + 3) % 7 + 1) + 10) // 7
                    y64 = y.to(torch.int64)
                    out = torch.where(w < 1, _weeks_in(y64 - 1),
                                      torch.where(w > _weeks_in(y64), 1, w))
            return out.to(torch.int64), n
        return fn

    def _compile_string_function(self, expr: Call):
        """length, upper and lower over a dictionary column, on the host
        dictionary: length gathers per-code lengths; upper/lower re-encode
        into a deduplicated dictionary of the transformed values, since two
        values may map to one ('abc' and 'ABC')."""
        name = expr.name
        f, d = self._compile(expr.args[0])
        if d is None or not hasattr(d, "values"):
            raise NotImplementedError(f"{name}() needs a materialized dictionary column")
        hi = max(len(d.values) - 1, 0)
        if name == "length":
            table = _DeviceTable(np.asarray([len(v) for v in d.values], dtype=np.int64))
            new_dict = None
        else:
            xform = str.upper if name == "upper" else str.lower
            transformed = [xform(v) for v in d.values]
            new_dict = Dictionary(sorted(set(transformed)))
            pos = new_dict.index()
            table = _DeviceTable(np.asarray([pos[v] for v in transformed], dtype=np.int32))

        def fn(datas, nulls):
            c, n = f(datas, nulls)
            return table.on(c.device)[c.to(torch.int64).clamp(0, hi)], n
        return fn, new_dict

    def _compile_substr(self, expr: Call):
        """substr over a dictionary column with literal bounds: the
        dictionary is rewritten on the host and the codes remapped on the
        device. A virtual dictionary (no values) needs the generator's
        synthesized rule for these bounds; anything else raises."""
        value, start = expr.args[0], expr.args[1]
        length = expr.args[2] if len(expr.args) > 2 else None
        vf, d = self._compile(value)
        if d is None or not isinstance(start, Constant) or \
                (length is not None and not isinstance(length, Constant)):
            raise NotImplementedError("substr needs a dictionary input and literal bounds")
        if not hasattr(d, "values"):
            key = (int(start.value), int(length.value) if length is not None else None)
            rule = getattr(d, "substr_rules", {}).get(key)
            if rule is None:
                raise NotImplementedError(
                    f"substr over a virtual dictionary ({type(d).__name__}) has no "
                    f"synthesized rule for {key}")
            nd, transform = rule

            def vfn(datas, nulls):
                vd, vn = vf(datas, nulls)
                return transform(vd).to(torch.int32), vn
            return vfn, nd
        s = int(start.value) - 1
        ln = int(length.value) if length is not None else None
        new_values = [v[s:s + ln] if ln is not None else v[s:] for v in d.values]
        nd = Dictionary(sorted(set(new_values)))
        index = nd.index()
        remap = torch.from_numpy(np.asarray([index[v] for v in new_values], dtype=np.int32))
        on_device = {}

        def fn(datas, nulls):
            vd, vn = vf(datas, nulls)
            if vd.device not in on_device:
                on_device[vd.device] = remap.to(vd.device)
            return on_device[vd.device][vd.long()], vn
        return fn, nd

    def _compile_like(self, expr: Call):
        """LIKE against a literal pattern: the matching codes of the value's
        dictionary (OR-ed equalities up to 64 codes, sorted membership
        above), or the word-field program over a ``PackedWordsDictionary``.
        A ``FormattedDictionary`` refuses (it has no entries to match)."""
        value, pattern = expr.args[0], expr.args[1]
        escape = expr.args[2].value if len(expr.args) > 2 else None
        if not isinstance(pattern, Constant):
            raise NotImplementedError("LIKE with a non-literal pattern is not ported")
        vf, d = self._compile(value)
        if d is None:
            raise NotImplementedError("LIKE over a column without a dictionary is not ported")
        from ..connectors.tpch.generator import PackedWordsDictionary

        if isinstance(d, PackedWordsDictionary):
            # escaped patterns would need escape-aware tokenization
            fn = None if escape is not None else _packed_like(d, pattern.value, vf)
            if fn is None:
                raise NotImplementedError(f"LIKE {pattern.value!r} on packed column")
            return fn
        codes = d.codes_where(_like_to_predicate(pattern.value, escape))
        sorted_codes = torch.from_numpy(np.sort(codes).astype(np.int32))

        def fn(datas, nulls):
            vd, vn = vf(datas, nulls)
            if len(codes) == 0:
                return torch.zeros(vd.shape, dtype=torch.bool, device=vd.device), vn
            if len(codes) <= 64:
                acc = vd == int(codes[0])
                for c in codes[1:]:
                    acc = acc | (vd == int(c))
                return acc, vn
            # large match sets: sorted membership
            sc = sorted_codes.to(vd.device)
            pos = torch.searchsorted(sc, vd.to(torch.int32).contiguous()).clamp(0, len(codes) - 1)
            return sc[pos] == vd, vn
        return fn

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
                if name == "add":
                    return a + b, n
                if name == "subtract":
                    return a - b, n
                if name == "modulus":
                    # SQL mod takes the sign of the DIVIDEND
                    return _sign_mod(a, _nonzero(b)), n
                raise AssertionError(name)
            if out is DOUBLE or out is REAL:
                # float64 on the unscaled values, in the reference's order
                a = _unscale(ld, lscale)
                b = _unscale(rd, rscale)
                if name == "modulus":
                    return _sign_mod(a, b), n
                op = {"add": torch.add, "subtract": torch.sub, "multiply": torch.mul,
                      "divide": torch.div}[name]
                return op(a, b), n
            if out is DATE and name in ("add", "subtract"):
                # date ± integer days, on int64 and back to int32 days
                op = torch.add if name == "add" else torch.sub
                return op(ld.to(torch.int64), rd.to(torch.int64)).to(torch.int32), n
            if not is_integral(out):
                raise NotImplementedError(f"{name} on {out.display_name()} is not ported yet")
            dtype = torch_dtype(out)
            if name == "divide":
                # truncate toward zero. As in the reference, a zero divisor
                # divides by 1 (x / 0 is x) and x mod 0 is 0, not an error
                a = ld.to(torch.int64)
                b = rd.to(torch.int64)
                bs = _nonzero(b)
                q = torch.div(a, bs, rounding_mode="floor")
                r = a - q * bs
                return torch.where((r != 0) & ((a < 0) ^ (b < 0)), q + 1, q).to(dtype), n
            if name == "modulus":
                return _sign_mod(ld, _nonzero(rd)).to(dtype), n
            d = {"add": torch.add, "subtract": torch.sub, "multiply": torch.mul}[name](ld, rd)
            return d.to(dtype), n
        return fn


def _like_to_predicate(pattern: str, escape: Optional[str] = None) -> Callable[[str], bool]:
    """SQL LIKE -> python predicate over one dictionary entry."""
    out = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if escape and c == escape and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if c == "%":
            out.append(".*")
        elif c == "_":
            out.append(".")
        else:
            out.append(re.escape(c))
        i += 1
    rx = re.compile("^" + "".join(out) + "$", re.DOTALL)
    return lambda s: rx.match(s) is not None


def _packed_like(d, pattern: str, vf):
    """LIKE over a ``PackedWordsDictionary`` column, exactly, without making
    strings: a pattern ``%t1%t2%...%`` (tokens free of ``%``, ``_`` and the
    separator; either end may be anchored) is an ordered containment test,
    run as a dynamic program over the packed word fields. State s = "the
    first s tokens matched"; a field's word moves s to e when tokens[s:e]
    appear in order inside it. The word -> move tables are built on the
    host; the device does one gather per (field, move). Returns None when
    the pattern has another shape."""
    if "_" in pattern:
        return None
    anchored_start = not pattern.startswith("%")
    anchored_end = not pattern.endswith("%")
    tokens = [t for t in pattern.split("%") if t != ""]
    if not tokens or any(d.sep in t for t in tokens):
        return None
    k = len(tokens)

    def contains_seq(word: str, toks, at_start=False, at_end=False) -> bool:
        """tokens appear in order within the word; optionally the first must
        start at position 0 / the last must end at the word's end."""
        pos = 0
        for i, t in enumerate(toks):
            if i == 0 and at_start:
                if not word.startswith(t):
                    return False
                j = 0
            else:
                j = word.find(t, pos)
                if j < 0:
                    return False
            pos = j + len(t)
        if at_end and toks:
            last = toks[-1]
            # the last token as far right as possible after the prior ones
            prior_end = 0
            for t in toks[:-1]:
                prior_end = word.find(t, prior_end) + len(t)
            return word.endswith(last) and word.rfind(last) >= prior_end
        return True

    # move tables: a word moves the program from "s tokens matched" to "e
    # matched". Anchored variants pin the first/last token to the word's
    # boundary; an anchored start also restricts the match to field 0.
    tables = {}
    for s in range(k):
        for e in range(s + 1, k + 1):
            a_s = anchored_start and s == 0
            a_e = anchored_end and e == k
            tables[(s, e, a_s, a_e)] = torch.from_numpy(np.asarray(
                [contains_seq(w, tokens[s:e], a_s, a_e) for w in d.words], dtype=bool))
    bits, nf, nw = d.BITS, d.n_fields, len(d.words)
    on_device = {}

    def fn(datas, nulls):
        vd, vn = vf(datas, nulls)
        dev = vd.device
        if dev not in on_device:
            on_device[dev] = {key: t.to(dev) for key, t in tables.items()}
        dev_tables = on_device[dev]
        c = vd.to(torch.int64)
        states = [torch.ones(c.shape, dtype=torch.bool, device=dev)] + \
            [torch.zeros(c.shape, dtype=torch.bool, device=dev) for _ in range(k)]
        for f in range(nf):
            wid = ((c >> (bits * f)) & ((1 << bits) - 1)).clamp(0, nw - 1)
            new = list(states)
            for e in range(1, k + 1):
                for s in range(e):
                    a_s = anchored_start and s == 0 and f == 0
                    a_e = anchored_end and e == k
                    if anchored_start and s == 0 and f > 0:
                        continue  # the match must begin in field 0
                    if a_e and f != nf - 1:
                        continue  # the match must end in the last field
                    hit = dev_tables[(s, e, a_s, a_e)][wid]
                    new[e] = new[e] | (states[s] & hit)
            states = new
            if anchored_start and f == 0:
                states[0] = torch.zeros(c.shape, dtype=torch.bool, device=dev)
        return states[k], vn
    return fn


def _unscale(d: torch.Tensor, scale: int) -> torch.Tensor:
    """Scaled decimal -> float64. The reference divides by 10**scale inside a
    jitted function, which XLA folds into a multiply by the reciprocal; the
    port multiplies the same way so DOUBLE results agree bit for bit."""
    d = d.to(torch.float64)
    return d * (1.0 / 10 ** scale) if scale else d


def _nonzero(b: torch.Tensor) -> torch.Tensor:
    """The divisor with 0 replaced by 1."""
    return torch.where(b == 0, torch.ones_like(b), b)


def _sign_mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SQL ``mod``: |a| mod |b| with the sign of the dividend (a DOUBLE
    divisor of 0 gives NaN)."""
    return torch.sign(a) * torch.remainder(torch.abs(a), torch.abs(b))


def _value_dtype(t: Type) -> torch.dtype:
    """Tensor dtype of a CASE/IF/COALESCE result; an untyped NULL is BIGINT."""
    return torch_dtype(BIGINT if t is UNKNOWN else t)


def _true(d: torch.Tensor, n: Optional[torch.Tensor]) -> torch.Tensor:
    """A condition's rows that are TRUE: NULL counts as false."""
    return d if n is None else (d & ~n)


def _is_cpu_scalar(t: torch.Tensor) -> bool:
    return t.ndim == 0 and t.device.type == "cpu"


def _where(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
    """``torch.where(cond, a, b)`` in ``dtype``. Constants are 0-d CPU
    tensors; they enter as Python scalars, so a page copies nothing to the
    device for them. A constant condition picks its branch."""
    a, b = a.to(dtype), b.to(dtype)
    if _is_cpu_scalar(cond):
        return a if bool(cond) else b
    if _is_cpu_scalar(a) and _is_cpu_scalar(b):
        a = torch.full(cond.shape, a.item(), dtype=dtype, device=cond.device)
    return torch.where(cond, a.item() if _is_cpu_scalar(a) else a,
                       b.item() if _is_cpu_scalar(b) else b)


def _where_nulls(cond, tn, en) -> Optional[torch.Tensor]:
    """Null mask of a per-row branch select; None when neither side has one."""
    if tn is None and en is None:
        return None
    tn = torch.tensor(False) if tn is None else tn
    en = torch.tensor(False) if en is None else en
    return _where(cond, tn, en, torch.bool)


def _merge_dicts(a: Optional[Dictionary], b: Optional[Dictionary]) -> Optional[Dictionary]:
    """Output dictionary of a branch merge (IF/SWITCH/COALESCE). NULL and
    non-string branches carry none; two distinct dictionaries would need a
    re-encode, which the reference does not do either."""
    if a is None:
        return b
    if b is None or a is b:
        return a
    raise NotImplementedError(
        "CASE/COALESCE across two distinct dictionaries requires re-encoding")


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


def _log2(d: torch.Tensor) -> torch.Tensor:
    return torch.log(d) * (1.0 / math.log(2.0))


def _cbrt(d: torch.Tensor) -> torch.Tensor:
    return torch.sign(d) * torch.abs(d) ** (1.0 / 3.0)


# the unary DOUBLE functions (the analyzer casts their argument to DOUBLE),
# floor/ceil/truncate of a DOUBLE (of an integral argument the analyzer
# passes the argument through) and abs of any number; _compile_math
# handles the rest of _NUMERIC and the DECIMAL arguments
_MATH = {"sqrt": torch.sqrt, "ln": torch.log, "log10": torch.log10, "exp": torch.exp,
         "log2": _log2, "cbrt": _cbrt, "floor": torch.floor, "ceil": torch.ceil,
         "ceiling": torch.ceil, "truncate": torch.trunc, "abs": torch.abs}
_NUMERIC = tuple(_MATH) + ("round", "round2", "power", "sign", "hash_code")
_DATE_PARTS = ("quarter", "week", "day_of_week", "dow", "day_of_year", "doy")

_SPLITMIX_GOLDEN = 0x9E3779B97F4A7C15 - (1 << 64)
_SPLITMIX_M1 = 0xBF58476D1CE4E5B9 - (1 << 64)
_SPLITMIX_M2 = 0x94D049BB133111EB - (1 << 64)


def _round_scaled(d: torch.Tensor, m: int) -> torch.Tensor:
    """Scaled integers rounded to a multiple of ``m``, half away from zero."""
    return (torch.sign(d) * ((torch.abs(d) + m // 2) // m) * m).to(torch.int64)


def _shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical >> of the uint64 bit pattern held in int64."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _hash64(x: torch.Tensor) -> torch.Tensor:
    """The reference's ``hash_code`` (splitmix64), on int64 bits with
    wrapping adds and multiplies: bit-identical to the uint64 original."""
    x = x.to(torch.int64) + _SPLITMIX_GOLDEN
    x = (x ^ _shr(x, 30)) * _SPLITMIX_M1
    x = (x ^ _shr(x, 27)) * _SPLITMIX_M2
    return x ^ _shr(x, 31)


class _DeviceTable:
    """A host lookup table, copied to each device it is gathered on once."""

    def __init__(self, arr: np.ndarray):
        self._host = torch.from_numpy(arr)
        self._on = {}

    def __len__(self):
        return int(self._host.shape[0])

    def on(self, device) -> torch.Tensor:
        if device not in self._on:
            self._on[device] = self._host.to(device)
        return self._on[device]


def _days_from_civil_vec(y: torch.Tensor, m: int, d: int) -> torch.Tensor:
    """Vectorized inverse of ``_civil_from_days`` for a fixed month and day."""
    y = y.to(torch.int64) - (1 if m <= 2 else 0)
    era = torch.where(y >= 0, y, y - 399) // 400
    yoe = y - era * 400
    doy = (153 * (m + (-3 if m > 2 else 9)) + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def _weeks_in(y: torch.Tensor) -> torch.Tensor:
    """ISO weeks (52 or 53) of int64 years ``y``."""
    p = (y + y // 4 - y // 100 + y // 400) % 7
    pm = ((y - 1) + (y - 1) // 4 - (y - 1) // 100 + (y - 1) // 400) % 7
    return 52 + ((p == 4) | (pm == 3)).to(torch.int64)


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
