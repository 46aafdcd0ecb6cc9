"""The port's special forms, division, substr, min/max and EnforceSingleRow
against presto_tpu's, on the same numpy inputs made from a seed.

- Expressions: one page of typed columns with NULLs (BIGINT, INTEGER,
  DECIMAL, DOUBLE, BOOLEAN, a dictionary VARCHAR and the virtual ``c_phone``
  dictionary) goes through each package's ``PageProcessor`` with the same
  projections: NULL literals, IS_NULL, IF, COALESCE and SWITCH with NULLs in
  conditions and branches; ``divide`` and ``modulus`` over integers (negative
  operands and zero divisors), DECIMAL and DOUBLE; ``substr`` over a real and
  a virtual dictionary. The live rows must agree: the null masks exactly,
  the values of non-NULL rows exactly, DOUBLE to 1e-12 relative. What the
  reference refuses, the port refuses too.
- Aggregates: ``min`` and ``max`` over BIGINT, DECIMAL, DOUBLE, DATE and
  VARCHAR codes, with all-NULL and empty groups, through the DIRECT, GLOBAL
  and SORT groupings, the insert kernel's grouping (its plain version on the
  CPU) and the host-RAM spill merge at a small ``max_groups``.
- EnforceSingleRow with 0, 1 and 2 input rows.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from presto_tpu import block as jblock
from presto_tpu import types as jt
from presto_tpu.connectors.tpch import generator as jg
from presto_tpu.ops import aggregates as jagg
from presto_tpu.ops import expressions as jx
from presto_tpu.ops import hash_agg as jha
from presto_tpu.ops.filter_project import PageProcessor as JPageProcessor
from presto_tpu.ops.single_row import EnforceSingleRowOperatorFactory as JSingleRow
from presto_tpu_torch import block as tblock
from presto_tpu_torch import types as tt
from presto_tpu_torch.connectors.tpch import generator as tg
from presto_tpu_torch.ops import aggregates as tagg
from presto_tpu_torch.ops import expressions as tx
from presto_tpu_torch.ops import hash_agg as tha
from presto_tpu_torch.ops.filter_project import PageProcessor as TPageProcessor
from presto_tpu_torch.ops.single_row import EnforceSingleRowOperatorFactory as TSingleRow
from presto_tpu_torch.utils.metrics import METRICS
from test_torch_sql import assert_same_rows

CAP = 512


# ------------------------------------------------------------ pages

def _columns(seed: int):
    """(name, kind, data, nulls) per column; ``kind`` picks the type."""
    rng = np.random.RandomState(seed)

    def nulls(p):
        return rng.rand(CAP) < p

    return [
        ("a", "bigint", rng.randint(-50, 51, CAP).astype(np.int64), nulls(0.15)),
        ("b", "bigint", rng.randint(-5, 6, CAP).astype(np.int64), nulls(0.15)),
        ("d1", "dec", rng.randint(-10 ** 6, 10 ** 6, CAP).astype(np.int64), nulls(0.1)),
        ("d2", "dec", rng.randint(-500, 501, CAP).astype(np.int64), None),
        ("x", "double", rng.randn(CAP) * 100.0, nulls(0.1)),
        ("y", "double", np.where(rng.rand(CAP) < 0.05, 0.0, rng.randn(CAP)), None),
        ("c", "boolean", rng.rand(CAP) < 0.5, nulls(0.2)),
        ("s", "ptype", rng.randint(0, len(jg.DICT_P_TYPE), CAP).astype(np.int32), nulls(0.1)),
        ("ph", "phone", rng.randint(0, 150_000, CAP).astype(np.int32), None),
        ("i", "integer", rng.randint(-20, 21, CAP).astype(np.int32), None),
        ("i2", "integer", rng.randint(-4, 5, CAP).astype(np.int32), nulls(0.1)),
    ]


def _type_of(types, kind):
    return {"bigint": types.BIGINT, "dec": types.DecimalType(12, 2), "double": types.DOUBLE,
            "boolean": types.BOOLEAN, "ptype": types.VARCHAR, "phone": types.VARCHAR,
            "shipmode": types.VARCHAR, "priority": types.VARCHAR, "integer": types.INTEGER,
            "date": types.DATE}[kind]


def _dict_of(gen, kind):
    return {"ptype": gen.DICT_P_TYPE, "phone": gen.DICT_PHONE,
            "shipmode": gen.DICT_SHIP_MODE, "priority": gen.DICT_PRIORITY}.get(kind)


def _ref_page(cols, mask):
    blocks = tuple(jblock.Block(_type_of(jt, k), jnp.asarray(d),
                                jnp.asarray(n) if n is not None else None, _dict_of(jg, k))
                   for _, k, d, n in cols)
    return jblock.Page(blocks, jnp.asarray(mask))


def _port_page(cols, mask):
    blocks = tuple(tblock.Block(_type_of(tt, k), torch.from_numpy(np.ascontiguousarray(d)),
                                torch.from_numpy(n) if n is not None else None,
                                _dict_of(tg, k))
                   for _, k, d, n in cols)
    return tblock.Page(blocks, torch.from_numpy(mask))


def _layout(x, types, gen, cols):
    return x.InputLayout([_type_of(types, k) for _, k, _, _ in cols],
                         [_dict_of(gen, k) for _, k, _, _ in cols])


# ------------------------------------------------------------ expressions

def _exprs(x, types, cols):
    """The projections of each case, built with one package's IR."""
    ref = {name: x.input_ref(i, _type_of(types, k)) for i, (name, k, _, _) in enumerate(cols)}
    a, b, d1, d2, xx, y, c, s, ph, i, i2 = (ref[n] for n in
                                             ("a", "b", "d1", "d2", "x", "y", "c", "s", "ph",
                                              "i", "i2"))
    B, BI, I, D, V = types.BOOLEAN, types.BIGINT, types.INTEGER, types.DOUBLE, types.VARCHAR
    DEC, DEC4 = types.DecimalType(12, 2), types.DecimalType(18, 4)
    call, special, const = x.call, x.special, x.constant

    def null(t):
        return const(None, t)

    return {
        "null_literals": [null(BI), null(D), null(DEC)],
        "is_null": [special("IS_NULL", B, a), special("IS_NULL", B, d2),
                    special("NOT", B, special("IS_NULL", B, s))],
        "if": [special("IF", BI, c, a, b),
               special("IF", DEC, call("greater_than", B, a, b), d1, null(DEC)),
               special("IF", V, c, s, null(V)),
               special("IF", BI, c, const(1, BI), const(0, BI))],
        "coalesce": [special("COALESCE", BI, a, b),
                     special("COALESCE", BI, a, b, const(7, BI)),
                     special("COALESCE", D, xx, null(D)),
                     special("COALESCE", DEC, d1, d2)],
        "switch": [
            # NULL conditions (a and c have NULLs) count as false
            special("SWITCH", BI, call("greater_than", B, a, const(0, BI)), a, c, b, null(BI)),
            special("SWITCH", DEC, call("equal", B, b, const(0, BI)), d1,
                    call("less_than", B, a, b), d2, const(0, DEC)),
            special("SWITCH", V, c, s, null(V)),
            # Q14's shape: CASE WHEN p_type LIKE 'PROMO%' THEN price ELSE 0 END
            special("SWITCH", DEC4, call("like", B, s, const("PROMO%", V)),
                    call("multiply", DEC4, d1, d2), const(0, DEC4)),
            special("SWITCH", BI, c, const(1, BI), const(0, BI))],
        "divide_int": [call("divide", BI, a, b), call("divide", I, i, i2),
                       call("divide", BI, a, const(-3, BI)), call("divide", BI, const(7, BI), b)],
        "modulus_int": [call("modulus", BI, a, b), call("modulus", I, i, i2),
                        call("modulus", BI, a, const(-3, BI))],
        "divide_decimal": [call("divide", D, d1, d2),
                           call("divide", D, d1, const(70, types.DecimalType(2, 1))),
                           call("divide", D, d1, a)],
        "modulus_decimal": [call("modulus", types.DecimalType(13, 2), d1, d2),
                            call("modulus", DEC, d1, const(7, BI))],
        "double": [call("multiply", D, const(2, types.DecimalType(1, 1)), xx),
                   call("add", D, xx, d1), call("subtract", D, d1, y), call("divide", D, xx, y),
                   call("modulus", D, xx, const(2.5, D)), call("multiply", D, xx, a)],
        "substr": [call("substr", V, s, const(1, BI), const(5, BI)),
                   call("substr", V, s, const(7, BI)),
                   call("substr", V, ph, const(1, BI), const(2, BI))],
    }


def _refusals(x, types, cols):
    ref = {name: x.input_ref(i, _type_of(types, k)) for i, (name, k, _, _) in enumerate(cols)}
    BI, V = types.BIGINT, types.VARCHAR
    return {
        "substr_virtual_without_rule": x.call("substr", V, ref["ph"], x.constant(2, BI),
                                              x.constant(3, BI)),
        "substr_non_literal_start": x.call("substr", V, ref["s"], ref["a"], x.constant(2, BI)),
        "switch_two_dictionaries": x.special("SWITCH", V, ref["c"], ref["s"], ref["ph"]),
    }


def _assert_blocks_match(want, got, mask):
    """Live rows: null masks exactly, non-NULL values exactly (DOUBLE to
    1e-12 relative), dictionaries entry for entry."""
    wn = np.asarray(want.nulls)[mask] if want.nulls is not None else np.zeros(mask.sum(), bool)
    gn = got.nulls.numpy()[mask] if got.nulls is not None else np.zeros(mask.sum(), bool)
    np.testing.assert_array_equal(gn, wn)
    keep = ~wn
    wd = np.broadcast_to(np.asarray(want.data), mask.shape)[mask][keep]
    gd = got.data.numpy()[mask][keep]
    assert got.type.display_name() == want.type.display_name()
    if np.asarray(wd).dtype.kind == "f":
        np.testing.assert_allclose(gd, wd, rtol=1e-12, atol=0.0)
    else:
        np.testing.assert_array_equal(gd.astype(np.int64), np.asarray(wd).astype(np.int64))
    assert (want.dictionary is None) == (got.dictionary is None)
    if want.dictionary is not None:
        codes = np.arange(len(want.dictionary)) if hasattr(want.dictionary, "values") \
            else np.unique(gd)
        assert list(got.dictionary.lookup(codes)) == list(want.dictionary.lookup(codes))


CASES = sorted(_exprs(tx, tt, _columns(0)))


@pytest.mark.parametrize("case", CASES)
def test_projections_match_reference(case):
    cols = _columns(11)
    mask = np.random.RandomState(12).rand(CAP) < 0.9
    jproj = _exprs(jx, jt, cols)[case]
    tproj = _exprs(tx, tt, cols)[case]
    want = JPageProcessor(_layout(jx, jt, jg, cols), None, jproj)(_ref_page(cols, mask))
    got = TPageProcessor(_layout(tx, tt, tg, cols), None, tproj)(_port_page(cols, mask))
    assert len(got.blocks) == len(want.blocks) == len(tproj)
    for w, g in zip(want.blocks, got.blocks):
        _assert_blocks_match(w, g, mask)


def test_switch_first_match_wins_and_null_condition_is_false():
    """Hand-checked rows: CASE WHEN c THEN 1 WHEN a > 0 THEN 2 ELSE 3."""
    cols = [("a", "bigint", np.asarray([5, 5, -1, 5, -1], np.int64), None),
            ("c", "boolean", np.asarray([True, False, True, False, False]),
             np.asarray([False, False, False, True, True]))]
    B, BI = tt.BOOLEAN, tt.BIGINT
    a, c = tx.input_ref(0, BI), tx.input_ref(1, B)
    expr = tx.special("SWITCH", BI, c, tx.constant(1, BI),
                      tx.call("greater_than", B, a, tx.constant(0, BI)), tx.constant(2, BI),
                      tx.constant(3, BI))
    layout = tx.InputLayout([BI, B], [None, None])
    page = tblock.Page(tuple(tblock.Block(_type_of(tt, k), torch.from_numpy(d),
                                          torch.from_numpy(n) if n is not None else None)
                             for _, k, d, n in cols), torch.ones(5, dtype=torch.bool))
    out = TPageProcessor(layout, None, [expr])(page)
    assert out.blocks[0].data.tolist() == [1, 2, 1, 2, 3]


@pytest.mark.parametrize("case", sorted(_refusals(tx, tt, _columns(0))))
def test_refusals_match_reference(case):
    cols = _columns(13)
    with pytest.raises(NotImplementedError):
        JPageProcessor(_layout(jx, jt, jg, cols), None, [_refusals(jx, jt, cols)[case]])
    with pytest.raises(NotImplementedError):
        TPageProcessor(_layout(tx, tt, tg, cols), None, [_refusals(tx, tt, cols)[case]])


@pytest.mark.parametrize("op,a,b,want", [
    ("divide", 7, 2, 3), ("divide", -7, 2, -3), ("divide", 7, -2, -3), ("divide", -7, -2, 3),
    ("divide", 5, 0, 5), ("divide", -5, 0, -5), ("modulus", -7, 3, -1), ("modulus", 7, -3, 1),
    ("modulus", 7, 0, 0)])
def test_integer_division_truncates_toward_zero(op, a, b, want):
    """SQL semantics (truncation, the dividend's sign); a zero divisor
    gives what the reference gives: x / 0 is x and x mod 0 is 0."""
    BI = tt.BIGINT
    layout = tx.InputLayout([BI, BI], [None, None])
    fn = tx.ExpressionCompiler(layout).compile(
        tx.call(op, BI, tx.input_ref(0, BI), tx.input_ref(1, BI)))
    got = fn((torch.tensor([a]), torch.tensor([b])), (None, None))[0]
    ref = jx.ExpressionCompiler(jx.InputLayout([jt.BIGINT] * 2, [None, None])).compile(
        jx.call(op, jt.BIGINT, jx.input_ref(0, jt.BIGINT), jx.input_ref(1, jt.BIGINT)))
    assert got.tolist() == [want] == np.asarray(
        ref((jnp.asarray([a]), jnp.asarray([b])), (None, None))[0]).tolist()


# ------------------------------------------------------------ min / max

AGG_KINDS = ("bigint", "dec", "double", "date", "shipmode", "priority")
# kinds whose min/max the reference cannot decode over an all-NULL group
UNDECODED = ("date", "priority")


def _agg_columns(seed: int, key_kind: str, n_keys: int):
    """Key column, then one argument column per AGG_KINDS entry. The
    argument columns are NULL on ~20% of the rows (UNDECODED ones on ~5%),
    and all but UNDECODED on every row of the last key (an all-NULL group):
    the reference cannot decode the DATE identity or the sorted
    dictionary's code that an all-NULL group leaves under its NULL
    (``test_min_max_of_an_all_null_group_is_null``)."""
    rng = np.random.RandomState(seed)
    if key_kind == "priority":  # codes 0..3 of a 5-entry dictionary
        key = rng.randint(0, 4, CAP).astype(np.int32)
        last = 3
    else:
        key = rng.randint(0, n_keys, CAP).astype(np.int64)
        last = n_keys - 1
    some = rng.rand(CAP) < 0.2
    nulls = some | (key == last)
    date_nulls = some & (rng.rand(CAP) < 0.25)  # never a whole group here
    data = {"bigint": rng.randint(-10 ** 12, 10 ** 12, CAP).astype(np.int64),
            "dec": rng.randint(-10 ** 8, 10 ** 8, CAP).astype(np.int64),
            "double": rng.randn(CAP) * 1e3,
            "date": rng.randint(8000, 11000, CAP).astype(np.int32),
            "shipmode": rng.randint(0, len(jg.DICT_SHIP_MODE), CAP).astype(np.int32),
            "priority": rng.randint(0, len(jg.DICT_PRIORITY), CAP).astype(np.int32)}
    return [("k", key_kind, key, None)] + \
        [(k, k, data[k], date_nulls if k in UNDECODED else nulls) for k in AGG_KINDS]


def _agg_rows(pkg, cols_pages, masks, grouping, max_groups, kinds=AGG_KINDS):
    """Run one HashAggregation of min and max over the ``kinds`` argument
    columns in one package; its rows."""
    types, gen, agg, ha = pkg["types"], pkg["gen"], pkg["agg"], pkg["ha"]
    keyed = grouping != "global"
    calls = []
    for kind in kinds:
        j = AGG_KINDS.index(kind)
        for name in ("min", "max"):
            fn = agg.resolve_aggregate(name, [_type_of(types, kind)])
            calls.append(agg.AggregateCall(fn, [j + 1], output_dictionary=_dict_of(gen, kind)))
    key_kind = cols_pages[0][0][1]
    key_ch = [0] if keyed else []
    key_types = [_type_of(types, key_kind)] if keyed else []
    key_dicts = [_dict_of(gen, key_kind)] if keyed else []
    domains = [5] if grouping == "direct" else None
    hash_grouping = "force" if grouping == "insert" else "off"
    if pkg["name"] == "ref":
        fac = ha.HashAggregationOperatorFactory(0, key_ch, key_types, key_dicts, domains, calls,
                                                ha.SINGLE, CAP, max_groups=max_groups,
                                                hash_grouping=hash_grouping)
    else:
        fac = ha.HashAggregationOperatorFactory(0, key_ch, key_types, key_dicts, calls,
                                                ha.SINGLE, CAP, max_groups=max_groups,
                                                device="cpu", key_domains=domains,
                                                hash_grouping=hash_grouping)
    op = fac.create_operator()
    for cols, mask in zip(cols_pages, masks):
        op.add_input(pkg["page"](cols, mask))
    op.finish()
    rows = []
    for _ in range(1000):
        if op.is_finished():
            break
        out = op.get_output()
        if out is not None:
            rows.extend(out.to_pylists())
    assert op.is_finished()
    return sorted(rows, key=repr)


REF_PKG = {"name": "ref", "x": jx, "types": jt, "gen": jg, "agg": jagg, "ha": jha,
           "page": _ref_page}
PORT_PKG = {"name": "port", "x": tx, "types": tt, "gen": tg, "agg": tagg, "ha": tha,
            "page": _port_page}
# grouping -> (key kind, distinct keys, max_groups)
GROUPINGS = {"direct": ("priority", 4, 1 << 20), "global": ("bigint", 1, 1 << 20),
             "sort": ("bigint", 40, 1 << 20), "insert": ("bigint", 40, 1 << 20),
             "spill": ("bigint", 200, 64)}


@pytest.mark.parametrize("grouping", sorted(GROUPINGS))
def test_min_max_match_reference(grouping):
    key_kind, n_keys, max_groups = GROUPINGS[grouping]
    pages = [_agg_columns(20 + p, key_kind, n_keys) for p in range(3)]
    rng = np.random.RandomState(30)
    masks = [rng.rand(CAP) < 0.9 for _ in pages]
    spilled = METRICS.counter_value("agg.spilled_folds")
    got = _agg_rows(PORT_PKG, pages, masks, grouping, max_groups)
    spilled = METRICS.counter_value("agg.spilled_folds") - spilled
    want = _agg_rows(REF_PKG, pages, masks, grouping, max_groups)
    assert got and len(got) == len(want)
    assert_same_rows(got, want)
    assert (spilled > 0) == (grouping == "spill")
    if grouping != "global":  # the last key's group is NULL but for UNDECODED
        nulled = [1 + 2 * j + m for j, k in enumerate(AGG_KINDS) if k not in UNDECODED
                  for m in (0, 1)]
        assert any(all(r[i] is None for i in nulled) for r in got)


@pytest.mark.parametrize("grouping", ["global", "sort"])
def test_min_max_of_an_empty_input_match_reference(grouping):
    """No live row: GLOBAL gives one all-NULL row, a keyed grouping none.
    (UNDECODED kinds are left out: the reference cannot decode them.)"""
    kinds = tuple(k for k in AGG_KINDS if k not in UNDECODED)
    pages = [_agg_columns(40, "bigint", 40)]
    masks = [np.zeros(CAP, bool)]
    got = _agg_rows(PORT_PKG, pages, masks, grouping, 1 << 20, kinds)
    want = _agg_rows(REF_PKG, pages, masks, grouping, 1 << 20, kinds)
    assert_same_rows(got, want)
    assert got == ([[None] * (2 * len(kinds))] if grouping == "global" else [])


@pytest.mark.parametrize("kind", UNDECODED)
@pytest.mark.parametrize("grouping", ["global", "sort", "insert"])
def test_min_max_of_an_all_null_group_is_null(grouping, kind):
    """A deliberate difference: the reference raises decoding what an
    all-NULL group leaves under its NULL min (the int32 identity: an
    OverflowError as a DATE, an IndexError as a code of a sorted
    dictionary); the port decodes only non-NULL rows, so the group's min
    and max are NULL."""
    cols = _agg_columns(41, "bigint", 40)
    all_null = np.ones(CAP, bool)
    cols = [(n, k, d, all_null if k == kind else nl) for n, k, d, nl in cols]
    rows = _agg_rows(PORT_PKG, [cols], [np.ones(CAP, bool)], grouping, 1 << 20, (kind,))
    assert rows and all(r[-2:] == [None, None] for r in rows)
    with pytest.raises((OverflowError, IndexError)):
        _agg_rows(REF_PKG, [cols], [np.ones(CAP, bool)], grouping, 1 << 20, (kind,))


# ------------------------------------------------------------ EnforceSingleRow

def _single_row(pkg, live_per_page):
    """Feed pages with the given live-row counts; the rows out, or the error."""
    cols = [("a", "bigint", np.arange(8, dtype=np.int64) + 40, None),
            ("s", "shipmode", np.arange(8, dtype=np.int32) % 7, None)]
    types = pkg["types"]
    types_ = [_type_of(types, k) for _, k, _, _ in cols]
    dicts = [_dict_of(pkg["gen"], k) for _, k, _, _ in cols]
    if pkg["name"] == "ref":
        op = JSingleRow(0, types_, dicts).create_operator()
    else:
        op = TSingleRow(0, types_, dicts, device="cpu").create_operator()
    try:
        for p, n in enumerate(live_per_page):
            mask = np.zeros(8, bool)
            mask[p + 2: p + 2 + n] = True
            # the page helpers are sized for CAP; build 8-row pages here
            page = pkg["page8"](cols, mask)
            op.add_input(page)
        op.finish()
        out = op.get_output()
        assert op.is_finished()
        return out.to_pylists()
    except RuntimeError as e:
        return str(e)


@pytest.mark.parametrize("live_per_page", [[], [0], [1], [0, 1, 0], [2], [1, 1]],
                         ids=["no_page", "empty_page", "one_row", "one_row_of_three_pages",
                              "two_rows", "two_pages_of_one"])
def test_enforce_single_row_matches_reference(live_per_page):
    ref = dict(REF_PKG, page8=lambda cols, mask: jblock.Page(
        tuple(jblock.Block(_type_of(jt, k), jnp.asarray(d), None, _dict_of(jg, k))
              for _, k, d, _ in cols), jnp.asarray(mask)))
    port = dict(PORT_PKG, page8=lambda cols, mask: tblock.Page(
        tuple(tblock.Block(_type_of(tt, k), torch.from_numpy(d), None, _dict_of(tg, k))
              for _, k, d, _ in cols), torch.from_numpy(mask)))
    want = _single_row(ref, live_per_page)
    got = _single_row(port, live_per_page)
    assert got == want
    total = sum(live_per_page)
    if total > 1:
        assert got == "scalar subquery returned more than one row"
    elif total == 1:
        assert len(got) == 1 and got[0][0] >= 42
    else:
        assert got == [[None, None]]


def test_double_results_stay_within_tolerance():
    """Q17's 0.2 * avg shape and a decimal ratio: finite, and equal to the
    exact rational value to 1e-12 relative."""
    DEC, D, B = tt.DecimalType(12, 2), tt.DOUBLE, tt.BOOLEAN
    layout = tx.InputLayout([DEC, D], [None, None])
    comp = tx.ExpressionCompiler(layout)
    ratio = comp.compile(tx.call("divide", D, tx.input_ref(0, DEC),
                                 tx.constant(70, tt.DecimalType(2, 1))))
    scaled = comp.compile(tx.call("multiply", D, tx.constant(2, tt.DecimalType(1, 1)),
                                  tx.input_ref(1, D)))
    d = torch.tensor([123456, -98765, 1], dtype=torch.int64)
    v = torch.tensor([25.5, -1.25, 3.0], dtype=torch.float64)
    for got, exact in zip(ratio((d, v), (None, None))[0].tolist(),
                          [1234.56 / 7, -987.65 / 7, 0.01 / 7]):
        assert math.isclose(got, exact, rel_tol=1e-12)
    assert scaled((d, v), (None, None))[0].tolist() == [5.1000000000000005, -0.25, 0.6000000000000001]
    assert comp.compile(tx.call("less_than", B, tx.input_ref(0, DEC), tx.input_ref(1, D)))
