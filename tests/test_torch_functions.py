"""The rest of the reference's built-in scalar functions in the port
(``presto_tpu/ops/expressions.py`` ``_compile_call``), held against
presto_tpu on the CPU.

- Expressions: one page of seeded numpy columns with NULLs (BIGINT,
  INTEGER, DECIMAL, DOUBLE, DATE and dictionary VARCHAR) through each
  package's ``PageProcessor``: ``abs``, ``sqrt``, ``ln``, ``log10``,
  ``exp``, ``log2``, ``cbrt``, ``power``, ``floor``, ``ceil``/``ceiling``,
  ``round`` with one and two arguments, ``truncate`` (DECIMAL too),
  ``sign``, ``greatest``/``least``, ``quarter``, ``week``,
  ``day_of_week``/``dow``, ``day_of_year``/``doy``, ``length``, ``upper``,
  ``lower`` and ``hash_code``. Live rows agree: NULL masks and integral
  values exactly (``hash_code`` bit for bit), DOUBLE to 1e-12 relative
  (XLA's transcendental functions are not libm's: the two differ by an ulp
  or two), dictionaries entry for entry.
- ``cardinality`` over an ARRAY/MAP handle column of each package's store.
- SQL: the built-in cases of ``tests/test_functions.py`` and queries that
  apply every new function to ``lineitem``/``orders`` columns, through both
  runners at ``tpch.tiny``.
"""
import numpy as np
import pytest
import torch

from presto_tpu import block as jblock
from presto_tpu import types as jt
from presto_tpu.connectors.tpch import generator as jg
from presto_tpu.metadata import Session as RefSession
from presto_tpu.ops import expressions as jx
from presto_tpu.ops.filter_project import PageProcessor as JPageProcessor
from presto_tpu.runner import LocalQueryRunner as RefRunner
from presto_tpu_torch import block as tblock
from presto_tpu_torch import types as tt
from presto_tpu_torch.connectors.tpch import generator as tg
from presto_tpu_torch.metadata import Session
from presto_tpu_torch.ops import expressions as tx
from presto_tpu_torch.ops.filter_project import PageProcessor as TPageProcessor
from presto_tpu_torch.runner import LocalQueryRunner
from test_torch_expressions import (_assert_blocks_match, _layout, _port_page, _ref_page,
                                    _type_of)
from test_torch_sql import assert_same_rows

CAP = 512


def _columns(seed: int):
    rng = np.random.RandomState(seed)

    def nulls(p):
        return rng.rand(CAP) < p

    return [
        ("a", "bigint", rng.randint(-10 ** 6, 10 ** 6, CAP).astype(np.int64), nulls(0.15)),
        ("b", "bigint", rng.randint(-50, 51, CAP).astype(np.int64), None),
        ("d1", "dec", rng.randint(-10 ** 6, 10 ** 6, CAP).astype(np.int64), nulls(0.1)),
        ("d2", "dec", rng.randint(-500, 501, CAP).astype(np.int64), None),
        ("x", "double", rng.randn(CAP) * 100.0, nulls(0.1)),
        ("u", "double", rng.randn(CAP) * 3.0, None),
        ("pos", "double", np.exp(rng.randn(CAP) * 8.0), None),
        ("i", "integer", rng.randint(-20, 21, CAP).astype(np.int32), None),
        # days from 1900 to 2100: leap years, ISO weeks 52/53 and year ends
        ("dt", "date", rng.randint(-25567, 47482, CAP).astype(np.int32), nulls(0.1)),
        ("s", "shipmode", rng.randint(0, len(jg.DICT_SHIP_MODE), CAP).astype(np.int32),
         nulls(0.1)),
        ("p", "ptype", rng.randint(0, len(jg.DICT_P_TYPE), CAP).astype(np.int32), None),
    ]


def _dict_of(gen, kind):
    return {"ptype": gen.DICT_P_TYPE, "shipmode": gen.DICT_SHIP_MODE}.get(kind)


def _exprs(x, types, cols):
    """The projections of each case, typed as the analyzer types them."""
    ref = {name: x.input_ref(i, _type_of(types, k)) for i, (name, k, _, _) in enumerate(cols)}
    a, b, d1, d2, xx, u, pos, i, dt, s, p = (ref[n] for n in
                                             ("a", "b", "d1", "d2", "x", "u", "pos", "i",
                                              "dt", "s", "p"))
    BI, D, V = types.BIGINT, types.DOUBLE, types.VARCHAR
    DEC = types.DecimalType(12, 2)
    call, const = x.call, x.constant
    return {
        "abs": [call("abs", BI, a), call("abs", DEC, d1), call("abs", D, xx)],
        "sqrt_ln_log10_exp": [call("sqrt", D, pos), call("ln", D, pos), call("log10", D, pos),
                              call("exp", D, u), call("sqrt", D, xx)],
        "log2_cbrt": [call("log2", D, pos), call("cbrt", D, xx), call("cbrt", D, u)],
        "power": [call("power", D, pos, u), call("power", D, xx, const(2.0, D)),
                  call("power", D, xx, u)],
        "floor_ceil": [call("floor", D, xx), call("ceil", D, xx), call("ceiling", D, u),
                       call("floor", DEC, d1), call("ceil", DEC, d1), call("ceiling", DEC, d2)],
        "round": [call("round", D, xx), call("round", DEC, d1), call("round", DEC, d2)],
        "round2": [call("round2", D, xx, const(2, BI)), call("round2", DEC, d1, const(1, BI)),
                   call("round2", BI, a, const(-2, BI)), call("round2", DEC, d1, const(3, BI)),
                   call("round2", D, u, const(0, BI))],
        "truncate": [call("truncate", D, xx), call("truncate", DEC, d1),
                     call("truncate", DEC, d2)],
        "sign": [call("sign", BI, a), call("sign", BI, d1), call("sign", D, xx),
                 call("sign", BI, b)],
        "greatest_least": [call("greatest", BI, a, b), call("least", BI, a, b, const(7, BI)),
                           call("greatest", D, xx, u), call("least", DEC, d1, d2)],
        "date_parts": [call(n, BI, dt) for n in ("quarter", "week", "day_of_week", "dow",
                                                 "day_of_year", "doy")],
        "strings": [call("length", BI, s), call("upper", V, s), call("lower", V, s),
                    call("length", BI, p), call("lower", V, p)],
        "hash_code": [call("hash_code", BI, a), call("hash_code", BI, b),
                      call("hash_code", BI, i)],
    }


CASES = sorted(_exprs(tx, tt, _columns(0)))


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("case", CASES)
def test_scalar_functions_match_reference(case, seed):
    cols = _columns(seed)
    mask = np.random.RandomState(seed + 100).rand(CAP) < 0.9
    jproj = _exprs(jx, jt, cols)[case]
    tproj = _exprs(tx, tt, cols)[case]
    want = JPageProcessor(_layout(jx, jt, jg, cols), None, jproj)(_ref_page(cols, mask))
    got = TPageProcessor(_layout(tx, tt, tg, cols), None, tproj)(_port_page(cols, mask))
    assert len(got.blocks) == len(want.blocks) == len(tproj)
    for w, g in zip(want.blocks, got.blocks):
        _assert_blocks_match(w, g, mask)


def test_hash_code_is_bit_identical_over_the_int64_range():
    rng = np.random.default_rng(5)
    vals = np.concatenate([rng.integers(-2 ** 63, 2 ** 63 - 1, 4096, dtype=np.int64),
                           np.asarray([0, 1, -1, 2 ** 63 - 1, -2 ** 63], dtype=np.int64)])
    want = np.asarray(jx._hash64(jblock.jnp.asarray(vals)))
    got = tx._hash64(torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(got, want)


def test_cardinality_of_a_handle_column_matches_reference():
    entries = [(1, 2, 3), (), (("a", 1), ("b", 2)), (None,), tuple(range(40))]
    jstore, tstore = jblock.ArrayValues("array"), tblock.ArrayValues("array")
    assert jstore.extend(entries) == tstore.extend(entries)
    codes = np.asarray([0, 1, 2, 3, 4, -1, 2, 0], dtype=np.int32)
    nulls = np.asarray([0, 0, 0, 0, 0, 0, 1, 0], dtype=bool)
    mask = np.ones(len(codes), dtype=bool)
    jlayout = jx.InputLayout([jt.ArrayType(jt.BIGINT)], [jstore])
    tlayout = tx.InputLayout([tt.ArrayType(tt.BIGINT)], [tstore])
    jproj = [jx.call("cardinality", jt.BIGINT, jx.input_ref(0, jt.ArrayType(jt.BIGINT)))]
    tproj = [tx.call("cardinality", tt.BIGINT, tx.input_ref(0, tt.ArrayType(tt.BIGINT)))]
    jpage = jblock.Page((jblock.Block(jt.ArrayType(jt.BIGINT), jblock.jnp.asarray(codes),
                                      jblock.jnp.asarray(nulls), jstore),),
                        jblock.jnp.asarray(mask))
    tpage = tblock.Page((tblock.Block(tt.ArrayType(tt.BIGINT), torch.from_numpy(codes),
                                      torch.from_numpy(nulls), tstore),),
                        torch.from_numpy(mask))
    want = JPageProcessor(jlayout, None, jproj)(jpage)
    got = TPageProcessor(tlayout, None, tproj)(tpage)
    _assert_blocks_match(want.blocks[0], got.blocks[0], mask)
    assert got.blocks[0].data.tolist()[:5] == [3, 0, 2, 1, 40]
    assert list(tstore.lookup(np.asarray([0, 1, -1]))) == [[1, 2, 3], [], None]


# ------------------------------------------------------------------ SQL

FUNCTION_SQL = {
    # tests/test_functions.py
    "math_scalars": "select power(2, 10), mod(17, 5), sign(-3), sign(0), sign(42), "
                    "cbrt(27.0), log2(8.0), truncate(3.9), round(2.567, 2), pi() "
                    "from nation limit 1",
    "greatest_least": "select greatest(n_nationkey, n_regionkey * 4, 7), "
                      "least(n_nationkey, n_regionkey * 4, 7) from nation "
                      "where n_nationkey < 3 order by n_nationkey",
    "string_scalars": "select n_name, length(n_name), upper(n_name), lower(n_name) "
                      "from nation order by n_nationkey limit 5",
    "date_parts": "select quarter(o_orderdate), day_of_week(o_orderdate), "
                  "day_of_year(o_orderdate), week(o_orderdate) "
                  "from orders where o_orderkey = 1",
    "date_add": "select count(*) from orders "
                "where o_orderdate < date_add('day', 30, date '1995-06-01')",
    # every new function over lineitem / orders columns
    "lineitem_numeric": "select l_orderkey, l_linenumber, abs(l_extendedprice - 50000), "
                        "sqrt(l_quantity), ln(l_extendedprice), log10(l_extendedprice), "
                        "exp(l_discount), log2(l_quantity), cbrt(l_extendedprice), "
                        "power(l_discount, 2), floor(l_extendedprice), ceil(l_tax), "
                        "ceiling(l_extendedprice / 7), round(l_extendedprice), "
                        "round(l_extendedprice, 1), truncate(l_extendedprice), "
                        "sign(l_discount - 0.05), greatest(l_quantity, 25), "
                        "least(l_tax, l_discount) from lineitem where l_orderkey < 200 "
                        "order by l_orderkey, l_linenumber",
    "orders_dates_strings": "select o_orderkey, quarter(o_orderdate), week(o_orderdate), "
                            "day_of_week(o_orderdate), dow(o_orderdate), "
                            "day_of_year(o_orderdate), doy(o_orderdate), "
                            "length(o_orderpriority), upper(o_orderpriority), "
                            "lower(o_orderstatus), greatest(o_orderdate, date '1995-01-01') "
                            "from orders where o_orderkey < 300 order by o_orderkey",
    "grouped_by_functions": "select quarter(o_orderdate), lower(o_orderpriority), "
                            "count(*), sum(round(o_totalprice)) from orders "
                            "group by 1, 2 order by 1, 2",
    "filtered_by_functions": "select count(*) from lineitem where upper(l_shipmode) = 'MAIL' "
                             "and length(l_shipinstruct) > 4 and day_of_week(l_shipdate) = 3",
}


@pytest.fixture(scope="module")
def runners():
    return (RefRunner(RefSession(catalog="tpch", schema="tiny")),
            LocalQueryRunner(Session(catalog="tpch", schema="tiny"), device="cpu"))


@pytest.mark.parametrize("name", sorted(FUNCTION_SQL))
def test_function_sql_matches_reference(runners, name):
    sql = FUNCTION_SQL[name]
    want = runners[0].execute(sql).rows
    got = runners[1].execute(sql).rows
    assert got
    assert_same_rows(got, want)
