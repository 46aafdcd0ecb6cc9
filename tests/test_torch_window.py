"""Window functions in the port (``ops/window.py``, the planner's
``visit_WindowNode``), held against presto_tpu on the CPU at ``tpch.tiny``.

- every SQL string of ``tests/test_window.py`` (ranking, running and
  whole-partition aggregates under RANGE and ROWS frames, positional
  functions, dictionary-ordered VARCHAR, a window over a join, two
  specifications in one select), its top-k-in-a-subquery case, and the
  ranking strings of ``tests/test_sql_breadth.py`` (``ntile``,
  ``percent_rank``, ``cume_dist``, ``nth_value``, more buckets than rows):
  rows equal to the reference's, in order, and its ``rank() over ()``
  error;
- fused segments and pipeline cuts equal to the reference's at 4 drivers;
- ``_window_kernel`` against the reference's on seeded numpy inputs for
  every function and frame: integer results bit-identical, DOUBLE results
  to 1e-12 of the running total's magnitude.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu.exec.local_planner import LocalExecutionPlanner as RefPlanner
from presto_tpu.metadata import Session as RefSession
from presto_tpu.ops.window import _window_kernel as ref_window_kernel
from presto_tpu.runner import LocalQueryRunner as RefRunner
from presto_tpu_torch.exec.local_planner import LocalExecutionPlanner
from presto_tpu_torch.metadata import Session
from presto_tpu_torch.ops.window import _seg_scan, _window_kernel
from presto_tpu_torch.runner import LocalQueryRunner
from presto_tpu_torch.sql.analyzer import SemanticError
from test_torch_sql import assert_same_rows
from test_torch_sql_tpch_exprs import segment_view

# tests/test_window.py:33-66, its top-k case (:74), and
# tests/test_sql_breadth.py:119-140
WINDOW_SQL = [
    "select n_name, rank() over (partition by n_regionkey order by n_name) from nation",
    "select n_name, row_number() over (order by n_nationkey desc) from nation",
    "select n_nationkey, dense_rank() over (order by n_regionkey) from nation",
    "select o_orderkey, sum(o_totalprice) over (partition by o_custkey order by o_orderkey) "
    "from orders where o_orderkey < 400",
    "select o_orderkey, sum(o_totalprice) over (partition by o_custkey order by o_orderkey "
    "rows between unbounded preceding and current row) from orders where o_orderkey < 400",
    "select n_nationkey, count(*) over (partition by n_regionkey order by n_regionkey) "
    "from nation",
    "select n_nationkey, count(*) over (partition by n_regionkey) from nation",
    "select n_nationkey, max(n_name) over (partition by n_regionkey) from nation",
    "select o_orderkey, avg(o_totalprice) over (partition by o_orderpriority) from orders "
    "where o_orderkey < 400",
    "select n_nationkey, lag(n_name) over (order by n_nationkey) from nation",
    "select o_orderkey, lead(o_orderdate) over (partition by o_custkey order by o_orderkey) "
    "from orders where o_orderkey < 400",
    "select n_name, first_value(n_name) over (partition by n_regionkey order by n_nationkey), "
    "last_value(n_name) over (partition by n_regionkey order by n_nationkey) from nation",
    "select n_nationkey, rank() over (order by n_nationkey) + 100, "
    "count(*) over (partition by n_regionkey) from nation",
    "select n_name, row_number() over (partition by r_name order by n_name) "
    "from nation join region on n_regionkey = r_regionkey",
    "select n_name, rk from (select n_name, n_regionkey, rank() over "
    "(partition by n_regionkey order by n_name) rk from nation) t where rk <= 2",
    "select s_nationkey, s_suppkey, ntile(3) over (partition by s_nationkey order by s_suppkey), "
    "percent_rank() over (partition by s_nationkey order by s_suppkey), "
    "cume_dist() over (partition by s_nationkey order by s_suppkey), "
    "nth_value(s_suppkey, 2) over (partition by s_nationkey order by s_suppkey) "
    "from supplier order by 1, 2",
    "select n_nationkey, ntile(40) over (order by n_nationkey) from nation order by 1",
    # the port's own: running min/max (a VARCHAR max by rank), DESC NULLS
    # FIRST over a DOUBLE, and a DECIMAL avg over a ROWS frame
    "select o_orderkey, min(o_totalprice) over (partition by o_custkey order by o_orderdate "
    "rows between unbounded preceding and current row), max(o_orderpriority) over "
    "(partition by o_custkey order by o_orderkey) from orders where o_orderkey < 2000",
    "select l_orderkey, l_linenumber, rank() over (partition by l_orderkey order by "
    "l_extendedprice * (1 - l_discount) desc nulls first), avg(l_quantity) over (partition by "
    "l_orderkey order by l_linenumber rows between unbounded preceding and current row) "
    "from lineitem where l_orderkey < 300",
]


@pytest.fixture(scope="module")
def reference():
    cache = {}

    def get(i, props):
        key = (i, tuple(sorted(props.items())))
        if key not in cache:
            res = RefRunner(RefSession(catalog="tpch", schema="tiny",
                                       properties=dict(props))).execute(WINDOW_SQL[i])
            cache[key] = (res.rows, segment_view((res.stats or {}).get("segments")))
        return cache[key]
    return get


@pytest.mark.parametrize("i", range(len(WINDOW_SQL)))
def test_rows_and_segments_match_reference(reference, i):
    props = {"hash_kernels": "pallas"}
    want_rows, want_seg = reference(i, props)
    res = LocalQueryRunner(Session(catalog="tpch", schema="tiny", properties=props),
                           device="cpu").execute(WINDOW_SQL[i])
    assert res.rows
    # a window keeps its input's row order, in both packages
    assert_same_rows(res.rows, want_rows)
    assert segment_view((res.stats or {}).get("segments")) == want_seg


def _plan_view(pipelines):
    return [([f.name for f in p], getattr(p[0], "parallel_drivers", 1)) for p in pipelines]


@pytest.mark.parametrize("i", [3, 13, 18])
def test_pipeline_cuts_match_reference(i):
    """At 4 drivers the scan prefix runs as producers and the window, a
    stateful operator, after the exchange: the cuts equal the reference's."""
    props = {"driver_parallelism": 4, "hash_kernels": "pallas"}
    rr = RefRunner(RefSession(catalog="tpch", schema="tiny", properties=props))
    want = RefPlanner(rr.metadata, rr.session).plan(rr.plan_sql(WINDOW_SQL[i]))
    pr = LocalQueryRunner(Session(catalog="tpch", schema="tiny", properties=props), device="cpu")
    got = LocalExecutionPlanner(pr.metadata, pr.session, "cpu").plan(pr.plan_sql(WINDOW_SQL[i]))
    assert _plan_view(got.pipelines) == _plan_view(want.pipelines)
    assert any("Window" in names for names, _ in _plan_view(got.pipelines))
    assert got.segment_decisions == want.segment_decisions


def test_rank_requires_order_by():
    with pytest.raises(SemanticError, match="requires ORDER BY"):
        LocalQueryRunner(Session(catalog="tpch", schema="tiny"), device="cpu") \
            .execute("select rank() over () from nation")


# ------------------------------------------------------------ the kernel

# (call, argument): the argument column a call reads, 0 = the BIGINT
# column, 1 = the DOUBLE one
CALLS = (
    (("row_number", 0, "range", 1, 1), None), (("rank", 0, "range", 1, 1), None),
    (("dense_rank", 0, "range", 1, 1), None), (("ntile", 0, "range", 1, 3), None),
    (("percent_rank", 0, "range", 1, 1), None), (("cume_dist", 0, "range", 1, 1), None),
    (("nth_value", 1, "range", 1, 2), 0), (("nth_value", 1, "rows", 1, 3), 1),
    (("lag", 1, "range", 1, 1), 0), (("lead", 1, "range", 1, 2), 1),
    (("first_value", 1, "range", 1, 1), 0), (("last_value", 1, "range", 1, 1), 0),
    (("last_value", 1, "rows", 1, 1), 1), (("count", 0, "range", 1, 1), None),
    (("count", 1, "rows", 1, 1), 0), (("sum", 1, "range", 1, 1), 0),
    (("sum", 1, "rows", 1, 1), 0), (("avg", 1, "range", 100, 1), 0),
    (("min", 1, "range", 1, 1), 0), (("max", 1, "rows", 1, 1), 0),
    (("sum", 1, "rows", 1, 1), 1), (("avg", 1, "rows", 1, 1), 1),
    (("min", 1, "rows", 1, 1), 1), (("max", 1, "range", 1, 1), 1),
)
# the calls that need an ORDER BY
ORDERED = ("row_number", "rank", "dense_rank", "ntile", "percent_rank", "cume_dist",
           "nth_value", "lag", "lead", "first_value", "last_value")


def _kernel_inputs(seed: int, n: int = 3000):
    rng = np.random.default_rng(seed)
    part = rng.integers(0, 9, n).astype(np.int64)
    order = rng.integers(0, 25, n).astype(np.int64)
    ints = rng.integers(-10 ** 6, 10 ** 6, n).astype(np.int64)
    dbl = rng.normal(0.0, 1e5, n)
    nulls = [rng.random(n) < 0.1, rng.random(n) < 0.1]
    mask = rng.random(n) < 0.9
    return part, order, (ints, dbl), nulls, mask


@pytest.mark.parametrize("n_ord", [0, 1])
def test_window_kernel_matches_reference(n_ord):
    part, order, cols, nulls, mask = _kernel_inputs(3 + n_ord)
    chosen = [(c, a) for c, a in CALLS if n_ord or c[0] not in ORDERED]
    calls = tuple(c for c, _ in chosen)
    args = [a for _, a in chosen]
    keys = (part, order)[:1 + n_ord]
    ref_args, port_args = [], []
    for c, a in zip(calls, args):
        if c[1]:
            ref_args += [jnp.asarray(cols[a]), jnp.asarray(nulls[a])]
            port_args += [torch.from_numpy(cols[a]), torch.from_numpy(nulls[a])]
    want = ref_window_kernel(tuple(jnp.asarray(k) for k in keys), tuple(ref_args),
                             jnp.asarray(mask), calls, 1, n_ord)
    got = _window_kernel(tuple(torch.from_numpy(k) for k in keys), tuple(port_args),
                         torch.from_numpy(mask), calls, 1, n_ord)
    scale = float(np.abs(cols[1]).sum())  # the running total's magnitude
    for c, (gv, gn), (wv, wn) in zip(calls, got, want):
        gv, wv = gv.numpy()[mask], np.asarray(wv)[mask]
        assert (gn is None) == (wn is None), c
        if gn is not None:
            gn, wn = gn.numpy()[mask], np.asarray(wn)[mask]
            np.testing.assert_array_equal(gn, wn, err_msg=str(c))
            gv, wv = gv[~gn], wv[~wn]
        if np.issubdtype(wv.dtype, np.integer) or c[0] in ("percent_rank", "cume_dist"):
            np.testing.assert_array_equal(gv, wv, err_msg=str(c))
        else:
            np.testing.assert_allclose(gv, wv, rtol=0, atol=1e-12 * scale, err_msg=str(c))


@pytest.mark.parametrize("op", ["min", "max", "sum"])
def test_segmented_scan(op):
    """The packed (segment, rank) cummax and the cumsum-less-base scan
    against a plain loop over segments."""
    rng = np.random.default_rng(9)
    v = rng.integers(-50, 50, 500).astype(np.int64)
    new = rng.random(500) < 0.1
    new[0] = True
    got = _seg_scan(op, torch.from_numpy(v), torch.from_numpy(new)).numpy()
    want = np.empty_like(v)
    acc = 0
    for i in range(len(v)):
        if new[i]:
            acc = v[i]
        else:
            acc = {"min": min, "max": max}[op](acc, v[i]) if op != "sum" else acc + v[i]
        want[i] = acc
    np.testing.assert_array_equal(got, want)
