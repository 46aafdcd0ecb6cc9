"""The rest of the reference's aggregates in the port, held against presto_tpu
on the CPU at ``tpch.tiny``.

- ``min_by``/``max_by`` (the joint AMIN/AMAX + ACARRY reduce), the variance
  family, ``covar_*``/``corr``, ``bool_and``/``bool_or``/``every``,
  ``count_if``, ``arbitrary``/``any_value``, ``approx_distinct`` (HLL) and
  ``approx_percentile`` (log histogram) through ``LocalQueryRunner``: rows,
  fused segments and ``pallas.`` counter deltas equal to the reference's
  under the defaults with ``pallas`` (the insert route for hashable
  groupings), unfused with ``sorted``, and with ``max_groups`` 1,024 (the
  host-RAM spill); a sketch grouping above ``WIDE_STATE_MAX_GROUPS``;
- the cases of ``tests/test_minmax_by.py``, ``tests/test_functions.py``'s
  aggregates and ``tests/test_sql_breadth.py``'s sketches, against their
  Python oracles;
- the HLL registers and the percentile histogram bit-identical to the
  reference's states, a reference-built state finished by the port's
  ``final_map`` through ``interop.aggregation_state_from_numpy``, and the
  HLL rho step on crafted values at and just below 2^k.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu.block import Block as RefBlock
from presto_tpu.block import Page as RefPage
from presto_tpu.metadata import Session as RefSession
from presto_tpu.ops import aggregates as ref_aggs
from presto_tpu.ops import hash_agg as ref_hash_agg
from presto_tpu.runner import LocalQueryRunner as RefRunner
from presto_tpu.utils.metrics import METRICS as REF_METRICS
from presto_tpu_torch.block import Block, Page
from presto_tpu_torch.interop import aggregation_state_from_numpy
from presto_tpu_torch.metadata import Session
from presto_tpu_torch.ops import aggregates as aggs
from presto_tpu_torch.ops import hash_agg
from presto_tpu_torch.runner import LocalQueryRunner
from presto_tpu_torch.types import BIGINT, DOUBLE
from presto_tpu_torch.utils.metrics import METRICS
from test_torch_sql import COUNTERS, UNFUSED, assert_same_rows
from test_torch_sql_tpch_exprs import segment_view

QUERIES = {
    # a hashable grouping (the insert route under pallas): joint pairs over
    # DATE and DOUBLE orderings, the variance family, bool/count_if/arbitrary
    # and covariance; 2,000 groups, so max_groups 1,024 spills
    "lineitem_by_part": "select l_partkey, min_by(l_orderkey, l_extendedprice), "
                        "max_by(l_suppkey, l_shipdate), stddev_samp(l_quantity), "
                        "var_samp(l_extendedprice), bool_and(l_quantity > 10), "
                        "bool_or(l_discount > 0.05), count_if(l_returnflag = 'R'), "
                        "arbitrary(l_shipmode), covar_samp(l_quantity, l_extendedprice), "
                        "corr(l_quantity, l_extendedprice) from lineitem group by l_partkey",
    "minmax_by_customer": "select o_custkey, min_by(o_orderkey, o_orderdate), "
                          "max_by(o_orderkey, o_orderdate), min_by(o_orderpriority, o_totalprice) "
                          "from orders group by o_custkey",
    # a dictionary key: the DIRECT builder, sketches as (groups, width) tables
    "status_sketches": "select o_orderstatus, approx_distinct(o_custkey), "
                       "approx_percentile(o_totalprice, 0.9), stddev(o_totalprice), "
                       "variance(o_totalprice), var_pop(o_totalprice), "
                       "stddev_pop(o_totalprice), every(o_shippriority = 0) "
                       "from orders group by 1",
    # no GROUP BY: the GLOBAL builder
    "global": "select min_by(l_orderkey, l_extendedprice - 30000), "
              "max_by(l_orderkey, l_extendedprice - 30000), approx_distinct(l_partkey), "
              "approx_percentile(l_extendedprice, 0.5), covar_pop(l_quantity, l_discount), "
              "every(l_quantity >= 0), count_if(l_shipmode = 'AIR'), any_value(l_linenumber) "
              "from lineitem",
    # VARCHAR payloads and orderings (dictionary codes and ranks)
    "varchar_by": "select n_regionkey, min_by(n_name, n_nationkey), max_by(n_nationkey, n_name), "
                  "arbitrary(n_name), bool_or(n_name like 'A%') from nation group by n_regionkey",
}
# above WIDE_STATE_MAX_GROUPS (15,000 groups): the wide partials spill
SKETCH_SPILL = ("select o_orderkey, approx_distinct(o_custkey), "
                "approx_percentile(o_totalprice, 0.5) from orders group by 1")
PROPS = {"pallas_defaults": {"hash_kernels": "pallas"},
         "sorted_unfused": {"hash_kernels": "sorted", **UNFUSED},
         "spill_1024": {"hash_kernels": "pallas", "max_groups": 1024}}


def _ref(sql, props):
    before = {k: REF_METRICS.counter_value(k) for k in COUNTERS}
    res = RefRunner(RefSession(catalog="tpch", schema="tiny", properties=dict(props))).execute(sql)
    delta = {k: REF_METRICS.counter_value(k) - before[k] for k in COUNTERS}
    return res.rows, segment_view((res.stats or {}).get("segments")), delta


def _port(sql, props):
    keys = COUNTERS + ("agg.spilled_folds",)
    before = {k: METRICS.counter_value(k) for k in keys}
    res = LocalQueryRunner(Session(catalog="tpch", schema="tiny", properties=dict(props)),
                           device="cpu").execute(sql)
    delta = {k: METRICS.counter_value(k) - before[k] for k in keys}
    return res.rows, segment_view((res.stats or {}).get("segments")), delta


@pytest.fixture(scope="module")
def reference():
    cache = {}

    def get(sql, props_id):
        if (sql, props_id) not in cache:
            cache[(sql, props_id)] = _ref(sql, PROPS[props_id])
        return cache[(sql, props_id)]
    return get


def _by_key(rows):
    return sorted(rows, key=lambda r: repr(r[0]))


@pytest.mark.parametrize("props_id", sorted(PROPS))
@pytest.mark.parametrize("name", sorted(QUERIES))
def test_rows_segments_and_counters_match_reference(reference, name, props_id):
    want_rows, want_seg, want_delta = reference(QUERIES[name], props_id)
    rows, seg, delta = _port(QUERIES[name], PROPS[props_id])
    assert rows, "the query returned no rows"
    # groups are unordered (no ORDER BY): compare by key
    assert_same_rows(_by_key(rows), _by_key(want_rows))
    assert seg == want_seg
    assert {k: delta[k] for k in COUNTERS} == want_delta
    if name == "lineitem_by_part":
        if props_id == "spill_1024":
            assert delta["agg.spilled_folds"] > 0
        if PROPS[props_id]["hash_kernels"] == "pallas":
            assert delta["pallas.agg_pages"] > 0  # the grouping took the insert


def test_sketch_grouping_above_the_wide_cap_spills_and_matches_reference(reference):
    assert hash_agg.WIDE_STATE_MAX_GROUPS == ref_hash_agg.WIDE_STATE_MAX_GROUPS == 8192
    want_rows, _, want_delta = reference(SKETCH_SPILL, "pallas_defaults")
    rows, _, delta = _port(SKETCH_SPILL, PROPS["pallas_defaults"])
    assert len(rows) == 15000
    assert_same_rows(_by_key(rows), _by_key(want_rows))
    assert delta["agg.spilled_folds"] > 0
    assert {k: delta[k] for k in COUNTERS} == want_delta
    assert delta["pallas.agg_pages"] == 0  # sketch groupings never take the insert


def test_literal_parameters_and_unported_collectors():
    fn = aggs.resolve_aggregate("approx_percentile", [DOUBLE], params=(0.25,))
    assert fn.params == (0.25,) and fn.fingerprint[-1] == (0.25,)
    assert fn.state[0].width == aggs.PCT_BUCKETS == 769 and not fn.splittable
    assert aggs.resolve_aggregate("approx_distinct", [BIGINT]).state[0].width == 2048
    with pytest.raises(ValueError, match="fraction"):
        aggs.resolve_aggregate("approx_percentile", [DOUBLE], params=(1.5,))
    # the collectors, once unported, now resolve as the reference's do: one
    # int32 handle state into the function's own ArrayValues store
    for name in ("array_agg", "map_agg", "histogram"):
        fn = aggs.resolve_aggregate(name, [BIGINT, BIGINT])
        ref = ref_aggs.resolve_aggregate(name, [BIGINT, BIGINT])
        assert fn.output_type.name == ref.output_type.name
        assert [(c.dtype, c.reduce, c.identity) for c in fn.state] == \
            [(c.dtype, c.reduce, c.identity) for c in ref.state]
        assert not fn.splittable and fn.output_dict.mode == ref.output_dict.mode


# ------------------------------------------- the reference tests' own oracles

@pytest.fixture(scope="module")
def runner():
    return LocalQueryRunner(Session(catalog="tpch", schema="tiny"), device="cpu")


def test_min_by_max_by_grouped_vs_python(runner):
    rows = runner.execute("select o_custkey, o_orderkey, o_orderdate from orders").rows
    got = runner.execute("select o_custkey, min_by(o_orderkey, o_orderdate), "
                         "max_by(o_orderkey, o_orderdate) from orders group by o_custkey").rows
    by_cust = {}
    for k, o, d in rows:
        by_cust.setdefault(k, []).append((o, d))
    for k, mn, mx in got:
        dates = [d for _, d in by_cust[k]]
        assert mn in [o for o, d in by_cust[k] if d == min(dates)]
        assert mx in [o for o, d in by_cust[k] if d == max(dates)]
    assert len(got) == len(by_cust)


def test_min_by_double_ordering(runner):
    got = runner.execute("select min_by(l_orderkey, l_extendedprice - 30000), "
                         "max_by(l_orderkey, l_extendedprice - 30000) from lineitem").rows[0]
    rows = runner.execute("select l_orderkey, l_extendedprice - 30000 from lineitem").rows
    lo, hi = min(r[1] for r in rows), max(r[1] for r in rows)
    assert got[0] in [r[0] for r in rows if r[1] == lo]
    assert got[1] in [r[0] for r in rows if r[1] == hi]


def test_min_by_varchar_payload_and_ordering(runner):
    got = dict(runner.execute("select n_regionkey, min_by(n_name, n_nationkey) from nation "
                              "group by n_regionkey order by n_regionkey").rows)
    rows = runner.execute("select n_regionkey, n_name, n_nationkey from nation").rows
    want = {}
    for k, name, key in rows:
        if k not in want or key < want[k][1]:
            want[k] = (name, key)
    assert got == {k: v[0] for k, v in want.items()}
    lo_hi = runner.execute("select min_by(n_nationkey, n_name), max_by(n_nationkey, n_name) "
                           "from nation").rows[0]
    rows = runner.execute("select n_nationkey, n_name from nation").rows
    assert lo_hi[0] == [r[0] for r in rows if r[1] == min(x[1] for x in rows)][0]
    assert lo_hi[1] == [r[0] for r in rows if r[1] == max(x[1] for x in rows)][0]


def test_min_by_nulls(runner):
    """The memory-catalog table of the reference's test as a VALUES list: a
    NULL ordering value skips the row, a NULL payload can win."""
    got = dict(runner.execute(
        "select k, min_by(x, y) from (values (1, 10, 5), (1, 20, null), (1, null, 1), "
        "(2, null, null), (2, 7, 9), (3, null, null)) as t(k, x, y) group by k").rows)
    assert got == {1: None, 2: 7, 3: None}


def test_min_by_small_domain_direct_strategy(runner):
    got = runner.execute("select l_returnflag, min_by(l_orderkey, l_shipdate) from lineitem "
                         "group by l_returnflag").rows
    rows = runner.execute("select l_returnflag, l_orderkey, l_shipdate from lineitem").rows
    by_flag = {}
    for f, o, d in rows:
        by_flag.setdefault(f, []).append((o, d))
    assert len(got) == len(by_flag)
    for f, o in got:
        lo = min(d for _, d in by_flag[f])
        assert o in [ok for ok, d in by_flag[f] if d == lo]


def test_count_if_bool_and_arbitrary(runner):
    got = runner.execute("select count_if(o_totalprice > 100000) from orders").rows[0][0]
    prices = [p for (p,) in runner.execute("select o_totalprice from orders").rows]
    assert got == sum(1 for p in prices if p > 100000)
    assert runner.execute("select bool_and(n_regionkey < 5), bool_or(n_regionkey = 4), "
                          "every(n_nationkey >= 0) from nation").rows[0] == [True, True, True]
    rows = runner.execute("select n_regionkey, arbitrary(n_name), any_value(n_nationkey) "
                          "from nation group by n_regionkey order by n_regionkey").rows
    assert len(rows) == 5 and all(isinstance(r[1], str) for r in rows)


def test_variance_family(runner):
    vals = [float(p) for (p,) in runner.execute("select o_totalprice from orders").rows]
    n = len(vals)
    mean = sum(vals) / n
    var_pop = sum((v - mean) ** 2 for v in vals) / n
    var_samp = var_pop * n / (n - 1)
    got = runner.execute("select var_pop(o_totalprice), var_samp(o_totalprice), "
                         "stddev_pop(o_totalprice), stddev(o_totalprice) from orders").rows[0]
    assert abs(got[0] - var_pop) / var_pop < 1e-9
    assert abs(got[1] - var_samp) / var_samp < 1e-9
    assert abs(got[2] - math.sqrt(var_pop)) / math.sqrt(var_pop) < 1e-9
    assert abs(got[3] - math.sqrt(var_samp)) / math.sqrt(var_samp) < 1e-9


def test_corr_covar(runner):
    xs = [(x, float(y)) for x, y in
          runner.execute("select o_custkey, o_totalprice from orders").rows]
    n = len(xs)
    mx = sum(x for x, _ in xs) / n
    my = sum(y for _, y in xs) / n
    cov_pop = sum((x - mx) * (y - my) for x, y in xs) / n
    got = runner.execute("select covar_pop(o_custkey, o_totalprice), "
                         "covar_samp(o_custkey, o_totalprice), "
                         "corr(o_custkey, o_totalprice) from orders").rows[0]
    assert abs(got[0] - cov_pop) / max(abs(cov_pop), 1) < 1e-6
    assert abs(got[1] - cov_pop * n / (n - 1)) / max(abs(cov_pop), 1) < 1e-6
    assert -1.0 <= got[2] <= 1.0


def test_approx_distinct_accuracy(runner):
    got = runner.execute("select approx_distinct(o_custkey) from orders").rows[0][0]
    exact = runner.execute("select count(*) from (select distinct o_custkey from orders) t") \
        .rows[0][0]
    assert abs(got - exact) / exact < 0.05


def test_approx_percentile(runner):
    got = runner.execute("select approx_percentile(o_totalprice, 0.5) from orders").rows[0][0]
    vals = sorted(float(p) for (p,) in runner.execute("select o_totalprice from orders").rows)
    exact = vals[len(vals) // 2]
    assert abs(float(got) - exact) / exact < 0.10
    rows = runner.execute("select o_orderstatus, o_totalprice from orders").rows
    for status, got90 in runner.execute("select o_orderstatus, approx_percentile(o_totalprice, "
                                        "0.9) from orders group by 1 order by 1").rows:
        sv = sorted(float(p) for s, p in rows if s == status)
        exact90 = sv[int(0.9 * len(sv))]
        assert abs(float(got90) - exact90) / exact90 < 0.10


# -------------------------------------------------- sketch states, bit for bit

def _sketch_pages(seed: int, n: int = 4096):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 40, n).astype(np.int64)
    ints = rng.integers(-10 ** 9, 10 ** 9, n).astype(np.int64)
    dbl = rng.normal(0.0, 1e4, n)
    dbl[:64] = 0.0
    mask = rng.random(n) < 0.9
    return keys, ints, dbl, mask


def _states(seed: int):
    """The sketch grouping's (keys, states, valid) from both packages'
    grouped builders over the same two pages."""
    from presto_tpu.types import BIGINT as RBIGINT
    from presto_tpu.types import DOUBLE as RDOUBLE

    ref_calls = [ref_aggs.AggregateCall(ref_aggs.resolve_aggregate("approx_distinct", [RBIGINT]),
                                        [1]),
                 ref_aggs.AggregateCall(ref_aggs.resolve_aggregate(
                     "approx_percentile", [RDOUBLE], params=(0.75,)), [2])]
    calls = [aggs.AggregateCall(aggs.resolve_aggregate("approx_distinct", [BIGINT]), [1]),
             aggs.AggregateCall(aggs.resolve_aggregate("approx_percentile", [DOUBLE],
                                                       params=(0.75,)), [2])]
    rb = ref_hash_agg.GroupedAggregationBuilder([RBIGINT], [None], ref_calls, 4096)
    rb.set_channels([0])
    pb = hash_agg.GroupedAggregationBuilder([BIGINT], calls, device="cpu").set_channels([0])
    for s in (seed, seed + 1):
        keys, ints, dbl, mask = _sketch_pages(s)
        rb.add_page(RefPage((RefBlock(RBIGINT, jnp.asarray(keys)), RefBlock(RBIGINT, jnp.asarray(ints)),
                             RefBlock(RDOUBLE, jnp.asarray(dbl))), jnp.asarray(mask)))
        pb.add_page(Page((Block(BIGINT, torch.from_numpy(keys)), Block(BIGINT, torch.from_numpy(ints)),
                          Block(DOUBLE, torch.from_numpy(dbl))), torch.from_numpy(mask)))
    return ref_calls, calls, rb.finish(), pb.finish()


def test_sketch_states_are_bit_identical_and_finish_through_interop():
    ref_calls, calls, (rk, rs, rv), (pk, ps, pv) = _states(11)
    # both tables are compact (valid is a prefix); the reference's final fold
    # keeps its table size, the port's shrinks it to the groups' pow2
    rv = np.asarray(rv)
    live = rv.nonzero()[0]
    assert len(live) == 40 and pv.numpy().nonzero()[0].tolist() == live.tolist()
    for a, b in zip(pk, rk):
        np.testing.assert_array_equal(a.numpy()[live], np.asarray(b)[live])
    regs, hist = np.asarray(rs[0]), np.asarray(rs[1])
    assert regs.shape[1:] == (2048,) and regs.dtype == np.float32
    assert hist.shape[1:] == (769,) and hist.dtype == np.float64
    np.testing.assert_array_equal(ps[0].numpy()[live], regs[live])  # HLL registers
    np.testing.assert_array_equal(ps[1].numpy()[live], hist[live])  # percentile histogram
    # the reference-built state, finished by the port
    keys, states, valid = aggregation_state_from_numpy(
        calls, [np.asarray(k) for k in rk], [regs, hist], rv, device="cpu")
    assert states[0].dtype == torch.float32 and states[1].dtype == torch.float64
    want_hll = np.asarray(ref_calls[0].function.final_map((jnp.asarray(regs),)))
    got_hll = calls[0].function.final_map((states[0],)).numpy()
    np.testing.assert_array_equal(got_hll[live], want_hll[live])
    want_pct, want_null = ref_calls[1].function.final_map((jnp.asarray(hist),))
    got_pct, got_null = calls[1].function.final_map((states[1],))
    np.testing.assert_array_equal(got_pct.numpy()[live], np.asarray(want_pct)[live])
    np.testing.assert_array_equal(got_null.numpy()[live], np.asarray(want_null)[live])
    with pytest.raises(ValueError, match="needs"):
        aggregation_state_from_numpy(calls, [], [regs[:, :10], hist], rv, device="cpu")


def test_hll_rho_at_and_below_powers_of_two():
    """rest = just below 2^k (which rounds up to 2^k in float64 for large k),
    exactly 2^k with the low bits set, and just above, for k from 11 to 64:
    the port's rho equals the reference's formula, in JAX and in numpy's
    direct uint64 -> float64 form (log2 as log * (1/ln 2), the reference's)."""
    vals = []
    for k in range(11, 65):
        for d in range(0, 40):
            below = (1 << k) - 1 - (d << 1)
            if below >= 1 << 11:
                vals.append(below | 0x7FF)
            above = ((1 << k) + (d << 11)) | 0x7FF
            if above < 1 << 64:
                vals.append(above)
    u = np.array(vals, dtype=np.uint64)
    got = aggs._hll_rho(torch.from_numpy(u.view(np.int64))).numpy()
    want_jax = np.clip(64.0 - np.floor(np.asarray(jnp.log2(jnp.asarray(u).astype(jnp.float64)))),
                       1, 54).astype(np.float32)
    want_np = np.clip(64.0 - np.floor(np.log(u.astype(np.float64)) * (1 / np.log(2))),
                      1, 54).astype(np.float32)
    np.testing.assert_array_equal(got, want_jax)
    np.testing.assert_array_equal(got, want_np)
    # the conversion itself: correctly rounded, as numpy's
    np.testing.assert_array_equal(aggs._u64_to_f64(torch.from_numpy(u.view(np.int64))).numpy(),
                                  u.astype(np.float64))


def test_sketch_contributions_match_reference():
    """Hash buckets, rho, percentile buckets and the IEEE ordering key on
    seeded columns (and values at sub-bucket edges), bit for bit."""
    from presto_tpu.types import BIGINT as RBIGINT
    from presto_tpu.types import DOUBLE as RDOUBLE

    rng = np.random.default_rng(5)
    x = rng.integers(-10 ** 12, 10 ** 12, 50000)
    m = rng.random(50000) < 0.9
    (rb, rr), = ref_aggs.resolve_aggregate("approx_distinct", [RBIGINT]).input_map(
        (jnp.asarray(x),), jnp.asarray(m))
    (pb, pr), = aggs.resolve_aggregate("approx_distinct", [BIGINT]).input_map(
        (torch.from_numpy(x),), torch.from_numpy(m))
    np.testing.assert_array_equal(pb.numpy(), np.asarray(rb))
    np.testing.assert_array_equal(pr.numpy(), np.asarray(rr))
    edges = np.array([float((8 + j) << e) for j in range(8) for e in range(28)])
    v = np.concatenate([rng.normal(0, 1e6, 50000), edges, -edges, 2.0 ** np.arange(-20, 35), [0.0]])
    ones = np.ones(len(v), dtype=bool)
    (rb, _), = ref_aggs.resolve_aggregate("approx_percentile", [RDOUBLE], params=(0.5,)) \
        .input_map((jnp.asarray(v),), jnp.asarray(ones))
    (pb, _), = aggs.resolve_aggregate("approx_percentile", [DOUBLE], params=(0.5,)) \
        .input_map((torch.from_numpy(v),), torch.from_numpy(ones))
    np.testing.assert_array_equal(pb.numpy(), np.asarray(rb))
    y = np.concatenate([rng.normal(0, 1e6, 1000), [0.0, -0.0, np.inf, -np.inf]])
    np.testing.assert_array_equal(aggs._sortable_i64(torch.from_numpy(y)).numpy(),
                                  np.asarray(ref_aggs._sortable_i64(jnp.asarray(y))))
