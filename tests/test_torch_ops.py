"""Operators of the PyTorch port against their JAX counterparts.

Same numpy inputs (fixed seeds) through both packages; every comparison is
exact (integer, decimal and boolean data).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from presto_tpu import block as jblock
from presto_tpu.connectors.tpch import generator as jg
from presto_tpu.ops import expressions as jx
from presto_tpu.ops.filter_project import PageProcessor as JPageProcessor
from presto_tpu.ops.hash_agg import sort_group_reduce as jax_sort_group_reduce
from presto_tpu.ops.sorting import lexsort_fast as jax_lexsort_fast
from presto_tpu.ops.topn import SortOrder as JSortOrder, topn_merge_stage as jax_topn
from presto_tpu import types as jt
from presto_tpu_torch import block as tblock, interop
from presto_tpu_torch.connectors.tpch import generator as tg
from presto_tpu_torch.ops import expressions as tx
from presto_tpu_torch.ops.filter_project import PageProcessor as TPageProcessor
from presto_tpu_torch.ops.aggregates import AggregateCall, resolve_aggregate
from presto_tpu_torch.ops.hash_agg import (SINGLE, HashAggregationOperatorFactory,
                                           sort_group_reduce)
from presto_tpu_torch.ops.sorting import lexsort_fast
from presto_tpu_torch.ops.topn import SortOrder, topn_merge_stage
from presto_tpu_torch import types as tt

CAP = 1024


def _page_pair(types_j, types_t, arrays, mask, dicts_j=None, dicts_t=None):
    jp = jblock.page_from_arrays(types_j, arrays, dicts_j, capacity=CAP)
    jp = jblock.Page(jp.blocks, jnp.asarray(mask))
    tp = interop.page_from_numpy(types_t, arrays, mask, dicts_t, device="cpu")
    return jp, tp


def _assert_pages_equal(jp, tp):
    np.testing.assert_array_equal(tp.mask.numpy(), np.asarray(jp.mask))
    assert len(jp.blocks) == len(tp.blocks)
    for jb, tb in zip(jp.blocks, tp.blocks):
        assert jb.type.display_name() == tb.type.display_name()
        want = np.asarray(jb.data)
        got = tb.data.numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        assert (jb.nulls is None) == (tb.nulls is None)


def test_compact_matches_reference():
    rng = np.random.RandomState(1)
    a = rng.randint(-10 ** 9, 10 ** 9, CAP).astype(np.int64)
    d = rng.randint(8000, 11000, CAP).astype(np.int32)
    mask = rng.rand(CAP) < 0.4
    jp, tp = _page_pair([jt.BIGINT, jt.DATE], [tt.BIGINT, tt.DATE], [a, d], mask)
    _assert_pages_equal(jblock._compact(jp), tblock._compact(tp))
    # a padded page: 600 live rows of capacity 1024
    jp = jblock.page_from_arrays([jt.BIGINT, jt.DATE], [a[:600], d[:600]], capacity=CAP)
    tp = tblock.page_from_arrays([tt.BIGINT, tt.DATE], [a[:600], d[:600]], capacity=CAP,
                                 device="cpu")
    _assert_pages_equal(jp, tp)
    jp, tp = jp.with_mask(jnp.asarray(mask)), tp.with_mask(torch.from_numpy(mask))
    _assert_pages_equal(jblock._compact(jp), tblock._compact(tp))


def _lineitem_like(rng):
    return [
        rng.randint(1, 6_000_000, CAP).astype(np.int64),          # orderkey
        rng.randint(8035, 10561, CAP).astype(np.int32),           # shipdate
        rng.randint(90100, 10_495_000, CAP).astype(np.int64),     # extendedprice
        rng.randint(0, 11, CAP).astype(np.int64),                 # discount
        rng.randint(0, 9, CAP).astype(np.int64),                  # tax
        rng.randint(100, 5001, CAP).astype(np.int64),             # quantity
    ]


def _exprs(x, types):
    """Q3/Q1/Q6 predicates and projections over the lineitem-like layout,
    built with one package's expression module."""
    DEC = types.DecimalType(12, 2)
    B = types.BOOLEAN
    ok, sd, ep, disc, tax, qty = (x.input_ref(i, t) for i, t in enumerate(
        [types.BIGINT, types.DATE, DEC, DEC, DEC, DEC]))
    cut = x.days_from_civil(1995, 3, 15)
    one = x.constant(100, DEC)
    disc_price = x.call("multiply", types.DecimalType(18, 4), ep,
                        x.call("subtract", DEC, one, disc))
    return {
        "q3": (x.call("greater_than", B, sd, x.constant(cut, types.DATE)),
               [ok, disc_price]),
        "q1": (x.call("less_than_or_equal", B, sd,
                      x.constant(x.days_from_civil(1998, 12, 1) - 90, types.DATE)),
               [qty, disc_price,
                x.call("multiply", types.DecimalType(18, 6), disc_price,
                       x.call("add", DEC, one, tax))]),
        "q6": (x.special("AND", B,
                         x.call("greater_than_or_equal", B, sd,
                                x.constant(x.days_from_civil(1994, 1, 1), types.DATE)),
                         x.call("less_than", B, sd,
                                x.constant(x.days_from_civil(1995, 1, 1), types.DATE)),
                         x.special("BETWEEN", B, disc, x.constant(5, DEC), x.constant(7, DEC)),
                         x.call("less_than", B, qty, x.constant(2400, DEC))),
               [x.call("multiply", types.DecimalType(18, 4), ep, disc),
                x.call("year", types.BIGINT, sd), x.call("month", types.BIGINT, sd),
                x.call("day", types.BIGINT, sd)]),
        # decimal rescale with floor rounding (scale 4 -> 2) and a cast
        "rescale": (x.special("NOT", B, x.call("equal", B, disc, x.constant(0, DEC))),
                    [x.call("multiply", DEC, ep, disc),
                     x.special("CAST", types.DOUBLE, ep),
                     x.call("negate", DEC, ep)]),
    }


@pytest.mark.parametrize("query", ["q3", "q1", "q6", "rescale"])
def test_predicates_and_decimal_projections_match_reference(query):
    rng = np.random.RandomState(2)
    arrays = _lineitem_like(rng)
    mask = rng.rand(CAP) < 0.9
    DECJ, DECT = jt.DecimalType(12, 2), tt.DecimalType(12, 2)
    tj = [jt.BIGINT, jt.DATE, DECJ, DECJ, DECJ, DECJ]
    ttypes = [tt.BIGINT, tt.DATE, DECT, DECT, DECT, DECT]
    jp, tp = _page_pair(tj, ttypes, arrays, mask)
    jf, jproj = _exprs(jx, jt)[query]
    tf, tproj = _exprs(tx, tt)[query]
    want = JPageProcessor(jx.InputLayout(tj, [None] * 6), jf, jproj)(jp)
    got = TPageProcessor(tx.InputLayout(ttypes, [None] * 6), tf, tproj)(tp)
    _assert_pages_equal(want, got)
    assert 0 < int(got.mask.sum()) < CAP


def test_dictionary_string_predicate_matches_reference():
    rng = np.random.RandomState(3)
    seg = rng.randint(0, len(jg.SEGMENTS), CAP).astype(np.int32)
    key = np.arange(CAP, dtype=np.int64)
    mask = np.ones(CAP, bool)
    jp, tp = _page_pair([jt.BIGINT, jt.VARCHAR], [tt.BIGINT, tt.VARCHAR], [key, seg], mask,
                        [None, jg.DICT_SEGMENT], [None, tg.DICT_SEGMENT])
    for x, types, page, dicts, proc in ((jx, jt, jp, jg.DICT_SEGMENT, JPageProcessor),
                                        (tx, tt, tp, tg.DICT_SEGMENT, TPageProcessor)):
        pred = x.special("OR", types.BOOLEAN,
                         x.call("equal", types.BOOLEAN, x.input_ref(1, types.VARCHAR),
                                x.constant("BUILDING", types.VARCHAR)),
                         x.special("IN", types.BOOLEAN, x.input_ref(1, types.VARCHAR),
                                   x.constant("MACHINERY", types.VARCHAR),
                                   x.constant("NOT A SEGMENT", types.VARCHAR)))
        out = proc(x.InputLayout([types.BIGINT, types.VARCHAR], [None, dicts]), pred,
                   [x.input_ref(0, types.BIGINT)])(page)
        if x is jx:
            want = np.asarray(out.mask)
        else:
            got = out.mask.numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()


@pytest.mark.parametrize("domain", ["narrow", "wide"])
def test_lexsort_fast_matches_reference(domain):
    """The packed single-sort path (narrow) and the per-key fallback (wide)."""
    rng = np.random.RandomState(4)
    if domain == "narrow":
        keys = [rng.randint(0, 50, CAP).astype(np.int64),
                rng.randint(8000, 8100, CAP).astype(np.int32),
                rng.rand(CAP) < 0.5]
    else:
        keys = [rng.randint(-2 ** 62, 2 ** 62, CAP, dtype=np.int64),
                rng.randint(0, 3, CAP).astype(np.int64),
                rng.randint(-2 ** 62, 2 ** 62, CAP, dtype=np.int64)]
    want = np.asarray(jax_lexsort_fast(tuple(jnp.asarray(k) for k in keys)))
    got = lexsort_fast(tuple(torch.from_numpy(k) for k in keys)).numpy()
    np.testing.assert_array_equal(got, want)


def test_sort_group_reduce_matches_reference():
    """The Q3 grouping shape: (orderkey, date, priority) keys with null flags,
    decimal sum + count states, masked rows, a trash segment."""
    rng = np.random.RandomState(5)
    okey = rng.randint(0, 200, CAP).astype(np.int64)
    date = (8000 + okey % 7).astype(np.int32)
    prio = np.zeros(CAP, np.int32)
    flags = np.zeros(CAP, bool)
    rev = rng.randint(0, 10 ** 9, CAP).astype(np.int64)
    mask = rng.rand(CAP) < 0.8
    keys = (okey, flags, date, flags, prio, flags)
    contribs = (np.where(mask, rev, 0), mask.astype(np.int64))
    kinds, idents = ("sum", "sum"), (0, 0)
    for out_groups in (256, 64):  # 64 < groups: the overflow lands in the bin
        want = jax_sort_group_reduce(tuple(jnp.asarray(k) for k in keys), jnp.asarray(mask),
                                     tuple(jnp.asarray(c) for c in contribs), kinds,
                                     idents, out_groups)
        got = sort_group_reduce(tuple(torch.from_numpy(k) for k in keys),
                                torch.from_numpy(mask),
                                tuple(torch.from_numpy(c) for c in contribs), kinds,
                                idents, out_groups)
        for w, g in zip(want[0] + want[1] + (want[2],), got[0] + got[1] + (got[2],)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert int(got[3]) == int(want[3])


def test_topn_merge_matches_reference():
    rng = np.random.RandomState(6)
    okey = rng.permutation(CAP).astype(np.int64)
    date = rng.randint(8000, 8010, CAP).astype(np.int32)
    rev = rng.randint(0, 50, CAP).astype(np.int64)  # many ties
    DECJ, DECT = jt.DecimalType(18, 4), tt.DecimalType(18, 4)
    arrays = [okey, date, rev]
    bufs = []
    for seed_mask in (rng.rand(CAP) < 0.7, rng.rand(CAP) < 0.7):
        bufs.append(_page_pair([jt.BIGINT, jt.DATE, DECJ], [tt.BIGINT, tt.DATE, DECT],
                               arrays, seed_mask))
    jbuf = tbuf = None
    for jp, tp in bufs:
        jbuf = jax_topn(jp, jbuf, (JSortOrder(2, descending=True), JSortOrder(1)), 10)
        tbuf = topn_merge_stage(tp, tbuf, (SortOrder(2, descending=True), SortOrder(1)), 10)
    _assert_pages_equal(jbuf, tbuf)


def _semi_join(pkg, expressions, types, join_type, build_arrays, probe_arrays, probe_mask,
               key_type, with_filter):
    """Build + probe one SEMI join in one package; returns the output mask.
    Build: (key, payload value); probe: (key, value); filter: probe value <
    build value."""
    hj = pkg["hash_join"]
    bp = pkg["page"]([key_type, types.BIGINT], build_arrays)
    filter_fn = None
    if with_filter:
        layout = expressions.InputLayout([types.BIGINT, types.BIGINT], [None, None])
        filter_fn = expressions.ExpressionCompiler(layout).compile(
            expressions.call("less_than", types.BOOLEAN,
                             expressions.input_ref(0, types.BIGINT),
                             expressions.input_ref(1, types.BIGINT)))
    build = hj.JoinBuildOperatorFactory(0, [0], [1] if with_filter else [],
                                        [(types.BIGINT, None)] if with_filter else [],
                                        strategy="sorted", unique=False)
    op = build.create_operator()
    op.add_input(bp)
    op.finish()
    probe = hj.LookupJoinOperatorFactory(
        1, build.lookup_factory, [0], [0, 1], [(key_type, None), (types.BIGINT, None)],
        [], [], join_type, filter_fn=filter_fn,
        filter_probe_channels=[1] if with_filter else None,
        filter_build_channels=[0] if with_filter else None).create_operator()
    assert probe.is_blocked() is None
    page = pkg["page"]([key_type, types.BIGINT], probe_arrays)
    page = page.with_mask(pkg["mask"](probe_mask))
    probe.add_input(page)
    return np.asarray(pkg["to_numpy"](probe.get_output().mask))


@pytest.mark.parametrize("with_filter", [True, False])
@pytest.mark.parametrize("key", ["bigint", "double"])
def test_semi_join_matches_reference(key, with_filter):
    """The semi probe over a duplicate-key build: the exact-key probe
    (bigint, no filter), and the range-scan probe (the reference's
    _emit_semi_expanded with _SemiFilterKernel) that a join filter, or float
    keys that only the true-key verify tells apart, send it to."""
    from presto_tpu.ops import hash_join as jhj
    from presto_tpu_torch.ops import hash_join as thj

    rng = np.random.RandomState(8)
    n = 600
    if key == "double":
        bkeys = rng.randint(0, 40, n) + rng.choice([0.0, 0.25, 0.5], n)
        pkeys = rng.randint(0, 50, CAP) + rng.choice([0.0, 0.25, 0.75], CAP)
    else:
        bkeys = rng.randint(0, 300, n).astype(np.int64)
        pkeys = rng.randint(0, 400, CAP).astype(np.int64)
    bvals = rng.randint(0, 1000, n).astype(np.int64)
    pvals = rng.randint(0, 1000, CAP).astype(np.int64)
    pmask = rng.rand(CAP) < 0.9
    jpkg = {"hash_join": jhj, "mask": jnp.asarray, "to_numpy": np.asarray,
            "page": lambda ts, arrs: jblock.page_from_arrays(ts, arrs)}
    tpkg = {"hash_join": thj, "mask": torch.from_numpy, "to_numpy": lambda t: t.numpy(),
            "page": lambda ts, arrs: tblock.page_from_arrays(ts, arrs, device="cpu")}
    jk = jt.DOUBLE if key == "double" else jt.BIGINT
    tk = tt.DOUBLE if key == "double" else tt.BIGINT
    want = _semi_join(jpkg, jx, jt, "semi", [bkeys, bvals], [pkeys, pvals], pmask, jk,
                      with_filter)
    got = _semi_join(tpkg, tx, tt, "semi", [bkeys, bvals], [pkeys, pvals], pmask, tk,
                     with_filter)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < pmask.sum()


@pytest.mark.parametrize("device", ["cpu", "cuda", None])
def test_aggregation_builder_takes_the_factory_device(device):
    """The builder works on the factory's device (default "cuda"), and an
    empty input yields its zero groups there."""
    calls = [AggregateCall(resolve_aggregate("sum", [tt.BIGINT]), [1])]
    kw = {} if device is None else {"device": device}
    factory = HashAggregationOperatorFactory(0, [0], [tt.BIGINT], [None], calls, SINGLE,
                                             64, **kw)
    op = factory.create_operator()
    assert factory.device == op.builder._device == torch.device(device or "cuda")
    if device == "cpu":
        op.finish()
        page = op.get_output()
        assert page.mask.device.type == "cpu" and not bool(page.mask.any())
        assert all(b.data.device.type == "cpu" for b in page.blocks)
        assert op.get_output() is None and op.is_finished()
