"""Fused segments in the port: the reference's own cases
(``tests/test_fused_segment.py``) against the port, and the page-local probe
stage against presto_tpu's, on the CPU.

The stage (``hash_join.apply_probe_stage``) runs in both packages on the
same numpy pages and the same builds, SORTED and PALLAS (the reference's
Pallas kernels in interpret mode, the port's plain versions), for INNER,
LEFT, SEMI, ANTI and null-aware ANTI, with NULL probe keys, NULL build keys
and masked rows: every column, null mask and row mask equal, dead rows
included.
"""
import numpy as np
import pytest

from presto_tpu import types as jt
from presto_tpu.ops import hash_join as jhj
from presto_tpu_torch import types as tt
from presto_tpu_torch.exec.local_planner import LocalExecutionPlanner
from presto_tpu_torch.metadata import Session
from presto_tpu_torch.models.tpch_sql import QUERIES
from presto_tpu_torch.ops import hash_join as thj
from presto_tpu_torch.ops.fused_segment import (FusedSegmentOperatorFactory,
                                                mid_stage_fusible)
from presto_tpu_torch.runner import LocalQueryRunner
from presto_tpu_torch.utils.metrics import METRICS
from test_torch_fused_segment import port_run, ref_run, segment_view
from test_torch_join_expand import _assert_pages_equal, _pages
from test_torch_sql import UNFUSED, assert_same_rows

TOPN_OVER_JOIN = ("select o_orderkey, c_name from orders, customer "
                  "where o_custkey = c_custkey order by o_orderkey limit 5")
SEMI_JOIN = ("select count(*) from orders where o_custkey in "
             "(select c_custkey from customer where c_acctbal > 0)")
DICT_GROUP_KEYS = ("select l_returnflag, l_linestatus, count(*) c, sum(l_quantity) q "
                   "from lineitem group by l_returnflag, l_linestatus "
                   "order by l_returnflag, l_linestatus")
FULL_JOIN = ("select c_custkey, o_orderkey from customer "
             "full join orders on c_custkey = o_custkey")


def _runner(**props):
    return LocalQueryRunner(Session(catalog="tpch", schema="tiny", properties=props),
                            device="cpu")


def _segments(runner, sql):
    """Plan ``sql``; -> (its fused segment factories, the execution plan)."""
    exec_plan = LocalExecutionPlanner(runner.metadata, runner.session, "cpu") \
        .plan(runner.plan_sql(sql))
    return [f for chain in exec_plan.pipelines for f in chain
            if isinstance(f, FusedSegmentOperatorFactory)], exec_plan


# ------------------------------------------------------------- differential

@pytest.mark.parametrize("sql", [TOPN_OVER_JOIN, SEMI_JOIN, DICT_GROUP_KEYS],
                         ids=["topn_over_join", "semi_join", "dict_group_keys"])
def test_fused_equals_unfused_and_reference(sql):
    """Fused rows equal the port's unfused rows and the reference's; the
    segments equal the reference's."""
    rows, seg, _ = port_run(sql, {})
    unfused, _, _ = port_run(sql, UNFUSED)
    want, want_seg, _ = ref_run(sql, {})
    assert rows
    assert_same_rows(rows, unfused)
    assert_same_rows(rows, want)
    assert segment_view(seg) == segment_view(want_seg)


# ------------------------------------------------------ boundary decisions

def test_q3_fuses_probe_chain_into_agg_terminal():
    segs, _ = _segments(_runner(), QUERIES[3])
    assert len(segs) == 1
    names = segs[0].member_names
    assert any("LookupJoin" in n for n in names)
    assert "HashAggregation" in " ".join(names)
    assert not any("TopN" in n for n in names)  # the aggregation ends the segment


def test_topn_terminates_a_probe_segment():
    segs, _ = _segments(_runner(), TOPN_OVER_JOIN)
    assert any("TopN" in s.member_names[-1] for s in segs)


def test_join_build_pipelines_never_fuse():
    _, exec_plan = _segments(_runner(), QUERIES[3])
    builds = [f for chain in exec_plan.pipelines for f in chain if f.name == "JoinBuild"]
    assert len(builds) == 2
    for chain in exec_plan.pipelines:
        for f in chain:
            if isinstance(f, FusedSegmentOperatorFactory):
                assert "JoinBuild" not in f.member_names


def test_full_join_probe_is_a_barrier():
    """A FULL probe never fuses: no segment holds it, and the fused plan's
    rows equal the unfused plan's (the reference's own case)."""
    fac = thj.LookupJoinOperatorFactory(0, thj.LookupSourceFactory(), [0], [0],
                                        [(tt.BIGINT, None)], [0], [(tt.BIGINT, None)],
                                        thj.FULL, unique_build=True)
    assert not mid_stage_fusible(fac)
    segs, _ = _segments(_runner(), FULL_JOIN)
    for s in segs:
        assert not any("LookupJoin" in n for n in s.member_names)
    fused = _runner().execute(FULL_JOIN + " order by 1, 2 limit 50")
    oracle = _runner(**UNFUSED).execute(FULL_JOIN + " order by 1, 2 limit 50")
    assert fused.rows and fused.rows == oracle.rows


def test_order_by_is_a_barrier():
    segs, exec_plan = _segments(_runner(), "select l_orderkey from lineitem order by l_orderkey")
    assert any(f.name == "OrderBy" for chain in exec_plan.pipelines for f in chain)
    for s in segs:
        assert not any("OrderBy" in n for n in s.member_names)


def test_knob_off_plans_no_segments():
    segs, exec_plan = _segments(_runner(segment_fusion=False), QUERIES[3])
    assert segs == [] and exec_plan.segment_decisions == []


def test_single_operator_runs_stay_unfused():
    segs, exec_plan = _segments(_runner(), QUERIES[6])
    assert segs == []
    assert any(d["reason"] == "single-operator run"
               for d in exec_plan.segment_decisions if not d["fused"])


# ------------------------------------------------------------ observability

def test_segment_stats_and_counters():
    before = {k: METRICS.counter_value(k) for k in ("segments.dispatches",
                                                     "coalesce.pages_in",
                                                     "coalesce.pages_out")}
    res = _runner().execute(QUERIES[3])
    seg = res.stats["segments"]
    assert seg["count"] == 1 and seg["dispatches"] == 4
    assert seg["segments"][0]["operators"] and seg["segments"][0]["probe_launches"] == 0
    assert any(d.get("fused") for d in seg["decisions"])
    assert METRICS.counter_value("segments.dispatches") - before["segments.dispatches"] == 4
    # Q3 coalesces its filtered lineitem, orders and customer scans
    pages_in = METRICS.counter_value("coalesce.pages_in") - before["coalesce.pages_in"]
    pages_out = METRICS.counter_value("coalesce.pages_out") - before["coalesce.pages_out"]
    assert pages_in > pages_out > 0
    assert _runner(**UNFUSED).execute(QUERIES[3]).stats is None


# --------------------------------------------------------------- the stage

def _stage_case(kind: str, join_type: str, null_aware: bool, n: int = 200, cap: int = 96):
    """A unique-key build (key, two payload columns, one nullable) and two
    probe pages, from a seed; NULL build keys in the null-aware case."""
    rng = np.random.RandomState(len(kind) * 7 + len(join_type) + null_aware)
    keys = rng.permutation(10_000)[:n].astype(np.int64) - 300
    knulls = (rng.rand(n) < 0.03) if null_aware else np.zeros(n, bool)
    pay = [rng.randint(0, 10 ** 6, n).astype(np.int64), rng.randint(-50, 50, n).astype(np.int32)]
    pnulls = rng.rand(n) < 0.2
    build = ([keys] + pay, [knulls, None, pnulls], rng.rand(n) < 0.9)
    probes = []
    for _ in range(2):
        pk = keys[rng.randint(0, n, cap)].copy()
        pk[rng.rand(cap) < 0.3] += 100_000  # misses
        pv = rng.randint(0, 9, cap).astype(np.int64)
        probes.append(([pv, pk], [None, rng.rand(cap) < 0.1], rng.rand(cap) < 0.85))
    return build, probes


def _run_stage(pkg, kind, join_type, null_aware):
    j = pkg is jhj
    T = jt if j else tt
    build, probes = _stage_case(kind, join_type, null_aware)
    btypes = [T.BIGINT, T.BIGINT, T.INTEGER]
    bj, bt = _pages(btypes, btypes, build[0], build[2], build[1])
    kw = {} if j else {"device": "cpu"}
    fac = pkg.JoinBuildOperatorFactory(0, [0], [1, 2], [(T.BIGINT, None), (T.INTEGER, None)],
                                       strategy=kind, unique=True, **kw)
    op = fac.create_operator()
    op.add_input(bj if j else bt)
    op.finish()
    src = fac.lookup_factory.get(0) if j else fac.lookup_factory.get()
    assert src.kind == kind and src.has_null_key == null_aware
    semi = join_type in ("semi", "anti")
    cfg = pkg.ProbeStageConfig(
        kind=src.kind, join_type=join_type, probe_key_channels=(1,),
        probe_output_channels=(0, 1), build_output_channels=() if semi else (1, 0),
        payload_meta=() if semi else ((T.INTEGER, None), (T.BIGINT, None)),
        null_aware=null_aware, pallas_trips=src.ph_trips)
    aux = pkg.probe_stage_aux(src)
    ptypes = [T.BIGINT, T.BIGINT]
    outs = []
    for cols, nulls, mask in probes:
        pj, pt = _pages(ptypes, ptypes, cols, mask, nulls)
        outs.append(pkg.apply_probe_stage(pj if j else pt, aux, cfg))
    return outs


@pytest.mark.parametrize("join_type,null_aware", [("inner", False), ("left", False),
                                                  ("semi", False), ("anti", False),
                                                  ("anti", True)],
                         ids=["inner", "left", "semi", "anti", "anti_null_aware"])
@pytest.mark.parametrize("kind", ["sorted", "pallas"])
def test_apply_probe_stage_matches_reference(kind, join_type, null_aware):
    want = _run_stage(jhj, kind, join_type, null_aware)
    got = _run_stage(thj, kind, join_type, null_aware)
    for jp, tp in zip(want, got):
        _assert_pages_equal(jp, tp)
    if null_aware:  # a NULL build key empties NOT IN
        assert not any(bool(p.mask.any()) for p in got)
    elif join_type in ("inner", "semi"):
        assert all(bool(p.mask.any()) for p in got)


@pytest.mark.parametrize("join_type", ["semi", "anti"])
def test_unfused_semi_and_anti_probe_through_the_stage(join_type):
    """The unfused probe calls the stage function: the operator's pages
    equal the stage's on the same build."""
    build, probes = _stage_case("sorted", join_type, False)
    btypes = [tt.BIGINT, tt.BIGINT, tt.INTEGER]
    _, bt = _pages(btypes, btypes, build[0], build[2], build[1])
    fac = thj.JoinBuildOperatorFactory(0, [0], [], [], strategy="sorted", device="cpu")
    op = fac.create_operator()
    op.add_input(bt)
    op.finish()
    probe = thj.LookupJoinOperatorFactory(1, fac.lookup_factory, [1], [0, 1],
                                          [(tt.BIGINT, None)] * 2, [], [],
                                          join_type).create_operator()
    assert probe.is_blocked() is None
    src = fac.lookup_factory.get()
    cfg = thj.ProbeStageConfig("sorted", join_type, (1,), (0, 1), (), ())
    for cols, nulls, mask in probes:
        _, pt = _pages([tt.BIGINT] * 2, [tt.BIGINT] * 2, cols, mask, nulls)
        probe.add_input(pt)
        got = probe.get_output()
        _assert_pages_equal(thj.apply_probe_stage(pt, thj.probe_stage_aux(src), cfg), got)
    assert probe._stage_cfg == cfg


def test_cached_segment_keeps_no_operators_builder():
    """The process-wide composition cache holds a fused segment's function,
    never the builder of the operator that composed it: once the query is
    gone, no grouping builder of its fused terminal is alive (a kept builder
    held its partial pages on the device after a cluster's tasks ended)."""
    import gc

    from presto_tpu_torch.ops import hash_agg

    def live_builders():
        gc.collect()
        return [o for o in gc.get_objects() if type(o) is hash_agg.GroupedAggregationBuilder]

    runner = _runner()
    assert runner.execute(QUERIES[3]).rows  # its probes fuse into the grouping
    factories, _plan = _segments(runner, QUERIES[3])
    assert any(isinstance(f.terminal_factory, hash_agg.HashAggregationOperatorFactory)
               for f in factories)
    del runner, factories, _plan
    assert live_builders() == []
