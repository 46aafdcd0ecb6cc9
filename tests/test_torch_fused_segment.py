"""The port's default execution path (fused segments, coalesced pages)
against presto_tpu's, on the CPU, through the SQL runners.

Both runners run TPC-H at schema ``tiny`` under their session defaults,
the reference with ``scan_pipeline=False`` (the port has no streaming scan
yet, so both scans pass the source pages through). Per query: the same rows
(exact, but DOUBLE to 1e-12 relative, as ``test_torch_sql.py``), the same
fused segments (operators, dispatches and pipeline of each), the same fusion
decisions with their reasons, and the same ``pallas.`` counter deltas. The
compositions a segment made are not compared: both packages cache them
process-wide, so the count depends on what ran before.
"""
import pytest

from presto_tpu.metadata import Session as RefSession
from presto_tpu.models.tpch_sql import QUERIES as REF_QUERIES
from presto_tpu.runner import LocalQueryRunner as RefRunner
from presto_tpu.utils.metrics import METRICS as REF_METRICS
from presto_tpu_torch.metadata import Session
from presto_tpu_torch.models.tpch_sql import QUERIES
from presto_tpu_torch.runner import LocalQueryRunner
from presto_tpu_torch.utils.metrics import METRICS
from test_torch_sql import COUNTERS, UNFUSED, assert_same_rows

DEFAULT_QUERIES = (1, 3, 5, 6, 7, 9, 10, 13, 19)
# the queries of CASE, division, min/max, scalar subqueries and filtered
# semi joins: held here under pallas only (both kernel settings, and the
# unfused path, in test_torch_sql_tpch_exprs.py and test_torch_sql_subqueries.py)
NEW_QUERIES = (2, 8, 11, 12, 14, 15, 17, 21, 22)
J = "LookupJoin(inner)"
# segments as the reference plans them at tiny: (operators, dispatches) each
SEGMENTS = {
    1: [], 6: [],
    3: [(["LookupJoin(inner)", "LookupJoin(inner)", "FilterProject",
          "HashAggregation(single)"], 4)],
    5: [(["LookupJoin(inner)"] * 3, 8), (["FilterProject", "HashAggregation(single)"], 116)],
    9: [(["LookupJoin(inner)"] * 3, 8),
        (["LookupJoin(inner)", "FilterProject", "HashAggregation(single)"], 8)],
    13: [(["FilterProject", "HashAggregation(single)"], 1)],
    2: [([J, J, J, "HashAggregation(single)"], 8), (["FilterProject", J], 1),
        ([J, J, J, "TopN"], 1)],
    8: [([J] * 7 + ["FilterProject", "HashAggregation(single)"], 8)],
    11: [([J, J, "FilterProject", "HashAggregation(single)"], 8),
         ([J, J, "FilterProject", "HashAggregation(single)"], 8),
         (["FilterProject", J, "FilterProject"], 1)],
    12: [([J, "FilterProject", "HashAggregation(single)"], 1)],
    14: [([J, "FilterProject", "HashAggregation(single)"], 1)],
    # the scalar subquery's max, then the join on its one-row build
    15: [(["FilterProject", "HashAggregation(single)"], 1), ([J, J, "FilterProject"], 1)],
    17: [([J, J, "FilterProject", "HashAggregation(single)"], 8)],
    # the filtered EXISTS / NOT EXISTS probes are never page-local
    21: [([J, J, J], 8), (["FilterProject", "HashAggregation(single)"], 8)],
    # the cross join's probe on the one-row build fuses; so does the NOT EXISTS
    22: [(["FilterProject", J, "FilterProject", "LookupJoin(anti)", "FilterProject",
           "HashAggregation(single)"], 8)],
}


def ref_run(sql: str, props: dict):
    """(rows, segment stats, pallas counter deltas) of the reference."""
    before = {k: REF_METRICS.counter_value(k) for k in COUNTERS}
    res = RefRunner(RefSession(catalog="tpch", schema="tiny",
                               properties={"scan_pipeline": False, **props})).execute(sql)
    delta = {k: REF_METRICS.counter_value(k) - before[k] for k in COUNTERS}
    return res.rows, (res.stats or {}).get("segments"), delta


def port_run(sql: str, props: dict):
    """(rows, segment stats, pallas counter deltas) of the port on the CPU."""
    before = {k: METRICS.counter_value(k) for k in COUNTERS}
    res = LocalQueryRunner(Session(catalog="tpch", schema="tiny", properties=dict(props)),
                           device="cpu").execute(sql)
    delta = {k: METRICS.counter_value(k) - before[k] for k in COUNTERS}
    return res.rows, (res.stats or {}).get("segments"), delta


def segment_view(stats):
    """What both packages must agree on: each segment's operators,
    dispatches and pipeline, and the decisions."""
    if stats is None:
        return None
    return ([(s["operators"], s["dispatches"], s["pipeline"]) for s in stats["segments"]],
            stats["decisions"], stats["count"], stats["dispatches"])


def test_session_defaults_match_reference():
    for prop in ("segment_fusion", "coalesce_pages"):
        assert Session().get(prop) is True
        assert RefSession().get(prop) is True


@pytest.mark.parametrize("q,hash_kernels",
                         [(q, hk) for q in DEFAULT_QUERIES for hk in ("sorted", "pallas")]
                         + [(q, "pallas") for q in NEW_QUERIES])
def test_default_path_matches_reference(q, hash_kernels):
    props = {"hash_kernels": hash_kernels}
    want_rows, want_seg, want_delta = ref_run(REF_QUERIES[q], props)
    rows, seg, delta = port_run(QUERIES[q], props)
    assert rows
    assert_same_rows(rows, want_rows)
    assert segment_view(seg) == segment_view(want_seg)
    assert delta == want_delta
    if q in SEGMENTS:
        assert [(s["operators"], s["dispatches"]) for s in seg["segments"]] == SEGMENTS[q]
    if q in (1, 6):  # each aggregation is a run of one operator
        assert seg["count"] == 0 and all(not d["fused"] for d in seg["decisions"])


@pytest.mark.parametrize("q", DEFAULT_QUERIES)
def test_fused_equals_unfused_in_the_port(q):
    props = {"hash_kernels": "pallas"}
    fused, seg, _ = port_run(QUERIES[q], props)
    unfused, none, _ = port_run(QUERIES[q], {**props, **UNFUSED})
    assert none is None
    assert_same_rows(fused, unfused)


@pytest.mark.parametrize("q,fused_pages,unfused_pages", [(3, 0, 7), (9, 0, 7), (13, 63, 63)])
def test_fused_grouping_leaves_the_insert(q, fused_pages, unfused_pages):
    """A fused grouping computes the sort partial: Q3's and Q9's groupings
    send no page through the insert under the defaults (7 unfused). Q13's
    insert-grouped aggregation sits after an expanding join, a barrier, so
    it stays unfused both ways."""
    props = {"hash_kernels": "pallas"}
    _, _, fused = port_run(QUERIES[q], props)
    _, _, unfused = port_run(QUERIES[q], {**props, **UNFUSED})
    assert fused["pallas.agg_pages"] == fused_pages
    assert unfused["pallas.agg_pages"] == unfused_pages
    assert fused["pallas.join_builds"] == unfused["pallas.join_builds"]
