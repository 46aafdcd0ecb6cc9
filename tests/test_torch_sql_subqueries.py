"""TPC-H Q11, Q15, Q21 and Q22 through the port's SQL runner against
presto_tpu's, on the CPU.

These queries need scalar subqueries (Q11, Q15 and Q22: an
``EnforceSingleRow`` build joined on a constant key), ``max`` (Q15), the
filtered semi and anti probe (Q21's EXISTS / NOT EXISTS with a non-equi
conjunct) and ``substr`` over a virtual dictionary (Q22). Each runs at
``tiny`` under ``hash_kernels`` ``sorted`` and ``pallas``, on the session
defaults and unfused, and the rows, fused segments and ``pallas.`` counter
deltas must equal the reference's under the same properties. Q21 and Q22
also run at a page capacity of 1,024, so that the semi probe's chunk loop
and the cross join's probe cross many pages, and all four with 4 drivers
per cut pipeline, so that the one-row build is published by the last of
its build drivers and probed from several producer threads.
"""
import pytest

from presto_tpu_torch.utils.metrics import METRICS
from test_torch_sql import assert_same_rows
from test_torch_sql_tpch_exprs import PROPS, reference_cache, run_port

SUBQUERY_QUERIES = (11, 15, 21, 22)
# builds on the open-addressing table under pallas: a cross join's build is
# sorted, so Q22 has none; Q15's one-row max build is one of its two
PALLAS_BUILDS = {11: 4, 15: 2, 21: 3, 22: 0}


@pytest.fixture(scope="module")
def reference():
    return reference_cache()


@pytest.mark.parametrize("props", sorted(PROPS))
@pytest.mark.parametrize("hash_kernels", ["sorted", "pallas"])
@pytest.mark.parametrize("q", SUBQUERY_QUERIES)
def test_rows_segments_and_counters_match_reference(reference, q, hash_kernels, props):
    p = {"hash_kernels": hash_kernels, **PROPS[props]}
    want_rows, want_seg, want_delta = reference(q, p)
    rows, seg, delta = run_port(q, p)
    assert rows, "the query returned no rows"
    assert_same_rows(rows, want_rows)
    assert seg == want_seg
    assert delta == want_delta
    builds = PALLAS_BUILDS[q] if hash_kernels == "pallas" else 0
    assert delta["pallas.join_builds"] == builds and delta["pallas.join_fallbacks"] == 0


@pytest.mark.parametrize("props", sorted(PROPS))
@pytest.mark.parametrize("q", [21, 22])
def test_small_pages_match_reference(reference, q, props):
    """At 1,024 rows per page Q21's two filtered probes (EXISTS and NOT
    EXISTS) run over many pages, one chunk of candidate pairs per page that
    has any; Q22's unfiltered NOT EXISTS takes the exact-key probe."""
    p = {"hash_kernels": "pallas", "page_capacity": 1024, **PROPS[props]}
    want_rows, want_seg, want_delta = reference(q, p)
    chunks = METRICS.counter_value("join.semi_chunks")
    pages = METRICS.counter_value("join.semi_pages")
    rows, seg, delta = run_port(q, p)
    chunks = METRICS.counter_value("join.semi_chunks") - chunks
    pages = METRICS.counter_value("join.semi_pages") - pages
    assert_same_rows(rows, want_rows)
    assert seg == want_seg and delta == want_delta
    if q == 21:
        assert pages > 8 and 0 < chunks <= pages
    else:
        assert chunks == pages == 0


@pytest.mark.parametrize("q", SUBQUERY_QUERIES)
def test_four_drivers_match_reference(reference, q):
    """4 drivers per cut pipeline on the port, the reference's defaults:
    the rows do not depend on the driver count."""
    want_rows = reference(q, {"hash_kernels": "pallas"})[0]
    rows, _, _ = run_port(q, {"hash_kernels": "pallas", "driver_parallelism": 4})
    assert_same_rows(rows, want_rows)

