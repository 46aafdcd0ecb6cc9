"""Multi-key and duplicate-key joins and LIKE through the port's SQL runner,
against presto_tpu's, on the CPU: TPC-H Q5, Q9 and Q13 at schema ``tiny``.

Q5 joins on two keys against a unique ``orders`` build and expands a
duplicate-key ``customer`` build; Q9 joins on two keys against ``partsupp``
and filters ``part`` with LIKE over packed words; Q13 is a duplicate-key
LEFT join whose build is filtered with NOT LIKE. Rows are compared exactly
(these queries have no DOUBLE column; one would be compared to 1e-12
relative, as in ``test_torch_sql.py``).
"""
import datetime

import pytest

from presto_tpu.utils.testing import SqliteOracle, assert_rows_equal
from presto_tpu_torch.models.tpch_sql import QUERIES
from presto_tpu_torch.utils.metrics import METRICS
from presto_tpu.utils.metrics import METRICS as REF_METRICS
from test_sql_e2e import to_sqlite
from test_torch_sql import (COUNTERS, HASH_KERNELS, UNFUSED, _port_rows, _ref_rows,
                            assert_same_rows)

JOIN_QUERIES = (5, 9, 13)
# join builds on the open-addressing table under hash_kernels="pallas": the
# unique single-key builds (the multi-key and duplicate-key ones stay sorted)
PALLAS_JOIN_BUILDS = {5: 3, 9: 4, 13: 0}
ROWS = {5: 5, 9: 168, 13: 25}


@pytest.mark.parametrize("ref_props", [{}, UNFUSED], ids=["ref_default", "ref_unfused"])
@pytest.mark.parametrize("hash_kernels", HASH_KERNELS)
@pytest.mark.parametrize("q", JOIN_QUERIES)
def test_join_queries_match_reference(q, hash_kernels, ref_props):
    props = {"hash_kernels": hash_kernels}
    want = _ref_rows(q, {**props, **ref_props})
    got = _port_rows(q, props)
    assert len(got) == ROWS[q]
    assert_same_rows(got, want)


@pytest.mark.parametrize("hash_kernels", HASH_KERNELS)
@pytest.mark.parametrize("q", JOIN_QUERIES)
def test_join_query_counters_match_reference(q, hash_kernels):
    """The ``pallas.`` counter deltas equal the reference's on the settings
    the port runs (passthrough scan, unfused); the expansions ran."""
    props = {"hash_kernels": hash_kernels, "scan_pipeline": False, **UNFUSED}
    ref_before = {k: REF_METRICS.counter_value(k) for k in COUNTERS}
    want_rows = _ref_rows(q, props)
    ref_delta = {k: REF_METRICS.counter_value(k) - ref_before[k] for k in COUNTERS}
    names = COUNTERS + ("join.expansion_chunks", "join.expanded_rows")
    before = {k: METRICS.counter_value(k) for k in names}
    got_rows = _port_rows(q, props)
    delta = {k: METRICS.counter_value(k) - before[k] for k in names}
    assert_same_rows(got_rows, want_rows)
    assert {k: delta[k] for k in COUNTERS} == ref_delta
    if q in (5, 13):  # the duplicate-key builds expanded
        assert delta["join.expanded_rows"] > 0 and delta["join.expansion_chunks"] > 0
    if hash_kernels == "pallas":
        assert delta["pallas.join_builds"] == PALLAS_JOIN_BUILDS[q]
        assert delta["pallas.join_fallbacks"] == 0
        if q == 9:
            assert delta["pallas.agg_pages"] == 7
        if q == 5:  # its grouping by n_name is direct
            assert delta["pallas.agg_pages"] == 0


@pytest.fixture(scope="module")
def oracle():
    o = SqliteOracle()
    o.load_tpch(0.01, ["customer", "orders", "lineitem", "supplier", "nation", "region",
                       "part", "partsupp"])
    return o


@pytest.mark.parametrize("q", JOIN_QUERIES)
def test_join_query_rows_match_sqlite_oracle(oracle, q):
    got = _port_rows(q, {"hash_kernels": "pallas"})
    epoch = datetime.date(1970, 1, 1)
    norm = [[(v - epoch).days if isinstance(v, datetime.date) else v for v in r] for r in got]
    want = oracle.query(to_sqlite(QUERIES[q]))
    assert len(want) == ROWS[q]
    assert_rows_equal(norm, want, ordered=True)
