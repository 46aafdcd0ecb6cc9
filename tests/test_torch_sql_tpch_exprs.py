"""TPC-H Q2, Q8, Q12, Q14 and Q17 through the port's SQL runner against
presto_tpu's, on the CPU.

These queries need what the expression compiler and the aggregates gained
for them: searched CASE (Q8, Q12, Q14), ``divide`` on DECIMAL operands
(Q8, Q14, Q17), DOUBLE arithmetic (Q17's ``0.2 * avg``) and ``min`` (Q2).
Each runs at ``tiny`` under ``hash_kernels`` ``sorted`` and ``pallas``,
on the session defaults and unfused, in both packages with the same
properties. Per run: the same rows (exact, DOUBLE to 1e-12 relative, as
``test_torch_sql.assert_same_rows``), the same fused segments and the same
``pallas.`` counter deltas. The reference runs once per (query,
properties) pair and module.
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

EXPR_QUERIES = (2, 8, 12, 14, 17)
PROPS = {"defaults": {}, "unfused": UNFUSED}
# builds on the open-addressing table under pallas (the reference's count)
PALLAS_BUILDS = {2: 7, 8: 7, 12: 1, 14: 1, 17: 2}


def segment_view(stats):
    """Each fused segment's operators, dispatches and pipeline, and the
    fusion decisions; None for an unfused run."""
    if stats is None:
        return None
    return ([(s["operators"], s["dispatches"], s["pipeline"]) for s in stats["segments"]],
            stats["decisions"], stats["count"], stats["dispatches"])


def _run(runner_cls, session_cls, metrics, sql: str, props: dict, **kw):
    before = {k: metrics.counter_value(k) for k in COUNTERS}
    res = runner_cls(session_cls(catalog="tpch", schema="tiny", properties=dict(props)),
                     **kw).execute(sql)
    delta = {k: metrics.counter_value(k) - before[k] for k in COUNTERS}
    return res.rows, segment_view((res.stats or {}).get("segments")), delta


def run_reference(q: int, props: dict):
    """(rows, segments, pallas counter deltas) of presto_tpu."""
    return _run(RefRunner, RefSession, REF_METRICS, REF_QUERIES[q], props)


def run_port(q: int, props: dict):
    """(rows, segments, pallas counter deltas) of the port on the CPU."""
    return _run(LocalQueryRunner, Session, METRICS, QUERIES[q], props, device="cpu")


def reference_cache():
    """A getter of the reference's run per (query, properties), made once."""
    cache = {}

    def get(q: int, props: dict):
        key = (q, tuple(sorted(props.items())))
        if key not in cache:
            cache[key] = run_reference(q, props)
        return cache[key]
    return get


@pytest.fixture(scope="module")
def reference():
    return reference_cache()


@pytest.mark.parametrize("props", sorted(PROPS))
@pytest.mark.parametrize("hash_kernels", ["sorted", "pallas"])
@pytest.mark.parametrize("q", EXPR_QUERIES)
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


def test_q14_promo_share_is_a_case_over_a_decimal_division(reference):
    """Q14 is 100 * sum(CASE ...) / sum(...): one DOUBLE row, strictly
    between 0 and 100, from the CASE's and the division's own path."""
    rows, _, _ = run_port(14, {"hash_kernels": "pallas"})
    assert len(rows) == 1 and isinstance(rows[0][0], float) and 0.0 < rows[0][0] < 100.0
    assert_same_rows(rows, reference(14, {"hash_kernels": "pallas"})[0])
