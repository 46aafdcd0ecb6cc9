"""The port's TPC-DS catalog and the 22 TPC-DS queries of
``presto_tpu/models/tpcds_sql.py`` against presto_tpu's, on the CPU.

- The connector: every table's pages at ``tiny``, split by split and page
  by page (dtypes, masks, values, dictionaries), its metadata, unique
  column sets and statistics, and ``show tables``.
- The plans: ``explain()`` text for the 22 queries, and the pipeline cuts,
  driver counts and fusion decisions at 4 drivers.
- DATE ± integer days: the expression on its own against the reference's
  ``_compile_arithmetic``, and ``date + interval 'n' day`` through SQL.
- The rows of the 22 queries on the session defaults (fused segments,
  coalesced pages, the staged scan), under ``pallas`` with the fused
  segments and ``pallas.`` counter deltas equal to the reference's, and
  under ``sorted`` with no table built. The unfused runs are in
  ``test_torch_tpcds_unfused.py``. DOUBLE is compared to 1e-12 relative
  (``test_torch_sql.assert_same_rows``); Q50 returns no rows in both
  packages and proves nothing beyond that.

The reference runs once per (query, properties) pair and module.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from presto_tpu import block as jblock
from presto_tpu import types as jt
from presto_tpu.connectors.tpcds import TpcdsConnector as RefConnector
from presto_tpu.exec.local_planner import LocalExecutionPlanner as RefPlanner
from presto_tpu.metadata import Session as RefSession
from presto_tpu.models.tpcds_sql import QUERIES as REF_QUERIES
from presto_tpu.ops import expressions as jx
from presto_tpu.ops.filter_project import PageProcessor as JPageProcessor
from presto_tpu.runner import LocalQueryRunner as RefRunner
from presto_tpu.spi.connector import Constraint as RefConstraint
from presto_tpu.spi.connector import SchemaTableName as RefName
from presto_tpu.utils.metrics import METRICS as REF_METRICS
from presto_tpu_torch import block as tblock
from presto_tpu_torch import types as tt
from presto_tpu_torch.block import torch_dtype
from presto_tpu_torch.connectors.tpcds import TpcdsConnector
from presto_tpu_torch.connectors.tpcds import generator as tg
from presto_tpu_torch.exec.local_planner import LocalExecutionPlanner
from presto_tpu_torch.metadata import Session
from presto_tpu_torch.models.tpcds_sql import QUERIES
from presto_tpu_torch.ops import expressions as tx
from presto_tpu_torch.ops.filter_project import PageProcessor as TPageProcessor
from presto_tpu_torch.runner import LocalQueryRunner
from presto_tpu_torch.spi.connector import Constraint, SchemaTableName
from presto_tpu_torch.utils.metrics import METRICS
from test_torch_sql import COUNTERS, UNFUSED, assert_same_rows
from test_torch_sql_tpch_exprs import segment_view

DS_QUERIES = sorted(QUERIES)
TABLES = list(tg.TPCDS_TABLES)
# the defaults (fused) here; the unfused oracle in test_torch_tpcds_unfused.py
PROPS = {"fused": {}, "unfused": UNFUSED}
NO_ROWS = {50}  # its predicates match nothing at tiny, in both packages


def _run(runner_cls, session_cls, metrics, sql: str, props: dict, **kw):
    before = {k: metrics.counter_value(k) for k in COUNTERS}
    res = runner_cls(session_cls(catalog="tpcds", schema="tiny", properties=dict(props)),
                     **kw).execute(sql)
    delta = {k: metrics.counter_value(k) - before[k] for k in COUNTERS}
    return res.rows, segment_view((res.stats or {}).get("segments")), delta


def run_reference(q: int, props: dict):
    return _run(RefRunner, RefSession, REF_METRICS, REF_QUERIES[q], props)


def run_port(q: int, props: dict):
    return _run(LocalQueryRunner, Session, METRICS, QUERIES[q], props, device="cpu")


def reference_cache():
    cache = {}

    def get(q: int, props: dict):
        key = (q, tuple(sorted(props.items())))
        if key not in cache:
            cache[key] = run_reference(q, props)
        return cache[key]
    return get


def check_query(reference, q: int, fusion: str, hash_kernels: str):
    """The port's rows equal the reference's under ``pallas`` with the same
    fusion; under ``pallas`` its segments and counter deltas equal the
    reference's too, under ``sorted`` nothing is built on the table."""
    want_rows, want_seg, want_delta = reference(q, {"hash_kernels": "pallas", **PROPS[fusion]})
    rows, seg, delta = run_port(q, {"hash_kernels": hash_kernels, **PROPS[fusion]})
    assert rows or q in NO_ROWS, "the query returned no rows"
    assert_same_rows(rows, want_rows)
    if hash_kernels == "pallas":
        assert seg == want_seg
        assert delta == want_delta
    else:
        assert all(v == 0 for k, v in delta.items() if k.startswith("pallas."))
    assert delta["pallas.join_fallbacks"] == 0


@pytest.fixture(scope="module")
def reference():
    return reference_cache()


def test_query_texts_are_the_reference_texts():
    assert QUERIES == REF_QUERIES and len(QUERIES) == 22


# ------------------------------------------------------------ connector

def _connectors():
    return RefConnector("tpcds"), TpcdsConnector("tpcds")


def test_metadata_matches_reference():
    ref, port = _connectors()
    assert ref.metadata().list_schemas() == port.metadata().list_schemas()
    assert [str(n) for n in ref.metadata().list_tables("tiny")] == \
        [str(n) for n in port.metadata().list_tables("tiny")]
    for table in TABLES:
        rh = ref.metadata().get_table_handle(RefName("tiny", table))
        ph = port.metadata().get_table_handle(SchemaTableName("tiny", table))
        rm, pm = ref.metadata().get_table_metadata(rh), port.metadata().get_table_metadata(ph)
        assert [(c.name, c.type.display_name()) for c in rm.columns] == \
            [(c.name, c.type.display_name()) for c in pm.columns]
        assert ref.metadata().get_unique_column_sets(rh) == \
            port.metadata().get_unique_column_sets(ph)
        rs = ref.metadata().get_table_statistics(rh, RefConstraint.all())
        ps = port.metadata().get_table_statistics(ph, Constraint.all())
        assert rs.row_count == ps.row_count
        assert {k: (v.null_fraction, v.distinct_count) for k, v in rs.columns.items()} == \
            {k: (v.null_fraction, v.distinct_count) for k, v in ps.columns.items()}


def _assert_dictionaries_match(want, got, codes):
    assert (want is None) == (got is None)
    if want is None:
        return
    assert type(got).__name__ == type(want).__name__
    if hasattr(want, "values"):
        assert list(got.values) == list(want.values)
    else:
        assert list(got.lookup(codes)) == list(want.lookup(codes))


@pytest.mark.parametrize("capacity", [4096, 1 << 20])
@pytest.mark.parametrize("table", TABLES)
def test_pages_match_reference(table, capacity):
    ref, port = _connectors()
    rh = ref.metadata().get_table_handle(RefName("tiny", table))
    ph = port.metadata().get_table_handle(SchemaTableName("tiny", table))
    rcols = list(ref.metadata().get_column_handles(rh).values())
    pcols = list(port.metadata().get_column_handles(ph).values())
    rsplits = ref.split_manager().get_splits(rh, RefConstraint.all(), 8)
    psplits = port.split_manager().get_splits(ph, Constraint.all(), 8)
    assert [s.payload for s in rsplits] == [s.payload for s in psplits]
    n_pages = 0
    for rs, ps in zip(rsplits, psplits):
        rsrc = ref.page_source_provider().create_page_source(rs, rcols, capacity)
        psrc = port.page_source_provider().create_page_source(ps, pcols, capacity)
        assert getattr(psrc, "cache_token", None) is None  # regenerated on every scan
        rpages, ppages = list(rsrc), list(psrc)
        assert len(rpages) == len(ppages)
        for rp, pp in zip(rpages, ppages):
            assert pp.mask.dtype == torch.bool and pp.mask.device.type == "cpu"
            np.testing.assert_array_equal(pp.mask.numpy(), np.asarray(rp.mask))
            for rb, pb in zip(rp.blocks, pp.blocks):
                assert pb.type.display_name() == rb.type.display_name()
                assert pb.data.dtype == torch_dtype(pb.type)
                assert pb.data.numpy().dtype == np.asarray(rb.data).dtype
                np.testing.assert_array_equal(pb.data.numpy(), np.asarray(rb.data))
                assert pb.nulls is None and rb.nulls is None
                _assert_dictionaries_match(rb.dictionary, pb.dictionary,
                                           np.unique(pb.data.numpy()[pp.mask.numpy()]))
            n_pages += 1
    assert n_pages >= len(rsplits)


def test_show_tables_matches_reference():
    sql = "show tables from tpcds.tiny"
    want = RefRunner(RefSession(catalog="tpch", schema="tiny")).execute(sql).rows
    got = LocalQueryRunner(Session(catalog="tpch", schema="tiny"), device="cpu").execute(sql).rows
    assert got == want and sorted(r[0] for r in got) == sorted(TABLES)


# ---------------------------------------------------------------- plans

@pytest.mark.parametrize("q", DS_QUERIES)
def test_explain_matches_reference(q):
    ref = RefRunner(RefSession(catalog="tpcds", schema="tiny"))
    port = LocalQueryRunner(Session(catalog="tpcds", schema="tiny"), device="cpu")
    assert port.explain(QUERIES[q]) == ref.explain(REF_QUERIES[q])


def _plan_view(pipelines):
    return [([f.name for f in p], getattr(p[0], "parallel_drivers", 1)) for p in pipelines]


@pytest.mark.parametrize("q", DS_QUERIES)
def test_pipeline_cuts_match_reference(q):
    props = {"driver_parallelism": 4, "hash_kernels": "pallas"}
    rr = RefRunner(RefSession(catalog="tpcds", schema="tiny", properties=props))
    want = RefPlanner(rr.metadata, rr.session).plan(rr.plan_sql(REF_QUERIES[q]))
    pr = LocalQueryRunner(Session(catalog="tpcds", schema="tiny", properties=props),
                          device="cpu")
    got = LocalExecutionPlanner(pr.metadata, pr.session, "cpu").plan(pr.plan_sql(QUERIES[q]))
    assert _plan_view(got.pipelines) == _plan_view(want.pipelines)
    assert got.segment_decisions == want.segment_decisions


# --------------------------------------------------------- date ± days

def test_date_plus_minus_days_matches_reference_expression():
    """DATE ± BIGINT and ± INTEGER days, NULLs on both sides, through each
    package's PageProcessor over the same seeded page."""
    rng = np.random.RandomState(5)
    cap = 256
    days = rng.randint(-20_000, 20_000, cap).astype(np.int32)
    dn = rng.rand(cap) < 0.2
    n64 = rng.randint(-400, 400, cap).astype(np.int64)
    nn = rng.rand(cap) < 0.2
    n32 = rng.randint(-40, 40, cap).astype(np.int32)
    mask = rng.rand(cap) < 0.9

    def exprs(x, types):
        d = x.input_ref(0, types.DATE)
        b = x.input_ref(1, types.BIGINT)
        i = x.input_ref(2, types.INTEGER)
        D, BI = types.DATE, types.BIGINT
        return [x.call("add", D, d, x.constant(5, BI)), x.call("subtract", D, d, x.constant(3, BI)),
                x.call("add", D, d, b), x.call("subtract", D, d, i), x.call("add", D, i, d)]

    jpage = jblock.Page((jblock.Block(jt.DATE, jnp.asarray(days), jnp.asarray(dn)),
                         jblock.Block(jt.BIGINT, jnp.asarray(n64), jnp.asarray(nn)),
                         jblock.Block(jt.INTEGER, jnp.asarray(n32), None)), jnp.asarray(mask))
    tpage = tblock.Page((tblock.Block(tt.DATE, torch.from_numpy(days), torch.from_numpy(dn)),
                         tblock.Block(tt.BIGINT, torch.from_numpy(n64), torch.from_numpy(nn)),
                         tblock.Block(tt.INTEGER, torch.from_numpy(n32), None)),
                        torch.from_numpy(mask))
    want = JPageProcessor(jx.InputLayout([jt.DATE, jt.BIGINT, jt.INTEGER], [None] * 3), None,
                          exprs(jx, jt))(jpage)
    got = TPageProcessor(tx.InputLayout([tt.DATE, tt.BIGINT, tt.INTEGER], [None] * 3), None,
                         exprs(tx, tt))(tpage)
    for w, g in zip(want.blocks, got.blocks):
        assert g.type is tt.DATE and g.data.dtype == torch.int32
        wn = np.asarray(w.nulls)[mask] if w.nulls is not None else np.zeros(mask.sum(), bool)
        gn = g.nulls.numpy()[mask] if g.nulls is not None else np.zeros(mask.sum(), bool)
        np.testing.assert_array_equal(gn, wn)
        np.testing.assert_array_equal(g.data.numpy()[mask][~gn],
                                      np.asarray(w.data)[mask][~wn])


def test_date_interval_through_sql_matches_reference():
    sql = ("select d_date_sk, d_date + interval '5' day, d_date - interval '31' day, "
           "d_date + 2 from date_dim where d_date + interval '5' day < date '1998-02-01' "
           "order by 1")
    want = RefRunner(RefSession(catalog="tpcds", schema="tiny")).execute(sql).rows
    got = LocalQueryRunner(Session(catalog="tpcds", schema="tiny"), device="cpu") \
        .execute(sql).rows
    assert len(got) == 26
    assert_same_rows(got, want)


# ----------------------------------------------------------------- rows

@pytest.mark.parametrize("hash_kernels", ["pallas", "sorted"])
@pytest.mark.parametrize("q", DS_QUERIES)
def test_rows_segments_and_counters_match_reference(reference, q, hash_kernels):
    check_query(reference, q, "fused", hash_kernels)
