"""The port's DistributedQueryRunner against presto_tpu, on the CPU.

parse -> plan -> AddExchanges -> fragment -> per-worker drivers and the
exchanges between them, on two CPU workers (``MeshContext([cpu] * 2)``).
Rows are held against the reference's ``LocalQueryRunner`` (the
reference's own tests hold its distributed rows equal to those; an 8-way
reference run costs minutes of XLA compile): in order where the SQL orders,
exact but for DOUBLE (relative 1e-12, the partial sums' order differs).
``explain`` prints the reference ``DistributedQueryRunner.explain``'s
fragments, which it plans without executing.
"""
import math

import pytest
import torch

from presto_tpu.models.tpch_sql import QUERIES as REF_QUERIES
from presto_tpu.parallel.mesh import MeshContext as RefMesh
from presto_tpu.parallel.runner import DistributedQueryRunner as RefDistributed
from presto_tpu.runner import LocalQueryRunner as RefRunner
from presto_tpu_torch.metadata import Session
from presto_tpu_torch.models.tpch_sql import QUERIES
from presto_tpu_torch.parallel.mesh import MeshContext
from presto_tpu_torch.parallel.runner import DistributedQueryRunner

DOUBLE_REL_TOL = 1e-12
CPU2 = [torch.device("cpu")] * 2

# the tier-1 set of tests/test_distributed_sql.py, and the shapes its slow
# ladder covers (one per exchange kind and aggregation step)
SQL = {
    "group_by": "select n_regionkey, count(*), min(n_name), max(n_nationkey) "
                "from nation group by n_regionkey order by n_regionkey",
    "join": "select n_name, r_name from nation join region "
            "on n_regionkey = r_regionkey order by n_name",
    "union_values": "select n_nationkey from nation where n_regionkey = 0 "
                    "union all select 999 order by 1",
    "union_values_count": "select count(*) from (select 1 as x union all select 2) t",
    "order_by_no_limit": "select c_custkey, c_acctbal from customer "
                         "order by c_acctbal, c_custkey",
    "order_by_desc_varchar": "select c_name, c_custkey from customer "
                             "order by c_name desc, c_custkey",
    "global_agg": "select count(*), sum(o_totalprice), avg(o_totalprice) from orders",
    "distinct_agg": "select count(distinct o_custkey) from orders",
    "semi_join": "select c_name from customer where c_nationkey in "
                 "(select n_nationkey from nation where n_regionkey = 1) "
                 "order by c_name limit 20",
    "not_in": "select n_name from nation where n_regionkey not in "
              "(select r_regionkey from region where r_name like 'A%') order by n_name",
    "scalar_subquery": "select o_orderkey from orders where o_totalprice > "
                       "(select avg(o_totalprice) from orders) order by o_orderkey limit 10",
    "full_join": "select c_name, o_orderkey from "
                 "(select * from customer where c_custkey < 30) c full join "
                 "(select * from orders where o_orderkey < 7) o "
                 "on c_custkey = o_custkey order by 1, 2",
    "q1": QUERIES[1],
    "q3": QUERIES[3],
}


def assert_same_rows(got, want):
    """Same rows in the same order; exact but for DOUBLE (DOUBLE_REL_TOL)."""
    assert len(got) == len(want), (got, want)
    for r, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w), (g, w)
        for c, (a, b) in enumerate(zip(g, w)):
            if isinstance(a, float) or isinstance(b, float):
                assert type(a) is type(b) and math.isclose(a, b, rel_tol=DOUBLE_REL_TOL,
                                                           abs_tol=0.0), (r, c, a, b)
            else:
                assert type(a) is type(b) and a == b, (r, c, a, b)


@pytest.fixture(scope="module")
def ref_rows():
    """One reference LocalQueryRunner run per SQL text, shared."""
    runner = RefRunner()
    cache = {}

    def rows(sql):
        if sql not in cache:
            cache[sql] = runner.execute(sql).rows
        return cache[sql]
    return rows


@pytest.fixture(scope="module")
def dist():
    return DistributedQueryRunner(MeshContext(CPU2), device="cpu")


def test_tpch_texts_are_the_reference_texts():
    assert QUERIES[1] == REF_QUERIES[1] and QUERIES[3] == REF_QUERIES[3]


@pytest.mark.parametrize("shape", sorted(SQL))
def test_distributed_rows_equal_reference(dist, ref_rows, shape):
    res = dist.execute(SQL[shape])
    assert_same_rows(res.rows, ref_rows(SQL[shape]))
    assert res.stats["exchange"]["exchanges"] >= 1


@pytest.mark.parametrize("props", [{"streaming_exchange": False},
                                   {"hash_kernels": "pallas"},
                                   {"join_distribution_type": "PARTITIONED"}],
                         ids=["barrier", "pallas", "partitioned"])
@pytest.mark.parametrize("q", [1, 3])
def test_tpch_rows_equal_reference_under_properties(ref_rows, q, props):
    r = DistributedQueryRunner(MeshContext(CPU2), Session(catalog="tpch", schema="tiny",
                                                          properties=props), device="cpu")
    assert_same_rows(r.execute(QUERIES[q]).rows, ref_rows(QUERIES[q]))


def test_eight_workers_q3(ref_rows):
    r = DistributedQueryRunner(MeshContext([torch.device("cpu")] * 8), device="cpu")
    assert_same_rows(r.execute(QUERIES[3]).rows, ref_rows(QUERIES[3]))


@pytest.fixture(scope="module")
def ref_dist(eight_devices):
    return RefDistributed(RefMesh(eight_devices[:2]))


@pytest.mark.parametrize("shape", ["group_by", "join", "union_values", "order_by_no_limit",
                                   "global_agg", "distinct_agg", "not_in", "full_join", "q1",
                                   "q3", "q5", "q9"])
def test_explain_prints_reference_fragments(dist, ref_dist, shape):
    sql = {"q5": QUERIES[5], "q9": QUERIES[9]}.get(shape) or SQL[shape]
    assert dist.explain(sql) == ref_dist.explain(sql)


def test_cbo_broadcasts_small_builds(dist):
    """Q5's dimension builds are under the broadcast threshold: replicated,
    so the lineitem probe joins them where it scans."""
    plan = dist.explain(QUERIES[5])
    assert "output=broadcast" in plan
    lineitem_frag = next(f for f in plan.split("Fragment") if "tiny.lineitem" in f)
    assert "RemoteSource" in lineitem_frag
    part = DistributedQueryRunner(MeshContext(CPU2), Session(
        catalog="tpch", schema="tiny", properties={"join_distribution_type": "PARTITIONED"}),
        device="cpu")
    assert "output=broadcast" not in part.explain(QUERIES[5])


def test_join_builds_keep_their_uniqueness_across_exchanges():
    """A build whose rows arrive by an exchange is unique where its producer
    fragment is, so ``hash_kernels="pallas"`` takes the open-addressing
    table on every worker (two builds of Q3 on each of two workers)."""
    from presto_tpu_torch.utils.metrics import METRICS

    r = DistributedQueryRunner(MeshContext(CPU2), Session(
        catalog="tpch", schema="tiny", properties={"hash_kernels": "pallas"}), device="cpu")
    before = METRICS.counter_value("pallas.join_builds")
    r.execute(QUERIES[3])
    assert METRICS.counter_value("pallas.join_builds") - before == 4


def test_explain_analyze_rolls_up_fragments(dist):
    res = dist.execute("explain analyze " + SQL["group_by"])
    text = "\n".join(r[0] for r in res.rows)
    assert text.startswith("Query: ") and "2 workers, exchange=streaming" in text
    assert "Fragment 0 [source] output=repartition workers=2" in text
    assert "exchange [repartition]: chunks=" in text and "TableScan" in text


def test_non_queries_stay_local(dist):
    assert dist.execute("show schemas").rows == dist.local.execute("show schemas").rows
    with pytest.raises(ValueError):
        dist.plan_sql("show tables")


def test_default_mesh_needs_cuda_or_devices():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default mesh is one worker per card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MeshContext()


PLACED = {"TableScanOperatorFactory", "RemoteSourceOperatorFactory", "JoinBuildOperatorFactory",
          "HashAggregationOperatorFactory", "EnforceSingleRowOperatorFactory",
          "DictionaryRemapOperatorFactory"}


@pytest.mark.parametrize("sql", [SQL["group_by"], SQL["scalar_subquery"], QUERIES[3],
                                 "select n_name from nation union all select r_name from region"],
                         ids=["group_by", "scalar_subquery", "q3", "union_two_dictionaries"])
def test_each_worker_allocates_on_its_own_device(sql):
    """On a mesh of distinct devices, every factory that allocates, a fused
    segment's aggregation terminal among them, places worker w's operators
    on ``devices[w]``: worker 1's drivers (on ``cpu:1``, a device object
    distinct from worker 0's ``cpu``) are created with every allocating
    operator there."""
    from presto_tpu_torch.ops.fused_segment import FusedSegmentOperatorFactory
    from presto_tpu_torch.ops.hash_agg import HashAggregationOperator

    devs = [torch.device("cpu"), torch.device("cpu", 1)]
    runner = DistributedQueryRunner(MeshContext(devs), Session(catalog="tpch", schema="tiny"),
                                    device="cpu")
    sub = runner.plan_sql(sql)
    placed = set()
    for frag in sub.fragments:
        plan = runner._planner(sub, {}, None).plan(runner._fragment_root(sub, frag))
        facs = [f for chain in plan.pipelines for f in chain]
        facs += [f.terminal_factory for f in facs
                 if isinstance(f, FusedSegmentOperatorFactory) and f.terminal_factory]
        for w, dev in enumerate(devs):
            drivers = plan.create_drivers(w)
            for f in facs:
                if f.device is not None:
                    assert f.worker_device(w) == dev, (type(f).__name__, w)
                    placed.add(type(f).__name__)
            for op in (o for d in drivers for o in d.operators):
                inner = getattr(getattr(op, "_terminal", None), "op", op)
                if isinstance(inner, HashAggregationOperator):
                    assert inner.builder._device == dev
    assert placed <= PLACED and "TableScanOperatorFactory" in placed
