"""The port's streaming exchange (parallel/streaming_exchange.py), on the CPU.

Held as ``tests/test_streaming_exchange.py`` holds the reference's: the
streaming runner against its barrier runner (``streaming_exchange=False``,
the differential oracle) on every exchange kind, the overflow carry-over
under total key skew, skew-aware spreading of a hot key (and its off
switch, and its refusal where the join's consumer needs co-partitioning),
producer backpressure, close while blocked, a poisoned consumer, a LIMIT
that abandons its stream, and the stats plumbing. The workers are CPU
workers: two for the differentials, four where skew needs a peer's slice
smaller than a chunk. Last, Q3's delivered rows per partition equal one
reference run's on its 2-device mesh.
"""
import threading
import time

import pytest
import torch

from presto_tpu.metadata import Session as RefSession
from presto_tpu.models.tpch_sql import QUERIES as REF_QUERIES
from presto_tpu.parallel.mesh import MeshContext as RefMesh
from presto_tpu.parallel.runner import DistributedQueryRunner as RefDistributed
from presto_tpu_torch.block import Block, Page
from presto_tpu_torch.metadata import Session
from presto_tpu_torch.ops.local_exchange import LocalExchangeBuffer
from presto_tpu_torch.parallel.mesh import MeshContext
from presto_tpu_torch.parallel.runner import DistributedQueryRunner
from presto_tpu_torch.parallel.streaming_exchange import ExchangeStatsBook, StreamingExchange
from presto_tpu_torch.sql.planner.plan import GATHER
from presto_tpu_torch.types import BIGINT
from test_torch_distributed_sql import assert_same_rows

DEADLINE_S = 20.0


def _mesh(n):
    return MeshContext([torch.device("cpu")] * n)


def _session(**props):
    return Session(catalog="tpch", schema="tiny", properties=props)


def _runner(n=2, **props):
    return DistributedQueryRunner(_mesh(n), _session(**props), device="cpu")


@pytest.fixture(scope="module")
def streaming():
    return _runner()


@pytest.fixture(scope="module")
def barrier():
    return _runner(streaming_exchange=False)


def check(s_runner, b_runner, sql):
    s = s_runner.execute(sql)
    b = b_runner.execute(sql)
    assert_same_rows(s.rows, b.rows)
    assert s.stats["exchange"]["mode"] == "streaming"
    assert b.stats["exchange"]["mode"] == "barrier"
    return s


# ------------------------------------------------------------- differential

DIFFERENTIAL = {
    "repartition_group_by": "select o_custkey % 7, count(*), sum(o_totalprice) "
                            "from orders group by 1 order by 1",
    "gather_global_agg": "select count(*), sum(o_totalprice), min(o_orderdate) from orders",
    "broadcast_join": "select n_name, r_name from nation join region "
                      "on n_regionkey = r_regionkey order by n_name",
    "merge_global_order": "select c_custkey, c_acctbal from customer "
                          "order by c_acctbal, c_custkey",
    "merge_desc_dict_encoded": "select c_name, c_custkey from customer "
                               "order by c_name desc, c_custkey",
    "dict_encoded_agg_outputs": "select n_regionkey, min(n_name), max(n_name) from nation "
                                "group by n_regionkey order by n_regionkey",
}


@pytest.mark.parametrize("shape", sorted(DIFFERENTIAL))
def test_streaming_equals_barrier(streaming, barrier, shape):
    s = check(streaming, barrier, DIFFERENTIAL[shape])
    assert s.stats["exchange"]["chunks"] >= 1 and s.stats["exchange"]["exchanges"] >= 1


def test_join_repartitioned():
    check(_runner(join_distribution_type="PARTITIONED"),
          _runner(join_distribution_type="PARTITIONED", streaming_exchange=False),
          "select c_name, o_orderkey from customer join orders "
          "on c_custkey = o_custkey order by o_orderkey limit 50")


def test_small_chunks_match(barrier):
    r = check(_runner(exchange_chunk_rows=128), barrier,
              "select o_orderpriority, count(*) from orders group by o_orderpriority order by 1")
    assert r.stats["exchange"]["chunks"] > 1


# ---------------------------------------------------- skew / carry-over

def test_skew_carryover():
    """Every probe row keys to one partition: each 512-row chunk overflows
    its peer slice, and the overflow carries into later dispatches."""
    sql = ("select count(*) from (select o_custkey * 0 as k from orders) o "
           "join (select r_regionkey * 0 as k from region where r_regionkey = 0) r "
           "on o.k = r.k")
    s = _runner(8, exchange_chunk_rows=512, skew_aware_exchange=False,
                join_distribution_type="PARTITIONED").execute(sql)
    b = _runner(8, streaming_exchange=False, join_distribution_type="PARTITIONED").execute(sql)
    assert_same_rows(s.rows, b.rows)
    assert s.stats["exchange"]["carry_rows"] > 0


SKEWED_JOIN = (
    "select count(*), sum(o.k) from "
    "(select case when o_orderkey % 100 = 0 then o_custkey else 7 end as k from orders) o "
    "join (select c_custkey as k from customer) c on o.k = c.k")


def _skewed(**props):
    return _runner(4, exchange_chunk_rows=512, join_distribution_type="PARTITIONED", **props)


def test_skew_spreads_hot_key():
    oracle = _skewed(skew_aware_exchange=False).execute(SKEWED_JOIN)
    skewed = _skewed().execute(SKEWED_JOIN)
    assert_same_rows(skewed.rows, oracle.rows)
    per_ex = {e.get("skew_role"): e for e in skewed.stats["exchange"]["per_exchange"]}
    probe, build = per_ex.get("probe"), per_ex.get("build")
    assert probe is not None and build is not None, per_ex.keys()
    assert probe["hot_keys"] >= 1
    parts = probe["partition_rows"]
    assert sum(p > 0 for p in parts) >= 2 and max(parts) < 0.6 * sum(parts), parts
    assert build["replicated_rows"] > 0
    op = {e["fragment"]: e for e in oracle.stats["exchange"]["per_exchange"]}
    oparts = op[probe["fragment"]]["partition_rows"]
    assert max(oparts) > 0.9 * sum(oparts), oparts


def test_skew_build_side_hot():
    sql = ("select count(*) from (select o_custkey as k from orders where o_custkey <= 50) o "
           "join (select case when c_custkey % 50 = 0 then c_custkey else 13 end as k "
           "from customer) c on o.k = c.k")
    oracle = _skewed(skew_aware_exchange=False).execute(sql)
    skewed = _skewed().execute(sql)
    assert_same_rows(skewed.rows, oracle.rows)
    per_ex = {e.get("skew_role"): e for e in skewed.stats["exchange"]["per_exchange"]}
    assert per_ex["build"]["hot_keys"] >= 1
    assert sum(p > 0 for p in per_ex["build"]["partition_rows"]) >= 2


def test_skew_off_switch():
    r = _skewed(skew_aware_exchange=False).execute(SKEWED_JOIN)
    assert not any("skew_role" in e for e in r.stats["exchange"]["per_exchange"])


def test_skew_declines_when_downstream_needs_copartitioning():
    """A GROUP BY on the join key after the join relies on the join output
    being partitioned on k: the pair is not wired, and rows stay correct."""
    sql = (SKEWED_JOIN.replace("select count(*), sum(o.k)", "select o.k, count(*)")
           + " group by o.k order by 2 desc, 1 limit 5")
    oracle = _skewed(skew_aware_exchange=False).execute(sql)
    skewed = _skewed().execute(sql)
    assert_same_rows(skewed.rows, oracle.rows)
    assert not any("skew_role" in e for e in skewed.stats["exchange"]["per_exchange"])


# ------------------------------------------------- backpressure / teardown

def _exchange(mesh, **kw):
    args = dict(chunk_rows=64, inflight_bytes=1 << 20, page_capacity=256,
                book=ExchangeStatsBook())
    args.update(kw)
    return StreamingExchange(mesh, 99, GATHER, None, [BIGINT], [None], **args)


def _page(n=256, fill=1):
    return Page((Block(BIGINT, torch.full((n,), fill, dtype=torch.int64)),),
                torch.ones(n, dtype=torch.bool))


def _wait(cond):
    deadline = time.time() + DEADLINE_S
    while not cond() and time.time() < deadline:
        time.sleep(0.005)
    return cond()


def test_backpressure_blocks_and_releases():
    ex = _exchange(_mesh(2), inflight_bytes=2048)
    ex.start(n_producers=1)
    try:
        ex.add_page(0, _page())
        assert _wait(lambda: not ex.has_capacity())  # producers must park
        ex.producer_finished()
        buf = ex.out_buffer(0)
        got = 0
        deadline = time.time() + DEADLINE_S
        while time.time() < deadline:
            page = buf.poll()
            if page is not None:
                got += int(page.mask.sum())
            elif buf.is_done(None):
                break
            else:
                time.sleep(0.005)
        assert got == 256
        assert _wait(ex.has_capacity)
    finally:
        ex.close()


def test_no_deadlock_with_slow_consumer(barrier):
    check(_runner(exchange_chunk_rows=128, exchange_inflight_bytes=1 << 14), barrier,
          "select o_orderstatus, count(*) from orders group by o_orderstatus order by 1")


def test_close_while_blocked():
    ex = _exchange(_mesh(2), inflight_bytes=1)
    ex.start(n_producers=1)
    ex.add_page(0, _page())
    assert _wait(lambda: not ex.has_capacity())
    seen = {}

    def consume():
        buf = ex.out_buffer(1)
        try:
            while True:
                if buf.poll() is None:
                    if buf.is_done(None):
                        seen["done"] = True
                        return
                    time.sleep(0.005)
        except RuntimeError as e:
            seen["error"] = e

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    ex.close()  # the producer parked, a consumer blocked mid-stream
    t.join(timeout=DEADLINE_S)
    assert not t.is_alive(), "a blocked consumer must wake on close"
    assert "error" in seen, "a consumer cut off mid-stream must fail, not see its end"
    with pytest.raises(RuntimeError):
        ex.add_page(0, _page())
    ex.close()  # idempotent


def test_limit_abandons_undrained_stream(barrier):
    check(_runner(exchange_chunk_rows=128, exchange_inflight_bytes=1 << 14), barrier,
          "select o_orderkey from orders order by o_orderkey limit 7")


def test_abandoned_buffer_discards_puts():
    buf = LocalExchangeBuffer(n_producers=1, max_bytes=1)
    buf.put(_page())  # past the bound
    assert not buf.try_put(_page())
    buf.abandon()
    assert buf.try_put(_page(), wait_s=0.01)  # accepted and discarded
    assert buf.poll() is None and buf.buffered_bytes() == 0


def test_error_poisons_consumers():
    ex = _exchange(_mesh(2))
    ex.start(n_producers=1)
    ex.close(error=ValueError("producer exploded"))
    with pytest.raises(RuntimeError):
        ex.out_buffer(0).poll()


# ------------------------------------------------------------------ stats

def test_stats_and_metrics_plumbing():
    from presto_tpu_torch.utils.metrics import METRICS

    before = METRICS.counter_value("exchange.chunks")
    r = _runner().execute("select n_regionkey, count(*) from nation "
                          "group by n_regionkey order by 1")
    ex = r.stats["exchange"]
    assert ex["mode"] == "streaming" and ex["exchanges"] >= 1 and ex["chunks"] >= 1
    for key in ("fragment", "kind", "chunk_rows", "out_cap", "chunks", "dispatch_s",
                "overlap_s", "stall_s", "partition_rows"):
        assert key in ex["per_exchange"][0], key
    assert ex["pages"] >= 1 and ex["rows"] >= 5
    assert METRICS.counter_value("exchange.chunks") > before


def test_q3_partition_rows_equal_reference(eight_devices):
    """Q3 at 256-row chunks, hash routing only: every exchange delivers the
    reference's rows per partition (one reference run on its 2-device
    mesh)."""
    props = {"exchange_chunk_rows": 256, "skew_aware_exchange": False}
    ref = RefDistributed(RefMesh(eight_devices[:2]), session=RefSession(
        catalog="tpch", schema="tiny", properties=props)).execute(REF_QUERIES[3])
    port = _runner(**props).execute(REF_QUERIES[3])
    assert_same_rows(port.rows, ref.rows)

    def by_fragment(res):
        return {e["fragment"]: (e["kind"], e["partition_rows"], e["rows_out"])
                for e in res.stats["exchange"]["per_exchange"]}
    assert by_fragment(port) == by_fragment(ref)
