"""The port's raptor connector (``presto_tpu_torch/connectors/raptor``)
against presto_tpu on the CPU at ``tpch.tiny``.

One reference runner and one port runner, each with a ``raptor`` catalog
over a store of its own (a sqlite metadata database and PCOL shards) and a
read-only ``other`` catalog over the other package's store, run the cases
of ``tests/test_raptor.py``: equal rows, and after every case metadata
databases that hold the same tables, columns, shard row counts and
per-shard column min/max (shard uuids are random, so shards compare by
their table and contents). Besides: the same shards pruned by a
constraint, the same shard counts before and after compaction, a dropped
table's files kept until ``maintenance(grace_s)`` removes them, and each
package reading the other's store. Every connector is shut down when the
module ends, so no organizer thread or database outlives it.
"""
import os
import sqlite3
import time

import pytest

from presto_tpu.connectors import raptor as ref_raptor
from presto_tpu.metadata import Session as RefSession
from presto_tpu.runner import LocalQueryRunner as RefRunner
from presto_tpu.spi import connector as ref_spi
from presto_tpu_torch.connectors import raptor
from presto_tpu_torch.metadata import Session
from presto_tpu_torch.runner import LocalQueryRunner
from presto_tpu_torch.spi import connector as port_spi
from test_torch_sql import assert_same_rows
from test_torch_writers import run_both

THRESHOLD = 100_000


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """(reference runner, port runner, reference base, port base)."""
    base = tmp_path_factory.mktemp("raptor")
    ref_dir, port_dir = str(base / "ref"), str(base / "port")
    ref = RefRunner(RefSession(catalog="tpch", schema="tiny"))
    port = LocalQueryRunner(Session(catalog="tpch", schema="tiny"), device="cpu")
    conns = []
    for r, pkg, own, others in ((ref, ref_raptor, ref_dir, port_dir),
                                (port, raptor, port_dir, ref_dir)):
        for name, root, kw in (("raptor", own, {"compaction_threshold_rows": THRESHOLD}),
                               ("other", others, {})):
            conns.append(pkg.RaptorConnector(name, root, **kw))
            r.catalogs.register(name, conns[-1])
    yield ref, port, ref_dir, port_dir
    for c in conns:
        c.shutdown()


def _db_state(base: str):
    """The metadata database's contents, shard uuids left out."""
    db = sqlite3.connect(os.path.join(base, "metadata.db"))
    try:
        q = db.execute
        return {
            "tables": q("select schema_name, table_name from tables order by 1, 2").fetchall(),
            "columns": q("select t.table_name, c.ordinal, c.column_name, c.type_tag, "
                         "c.type_scale from columns c join tables t using (table_id) "
                         "order by 1, 2").fetchall(),
            "shards": q("select t.table_name, s.row_count, s.compacted from shards s "
                        "join tables t using (table_id) order by 1, 2, 3").fetchall(),
            "stats": q("select t.table_name, s.row_count, st.column_name, st.min_value, "
                       "st.max_value from shard_stats st join shards s using (shard_uuid) "
                       "join tables t using (table_id) order by 1, 2, 3, 4, 5").fetchall(),
        }
    finally:
        db.close()


def _both(st, statements):
    """The statements through both runners (equal rows or errors), then
    equal metadata databases."""
    out = run_both(st[:2], statements)
    assert _db_state(st[3]) == _db_state(st[2])
    return out


def _shards(base: str, table: str):
    db = sqlite3.connect(os.path.join(base, "metadata.db"))
    try:
        return db.execute("select s.shard_uuid, s.row_count from shards s join tables t "
                          "using (table_id) where t.table_name = ?", (table,)).fetchall()
    finally:
        db.close()


def _splits(runner, table: str, domains=None):
    spi = port_spi if isinstance(runner, LocalQueryRunner) else ref_spi
    conn = runner.catalogs.get("raptor")
    handle = conn.metadata().get_table_handle(spi.SchemaTableName("default", table))
    return conn.split_manager().get_splits(handle, spi.Constraint(dict(domains or {})), 8)


# ---------------------------------------------- tests/test_raptor.py's cases

def test_ctas_registers_shard_in_metadata_db(stores):
    _both(stores, [
        "create table raptor.default.nat as select * from nation",
        "select n_name, n_regionkey from raptor.default.nat where n_regionkey = 2"])
    for base in stores[2:]:
        shards = _shards(base, "nat")
        assert len(shards) == 1 and shards[0][1] == 25
        assert os.path.isfile(os.path.join(base, "storage", f"{shards[0][0]}.pcol"))


def test_orphan_files_invisible(stores):
    for base in stores[2:]:
        with open(os.path.join(base, "storage", "deadbeef.pcol"), "wb") as f:
            f.write(b"junk")
    out = _both(stores, [
        "create table raptor.default.nat_orphan as select * from nation",
        "select count(*) from raptor.default.nat_orphan"])
    assert out[1][1] == [[25]]


def test_shard_pruning_in_metadata_db(stores):
    ref, port = stores[:2]
    _both(stores, [
        "create table raptor.default.ord as select o_orderkey, o_custkey from orders "
        "where o_orderkey <= 30000",
        "insert into raptor.default.ord select o_orderkey, o_custkey from orders "
        "where o_orderkey > 30000",
        "select count(*) from raptor.default.ord where o_orderkey <= 1000",
        "select count(*), max(o_custkey) from raptor.default.ord where o_orderkey > 50000"])
    kept = []
    for r, base in ((ref, stores[2]), (port, stores[3])):
        rows = dict(_shards(base, "ord"))
        every = _splits(r, "ord")
        pruned = _splits(r, "ord", {"o_orderkey": (1, 1000)})
        assert len(pruned) < len(every) == 2
        kept.append(sorted(rows[s.payload[2]] for s in pruned))
    assert kept[0] == kept[1]


def test_compaction_merges_small_shards(stores):
    ref, port = stores[:2]
    _both(stores, ["create table raptor.default.n2 as select n_nationkey, n_name "
                   "from nation where n_nationkey < 0"] +
          [f"insert into raptor.default.n2 select n_nationkey, n_name from nation "
           f"where n_regionkey = {k}" for k in range(5)])
    before = [len(_shards(b, "n2")) for b in stores[2:]]
    assert before[0] == before[1] >= 5
    removed = [r.catalogs.get("raptor").maintenance() for r in (ref, port)]
    assert removed[0] == removed[1] >= 5
    after = [len(_shards(b, "n2")) for b in stores[2:]]
    assert after[0] == after[1] < before[0]
    _both(stores, ["select n_nationkey, n_name from raptor.default.n2",
                   "select count(*) from raptor.default.n2 where n_name = 'PERU'"])


def test_drop_table_defers_file_removal(stores):
    ref, port = stores[:2]
    _both(stores, ["create table raptor.default.tmp as select * from nation"])
    files = [[os.path.join(b, "storage", f"{u}.pcol") for u, _ in _shards(b, "tmp")]
             for b in stores[2:]]
    assert all(len(f) == 1 for f in files)
    _both(stores, ["drop table raptor.default.tmp", "select count(*) from raptor.default.tmp"])
    # the metadata goes at once; the files outlive a grace period
    assert all(os.path.isfile(f) for fs in files for f in fs)
    for r in (ref, port):
        r.catalogs.get("raptor").maintenance(grace_s=3600.0)
    assert all(os.path.isfile(f) for fs in files for f in fs)
    for r in (ref, port):
        r.catalogs.get("raptor").maintenance(grace_s=0.0)
    assert not any(os.path.exists(f) for fs in files for f in fs)
    assert _db_state(stores[3]) == _db_state(stores[2])


# ------------------------------------------------------------- across packages

def test_each_package_reads_the_others_store(stores):
    ref, port = stores[:2]
    _both(stores, [
        "create table raptor.default.xr_li as select l_orderkey, l_quantity, l_returnflag, "
        "l_shipdate from lineitem where l_orderkey < 10000",
        "insert into raptor.default.xr_li select l_orderkey, l_quantity, l_returnflag, "
        "l_shipdate from lineitem where l_orderkey >= 10000 and l_orderkey < 20000"])
    for sql in ("select l_returnflag, count(*), sum(l_quantity), max(l_shipdate) "
                "from {}.default.xr_li group by 1 order by 1",
                "select count(*) from {}.default.xr_li where l_orderkey between 9000 and 11000"):
        want = ref.execute(sql.format("raptor")).rows
        assert_same_rows(port.execute(sql.format("other")).rows, want)
        assert_same_rows(ref.execute(sql.format("other")).rows, want)


def test_organizer_thread_compacts_and_stops(tmp_path):
    """``organize_interval_s`` runs maintenance on a thread of the
    connector's own, which ``shutdown()`` stops and joins."""
    conn = raptor.RaptorConnector("raptor", str(tmp_path), compaction_threshold_rows=THRESHOLD,
                                  organize_interval_s=0.05)
    try:
        port = LocalQueryRunner(Session(catalog="tpch", schema="tiny"), device="cpu")
        port.catalogs.register("raptor", conn)
        port.execute("create table raptor.default.r as select n_nationkey from nation "
                     "where n_regionkey = 0")
        port.execute("insert into raptor.default.r select n_nationkey from nation "
                     "where n_regionkey = 1")
        deadline = time.monotonic() + 30
        while len(_shards(str(tmp_path), "r")) > 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert len(_shards(str(tmp_path), "r")) == 1
        assert port.execute("select count(*) from raptor.default.r").rows == [[10]]
    finally:
        conn.shutdown()
    assert not conn._organizer.is_alive()


def test_shard_manager_under_concurrent_writers(tmp_path):
    """More threads than cores register shards and read the database
    through one shared connection, with a short switch interval: every
    shard is registered once and every read sees a consistent table."""
    import sys
    import threading

    from presto_tpu_torch.types import BIGINT

    sm = raptor.ShardManager(str(tmp_path))
    tid = sm.create_table(port_spi.SchemaTableName("default", "t"),
                          [port_spi.ColumnMetadata("k", BIGINT)])
    n_threads, per_thread = 2 * (os.cpu_count() or 1), 5
    errors = []

    def work(w):
        try:
            for i in range(per_thread):
                sm.register_shard(tid, f"{w}-{i}", i + 1, {"k": (i, i + 10)})
                assert sm.table_rows(tid) >= i + 1
                sm.shards(tid, port_spi.Constraint({"k": (0, 5)}))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(w,)) for w in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    try:
        assert not any(t.is_alive() for t in threads) and errors == []
        assert len(sm.shards(tid)) == n_threads * per_thread
        assert sm.table_rows(tid) == n_threads * sum(range(1, per_thread + 1))
    finally:
        sm.close()
