"""Writes in the port: CTAS / INSERT / DROP into the ``memory`` and
``blackhole`` catalogs, held against presto_tpu on the CPU at ``tpch.tiny``.

One module-scoped reference runner and one port runner run the same
statement sequences, each case with its own tables; every statement's rows
(or its error's type and message) must be equal:

- every case of ``tests/test_writers.py``, and the error messages of the
  refused writes, word for word;
- ``tests/test_null_semantics.py``'s nine queries over ``na``/``nb``,
  seeded by CTAS and INSERT VALUES with typeless NULLs, against sqlite too;
- ``test_scaled_insert_roundtrip`` of ``tests/test_scaled_writers.py``,
  and ``_scaled_writer_count`` of the same plans;
- the stale-dictionary sequence: a compiled predicate sees a value an
  INSERT added to the table's dictionary;
- a CTAS whose sink fails: the sinks are aborted and the table is gone;
- ``explain()`` of queries over written tables;
- ``Dictionary.extend`` and the dealing local exchange against the
  reference's.
"""
import sqlite3

import numpy as np
import pytest

from presto_tpu.block import Dictionary as RefDictionary
from presto_tpu.metadata import Session as RefSession
from presto_tpu.runner import LocalQueryRunner as RefRunner
from presto_tpu.utils.testing import SqliteOracle, assert_rows_equal
from presto_tpu_torch.block import Dictionary
from presto_tpu_torch.metadata import Session
from presto_tpu_torch.runner import LocalQueryRunner
from presto_tpu_torch.spi.connector import SchemaTableName
from test_torch_sql import assert_same_rows


@pytest.fixture(scope="module")
def runners():
    return (RefRunner(RefSession(catalog="tpch", schema="tiny")),
            LocalQueryRunner(Session(catalog="tpch", schema="tiny"), device="cpu"))


def _outcome(runner, sql):
    try:
        return "rows", runner.execute(sql).rows
    except Exception as e:  # noqa: BLE001 - the outcome compared
        return "error", (type(e).__name__, str(e))


def run_both(runners, statements, ordered=False):
    """Each statement through both runners; equal rows (sorted unless
    ``ordered``) or equal errors. Returns the port's outcomes."""
    out = []
    for sql in statements:
        want = _outcome(runners[0], sql)
        got = _outcome(runners[1], sql)
        assert got[0] == want[0], (sql, got, want)
        if got[0] == "error":
            assert got[1] == want[1], sql
        elif ordered or "order by" in sql.lower():
            assert_same_rows(got[1], want[1])
        else:
            assert_same_rows(sorted(got[1], key=repr), sorted(want[1], key=repr))
        out.append(got)
    return out


# ----------------------------------------------- tests/test_writers.py

WRITER_CASES = {
    "ctas_and_read_back": [
        "create table memory.default.t1 as select n_name, n_regionkey from nation",
        "select count(*), min(n_name), max(n_regionkey) from memory.default.t1"],
    "insert_select_and_values": [
        "create table memory.default.t2 as select n_nationkey, n_regionkey from nation "
        "where n_regionkey = 0",
        "insert into memory.default.t2 select n_nationkey, n_regionkey from nation "
        "where n_regionkey = 1",
        "insert into memory.default.t2 values (100, 9)",
        "select count(*), max(n_nationkey) from memory.default.t2"],
    "insert_arity_mismatch": [
        "create table memory.default.t3 as select n_nationkey from nation limit 1",
        "insert into memory.default.t3 select n_nationkey, n_regionkey from nation"],
    "ctas_if_not_exists_and_drop": [
        "create table memory.default.t4 as select 1 as x",
        "create table if not exists memory.default.t4 as select 2 as x",
        "create table memory.default.t4 as select 3 as x",
        "drop table memory.default.t4",
        "drop table if exists memory.default.t4",
        "drop table memory.default.t4"],
    "insert_values_extends_dictionary": [
        "create table memory.default.nat as select n_name, n_regionkey from nation",
        "insert into memory.default.nat values ('ATLANTIS', 9)",
        "select n_name from memory.default.nat where n_regionkey = 9",
        "select count(*) from memory.default.nat where n_name = 'CANADA'"],
    "blackhole_swallow": [
        "create table blackhole.default.sink as select * from nation",
        "select count(*) from blackhole.default.sink"],
    "join_against_written_table": [
        "create table memory.default.regions as select r_regionkey, r_name from region",
        "select r_name, count(*) from nation join memory.default.regions "
        "on n_regionkey = r_regionkey group by r_name order by r_name"],
    "varchar_min_max_after_unsorted_insert": [
        "create table memory.default.mm as select 'pear' as s",
        "insert into memory.default.mm values ('zebra')",
        "insert into memory.default.mm values ('apple')",
        "insert into memory.default.mm values ('mango')",
        "select min(s), max(s) from memory.default.mm",
        "create table memory.default.mm2 as select 1 as k, 'walnut' as s",
        "insert into memory.default.mm2 values (2, 'fig'), (1, 'almond'), (2, 'yam')",
        "select k, min(s), max(s) from memory.default.mm2 group by k order by k"],
    # the refusals, whose messages must be the reference's
    "errors": [
        "create table tpch.tiny.x as select 1 as a",
        "create table memory.default.dup as select n_nationkey, n_nationkey from nation",
        "create table memory.default.e1 as select n_nationkey, n_name from nation",
        "insert into memory.default.e1 select n_name, n_nationkey from nation",
        "insert into memory.default.e1 (n_name, n_nationkey) "
        "select n_nationkey, n_name from nation",
        "insert into memory.default.missing values (1)",
        "create table memory.default.arr as select n_regionkey, array_agg(n_name) a "
        "from nation group by n_regionkey",
        "select count(*) from memory.default.arr",
        "create table memory.default.props with (format = 'x') as select 1 as a",
        "insert into memory.default.e1 select n_nationkey, n_comment from nation",
        "select count(*), min(n_name), max(n_name) from memory.default.e1"],
    # a CTAS of sparse pages (a filtered scan), read back with ORDER BY,
    # then joined both ways, and a CTAS from a written table
    "filtered_ctas_and_reads": [
        "create table memory.default.big_orders as select o_orderkey, o_custkey, "
        "o_totalprice, o_orderdate, o_orderstatus from orders where o_totalprice > 300000",
        "select * from memory.default.big_orders order by o_orderkey",
        "select c_name, count(*) from memory.default.big_orders join customer "
        "on o_custkey = c_custkey group by c_name order by 2 desc, 1 limit 5",
        "select o_orderstatus, count(*), sum(o_totalprice) from memory.default.big_orders "
        "group by o_orderstatus order by 1",
        "create table memory.default.copy as select * from memory.default.big_orders "
        "where o_orderstatus = 'F'",
        "insert into memory.default.copy select * from memory.default.big_orders "
        "where o_orderstatus <> 'F'",
        "select count(*), max(o_orderdate) from memory.default.copy",
        "show tables from memory.default"],
}


@pytest.mark.parametrize("case", sorted(WRITER_CASES))
def test_writer_case_matches_reference(runners, case):
    run_both(runners, WRITER_CASES[case])


def test_ctas_oracle_equivalence(runners):
    """The reference's CTAS case, against its sqlite oracle too."""
    run_both(runners, ["create table memory.default.big_orders2 as select o_custkey, "
                       "o_totalprice from orders where o_totalprice > 300000"])
    got = runners[1].execute("select o_custkey, sum(o_totalprice) "
                             "from memory.default.big_orders2 group by o_custkey")
    o = SqliteOracle()
    o.load_tpch(0.01, ["orders"])
    assert_rows_equal(got.rows, o.query("select o_custkey, sum(o_totalprice) from orders "
                                        "where o_totalprice > 300000 group by o_custkey"))


def test_insert_leaves_the_tpch_dictionary_untouched(runners):
    from presto_tpu_torch.connectors.tpch.generator import DICT_NATION_NAME

    before = len(DICT_NATION_NAME)
    run_both(runners, ["create table memory.default.nat2 as select n_name from nation",
                       "insert into memory.default.nat2 values ('LEMURIA')"])
    assert len(DICT_NATION_NAME) == before


def test_stale_dictionary_codes_are_rekeyed(runners):
    """A predicate compiled before an INSERT extended the table's dictionary
    must see the new value afterwards, as the reference's does."""
    out = run_both(runners, [
        "create table memory.default.z as select n_name as s from nation where n_nationkey < 3",
        "select count(*) from memory.default.z where s = 'zebra'",
        "select count(*) from memory.default.z where s like 'z%'",
        "insert into memory.default.z values ('zebra')",
        "select count(*) from memory.default.z where s = 'zebra'",
        "select count(*) from memory.default.z where s like 'z%'",
        "select s from memory.default.z order by s"])
    assert [o[1] for o in out[1:3]] == [[[0]], [[0]]]
    assert [o[1] for o in out[4:6]] == [[[1]], [[1]]]


# --------------------------------------- tests/test_null_semantics.py

ROWS_A = [(1, 10), (2, None), (3, 10), (4, None), (5, 20), (6, None), (7, None)]
ROWS_B = [(1, 10), (2, None), (3, 30)]
NULL_QUERIES = [
    "select v, count(*) from na group by v",
    "select v, count(v), count(*) from na group by v",
    "select v, sum(k), min(k), max(k) from na group by v",
    "select distinct v from na",
    "select count(distinct v) from na",
    "select a.k, b.k from na a join nb b on a.v = b.v",
    "select a.k, b.k from na a left join nb b on a.v = b.v",
    "select v, k % 2, count(*) from na group by v, k % 2",
    "select count(v), sum(v), avg(v) from na",
]


def seed_null_tables(runner, prefix=""):
    """The null-semantics fixture: an empty two-BIGINT table by CTAS, then
    ``na``/``nb`` filled by INSERT VALUES that may carry NULLs."""
    runner.execute(f"create table memory.default.{prefix}seed as "
                   "select o_orderkey as k, o_custkey as v from tpch.tiny.orders limit 0")
    for name, rows in (("na", ROWS_A), ("nb", ROWS_B)):
        runner.execute(f"create table memory.default.{prefix}{name} as "
                       f"select * from memory.default.{prefix}seed")
        for k, v in rows:
            vv = "null" if v is None else str(v)
            runner.execute(f"insert into memory.default.{prefix}{name} values ({k}, {vv})")


@pytest.fixture(scope="module")
def null_tables(runners):
    for r in runners:
        seed_null_tables(r, "ns_")
    conn = sqlite3.connect(":memory:")
    conn.execute("create table na (k integer, v integer)")
    conn.execute("create table nb (k integer, v integer)")
    conn.executemany("insert into na values (?, ?)", ROWS_A)
    conn.executemany("insert into nb values (?, ?)", ROWS_B)
    return conn


@pytest.mark.parametrize("sql", NULL_QUERIES)
def test_null_semantics_match_reference_and_sqlite(runners, null_tables, sql):
    port_sql = sql.replace("na", "memory.default.ns_na").replace("nb", "memory.default.ns_nb")
    got = run_both(runners, [port_sql])[0][1]

    def key(row):
        return tuple((v is None, v if v is not None else 0) for v in row)

    exp = sorted((tuple(r) for r in null_tables.execute(sql).fetchall()), key=key)
    assert sorted((tuple(r) for r in got), key=key) == exp


# -------------------------------------------------------- scaled writers

def _scaled_runners():
    props = {"writer_min_rows_per_driver": 5000, "task_concurrency": 3}
    return (RefRunner(RefSession(catalog="tpch", schema="tiny", properties=dict(props))),
            LocalQueryRunner(Session(catalog="tpch", schema="tiny", properties=dict(props)),
                             device="cpu"))


SCALED_SOURCES = ["select o_orderkey from orders",
                  "select o_orderkey from orders where o_orderkey < 0",
                  "select n_name from nation",
                  "select l_orderkey, l_comment from lineitem"]


@pytest.mark.parametrize("sql", SCALED_SOURCES)
def test_scaled_writer_count_matches_reference(sql):
    ref, port = _scaled_runners()
    assert port._scaled_writer_count(port.plan_sql(sql)) == \
        ref._scaled_writer_count(ref.plan_sql(sql))


def test_scaled_insert_roundtrip():
    ref, port = _scaled_runners()
    assert port._scaled_writer_count(port.plan_sql("select o_orderkey from orders")) == 3
    out = run_both((ref, port), [
        "create table memory.default.t as select o_orderkey from orders where o_orderkey < 0",
        "insert into memory.default.t select o_orderkey from orders",
        "select count(*) from memory.default.t",
        "select count(*), sum(o_orderkey) from memory.default.t"])
    assert out[2][1] == [[15000]]
    # three writer drivers, each with its own sink, each given a share
    mem = port.catalogs.get("memory").metadata()
    pages = mem.table_data(mem.get_table_handle(SchemaTableName("default", "t"))).pages
    assert len(pages) >= 3


def test_scaling_off_keeps_one_writer():
    ref, port = _scaled_runners()
    port.session = port.session.with_properties(scaled_writers=False)
    ref.session = ref.session.with_properties(scaled_writers=False)
    sql = "select o_orderkey from orders"
    assert port._scaled_writer_count(port.plan_sql(sql)) == 1 == \
        ref._scaled_writer_count(ref.plan_sql(sql))
    run_both((ref, port), ["create table memory.default.o1 as select o_orderkey from orders",
                           "select count(*), max(o_orderkey) from memory.default.o1"])


# ------------------------------------------------------- CTAS rollback

def test_ctas_rolls_back_when_a_sink_fails(runners):
    """A failing sink aborts every sink and drops the created table."""
    from presto_tpu_torch.connectors import memory as mem_mod

    port = runners[1]
    aborted = []
    orig_append, orig_abort = mem_mod.MemoryPageSink.append_page, mem_mod.MemoryPageSink.abort

    def failing(self, page):
        raise RuntimeError("disk full")

    def abort(self):
        aborted.append(self)
        orig_abort(self)
    mem_mod.MemoryPageSink.append_page, mem_mod.MemoryPageSink.abort = failing, abort
    try:
        with pytest.raises(RuntimeError, match="disk full"):
            port.execute("create table memory.default.rb as select * from nation")
    finally:
        mem_mod.MemoryPageSink.append_page, mem_mod.MemoryPageSink.abort = \
            orig_append, orig_abort
    assert aborted
    assert "rb" not in [r[0] for r in port.execute("show tables from memory.default").rows]
    # the name is free again
    assert port.execute("create table memory.default.rb as select * from nation").rows == [[25]]


# ------------------------------------------------------------ plans

EXPLAIN_SETUP = [
    "create table memory.default.ex_o as select * from orders",
    "create table memory.default.ex_c as select * from customer",
]
EXPLAIN_QUERIES = [
    "select c_name, sum(o_totalprice) from memory.default.ex_o join memory.default.ex_c "
    "on o_custkey = c_custkey group by c_name",
    "select n_name, count(*) from memory.default.ex_c join nation "
    "on c_nationkey = n_nationkey group by n_name order by n_name",
    "select o_orderstatus, count(*) from memory.default.ex_o "
    "where o_orderkey in (select o_orderkey from orders where o_totalprice > 1000) "
    "group by o_orderstatus",
]


@pytest.fixture(scope="module")
def explain_tables(runners):
    for sql in EXPLAIN_SETUP:
        for r in runners:
            r.execute(sql)


@pytest.mark.parametrize("i", range(len(EXPLAIN_QUERIES)))
def test_explain_over_written_tables_matches_reference(runners, explain_tables, i):
    sql = EXPLAIN_QUERIES[i]
    assert runners[1].explain(sql) == runners[0].explain(sql)
    run_both(runners, [sql])


# ------------------------------------------------------------ pieces

def test_dictionary_extend_matches_reference():
    values = ["pear", "apple", "zebra"]
    d, ref = Dictionary(values), RefDictionary(values)
    assert d.is_sorted() == ref.is_sorted()
    for batch in (["fig", "apple", "fig"], ["aardvark"], ["pear"]):
        assert d.extend(batch) == ref.extend(batch)
        assert list(d.values) == list(ref.values)
        np.testing.assert_array_equal(d.sort_keys(), ref.sort_keys())
        assert d.is_sorted() == ref.is_sorted()
        assert d.code_of("fig") == ref.code_of("fig")


def test_dealing_exchange_gives_every_slot_a_share():
    """Round-robin dealing: source i of n reads pages i, i + n, ...; each
    slot is done once its own queue is empty and the producer finished."""
    from presto_tpu_torch.ops.local_exchange import (LocalExchangeFactory,
                                                     LocalExchangeSourceFactory)

    lx = LocalExchangeFactory(n_producers=1, max_pages=8, deal_slots=3)
    slots = [LocalExchangeSourceFactory(0, lx, []).create_operator()._slot for _ in range(3)]
    assert slots == [0, 1, 2]
    buf = lx.buffer()
    for i in range(7):
        buf.put(i)
    assert buf.has_room()  # 7 buffered of 8
    buf.producer_finished()
    got = []
    for s in slots:
        pages = []
        while not buf.is_done(s):
            pages.append(buf.poll(s))
        got.append(pages)
    assert got == [[0, 3, 6], [1, 4], [2, 5]]
