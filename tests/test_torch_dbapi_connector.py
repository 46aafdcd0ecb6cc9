"""The port's DB-API connector (``presto_tpu_torch/connectors/dbapi``, the
sqlite dialect) against presto_tpu on the CPU at ``tpch.tiny``.

Each case of ``tests/test_dbapi_connector.py`` runs through a runner of
each package over its own copy of the same sqlite file: equal rows. The
pushed-down WHERE (``_where_clause``) gives equal text and parameters. A
CTAS and INSERTs written by each package into its own file leave the same
``SELECT *, typeof(...)`` rows (values and sqlite storage classes), with
NULLs, DECINT and external decimal columns, dates, doubles and booleans,
and each package reads the other's file with equal rows. The port's
``_typed_block`` gives the reference's blocks on the same values (NULLs,
decimals stored as integers and reals, ISO date and timestamp strings, the
error for a value missing from the plan-time dictionary), and the sink's
column-at-a-time ``_remote_column`` the reference's per-value parameters.
"""
import shutil
import sqlite3

import numpy as np
import pytest
import torch

from presto_tpu.connectors import dbapi as ref_dbapi
from presto_tpu.metadata import Session as RefSession
from presto_tpu.runner import LocalQueryRunner as RefRunner
from presto_tpu.spi import connector as ref_spi
from presto_tpu.types import parse_type as ref_type
from presto_tpu_torch.block import Block, Dictionary
from presto_tpu_torch.connectors import dbapi
from presto_tpu_torch.metadata import Session
from presto_tpu_torch.runner import LocalQueryRunner
from presto_tpu_torch.spi import connector as port_spi
from presto_tpu_torch.types import parse_type
from test_torch_writers import run_both

SEED = 1515


def _seed_db(path: str) -> None:
    """The reference test's ``users`` and ``regions_map`` tables."""
    conn = sqlite3.connect(path)
    conn.execute("create table users (id integer, name text, score real)")
    conn.executemany("insert into users values (?,?,?)", [
        (1, "ann", 9.5), (2, "bob", 7.25), (3, "cara", None), (4, None, 1.0)])
    conn.execute("create table regions_map (rk integer, label text)")
    conn.executemany("insert into regions_map values (?,?)", [
        (0, "zero"), (1, "one"), (2, "two"), (3, "three"), (4, "four")])
    conn.commit()
    conn.close()


@pytest.fixture()
def dbs(tmp_path):
    """(reference runner, port runner, reference file, port file): two copies
    of one seeded file, each behind an ``ext`` catalog of one package."""
    ref_path, port_path = str(tmp_path / "ref.db"), str(tmp_path / "port.db")
    _seed_db(ref_path)
    shutil.copy(ref_path, port_path)
    ref = RefRunner(RefSession(catalog="tpch", schema="tiny"))
    port = LocalQueryRunner(Session(catalog="tpch", schema="tiny"), device="cpu")
    ref.catalogs.register("ext", ref_dbapi.sqlite_connector("ext", ref_path))
    port.catalogs.register("ext", dbapi.sqlite_connector("ext", port_path))
    return ref, port, ref_path, port_path


def _typed_rows(path: str, table: str):
    """Every row of ``table`` with each value's sqlite storage class."""
    conn = sqlite3.connect(path)
    try:
        cols = [r[1] for r in conn.execute(f'PRAGMA table_info("{table}")')]
        sel = ", ".join([f'"{c}"' for c in cols] + [f'typeof("{c}")' for c in cols])
        return sorted(conn.execute(f'select {sel} from "{table}"').fetchall(), key=repr)
    finally:
        conn.close()


# -------------------------------------------------- tests/test_dbapi_connector.py

DBAPI_CASES = {
    "scan_types_and_nulls": ["select id, name, score from ext.main.users order by id"],
    "predicate_pushdown_to_sql": [
        "select name from ext.main.users where id >= 2 and id <= 3 order by id"],
    "join_external_with_engine_table": [
        "select r.r_name, m.label from region r join ext.main.regions_map m "
        "on r.r_regionkey = m.rk where m.label = 'two'"],
    "ctas_into_sqlite_and_readback": [
        "create table ext.main.nat as select n_name, n_regionkey from nation "
        "where n_regionkey < 2",
        "select count(*) from ext.main.nat where n_regionkey = 1"],
    "insert_appends_and_dictionary_refreshes": [
        "create table ext.main.t as select n_name from nation where n_regionkey = 0",
        "insert into ext.main.t select n_name from nation where n_regionkey = 3",
        "select count(*) from ext.main.t",
        "select count(*) from ext.main.t where n_name = 'GERMANY'"],
    "show_tables_and_drop": ["show tables from ext.main", "drop table ext.main.regions_map",
                             "show tables from ext.main"],
    "ctas_decimal_and_date_roundtrip": [
        "create table ext.main.li as select l_quantity, l_shipdate from lineitem "
        "where l_orderkey = 1",
        "select l_quantity, l_shipdate from ext.main.li order by l_quantity"],
    "aggregate_over_external": [
        "select count(*), sum(score) from ext.main.users where score > 2.0"],
}


@pytest.mark.parametrize("case", sorted(DBAPI_CASES))
def test_dbapi_cases_equal_reference(dbs, case):
    ref, port, ref_path, port_path = dbs
    run_both((ref, port), DBAPI_CASES[case])
    conn = sqlite3.connect(port_path)
    tables = {r[0] for r in conn.execute("select name from sqlite_master where type = 'table'")}
    conn.close()
    for table in sorted(tables - {"users", "regions_map"}):  # what the case wrote
        assert _typed_rows(port_path, table) == _typed_rows(ref_path, table)


WHERE_CASES = [
    ({"id": (2, 3)}, {"id": "bigint"}, None),
    ({"id": (None, 7), "score": (1.5, None)}, {"id": "bigint", "score": "double"}, None),
    ({"d": (9000, 9100)}, {"d": "date"}, None),
    ({"name": (0, 3), "amount": (100, 200), "at": (5, 9), "id": (1, 1)},
     {"name": "varchar", "amount": "decimal(12,2)", "at": "timestamp", "id": "bigint"}, None),
    ({"id": (2, 3), "k": (0, 1)}, {"id": "bigint", "k": "bigint"}, {"k"}),
    ({"id": [1, 2]}, None, None),
    ({}, None, None),
    ({'we"ird': (1, None)}, None, None),
]


@pytest.mark.parametrize("i", range(len(WHERE_CASES)))
def test_where_clause_equals_reference(tmp_path, i):
    domains, types, columns = WHERE_CASES[i]
    path = str(tmp_path / "x.db")
    want = ref_dbapi._where_clause(
        ref_dbapi.SqliteDialect(path), ref_spi.Constraint(domains),
        {k: ref_type(v) for k, v in types.items()} if types else None, columns)
    got = dbapi._where_clause(
        dbapi.SqliteDialect(path), port_spi.Constraint(domains),
        {k: parse_type(v) for k, v in types.items()} if types else None, columns)
    assert got == want
    if i == 0:
        assert got == (' WHERE "id" >= ? AND "id" <= ?', [2, 3])


def test_pushed_down_where_fetches_only_the_rows_inside(dbs):
    _ref, port, _rp, _pp = dbs
    port.execute("create table ext.main.o as select o_orderkey, o_orderdate from orders")
    sources = []
    real = dbapi.DbApiPageSource.__iter__

    def spy(self):
        sources.append(self)
        return real(self)
    dbapi.DbApiPageSource.__iter__ = spy
    try:
        got = port.execute("select count(*) from ext.main.o "
                           "where o_orderdate < date '1995-03-15'").rows
    finally:
        dbapi.DbApiPageSource.__iter__ = real
    want = port.execute("select count(*) from orders where o_orderdate < date '1995-03-15'")
    assert got == want.rows and sum(s.rows_fetched for s in sources) == got[0][0]


# -------------------------------------------------- writes, storage classes

WIDE_CTAS = (
    "create table ext.main.wide as select l_orderkey, l_quantity, l_extendedprice, "
    "l_discount * 1.0e0 as disc, l_shipdate, l_returnflag, l_quantity > 25 as big, "
    "case when l_linenumber = 1 then null else l_shipdate end as maybe_day, "
    "case when l_linenumber = 2 then null else l_quantity end as maybe_qty, "
    "case when l_linenumber = 3 then null else l_shipmode end as maybe_mode "
    "from lineitem where l_orderkey < 200")
EXTERNAL_DDL = ("create table ext_types (k integer, price decimal(12,2), day date, "
                "amount decimal(10,3), ratio real, ok boolean, label text)")
EXTERNAL_INSERT = (
    "insert into ext.main.ext_types select l_orderkey, l_extendedprice, l_shipdate, "
    "case when l_linenumber = 1 then null else l_quantity end, l_discount * 1.0e0, "
    "l_tax > 0.04, l_shipinstruct from lineitem where l_orderkey < 100")


def test_writes_leave_the_same_rows_and_storage_classes(dbs):
    """A CTAS of every kind of column, and an INSERT into a table of
    external (non-DECINT) types: the same values and storage classes."""
    ref, port, ref_path, port_path = dbs
    for path in (ref_path, port_path):
        conn = sqlite3.connect(path)
        conn.execute(EXTERNAL_DDL)
        conn.commit()
        conn.close()
    run_both((ref, port), [WIDE_CTAS, EXTERNAL_INSERT, "select * from ext.main.wide",
                           "select * from ext.main.ext_types"])
    for table in ("wide", "ext_types"):
        got, want = _typed_rows(port_path, table), _typed_rows(ref_path, table)
        assert got == want and len(got) > 100


def test_each_package_reads_the_others_file(dbs):
    ref, port, ref_path, port_path = dbs
    run_both((ref, port), [WIDE_CTAS])
    ref.catalogs.register("other", ref_dbapi.sqlite_connector("other", port_path))
    port.catalogs.register("other", dbapi.sqlite_connector("other", ref_path))
    for sql in ("select * from other.main.wide",
                "select l_returnflag, count(*), sum(l_quantity), min(maybe_day), "
                "max(maybe_mode) from other.main.wide group by l_returnflag",
                "select id, name, score from other.main.users order by id"):
        want = ref.execute(sql.replace("other.", "ext.")).rows
        run_both((ref, port), [sql])
        assert sorted(port.execute(sql).rows, key=repr) == sorted(want, key=repr)


def test_a_failed_insert_leaves_nothing(dbs):
    _ref, port, _rp, port_path = dbs
    port.execute("create table ext.main.t as select n_name from nation where n_regionkey = 0")
    with pytest.raises(Exception):
        port.execute("insert into ext.main.t select cast(n_name as bigint) from nation")
    assert port.execute("select count(*) from ext.main.t").rows == [[5]]
    assert sqlite3.connect(port_path).execute("select count(*) from t").fetchone() == (5,)


# -------------------------------------------------- numpy against the loops

def _columns():
    """(type text, raw_substrate, values) cases of fetched columns."""
    rng = np.random.default_rng(SEED)
    n = 257
    ints = [None if i % 7 == 0 else int(v) for i, v in enumerate(rng.integers(-2**40, 2**40, n))]
    reals = [None if i % 5 == 0 else float(v) for i, v in enumerate(rng.normal(0, 1e4, n))]
    prices = [round(float(v), 2) for v in rng.uniform(-1e5, 1e5, n)]
    mixed = [[p, int(p), None, round(p, 1), p / 3][i % 5] for i, p in enumerate(prices)]
    days = [None if i % 6 == 0 else str(np.datetime64(int(d), "D"))
            for i, d in enumerate(rng.integers(-5000, 20000, n))]
    stamps = [None if i % 4 == 0 else
              ["2024-02-29T12:34:56.789", "1999-12-31 23:59:59", "2001-01-01T00:00:00+02:00",
               "1970-01-01"][i % 4] for i in range(n)]
    return [
        ("bigint", False, ints), ("double", False, reals), ("double", False, ints),
        ("decimal(12,2)", False, mixed), ("decimal(12,2)", True, ints),
        ("decimal(12,2)", True, [None if v is None else float(v) for v in ints]),
        ("date", False, days), ("date", False, [None, 8000, "1995-03-15", 9000]),
        ("timestamp", False, stamps), ("timestamp", False, [None, 123456789, 0]),
        ("boolean", False, [True, None, False, 1, 0]),
        ("bigint", False, []), ("double", False, [None, None]),
    ]


@pytest.mark.parametrize("i", range(len(_columns())))
def test_typed_block_equals_reference_loop(i):
    tname, raw, vals = _columns()[i]
    cap = 512
    want = ref_dbapi._typed_block(ref_spi.ColumnMetadata("c", ref_type(tname)), list(vals),
                                  cap, raw)
    got = dbapi._typed_block(port_spi.ColumnMetadata("c", parse_type(tname)), list(vals),
                             cap, raw)
    assert got.data.numpy().dtype == np.asarray(want.data).dtype
    assert got.data.numpy().tobytes() == np.asarray(want.data).tobytes()
    assert (got.nulls is None) == (want.nulls is None)
    if want.nulls is not None:
        assert got.nulls.numpy().tolist() == np.asarray(want.nulls).tolist()


def test_typed_block_strings_and_the_missing_value_error():
    from presto_tpu.block import Dictionary as RefDictionary

    words = ["apple", "kiwi", "fig", "é", "5"]
    vals = [None if i % 9 == 0 else [*words, 5][i % 6] for i in range(100)]
    want = ref_dbapi._typed_block(ref_spi.ColumnMetadata(
        "s", ref_type("varchar"), dictionary=RefDictionary(sorted(words))), vals, 128)
    got = dbapi._typed_block(port_spi.ColumnMetadata(
        "s", parse_type("varchar"), dictionary=Dictionary(sorted(words))), vals, 128)
    assert got.data.numpy().tolist() == np.asarray(want.data).tolist()
    assert got.nulls.numpy().tolist() == np.asarray(want.nulls).tolist()
    bad = vals[:10] + ["durian", "kiwi", "elder"]
    errors = []
    for pkg, spi, ptype, d in ((ref_dbapi, ref_spi, ref_type, RefDictionary(sorted(words))),
                               (dbapi, port_spi, parse_type, Dictionary(sorted(words)))):
        with pytest.raises(RuntimeError) as e:
            pkg._typed_block(spi.ColumnMetadata("s", ptype("varchar"), dictionary=d), bad, 16)
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "'durian' missing from the plan-time" in errors[1]


def _ref_column(b_dict, tname, data, nulls, substrate):
    """The reference sink's per-value conversion of one column, then
    ``_plain`` (``presto_tpu/connectors/dbapi/__init__.py`` ``append_page``)."""
    t = ref_type(tname)
    if b_dict is not None:
        strs = b_dict.lookup(data)
        vals = [None if (nulls is not None and nulls[i]) or s is None else str(s)
                for i, s in enumerate(strs)]
    elif t.name == "decimal" and substrate:
        vals = [None if nulls is not None and nulls[i] else int(x)
                for i, x in enumerate(data.tolist())]
    else:
        vals = [None if nulls is not None and nulls[i] else t.to_python(x)
                for i, x in enumerate(data.tolist())]
    return [ref_dbapi._plain(v) for v in vals]


@pytest.mark.parametrize("tname,substrate", [
    ("bigint", False), ("integer", False), ("double", False), ("real", False),
    ("boolean", False), ("date", False), ("timestamp", False), ("decimal(12,2)", False),
    ("decimal(12,2)", True), ("decimal(18,4)", False), ("varchar", False)])
def test_remote_column_equals_reference_loop(tname, substrate):
    rng = np.random.default_rng(SEED + 2)
    n = 300
    t = parse_type(tname)
    if tname == "varchar":
        d = Dictionary(["a", "bb", "ccc"])
        data = rng.integers(0, 3, n).astype(np.int32)
    else:
        d = None
        data = {"f": rng.normal(0, 1e6, n), "b": rng.random(n) < 0.5}.get(
            np.dtype(t.np_dtype).kind, rng.integers(-10**6, 10**6, n)).astype(t.np_dtype)
        if tname == "decimal(18,4)":
            data[:3] = [(1 << 53) + 1, -(1 << 60), 7]  # beyond the exact float range
    nulls = rng.random(n) < 0.2
    if tname == "date":
        data = rng.integers(-719162, 2932896, n).astype(np.int32)  # 0001-01-01..9999-12-31
        data[nulls] = -10**6  # out of datetime.date's range, under the NULL flags
    block = Block(t, torch.from_numpy(data), torch.from_numpy(nulls), d)
    got = dbapi._remote_column(block, port_spi.ColumnMetadata("c", t), data, nulls, substrate)
    want = _ref_column(d, tname, data, nulls, substrate)
    assert [type(v) for v in got] == [type(v) for v in want]
    assert got == want
    if tname == "date":  # a live date out of range raises in both
        nulls[np.argmax(data == -10**6)] = False
        with pytest.raises(OverflowError):
            _ref_column(d, tname, data, nulls, substrate)
        with pytest.raises(OverflowError):
            dbapi._remote_column(block, port_spi.ColumnMetadata("c", t), data, nulls, substrate)
