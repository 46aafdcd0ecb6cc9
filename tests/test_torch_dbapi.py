"""The port's PEP 249 client and CLI against presto_tpu, on the CPU
(``tests/test_dbapi.py`` and the CLI tests of ``tests/test_server.py``).

Each runs against the port's ``PrestoTpuServer`` over
``LocalQueryRunner(device="cpu")`` at ``tiny``. ``substitute_params``
renders the same SQL text as the reference's for the same parameters,
exactly; the CLI's formatters render the same text as the reference's.
"""
import datetime
import decimal
import io

import pytest

import presto_tpu.client.dbapi as ref_dbapi
import presto_tpu_torch.client.dbapi as dbapi
from presto_tpu_torch.metadata import Session
from presto_tpu_torch.runner import LocalQueryRunner
from presto_tpu_torch.server import PrestoTpuServer


@pytest.fixture(scope="module")
def server():
    runner = LocalQueryRunner(session=Session(catalog="tpch", schema="tiny"), device="cpu")
    srv = PrestoTpuServer(runner, port=0, page_rows=7)
    srv.start()
    yield srv
    srv.stop()


@pytest.fixture()
def base(server):
    return f"http://localhost:{server.port}"


@pytest.fixture()
def conn(server):
    with dbapi.connect(host="localhost", port=server.port, user="alice") as c:
        yield c


def test_module_globals():
    assert dbapi.apilevel == "2.0"
    assert dbapi.paramstyle == "qmark"
    assert issubclass(dbapi.ProgrammingError, dbapi.DatabaseError)
    assert issubclass(dbapi.DatabaseError, dbapi.Error)


def test_fetchall_and_description(conn):
    cur = conn.cursor()
    cur.execute("select n_nationkey, n_name from nation "
                "where n_nationkey < 3 order by n_nationkey")
    assert [d[0] for d in cur.description] == ["n_nationkey", "n_name"]
    # PEP 249 type-object protocol: singletons compare against type codes
    assert dbapi.NUMBER == cur.description[0][1]
    assert dbapi.STRING == cur.description[1][1]
    assert not (dbapi.DATETIME == cur.description[0][1])
    rows = cur.fetchall()
    assert len(rows) == 3 and rows[0][0] == 0
    assert cur.rowcount == 3
    assert all(isinstance(r, tuple) for r in rows)


def test_fetchone_fetchmany_iteration(conn):
    cur = conn.cursor()
    cur.execute("select n_nationkey from nation order by n_nationkey")
    assert cur.fetchone() == (0,)
    assert cur.fetchmany(3) == [(1,), (2,), (3,)]
    rest = list(cur)
    assert rest[0] == (4,) and len(rest) == 21
    assert cur.fetchone() is None


def test_qmark_parameters(conn):
    cur = conn.cursor()
    cur.execute("select n_name from nation where n_nationkey = ? or n_name = ?", (7, "CANADA"))
    got = sorted(r[0] for r in cur.fetchall())
    assert got == ["CANADA", "GERMANY"]


def test_parameter_rendering_edge_cases():
    sub = dbapi.substitute_params
    assert sub("select ?", (None,)) == "select NULL"
    assert sub("select ?", (True,)) == "select true"
    assert sub("select ?", ("it's",)) == "select 'it''s'"
    # placeholders inside string literals / comments are NOT substituted
    assert sub("select '?' , ?", (1,)) == "select '?' , 1"
    assert sub("select 1 -- ?\n, ?", (2,)) == "select 1 -- ?\n, 2"
    assert sub("select /* ? */ 1, ?", (2,)) == "select /* ? */ 1, 2"
    assert sub("select ?", (datetime.date(1995, 6, 17),)) == "select date '1995-06-17'"
    assert sub("select ?", (datetime.datetime(2020, 1, 1, 0, 0, 0, 500000),)) \
        == "select timestamp '2020-01-01 00:00:00.500000'"
    assert sub("select ?", (datetime.time(12, 30, 5),)) == "select time '12:30:05'"
    with pytest.raises(dbapi.ProgrammingError):
        sub("select ?, ?", (1,))
    with pytest.raises(dbapi.ProgrammingError):
        sub("select ?", (1, 2))


SUBSTITUTIONS = [
    ("select ?", (None,)),
    ("select ?", (True,)),
    ("select ?", (False,)),
    ("select ?", ("it's",)),
    ("select '?' , ?", (1,)),
    ("select 1 -- ?\n, ?", (2,)),
    ("select 1 -- ?", ()),
    ("select /* ? */ 1, ?", (2,)),
    ("select /* ? unterminated", ()),
    ("select 'a''?b', ?", (3,)),
    ("select ?", (datetime.date(1995, 6, 17),)),
    ("select ?", (datetime.datetime(2020, 1, 1, 0, 0, 0, 500000),)),
    ("select ?", (datetime.datetime(2020, 1, 1, 12, 0, 0),)),
    ("select ?", (datetime.time(12, 30, 5),)),
    ("select ?, ?", (1.5, -7)),
    ("select ?", (decimal.Decimal("12.340"),)),
    ("select ?", ([1, "x", None],)),
    ("select ?", ((datetime.date(2001, 2, 3),),)),
    ("select n_name from nation where n_nationkey = ? or n_name = ?", (7, "CANADA")),
    ("select ?", None),
    ("select ?, ?", (1,)),
    ("select ?", (1, 2)),
    ("select ?", (object(),)),
]


@pytest.mark.parametrize("i", range(len(SUBSTITUTIONS)))
def test_substitute_params_equal_reference(i):
    sql, params = SUBSTITUTIONS[i]

    def render(mod):
        try:
            return "sql", mod.substitute_params(sql, params)
        except mod.ProgrammingError as e:
            return "ProgrammingError", str(e)
    assert render(dbapi) == render(ref_dbapi)


def test_query_error_maps_to_programming_error(conn):
    cur = conn.cursor()
    with pytest.raises(dbapi.ProgrammingError):
        cur.execute("select definitely_not_a_column from nation")
        cur.fetchall()


def test_closed_state_checks(conn):
    cur = conn.cursor()
    with pytest.raises(dbapi.ProgrammingError):
        cur.fetchall()  # nothing executed
    cur.close()
    with pytest.raises(dbapi.InterfaceError):
        cur.execute("select 1")
    c2 = dbapi.connect(host="localhost", port=1)
    c2.close()
    with pytest.raises(dbapi.InterfaceError):
        c2.cursor()


def test_rollback_not_supported(conn):
    with pytest.raises(dbapi.NotSupportedError):
        conn.rollback()
    conn.commit()  # autocommit no-op


def test_catalog_schema_scoping(server):
    # connection-level schema: unqualified table names resolve through it
    conn = dbapi.connect(host="localhost", port=server.port, catalog="tpch", schema="tiny")
    cur = conn.cursor()
    cur.execute("select count(*) from region")
    assert cur.fetchall() == [(5,)]
    # a bogus schema must fail, proving the header actually scopes the query
    bad = dbapi.connect(host="localhost", port=server.port, catalog="tpch",
                        schema="no_such_schema")
    with pytest.raises(dbapi.Error):
        bad.cursor().execute("select count(*) from region").fetchall()


def test_scoped_runner_shares_the_engine(server):
    """A header-scoped copy of the runner has its own session and shares the
    engine's device, catalogs and metadata; the engine's own session is
    untouched."""
    from presto_tpu_torch.server.protocol import QueryInfo

    mgr = server.manager
    scoped = mgr._scoped_runner(QueryInfo("q-scope", "select 1", catalog="tpch",
                                          schema="sf1"))
    assert scoped is not mgr.runner
    assert (scoped.session.catalog, scoped.session.schema) == ("tpch", "sf1")
    assert mgr.runner.session.schema == "tiny"
    assert scoped.device == mgr.runner.device
    assert scoped.catalogs is mgr.runner.catalogs and scoped.metadata is mgr.runner.metadata
    assert mgr._scoped_runner(QueryInfo("q-plain", "select 1")) is mgr.runner


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_pipe(base, capsys, monkeypatch):
    from presto_tpu_torch.cli import main

    monkeypatch.setattr("sys.stdin", io.StringIO(
        "select n_name from nation where n_nationkey = 0;"))
    rc = main(["--server", base])
    out = capsys.readouterr().out
    assert rc == 0
    assert "ALGERIA" in out
    assert "(1 row)" in out


def test_cli_semicolon_in_literal():
    from presto_tpu_torch.cli import split_statements, statement_complete

    assert split_statements("select 'a;b' from t; select 2") == \
        ["select 'a;b' from t", " select 2"]
    assert split_statements("select 'it''s; fine';") == ["select 'it''s; fine'"]
    assert statement_complete("select 'a;b';")
    assert not statement_complete("select 'a;b")
    assert not statement_complete("select 1")


def test_cli_execute_csv(base, capsys):
    from presto_tpu_torch.cli import main

    rc = main(["--server", base, "--output-format", "csv",
               "-e", "select n_nationkey, n_name from nation "
                     "where n_nationkey < 2 order by 1"])
    out = capsys.readouterr().out
    assert rc == 0
    assert out.splitlines()[0] == "n_nationkey,n_name"
    assert out.splitlines()[1] == "0,ALGERIA"


def test_cli_formats_equal_reference():
    """``format_aligned`` and ``format_csv`` render the same text as the
    reference's for the same rows."""
    from presto_tpu.cli import format_aligned as ref_aligned
    from presto_tpu.cli import format_csv as ref_csv
    from presto_tpu_torch.cli import format_aligned, format_csv

    cols = ["k", "name", "price"]
    rows = [[1, "a,b", "1.50"], [None, "it's", None], [22, "", "-3.00"]]
    assert format_aligned(cols, rows) == ref_aligned(cols, rows)
    assert format_aligned(cols, rows[:1]) == ref_aligned(cols, rows[:1])
    assert format_csv(cols, rows) == ref_csv(cols, rows)
