"""The port's remote-service connector (``presto_tpu_torch/connectors/remote``)
against presto_tpu on the CPU.

One ``RemoteTestingService`` of each package (module-scoped, stopped when
the module ends) serves the same seeded tables. The cases of
``tests/test_remote_connector.py`` run through a runner of each package:
equal rows and, per statement, an equal number of requests served (the
same metadata calls, split batches, row batches and continuation tokens).
A client fails over past a dead endpoint in both. The port's batch
conversion (``RemotePageSource._page``) gives the reference's values,
NULL flags and errors on the same batch. Every HTTP call has a timeout.
"""
import numpy as np
import pytest

from presto_tpu.block import Dictionary as RefDictionary
from presto_tpu.connectors import remote as ref_remote
from presto_tpu.metadata import CatalogManager as RefCatalogs
from presto_tpu.metadata import Session as RefSession
from presto_tpu.runner import LocalQueryRunner as RefRunner
from presto_tpu.spi.connector import ColumnHandle as RefColumn
from presto_tpu.spi.connector import Split as RefSplit
from presto_tpu.types import parse_type as ref_type
from presto_tpu.utils.testing import SqliteOracle
from presto_tpu_torch.block import Dictionary
from presto_tpu_torch.connectors import remote
from presto_tpu_torch.metadata import CatalogManager, Session
from presto_tpu_torch.runner import LocalQueryRunner
from presto_tpu_torch.spi.connector import ColumnHandle, Split
from presto_tpu_torch.types import parse_type
from test_torch_sql import assert_same_rows

TIMEOUT_S = 10.0
DEAD = "http://127.0.0.1:1"  # nothing listens on port 1 of this host


def _tables():
    """The reference test's ``sales.orders`` (1,000 rows, NULLs in a varchar
    and a bigint column) and ``sales.tiny``."""
    rng = np.random.default_rng(7)
    n = 1000
    orders = (
        [("o_id", "bigint"), ("o_total", "double"), ("o_status", "varchar"),
         ("o_region", "varchar"), ("o_discount", "bigint")],
        {"o_id": list(range(n)),
         "o_total": [round(float(x), 2) for x in rng.uniform(1, 1000, n)],
         "o_status": [["OPEN", "SHIPPED", "DONE"][i % 3] for i in range(n)],
         "o_region": [None if i % 10 == 0 else ["east", "west"][i % 2] for i in range(n)],
         "o_discount": [None if i % 7 == 0 else int(i % 5) for i in range(n)]})
    return {("sales", "orders"): orders, ("sales", "tiny"): ([("k", "bigint")], {"k": [1, 2, 3]})}


@pytest.fixture(scope="module")
def services():
    """{"ref": (service, endpoint), "port": (service, endpoint)}."""
    out = {}
    try:
        for key, pkg in (("ref", ref_remote), ("port", remote)):
            svc = pkg.RemoteTestingService(rows_per_batch=100, n_splits=3)
            for (schema, table), (cols, data) in _tables().items():
                svc.add_table(schema, table, cols, data)
            out[key] = (svc, svc.start())
        yield out
    finally:
        for svc, _ep in out.values():
            svc.stop()


def _runners(services, endpoints=None):
    """(reference runner, port runner) with an ``svc`` catalog over each
    package's service (``endpoints``: extra endpoints tried first)."""
    pre = list(endpoints or [])
    ref_cat, port_cat = RefCatalogs(), CatalogManager()
    ref_cat.register("svc", ref_remote.RemoteConnector(
        "svc", pre + [services["ref"][1]], timeout_s=TIMEOUT_S))
    port_cat.register("svc", remote.RemoteConnector(
        "svc", pre + [services["port"][1]], timeout_s=TIMEOUT_S))
    return (RefRunner(session=RefSession(catalog="svc", schema="sales"), catalogs=ref_cat),
            LocalQueryRunner(Session(catalog="svc", schema="sales"), catalogs=port_cat,
                             device="cpu"))


def _run_counted(services, runners, sql):
    """Each runner's rows and the requests its service served for ``sql``."""
    out = []
    for key, r in zip(("ref", "port"), runners):
        svc = services[key][0]
        before = svc.request_count
        out.append((r.execute(sql), svc.request_count - before))
    return out


REMOTE_SQL = [
    "show tables",
    "show columns from orders",
    "select o_status, count(*) as c, sum(o_total) as s from orders where o_total > 100 "
    "group by o_status order by o_status",
    "select o_region, sum(o_discount) as d, count(o_discount) as c from orders "
    "group by o_region order by o_region nulls first",
    "select a.o_status, count(*) as c from orders a join orders b on a.o_id = b.o_id "
    "group by a.o_status order by a.o_status",
    "select count(*) from orders",
    "select sum(k) from tiny",
    "select o_id, o_total, o_status, o_region, o_discount from orders "
    "where o_id % 97 = 3 order by o_id",
]


@pytest.mark.parametrize("sql", REMOTE_SQL, ids=range(len(REMOTE_SQL)))
def test_remote_queries_equal_reference(services, sql):
    """The cases of ``tests/test_remote_connector.py``: rows and requests."""
    (want, want_n), (got, got_n) = _run_counted(services, _runners(services), sql)
    assert got.column_names == want.column_names
    assert_same_rows(got.rows, want.rows)
    assert got_n == want_n


def test_rows_equal_the_sqlite_oracle(services):
    _ref, port = _runners(services)
    cols, data = _tables()[("sales", "orders")]
    oracle = SqliteOracle()
    names = [n for n, _ in cols]
    oracle.conn.execute(f"CREATE TABLE orders ({', '.join(names)})")
    oracle.conn.executemany(f"INSERT INTO orders VALUES ({','.join('?' * len(names))})",
                            list(zip(*(data[c] for c in names))))
    oracle.conn.commit()
    for sql in REMOTE_SQL[2:5]:
        assert_same_rows(port.execute(sql).rows, [list(r) for r in oracle.query(
            sql.replace(" nulls first", ""))])


def test_continuation_tokens_exercised(services):
    """rows_per_batch=100 over ~333-row split ranges: four row batches per
    split and two split batches (two splits per call, three splits)."""
    svc = services["port"][0]
    _ref, port = _runners(services)
    calls = dict(svc.calls)
    assert port.execute("select count(*) from orders").rows == [[1000]]
    delta = {k: v - calls.get(k, 0) for k, v in svc.calls.items()}
    assert delta["splits"] == 2 and delta["rows"] == 12
    assert svc.request_count >= 10


def test_failover_to_live_endpoint(services):
    for key, pkg in (("ref", ref_remote), ("port", remote)):
        client = pkg.RemoteClient([DEAD, services[key][1]], timeout_s=TIMEOUT_S)
        assert client.call("list_schemas") == ["sales"]
        assert client.call("list_schemas") == ["sales"]  # the live host now comes first
    (want, want_n), (got, got_n) = _run_counted(
        services, _runners(services, [DEAD]), "select sum(k) from tiny")
    assert got.rows == want.rows == [[6]] and got_n == want_n
    with pytest.raises(ConnectionError, match="no remote endpoint reachable"):
        remote.RemoteClient([DEAD], timeout_s=TIMEOUT_S).call("list_schemas")
    with pytest.raises(RuntimeError, match="remote service error"):
        remote.RemoteClient([services["port"][1]], timeout_s=TIMEOUT_S).call("bogus")


def _batches():
    """(column type texts, {name: values}) batches of every kind."""
    rng = np.random.default_rng(11)
    n = 50
    return [
        ({"a": "bigint", "b": "double", "c": "boolean", "d": "varchar", "e": "real",
          "f": "date", "g": "integer"},
         {"a": [None if i % 7 == 0 else int(v) for i, v in enumerate(rng.integers(-9, 9, n))],
          "b": [None if i % 5 == 0 else [float(v), int(v)][i % 2]
                for i, v in enumerate(rng.normal(0, 100, n))],
          "c": [[True, False, None, 0, 1, "x", ""][i % 7] for i in range(n)],
          "d": [None if i % 4 == 0 else ["p", "q", 3][i % 3] for i in range(n)],
          "e": [float(v) for v in rng.normal(0, 1, n)],
          "f": [int(v) for v in rng.integers(0, 20000, n)],
          "g": [None] * n}),
        ({"a": "bigint", "b": "double"}, {"a": ["7", 2.9, True], "b": ["1.5", None, 3]}),
    ]


@pytest.mark.parametrize("i", range(2))
def test_page_conversion_equals_reference(i):
    types, cols = _batches()[i]
    n = len(next(iter(cols.values())))
    words = ["3", "p", "q"]
    ref_src = ref_remote.RemotePageSource(
        None, RefSplit("svc", ("s", "t", "id")),
        [RefColumn("svc", k, ref_type(t)) for k, t in types.items()], 64,
        {k: RefDictionary(words) for k, t in types.items() if t == "varchar"})
    port_src = remote.RemotePageSource(
        None, Split("svc", ("s", "t", "id")),
        [ColumnHandle("svc", k, parse_type(t)) for k, t in types.items()], 64,
        {k: Dictionary(words) for k, t in types.items() if t == "varchar"})
    want, got = ref_src._page(cols, n), port_src._page(cols, n)
    for k, wb, gb in zip(types, want.blocks, got.blocks):
        wd, gd = np.asarray(wb.data)[:n], gb.data.numpy()[:n]
        assert gd.dtype == wd.dtype and gd.tobytes() == wd.tobytes(), k
        assert (gb.nulls is None) == (wb.nulls is None), k
        if wb.nulls is not None:
            assert gb.nulls.numpy()[:n].tolist() == np.asarray(wb.nulls)[:n].tolist(), k
    assert got.mask.numpy().tolist()[:n] == [True] * n and not got.mask.numpy()[n:].any()


def test_page_conversion_errors_equal_reference():
    errors = []
    for pkg, col, ptype, dictionary, split in (
            (ref_remote, RefColumn, ref_type, RefDictionary, RefSplit),
            (remote, ColumnHandle, parse_type, Dictionary, Split)):
        src = pkg.RemotePageSource(None, split("svc", ("s", "t", "id")),
                                   [col("svc", "d", ptype("varchar"))], 8, {"d": dictionary(["a"])})
        with pytest.raises(ValueError) as e:
            src._page({"d": ["a", None, "zz"]}, 3)
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "'zz' not in the plan-time dictionary" in errors[1]
