"""The port's server, client and proxy against presto_tpu, on the CPU
(``tests/test_server.py`` and ``tests/test_proxy.py``; the CLI's tests are in
``tests/test_torch_dbapi.py``).

Each reference test runs against the port's ``PrestoTpuServer`` over
``LocalQueryRunner(device="cpu")`` at ``tiny``. The same statements sent
through both packages' servers (``page_rows=7``, so ``nextUri`` pages
several times) give equal final ``columns`` (names and type names), equal
``data`` and ``stats.state``, and the same ``error.errorType`` for a failing
statement. DOUBLE values are held to ``DOUBLE_REL_TOL`` relative; DECIMAL
(as its text), DATE, VARCHAR and integer values must be exact. The web UI
page is the reference's, byte for byte.
"""
import base64
import json
import math
import os
import time
import urllib.error
import urllib.request

import pytest

from presto_tpu.metadata import Session as RefSession
from presto_tpu.runner import LocalQueryRunner as RefRunner
from presto_tpu.server import PrestoTpuServer as RefServer
from presto_tpu_torch.client import QueryError, StatementClient, execute
from presto_tpu_torch.metadata import Session
from presto_tpu_torch.models.tpch_sql import QUERIES
from presto_tpu_torch.runner import LocalQueryRunner
from presto_tpu_torch.server import PrestoTpuServer
from presto_tpu_torch.server.proxy import ProxyServer

DOUBLE_REL_TOL = 1e-12
PAYLOAD_SQL = {"Q1": QUERIES[1], "Q3": QUERIES[3], "Q6": QUERIES[6], "Q9": QUERIES[9],
               "error": "select no_such_column from nation"}


def _runner():
    return LocalQueryRunner(session=Session(catalog="tpch", schema="tiny"), device="cpu")


@pytest.fixture(scope="module")
def server():
    srv = PrestoTpuServer(_runner(), port=0, page_rows=7)
    srv.start()
    yield srv
    srv.stop()


@pytest.fixture(scope="module")
def ref_server():
    srv = RefServer(RefRunner(session=RefSession(catalog="tpch", schema="tiny")), port=0,
                    page_rows=7)
    srv.start()
    yield srv
    srv.stop()


@pytest.fixture()
def base(server):
    return f"http://localhost:{server.port}"


def test_statement_roundtrip(base):
    rows = execute(base, "select n_nationkey, n_name from nation "
                         "where n_regionkey = 1 order by n_nationkey")
    assert len(rows) == 5
    assert rows[0][1] == "ARGENTINA"


def test_next_uri_paging(base):
    client = StatementClient(base, "select n_nationkey from nation order by n_nationkey")
    rows = list(client.rows())  # 25 rows at page_rows=7 -> 4 pages
    assert [r[0] for r in rows] == list(range(25))
    assert client.columns[0].name == "n_nationkey"
    assert client.stats["state"] == "FINISHED"


def test_query_error_propagates(base):
    with pytest.raises(QueryError, match="does not exist|cannot be resolved"):
        execute(base, "select * from no_such_table")


def test_info_and_query_listing(base):
    execute(base, "select 1")
    with urllib.request.urlopen(f"{base}/v1/info") as r:
        info = json.loads(r.read())
    assert info["coordinator"] is True
    with urllib.request.urlopen(f"{base}/v1/query") as r:
        queries = json.loads(r.read())
    assert any(q["state"] == "FINISHED" for q in queries)


def test_aggregate_over_http(base):
    rows = execute(base, "select count(*), sum(o_totalprice) from orders")
    assert rows[0][0] == 15000


def test_cancel_is_an_error_to_clients(base, server):
    # cancel right after submit: the protocol must surface QueryCanceled,
    # never a silent truncated result
    info = server.manager.submit("select count(*) from lineitem")
    assert server.manager.cancel(info.query_id)
    payload = server.manager.results_payload(info, 0, base)
    for _ in range(100):
        if payload.get("error") or payload["stats"]["state"] == "CANCELED":
            break
        time.sleep(0.05)
        payload = server.manager.results_payload(info, 0, base)
    assert info.state == "CANCELED"
    assert payload["error"]["errorType"] == "QueryCanceled"


def test_done_query_eviction():
    from presto_tpu_torch.server.protocol import QueryManager

    mgr = QueryManager(LocalQueryRunner(device="cpu"), max_done_queries=2)
    ids = []
    for _ in range(4):
        info = mgr.submit("select 1")
        ids.append(info.query_id)
        for _ in range(200):
            if info.done():
                break
            time.sleep(0.02)
    mgr.close()
    assert mgr.get(ids[0]) is None  # oldest done queries evicted
    assert mgr.get(ids[-1]) is not None


# ---------------------------------------------------------------------------
# password authentication
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def auth_server(tmp_path_factory):
    from presto_tpu_torch.security import FileBasedPasswordAuthenticator, hash_password

    pw_file = tmp_path_factory.mktemp("auth") / "password.db"
    pw_file.write_text(f"alice:{hash_password('wonderland')}\nbob:plain:builder\n")
    srv = PrestoTpuServer(_runner(), port=0,
                          authenticator=FileBasedPasswordAuthenticator(str(pw_file)))
    srv.start()
    yield srv
    srv.stop()


def test_unauthenticated_statement_rejected(auth_server):
    req = urllib.request.Request(f"http://localhost:{auth_server.port}/v1/statement",
                                 data=b"select 1", method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 401
    assert e.value.headers.get("WWW-Authenticate", "").startswith("Basic")


def test_wrong_password_rejected(auth_server):
    client = StatementClient(f"http://localhost:{auth_server.port}", "select 1",
                             user="alice", password="nope")
    with pytest.raises(urllib.error.HTTPError) as e:
        list(client.rows())
    assert e.value.code == 401


def test_authenticated_query_runs(auth_server):
    for user, pw in (("alice", "wonderland"), ("bob", "builder")):
        client = StatementClient(f"http://localhost:{auth_server.port}",
                                 "select count(*) from nation", user=user, password=pw)
        assert list(client.rows()) == [[25]]


def test_principal_mismatch_rejected(auth_server):
    cred = base64.b64encode(b"alice:wonderland").decode()
    req = urllib.request.Request(f"http://localhost:{auth_server.port}/v1/statement",
                                 data=b"select 1", method="POST")
    req.add_header("Authorization", f"Basic {cred}")
    req.add_header("X-Presto-User", "mallory")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 403


def test_web_ui_served(base):
    html = urllib.request.urlopen(f"{base}/ui", timeout=30).read().decode()
    assert "presto-tpu" in html and "/v1/cluster" in html
    # the root serves the dashboard too
    root = urllib.request.urlopen(f"{base}/", timeout=30).read().decode()
    assert "presto-tpu" in root


def test_web_ui_byte_identical_to_reference(base):
    import presto_tpu.server as ref_pkg

    with open(os.path.join(os.path.dirname(ref_pkg.__file__), "webui.html"), "rb") as f:
        want = f.read()
    assert urllib.request.urlopen(f"{base}/ui", timeout=30).read() == want


def test_trace_token_threads_through(base):
    """X-Presto-Trace-Token reaches the query's record."""
    req = urllib.request.Request(
        f"{base}/v1/statement", data=b"select 1",
        headers={"X-Presto-User": "t", "X-Presto-Trace-Token": "trace-42"})
    resp = json.loads(urllib.request.urlopen(req, timeout=10).read())
    qid = resp["id"]
    deadline = time.time() + 60
    while resp.get("nextUri") and time.time() < deadline:
        resp = json.loads(urllib.request.urlopen(urllib.request.Request(
            resp["nextUri"], headers={"X-Presto-User": "t"}), timeout=10).read())
    queries = json.loads(urllib.request.urlopen(urllib.request.Request(
        f"{base}/v1/query", headers={"X-Presto-User": "t"}), timeout=10).read())
    mine = [q for q in queries if q["queryId"] == qid]
    assert mine and mine[0]["traceToken"] == "trace-42"


# ---------------------------------------------------------------------------
# payloads equal to the reference server's
# ---------------------------------------------------------------------------

def _payloads(port: int, sql: str) -> list:
    """Every QueryResults payload of ``sql``, POST then each ``nextUri``."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/statement",
                                 data=sql.encode(), method="POST")
    out = [json.loads(urllib.request.urlopen(req, timeout=60).read())]
    deadline = time.monotonic() + 300
    while out[-1].get("nextUri"):
        assert time.monotonic() < deadline, "the statement never finished"
        if out[-1]["stats"]["state"] in ("QUEUED", "RUNNING"):
            time.sleep(0.02)
        out.append(json.loads(urllib.request.urlopen(out[-1]["nextUri"], timeout=60).read()))
    return out


def _assert_same_values(got, want, where):
    assert len(got) == len(want), (where, got, want)
    for g, w in zip(got, want):
        if isinstance(g, float) or isinstance(w, float):
            assert type(g) is type(w) and math.isclose(g, w, rel_tol=DOUBLE_REL_TOL), \
                (where, got, want)
        else:
            assert type(g) is type(w) and g == w, (where, got, want)


@pytest.mark.parametrize("label", sorted(PAYLOAD_SQL))
def test_payloads_equal_reference(server, ref_server, label):
    sql = PAYLOAD_SQL[label]
    got, want = _payloads(server.port, sql), _payloads(ref_server.port, sql)
    assert got[-1]["stats"]["state"] == want[-1]["stats"]["state"]
    if label == "error":
        assert got[-1]["stats"]["state"] == "FAILED"
        assert got[-1]["error"]["errorType"] == want[-1]["error"]["errorType"]
        return
    assert got[-1]["stats"]["state"] == "FINISHED"
    assert got[-1]["columns"] == want[-1]["columns"]
    pages = [p["data"] for p in got if "data" in p]
    ref_pages = [p["data"] for p in want if "data" in p]
    assert [len(p) for p in pages] == [len(p) for p in ref_pages]
    assert all(len(p) <= 7 for p in pages)
    rows = [r for p in pages for r in p]
    ref_rows = [r for p in ref_pages for r in p]
    assert rows, "no rows to compare"
    for i, (g, w) in enumerate(zip(rows, ref_rows)):
        _assert_same_values(g, w, f"{label} row {i}")


def test_json_rows_hold_host_values_only():
    """Tensors and numpy scalars in a row become JSON values, never tensors."""
    import datetime
    import decimal

    import numpy as np
    import torch

    from presto_tpu.server.protocol import QueryManager as RefManager
    from presto_tpu_torch.server.protocol import QueryManager

    row = [decimal.Decimal("1.50"), datetime.date(1995, 3, 15), np.int64(7),
           np.float64(0.25), "x", None, True]
    assert QueryManager._to_json_row(row) == RefManager._to_json_row(row)
    got = QueryManager._to_json_row([torch.tensor(7), torch.tensor(0.5, dtype=torch.float64)])
    assert got == [7, 0.5] and [type(v) for v in got] == [int, float]
    json.dumps(got)


# ---------------------------------------------------------------------------
# the proxy
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stack():
    srv = PrestoTpuServer(_runner(), port=0, page_rows=5)
    srv.start()
    proxy = ProxyServer(f"http://127.0.0.1:{srv.port}", port=0).start()
    yield proxy
    proxy.stop()
    srv.stop()


def _fetch(url, method="GET", data=None):
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"X-Presto-User": "proxied"})
    with urllib.request.urlopen(req, timeout=15) as resp:
        return json.loads(resp.read())


def test_statement_through_proxy_rewrites_uris(stack):
    base = f"http://127.0.0.1:{stack.port}"
    resp = _fetch(f"{base}/v1/statement", method="POST",
                  data=b"select n_name from nation where n_regionkey = 2 order by n_name")
    rows = list(resp.get("data") or [])
    deadline = time.time() + 120
    while resp.get("nextUri"):
        # every URI the client sees points at the proxy
        assert resp["nextUri"].startswith(base), resp["nextUri"]
        resp = _fetch(resp["nextUri"])
        rows.extend(resp.get("data") or [])
        assert time.time() < deadline, "query did not finish through proxy"
        if resp.get("stats", {}).get("state") == "QUEUED":
            time.sleep(0.05)
    assert [r[0] for r in rows] == ["CHINA", "INDIA", "INDONESIA", "JAPAN", "VIETNAM"]


def test_proxy_passes_info(stack):
    info = _fetch(f"http://127.0.0.1:{stack.port}/v1/info")
    assert "nodeVersion" in info


def test_proxy_404_outside_api(stack):
    with pytest.raises(urllib.error.HTTPError) as e:
        _fetch(f"http://127.0.0.1:{stack.port}/etc/passwd")
    assert e.value.code == 404


def test_proxy_backend_down_is_502():
    proxy = ProxyServer("http://127.0.0.1:1", port=0).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _fetch(f"http://127.0.0.1:{proxy.port}/v1/info")
        assert e.value.code == 502
    finally:
        proxy.stop()
