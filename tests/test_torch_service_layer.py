"""The port's service layer against presto_tpu, on the CPU: resource groups,
the query manager's events, ``etc/`` configuration, plugins and catalog
loading (the server-side tests of ``tests/test_service_layer.py``,
``TestMemoryAwareAdmission`` and the concurrent differential of
``tests/test_serving.py``, and ``tests/test_plugin_loading.py``).

Catalog equality: one ``etc/`` directory names every connector factory of
the port (``tpch``, ``tpcds``, ``memory``, ``blackhole``, ``file``, ``hive``,
``raptor``, ``sqlite``, ``kafka``, ``remote``); both packages'
``load_catalogs`` give the same catalog names, and one small query per
catalog gives equal rows. DOUBLE is held to ``DOUBLE_REL_TOL`` relative;
DECIMAL, DATE, VARCHAR and integer values must be exact.
"""
import json
import math
import os
import sqlite3
import textwrap
import threading
import time

import pytest

from presto_tpu.connectors.remote import RemoteTestingService
from presto_tpu.runner import LocalQueryRunner as RefRunner
from presto_tpu.server import config as ref_config
from presto_tpu_torch.metadata import Session
from presto_tpu_torch.models.tpch_sql import QUERIES
from presto_tpu_torch.runner import LocalQueryRunner
from presto_tpu_torch.server import config as C
from presto_tpu_torch.server.protocol import FINISHED, QueryManager
from presto_tpu_torch.server.resource_groups import (GroupSpec, QueryRejected,
                                                     ResourceGroupManager, SelectorSpec)
from presto_tpu_torch.spi.eventlistener import EventListener, QueryMonitor

DOUBLE_REL_TOL = 1e-12
MIX = [1, 3, 6]


def _cpu_runner(**kw):
    return LocalQueryRunner(device="cpu", **kw)


# ------------------------------------------------------------ resource groups

def test_concurrency_limit_queues_then_admits():
    rg = ResourceGroupManager(GroupSpec("root", hard_concurrency_limit=1, max_queued=10))
    t1 = rg.submit("q1")
    assert t1.admitted.is_set()
    admitted = []

    def second():
        admitted.append(rg.submit("q2", timeout_s=10))

    th = threading.Thread(target=second)
    th.start()
    time.sleep(0.1)
    assert not admitted  # queued behind q1
    rg.finish(t1)
    th.join(5)
    assert admitted and admitted[0].admitted.is_set()
    rg.finish(admitted[0])
    assert rg.stats()["root"] == (0, 0)


def test_queue_full_rejects():
    rg = ResourceGroupManager(GroupSpec("root", hard_concurrency_limit=1, max_queued=0))
    t1 = rg.submit("q1")
    with pytest.raises(QueryRejected, match="Too many queued"):
        rg.submit("q2")
    rg.finish(t1)


def test_selectors_route_to_subgroups():
    spec = GroupSpec("root", hard_concurrency_limit=10, sub_groups=[
        GroupSpec("etl", hard_concurrency_limit=1, max_queued=5),
        GroupSpec("adhoc", hard_concurrency_limit=5),
    ])
    rg = ResourceGroupManager(spec, selectors=[
        SelectorSpec(group="root.etl", source_regex="etl-.*"),
        SelectorSpec(group="root.adhoc"),
    ])
    a = rg.submit("q1", user="u", source="etl-nightly")
    assert a.group.name == "root.etl"
    b = rg.submit("q2", user="u", source="cli")
    assert b.group.name == "root.adhoc"
    # etl is at its limit of 1; adhoc still admits
    c = rg.submit("q3", user="u", source="cli")
    assert c.admitted.is_set()
    for tk in (a, b, c):
        rg.finish(tk)


def test_cpu_quota_blocks_admission():
    rg = ResourceGroupManager(GroupSpec("root", cpu_quota_per_s=0.5))
    t1 = rg.submit("q1")
    rg.finish(t1, cpu_seconds=100.0)  # burn far past the quota
    t_start = time.monotonic()
    with pytest.raises(QueryRejected):
        rg.submit("q2", timeout_s=0.3)
    assert time.monotonic() - t_start >= 0.25  # waited, then timed out


def test_unknown_selector_group_is_a_config_error():
    rg = ResourceGroupManager(GroupSpec("root"), selectors=[SelectorSpec(group="root.nope")])
    with pytest.raises(ValueError, match="unknown group"):
        rg.submit("q1")


class TestMemoryAwareAdmission:
    def test_admission_gated_on_memory_then_promotes(self):
        usage = {"bytes": 10 << 20}
        mgr = ResourceGroupManager(GroupSpec("root", 10, 10), memory_limit_bytes=1 << 20,
                                   memory_fn=lambda: usage["bytes"])
        admitted = []

        def submit():
            admitted.append(mgr.submit("q2", timeout_s=10.0))

        th = threading.Thread(target=submit)
        th.start()
        time.sleep(0.3)
        assert not admitted, "admitted while pool was over the memory limit"
        usage["bytes"] = 0  # tenants released: the next promotion tick admits
        th.join(timeout=15)
        assert admitted, "queued query never promoted after memory freed"
        mgr.finish(admitted[0])

    def test_memory_ok_defaults_to_shared_pool(self):
        from presto_tpu_torch.memory import shared_general_pool

        pool = shared_general_pool()
        mgr = ResourceGroupManager(GroupSpec("root", 10, 10), memory_limit_bytes=1 << 60)
        assert mgr._memory_fn == pool.reserved_bytes
        ticket = mgr.submit("q1")
        mgr.finish(ticket)
        assert pool.query_bytes("q1") == 0 and pool.spill_by_query() == {}


# ------------------------------------------------------- events + query manager

class _Recorder(EventListener):
    def __init__(self):
        self.created = []
        self.completed = []

    def query_created(self, e):
        self.created.append(e)

    def query_completed(self, e):
        self.completed.append(e)


class _Exploder(EventListener):
    def query_created(self, e):
        raise RuntimeError("bad listener")


def _wait_done(info, timeout=120):
    deadline = time.time() + timeout
    while not info.done() and time.time() < deadline:
        time.sleep(0.02)
    assert info.done()


def test_query_manager_emits_events_and_isolates_listener_errors():
    rec = _Recorder()
    mgr = QueryManager(_cpu_runner(), monitor=QueryMonitor([_Exploder(), rec]))
    try:
        info = mgr.submit("select 1", user="alice")
        _wait_done(info)
        assert info.state == "FINISHED"
        assert [e.query_id for e in rec.created] == [info.query_id]
        assert rec.completed[0].state == "FINISHED"
        assert rec.completed[0].user == "alice"
        assert rec.completed[0].row_count == 1

        info2 = mgr.submit("select bogus_column from nation")
        _wait_done(info2)
        assert rec.completed[1].state == "FAILED"
        assert rec.completed[1].error is not None
    finally:
        mgr.close()


class _TxConnector:
    def __init__(self):
        self.calls = []

    def begin_transaction(self, tid):
        self.calls.append(("begin", tid))

    def commit_transaction(self, tid):
        self.calls.append(("commit", tid))

    def rollback_transaction(self, tid):
        self.calls.append(("rollback", tid))


def test_query_manager_runs_each_query_in_a_transaction():
    """The protocol is the transaction manager's caller: a finished query
    commits, a failed one rolls back, on every catalog."""
    from presto_tpu_torch.transaction import TransactionManager

    runner = _cpu_runner()
    hooks = _TxConnector()
    real = runner.catalogs.get

    class _Catalogs:
        def names(self):
            return ["tpch"]

        def connector(self, name):
            return hooks if name == "tpch" else real(name)

    tm = TransactionManager(_Catalogs())
    mgr = QueryManager(runner, transactions=tm)
    try:
        ok = mgr.submit("select count(*) from nation")
        _wait_done(ok)
        bad = mgr.submit("select bogus_column from nation")
        _wait_done(bad)
    finally:
        mgr.close()
    assert (ok.state, bad.state) == ("FINISHED", "FAILED")
    assert [c[0] for c in hooks.calls] == ["begin", "commit", "begin", "rollback"]
    assert tm.active_transactions() == []


def test_server_wires_listeners_and_transactions():
    from presto_tpu_torch.server import PrestoTpuServer

    rec = _Recorder()
    srv = PrestoTpuServer(_cpu_runner(), port=0, listeners=[rec])
    srv.start()
    try:
        assert srv.manager.monitor is not None and srv.manager.transactions is not None
        assert sorted(srv.manager.transactions.catalog_names()) == \
            ["blackhole", "memory", "tpcds", "tpch"]
        info = srv.manager.submit("select 1")
        _wait_done(info)
    finally:
        srv.stop()
    assert rec.completed and rec.completed[0].state == "FINISHED"


# ------------------------------------------------------------- config system

def test_etc_config_and_catalog_loading(tmp_path):
    etc = tmp_path / "etc"
    (etc / "catalog").mkdir(parents=True)
    (etc / "config.properties").write_text(
        "# the coordinator\n"
        "http-server.http.port=9090\n"
        "session.catalog=gen\n"
        "session.schema=tiny\n"
        "session.task-concurrency=2\n")
    (etc / "catalog" / "gen.properties").write_text(
        "connector.name=tpch\ntpch.splits-per-node=4\n")
    (etc / "catalog" / "store.properties").write_text(
        f"connector.name=file\nfile.base-dir={tmp_path}/warehouse\n")

    conf = C.load_config(str(etc))
    assert conf == ref_config.load_config(str(etc))
    assert conf["http-server.http.port"] == "9090"
    catalogs = C.load_catalogs(str(etc))
    assert sorted(catalogs.names()) == ["gen", "store"]
    session = C.session_from_config(conf)
    ref_session = ref_config.session_from_config(conf)
    assert (session.user, session.catalog, session.schema, session.properties) == \
        (ref_session.user, ref_session.catalog, ref_session.schema, ref_session.properties)
    assert session.catalog == "gen" and session.schema == "tiny"
    assert session.properties["task_concurrency"] == 2

    r = LocalQueryRunner(session=session, catalogs=catalogs, device="cpu")
    assert r.execute("select count(*) from nation").rows == [[25]]

    with pytest.raises(ValueError, match="unknown connector"):
        (etc / "catalog" / "bad.properties").write_text("connector.name=nope\n")
        C.load_catalogs(str(etc))


def test_parse_properties_equal_reference(tmp_path):
    p = tmp_path / "x.properties"
    p.write_text("# comment\n! bang\n\n a = 1 \nb=two=2\nc=\n")
    assert C.parse_properties(str(p)) == ref_config.parse_properties(str(p))
    p.write_text("no equals sign\n")
    with pytest.raises(ValueError, match="malformed"):
        C.parse_properties(str(p))


def test_register_connector_factory(tmp_path):
    calls = []

    def factory(name, props):
        calls.append((name, dict(props)))
        from presto_tpu_torch.connectors.blackhole import BlackholeConnector
        return BlackholeConnector(name)

    C.register_connector_factory("custom", factory)
    try:
        etc = tmp_path / "etc"
        (etc / "catalog").mkdir(parents=True)
        (etc / "catalog" / "c1.properties").write_text("connector.name=custom\nmy.flag=on\n")
        cats = C.load_catalogs(str(etc))
        assert cats.names() == ["c1"]
        assert calls == [("c1", {"my.flag": "on"})]
    finally:
        C.FACTORIES.pop("custom", None)


def test_factories_name_every_reference_connector():
    assert sorted(C.FACTORIES) == sorted(ref_config.FACTORIES)


# ------------------------------------------------------------------- plugins

PLUGIN_SRC = textwrap.dedent('''
    """Example external plugin: a single-table connector + one function."""
    import torch

    from presto_tpu_torch.block import Block, Page
    from presto_tpu_torch.spi.connector import (
        ColumnMetadata, Connector, ConnectorMetadata, ConnectorPageSource,
        ConnectorPageSourceProvider, ConnectorSplitManager, Constraint, Plugin,
        SchemaTableName, Split, TableHandle, TableMetadata)
    from presto_tpu_torch.types import BIGINT


    class _Meta(ConnectorMetadata):
        def __init__(self, cid):
            self.cid = cid

        def list_schemas(self):
            return ["default"]

        def list_tables(self, schema=None):
            return [SchemaTableName("default", "numbers")]

        def get_table_handle(self, name):
            if name.table == "numbers":
                return TableHandle(self.cid, name)
            return None

        def get_table_metadata(self, table):
            return TableMetadata(table.schema_table, (ColumnMetadata("n", BIGINT),))


    class _Splits(ConnectorSplitManager):
        def __init__(self, cid):
            self.cid = cid

        def get_splits(self, table, constraint, desired_splits):
            return [Split(self.cid, payload=())]


    class _Source(ConnectorPageSource):
        def __iter__(self):
            yield Page((Block(BIGINT, torch.arange(10, dtype=torch.int64)),),
                       torch.ones(10, dtype=torch.bool))


    class _Sources(ConnectorPageSourceProvider):
        def create_page_source(self, split, columns, page_capacity,
                               constraint=Constraint.all()):
            return _Source()


    class DemoConnector(Connector):
        def __init__(self, cid):
            self.cid = cid

        def metadata(self):
            return _Meta(self.cid)

        def split_manager(self):
            return _Splits(self.cid)

        def page_source_provider(self):
            return _Sources()


    def _register_fn():
        from presto_tpu_torch.ops import expressions as ex
        from presto_tpu_torch.ops.expressions import Call
        from presto_tpu_torch.sql.analyzer import register_scalar_function

        def typer(name, args):
            return Call(BIGINT, "demo_fortytwo", tuple(args))
        register_scalar_function("demo_fortytwo", typer)

        def compile_(compiler, expr):
            def fn(datas, nulls):
                n = datas[0].shape[0] if datas else 1
                return torch.full((n,), 42, dtype=torch.int64), None
            return fn, None
        ex.register_compiler("demo_fortytwo", compile_)


    class DemoPlugin(Plugin):
        def connector_factories(self):
            # the factory receives the CATALOG name; handles and splits
            # carry it (the engine routes by table.connector_id)
            return [("demo", lambda catalog, config: DemoConnector(catalog))]

        def functions(self):
            return [_register_fn]
''')


def test_load_plugins_registers_factory_and_function(tmp_path):
    import sys

    (tmp_path / "plugin").mkdir()
    (tmp_path / "plugin" / "demo.py").write_text(PLUGIN_SRC)
    (tmp_path / "catalog").mkdir()
    (tmp_path / "catalog" / "demo.properties").write_text("connector.name=demo\n")
    try:
        loaded = C.load_plugins(str(tmp_path / "plugin"))
        assert len(loaded) == 1 and type(loaded[0]).__name__ == "DemoPlugin"
        assert "demo" in C.FACTORIES
        # the port's own module name: never the reference's plugin entry
        assert "presto_tpu_torch_plugin_demo" in sys.modules
        assert type(loaded[0]).__module__ == "presto_tpu_torch_plugin_demo"

        catalogs = C.load_catalogs(str(tmp_path))
        r = LocalQueryRunner(catalogs=catalogs, device="cpu")
        assert r.execute("select sum(n) from demo.default.numbers").rows == [[45]]
    finally:
        # take back everything the plugin registered: later tests in this
        # process compare the registries with the reference's
        from presto_tpu_torch.ops import expressions
        from presto_tpu_torch.sql import analyzer

        C.FACTORIES.pop("demo", None)
        sys.modules.pop("presto_tpu_torch_plugin_demo", None)
        analyzer.EXTERNAL_FUNCTIONS.pop("demo_fortytwo", None)
        expressions.EXTERNAL_COMPILERS.pop("demo_fortytwo", None)


def test_plugin_dir_missing_is_noop(tmp_path):
    assert C.load_plugins(str(tmp_path / "nope")) == []


# ------------------------------------------ the concurrent differential

def _wait(info, timeout_s=300.0):
    deadline = time.monotonic() + timeout_s
    while not info.done() and time.monotonic() < deadline:
        time.sleep(0.02)
    return info.done()


@pytest.mark.parametrize("shared", [True, False], ids=["shared-pools", "thread-oracle"])
def test_concurrent_queries_row_identical_to_serial(shared):
    """Six TPC-H queries at once through QueryManager: every result equal to
    its serial run, with the shared pools on and with ``shared_pools=False``
    as the differential oracle."""
    runner = LocalQueryRunner(session=Session(catalog="tpch", schema="tiny",
                                              properties={"shared_pools": shared}),
                              device="cpu")
    manager = QueryManager(runner)
    try:
        serial = {qid: runner.execute(QUERIES[qid]).rows for qid in MIX}
        infos = [manager.submit(QUERIES[MIX[i % len(MIX)]]) for i in range(6)]
        for i, info in enumerate(infos):
            assert _wait(info), f"query {i} never finished"
            assert info.state == FINISHED, f"query {i} failed: {info.error}"
        for i, info in enumerate(infos):
            qid = MIX[i % len(MIX)]
            expect = [manager._to_json_row(r) for r in serial[qid]]
            assert info.rows == expect, f"query {i} (q{qid}) diverged under concurrent load"
    finally:
        manager.close()


# ---------------------------------------------------- catalog equality

CATALOG_SQL = {
    "tpch": "select n_regionkey, count(*), min(n_name) from tpch.tiny.nation "
            "group by n_regionkey order by n_regionkey",
    "tpcds": "select count(*), min(d_date_sk) from tpcds.tiny.date_dim",
    "mem": ["create table mem.default.t as select n_nationkey, n_name from tpch.tiny.nation",
            "select count(*), max(n_name) from mem.default.t"],
    "bh": ["create table bh.default.sink as select * from tpch.tiny.region",
           "select count(*) from bh.default.sink"],
    "wh": "select n_nationkey, n_name from wh.default.nat order by n_nationkey",
    "hv": "select n_regionkey, count(*) from hv.default.nat group by n_regionkey "
          "order by n_regionkey",
    "rp": "select sum(n_nationkey), min(n_name) from rp.default.nat",
    "ext": "select id, name, score from ext.main.users order by id",
    "kf": "select user_id, amount, page from kf.default.clicks order by user_id, amount",
    "svc": "select o_status, count(*), sum(o_total) from svc.sales.orders "
           "group by o_status order by o_status",
}


def _write_etc(d, endpoint) -> str:
    etc = os.path.join(d, "etc")
    cat = os.path.join(etc, "catalog")
    os.makedirs(cat)
    props = {
        "tpch": "connector.name=tpch\n",
        "tpcds": "connector.name=tpcds\n",
        "mem": "connector.name=memory\n",
        "bh": "connector.name=blackhole\n",
        "wh": f"connector.name=file\nfile.base-dir={d}/file\n",
        "hv": f"connector.name=hive\nhive.metastore.catalog.dir={d}/hive\n",
        "rp": f"connector.name=raptor\nraptor.data.dir={d}/raptor\n",
        "ext": f"connector.name=sqlite\nsqlite.path={d}/ext.db\n",
        "kf": f"connector.name=kafka\nkafka.log.dir={d}/kafka\n",
        "svc": f"connector.name=remote\nremote.uri={endpoint}\nremote.timeout-s=10\n",
    }
    for name, text in props.items():
        with open(os.path.join(cat, f"{name}.properties"), "w") as f:
            f.write(text)
    conn = sqlite3.connect(os.path.join(d, "ext.db"))
    conn.execute("create table users (id integer, name text, score real)")
    conn.executemany("insert into users values (?, ?, ?)",
                     [(1, "ann", 1.5), (2, None, 2.25), (3, "cy", None)])
    conn.commit()
    conn.close()
    os.makedirs(os.path.join(d, "kafka"))
    desc = {"topic": "clicks", "message": {"dataFormat": "json", "fields": [
        {"name": "user_id", "type": "bigint", "mapping": "user"},
        {"name": "amount", "type": "double", "mapping": "amount"},
        {"name": "page", "type": "varchar", "mapping": "meta/page"}]}}
    with open(os.path.join(d, "kafka", "default.clicks.json"), "w") as f:
        json.dump(desc, f)
    msgs = [{"user": 1, "amount": 1.5, "meta": {"page": "home"}},
            {"user": 3, "amount": 0.5, "meta": {"page": "pay"}},
            {"user": 2, "amount": 2.0, "meta": {"page": "cart"}}]
    with open(os.path.join(d, "kafka", "clicks-0.log"), "w") as f:
        f.write("\n".join(json.dumps(m) for m in msgs) + "\nBROKEN {\n")
    return etc


def _same_rows(got, want, where):
    assert len(got) == len(want), (where, got, want)
    for g, w in zip(got, want):
        assert len(g) == len(w), (where, g, w)
        for a, b in zip(g, w):
            if isinstance(a, float) or isinstance(b, float):
                assert type(a) is type(b) and math.isclose(a, b, rel_tol=DOUBLE_REL_TOL), \
                    (where, g, w)
            else:
                assert type(a) is type(b) and a == b, (where, g, w)


@pytest.fixture(scope="module")
def etc_runners(tmp_path_factory):
    """(reference runner, port runner) over one ``etc/`` directory loaded by
    each package's ``load_catalogs``; the file, hive and raptor tables are
    written once by the port."""
    from presto_tpu.metadata import Session as RefSession

    d = str(tmp_path_factory.mktemp("etc_catalogs"))
    svc = RemoteTestingService(rows_per_batch=100, n_splits=3)
    svc.add_table("sales", "orders", [("o_id", "bigint"), ("o_total", "double"),
                                      ("o_status", "varchar")],
                  {"o_id": list(range(300)),
                   "o_total": [round(1.25 * i, 2) for i in range(300)],
                   "o_status": [["OPEN", "SHIPPED", "DONE"][i % 3] for i in range(300)]})
    etc = _write_etc(d, svc.start())
    port_cats, ref_cats = C.load_catalogs(etc), ref_config.load_catalogs(etc)
    port = LocalQueryRunner(Session(catalog="tpch", schema="tiny"), catalogs=port_cats,
                            device="cpu")
    for sql in ("create table wh.default.nat as select n_nationkey, n_name from tpch.tiny.nation",
                "create table hv.default.nat as select n_nationkey, n_name, n_regionkey "
                "from tpch.tiny.nation",
                "create table rp.default.nat as select n_nationkey, n_name from tpch.tiny.nation"):
        port.execute(sql)
    ref = RefRunner(session=RefSession(catalog="tpch", schema="tiny"), catalogs=ref_cats)
    yield ref, port, port_cats, ref_cats
    for cats in (port_cats, ref_cats):
        for name in cats.names():
            cats.get(name).shutdown()
    svc.stop()


def test_catalog_names_equal_reference(etc_runners):
    _ref, _port, port_cats, ref_cats = etc_runners
    assert sorted(port_cats.names()) == sorted(ref_cats.names()) == sorted(CATALOG_SQL)


@pytest.mark.parametrize("catalog", sorted(CATALOG_SQL))
def test_catalog_rows_equal_reference(etc_runners, catalog):
    ref, port, _pc, _rc = etc_runners
    stmts = CATALOG_SQL[catalog]
    stmts = stmts if isinstance(stmts, list) else [stmts]
    for sql in stmts[:-1]:
        port.execute(sql)
        ref.execute(sql)
    got, want = port.execute(stmts[-1]).rows, ref.execute(stmts[-1]).rows
    assert got, f"{catalog}: no rows"
    _same_rows(got, want, catalog)
