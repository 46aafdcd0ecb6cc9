"""The port's access control (``presto_tpu_torch/security.py`` and the
runner's ``_check_access``), transactions (``transaction.py``) and event
listeners (``spi/eventlistener.py``) against presto_tpu on the CPU.

``FileBasedAccessControl`` gives the reference's allow/deny decision over a
matrix of users and (catalog, schema, table, privilege); the runner's
check gives the reference's decision, as user, on every statement here
(SELECT, joins, subqueries, CTEs that shadow a table, CTAS, INSERT, DROP,
EXPLAIN), and a denied statement raises before any planning. The
reference's transaction and event cases run on both packages, with a
commit that fails part-way and a listener that raises. The password
authenticators accept each other's hashes.
"""
import itertools

import pytest

from presto_tpu import security as ref_security
from presto_tpu import transaction as ref_transaction
from presto_tpu.metadata import Session as RefSession
from presto_tpu.runner import LocalQueryRunner as RefRunner
from presto_tpu.spi import eventlistener as ref_events
from presto_tpu_torch import security, transaction
from presto_tpu_torch.metadata import Session
from presto_tpu_torch.runner import LocalQueryRunner
from presto_tpu_torch.spi import eventlistener as events


def _rules(pkg):
    R = pkg.AccessRule
    return [R(user_regex="bob", table_regex="nation", privileges=("select", "execute")),
            R(user_regex="admin.*"),
            R(user_regex="analyst", catalog_regex="tpch|ext", privileges=("select",)),
            R(user_regex="etl", catalog_regex="tpch|ext", privileges=("select",)),
            R(user_regex="etl", catalog_regex="memory"),
            R(user_regex="eve", schema_regex="tiny", table_regex="region", privileges=()),
            R(user_regex=".*", privileges=("execute",))]


def _decision(fn, *args):
    try:
        fn(*args)
        return "allow"
    except Exception as e:  # the exception's class name, compared across packages
        return type(e).__name__


USERS = ("bob", "admin1", "analyst", "etl", "eve", "", "bobby")
TARGETS = [("tpch", "tiny", "nation"), ("tpch", "tiny", "orders"), ("ext", "main", "orders"),
           ("memory", "default", "x"), ("tpch", "tiny", "region"), ("", "", "")]
PRIVILEGES = ("select", "insert", "create", "drop", "execute")


def test_file_based_decisions_equal_reference():
    ref = ref_security.FileBasedAccessControl(_rules(ref_security))
    port = security.FileBasedAccessControl(_rules(security))
    for user, (c, s, tb), priv in itertools.product(USERS, TARGETS, PRIVILEGES):
        if priv == "select":
            want = _decision(ref.check_can_select, user, c, s, tb)
            got = _decision(port.check_can_select, user, c, s, tb)
        elif priv == "execute":
            want = _decision(ref.check_can_execute_query, user)
            got = _decision(port.check_can_execute_query, user)
        else:
            want = _decision(ref.check_can_write, user, c, s, tb, priv)
            got = _decision(port.check_can_write, user, c, s, tb, priv)
        assert got == want, \
            (user, c, s, tb, priv)
    with pytest.raises(security.AccessDeniedException, match="cannot select on tpch.tiny"):
        port.check_can_select("bob", "tpch", "tiny", "orders")
    for ac in (security.AllowAllAccessControl(), security.AccessControl()):
        ac.check_can_select("anyone", "a", "b", "c")
        ac.check_can_write("anyone", "a", "b", "c", "drop")


STATEMENTS = [
    "select count(*) from nation",
    "select count(*) from orders",
    "select n_name, r_name from nation join region on n_regionkey = r_regionkey",
    "select * from nation where n_regionkey in (select r_regionkey from region)",
    "select (select max(o_totalprice) from orders) from nation",
    "with orders as (select * from nation) select count(*) from orders",
    "with x as (select * from orders) select count(*) from x",
    "with a as (select * from nation), b as (select * from a) select count(*) from b",
    "with nation as (select * from region) select * from tpch.tiny.nation",
    "select count(*) from tpch.tiny.customer c, ext.main.orders o where c.c_custkey = o.o_custkey",
    "create table memory.default.x as select 1 as a",
    "create table memory.default.x as select * from orders",
    "create table ext.main.x as select * from nation",
    "insert into memory.default.x select n_nationkey from nation",
    "insert into memory.default.x values (1)",
    "drop table memory.default.x",
    "drop table tpch.tiny.nation",
    "explain select count(*) from orders",
    "show tables",
    "select 1",
]


@pytest.mark.parametrize("user", ["bob", "admin1", "analyst", "etl", "eve", "nobody"])
def test_check_access_decisions_equal_reference(user):
    ref = RefRunner(RefSession(catalog="tpch", schema="tiny"))
    port = LocalQueryRunner(Session(catalog="tpch", schema="tiny"), device="cpu")
    ref.access_control = ref_security.FileBasedAccessControl(_rules(ref_security))
    port.access_control = security.FileBasedAccessControl(_rules(security))
    for sql in STATEMENTS:
        want = _decision(ref._check_access, ref.parser.parse(sql), user)
        got = _decision(port._check_access, port.parser.parse(sql), user)
        assert got == want, (user, sql)


def test_denied_statement_raises_before_planning(monkeypatch):
    """The reference's ``test_runner_enforces_table_access`` on the port,
    through ``execute(sql, user=...)``; nothing is planned for a denied
    statement and no table is created."""
    port = LocalQueryRunner(Session(catalog="tpch", schema="tiny"), device="cpu")
    port.session.user = "bob"
    port.access_control = security.FileBasedAccessControl(_rules(security))
    planned = []
    real = LocalQueryRunner.plan_statement
    monkeypatch.setattr(LocalQueryRunner, "plan_statement",
                        lambda self, stmt: planned.append(stmt) or real(self, stmt))
    assert port.execute("select count(*) from nation").rows == [[25]] and len(planned) == 1
    with pytest.raises(security.AccessDeniedException):
        port.execute("select count(*) from orders")
    with pytest.raises(security.AccessDeniedException):
        port.execute("create table memory.default.x as select 1 as a")
    assert len(planned) == 1
    assert port.execute("show tables from memory.default").rows == []
    # the same call as another user, and through the default user
    assert port.execute("create table memory.default.x as select 1 as a",
                        user="etl").rows == [[1]]
    assert port.execute("select * from memory.default.x", user="admin7").rows == [[1]]
    with pytest.raises(security.AccessDeniedException):
        port.execute("select * from memory.default.x", user="analyst")
    port.access_control = None
    assert port.execute("select count(*) from orders", user="anyone").rows == [[15000]]


# ----------------------------------------------------------- transactions

class _TxConnector:
    """A connector with transaction hooks that records the calls; ``fail``
    makes its commit raise."""

    def __init__(self, log, name, fail=False):
        self.log, self.name, self.fail = log, name, fail

    def begin_transaction(self, tid):
        self.log.append(("begin", self.name))

    def commit_transaction(self, tid):
        if self.fail:
            raise RuntimeError(f"commit of {self.name} failed")
        self.log.append(("commit", self.name))

    def rollback_transaction(self, tid):
        self.log.append(("rollback", self.name))


class _Catalogs:
    def __init__(self, conns):
        self._conns = conns

    def connector(self, name):
        return self._conns[name]

    def names(self):
        return list(self._conns)


def _transactions(pkg):
    """The reference's ``test_transaction_commit_and_abort``, a connector
    without hooks, and a commit that fails part-way: the log and states."""
    log = []
    conns = {"a": _TxConnector(log, "a"), "b": _TxConnector(log, "b", fail=True),
             "c": _TxConnector(log, "c"), "plain": object()}
    tm = pkg.TransactionManager(_Catalogs(conns))
    tx = tm.begin("q1")
    tm.join(tx, "a")
    tm.join(tx, "a")  # idempotent
    tm.join(tx, "plain")
    assert len(tm.active_transactions()) == 1
    tm.commit(tx)
    tx2 = tm.begin("q2")
    tm.join(tx2, "a")
    tm.abort(tx2)
    tx3 = tm.begin("q3")
    for name in ("a", "b", "c"):
        tm.join(tx3, name)
    with pytest.raises(RuntimeError, match="commit of b failed"):
        tm.commit(tx3)
    tm.commit(tx3)  # finished already: nothing more happens
    tm.join(None, "a")
    return (log, [t.state for t in (tx, tx2, tx3)], [t.joined for t in (tx, tx2, tx3)],
            tm.active_transactions(), tm.catalog_names())


def test_transactions_equal_reference():
    got, want = _transactions(transaction), _transactions(ref_transaction)
    assert got == want
    log, states, _joined, active, names = got
    assert log == [("begin", "a"), ("commit", "a"), ("begin", "a"), ("rollback", "a"),
                   ("begin", "a"), ("begin", "b"), ("begin", "c"), ("commit", "a"),
                   ("rollback", "b"), ("rollback", "c")]
    assert states == ["COMMITTED", "ABORTED", "ABORTED"] and active == []
    assert names == ["a", "b", "c", "plain"]


# --------------------------------------------------------------- events

def _events(pkg):
    """Created and completed events through a monitor whose first listener
    raises on every event; what the second listener saw."""
    class Recorder(pkg.EventListener):
        def __init__(self):
            self.seen = []

        def query_created(self, e):
            self.seen.append(("created", e.query_id, e.sql, e.user, e.trace_token))

        def query_completed(self, e):
            self.seen.append(("completed", e.query_id, e.state, e.user, e.row_count,
                              e.error))

    class Exploder(pkg.EventListener):
        def query_created(self, e):
            raise RuntimeError("bad listener")

        def query_completed(self, e):
            raise ValueError("bad listener")

    rec = Recorder()
    mon = pkg.QueryMonitor([Exploder()])
    mon.add_listener(rec)
    mon.add_listener(pkg.EventListener())
    mon.query_created(pkg.QueryCreatedEvent("q1", "select 1", user="alice", trace_token="t"))
    mon.query_completed(pkg.QueryCompletedEvent("q1", "select 1", user="alice", row_count=1))
    mon.query_completed(pkg.QueryCompletedEvent("q2", "select x", state="FAILED",
                                                error={"message": "no column x"}))
    return rec.seen


def test_query_monitor_equals_reference():
    got, want = _events(events), _events(ref_events)
    assert got == want
    assert [s[0] for s in got] == ["created", "completed", "completed"]
    assert got[2][2] == "FAILED" and got[2][5] == {"message": "no column x"}


# -------------------------------------------------------- authentication

def test_password_authenticators_accept_each_others_hashes(tmp_path):
    path = tmp_path / "passwords"
    path.write_text("# users\n"
                    f"ann:{security.hash_password('s3cret', iterations=1000)}\n"
                    f"bob:{ref_security.hash_password('hunter2', iterations=1000)}\n"
                    "cat:plain:meow\n"
                    "dan:pbkdf2:bad\n")
    for pkg in (security, ref_security):
        auth = pkg.FileBasedPasswordAuthenticator(str(path))
        assert auth.authenticate("ann", "s3cret") == "ann"
        assert auth.authenticate("bob", "hunter2") == "bob"
        assert auth.authenticate("cat", "meow") == "cat"
        for user, pw in (("ann", "wrong"), ("zed", "s3cret"), ("cat", "purr")):
            with pytest.raises(pkg.AuthenticationException, match="invalid credentials"):
                auth.authenticate(user, pw)
        with pytest.raises(pkg.AuthenticationException, match="malformed"):
            auth.authenticate("dan", "x")
        static = pkg.StaticPasswordAuthenticator({"eve": "pw"})
        assert static.authenticate("eve", "pw") == "eve"
        with pytest.raises(pkg.AuthenticationException):
            static.authenticate("eve", "nope")
