"""The disk rung of the port's memory ladder (``presto_tpu_torch/exec/spill.py``)
against the reference's, on the CPU at ``tiny``.

The local cases of ``tests/test_spill.py:106-312``. Under a one-byte pool
and ``page_capacity`` 1,024 every accounting update is over the revoke
target, so the join build's host pages and the grouping's host partials go
on to PCOL runs on disk. Each differential case runs the same query through
both packages and compares the rows exactly, the ``query.spill.disk``
events per run kind and the runs written; the port must leave no spill
directory and no spill-ledger byte behind. The SF1 case is ``slow``.
"""
import collections
import glob
import os
import tempfile
import threading

import numpy as np
import pytest

from presto_tpu.exec import spill as ref_spill
from presto_tpu.metadata import Session as RefSession
from presto_tpu.models.tpch_sql import QUERIES as REF_QUERIES
from presto_tpu.runner import LocalQueryRunner as RefRunner
from presto_tpu.utils import events as ref_events
from presto_tpu.utils.metrics import METRICS as REF_METRICS
from presto_tpu.utils.testing import SqliteOracle, assert_rows_equal
from presto_tpu_torch.cluster import faults
from presto_tpu_torch.exec import spill
from presto_tpu_torch.formats.pcol import PcolFile
from presto_tpu_torch.memory import (ExceededMemoryLimitException, MemoryPool,
                                     shared_general_pool)
from presto_tpu_torch.metadata import Session
from presto_tpu_torch.models.tpch_sql import QUERIES
from presto_tpu_torch.runner import LocalQueryRunner
from presto_tpu_torch.utils import events
from presto_tpu_torch.utils.metrics import METRICS
from test_torch_sql import assert_same_rows

AGG_SQL = ("select o_custkey, count(*), sum(o_totalprice) "
           "from orders group by o_custkey")
JOIN_SQL = ("select o.o_orderkey, c.c_name from orders o "
            "join customer c on o.o_custkey = c.c_custkey "
            "where o.o_totalprice > 100000")
CAPPED = {"memory_pool_bytes": 1, "page_capacity": 1 << 10}


def _own_spill_dirs():
    """Spill directories this process made under the port's root."""
    return [d for d in glob.glob(os.path.join(spill.spill_root(""), "*"))
            if os.path.basename(d).startswith(f"{os.getpid()}-")]


def _port(props):
    return LocalQueryRunner(Session(catalog="tpch", schema="tiny", properties=dict(props)),
                            device="cpu")


def _ref(props):
    return RefRunner(RefSession(catalog="tpch", schema="tiny", properties=dict(props)))


def _disk_runs(journal, since=0) -> dict:
    return dict(collections.Counter(
        e["run_kind"] for e in journal.events(since=since, kind="query.spill.disk",
                                              limit=1 << 20)))


@pytest.fixture(scope="module")
def oracle():
    o = SqliteOracle()
    o.load_tpch(0.01, ["orders", "customer", "nation"])
    return o


@pytest.fixture(scope="module")
def uncapped():
    """The port's uncapped rows of ``AGG_SQL`` and ``JOIN_SQL``."""
    return {sql: _port({}).execute(sql).rows for sql in (AGG_SQL, JOIN_SQL)}


def _run_both(sql, ref_sql, props):
    """-> (port rows, reference rows, port runs per kind, reference runs per
    kind, port bytes written, port bytes read)."""
    events.JOURNAL.clear()
    ref_events.JOURNAL.clear()
    want = _ref(props).execute(ref_sql).rows
    w0 = METRICS.counter_value("spill.bytes_written")
    r0 = METRICS.counter_value("spill.bytes_read")
    got = _port(props).execute(sql).rows
    return (got, want, _disk_runs(events.JOURNAL), _disk_runs(ref_events.JOURNAL),
            METRICS.counter_value("spill.bytes_written") - w0,
            METRICS.counter_value("spill.bytes_read") - r0)


DISK_CASES = {"agg": (AGG_SQL, AGG_SQL, 1), "join": (JOIN_SQL, JOIN_SQL, 1),
              "agg 4 drivers": (AGG_SQL, AGG_SQL, 4),
              "join 4 drivers": (JOIN_SQL, JOIN_SQL, 4),
              "q3": (QUERIES[3], REF_QUERIES[3], 1), "q18": (QUERIES[18], REF_QUERIES[18], 1)}


@pytest.mark.parametrize("case", sorted(DISK_CASES))
def test_disk_spill_row_identical_journaled_and_clean(oracle, uncapped, case):
    """Under the cap the grouping and the join build go device -> host ->
    disk in both packages: equal rows (and the oracle's, and the uncapped
    run's), the same runs per kind, every byte written read back, the
    ``query.spill.disk`` event's numbers, and nothing left behind."""
    sql, ref_sql, drivers = DISK_CASES[case]
    got, want, runs, ref_runs, written, read = _run_both(
        sql, ref_sql, {**CAPPED, "driver_parallelism": drivers})
    assert_same_rows(sorted(got), sorted(want))
    if sql in uncapped:
        assert sorted(got) == sorted(uncapped[sql])
        assert_rows_equal(got, oracle.query(sql))
    assert runs == ref_runs and sum(runs.values()) > 0
    assert written > 0 and read == written
    evt = events.JOURNAL.events(kind="query.spill.disk")[-1]
    assert evt["run_bytes"] > 0 and evt["disk_bytes"] >= evt["run_bytes"]
    assert evt["severity"] == "warn" and evt["path"].endswith(".pcol")
    assert not _own_spill_dirs(), "spill directories left behind"
    assert shared_general_pool().spill_by_query() == {}


def test_pallas_build_comes_back_from_disk_before_the_insert():
    """``hash_kernels="pallas"``: Q3's two builds go to disk under the cap
    and come back to the build's device before the insert, so both still
    take the table, with the reference's ``pallas.`` counters."""
    keys = ("pallas.join_builds", "pallas.join_fallbacks", "pallas.agg_pages")
    props = {**CAPPED, "hash_kernels": "pallas", "driver_parallelism": 1}
    before = {k: METRICS.counter_value(k) for k in keys}
    ref_before = {k: REF_METRICS.counter_value(k) for k in keys}
    got, want, runs, ref_runs, written, read = _run_both(QUERIES[3], REF_QUERIES[3], props)
    delta = {k: METRICS.counter_value(k) - before[k] for k in keys}
    ref_delta = {k: REF_METRICS.counter_value(k) - ref_before[k] for k in keys}
    assert_same_rows(got, want)
    assert delta == ref_delta and delta["pallas.join_builds"] == 2
    assert runs == ref_runs and runs.get("join", 0) > 0 and read == written > 0


def test_spill_to_disk_off_keeps_host_tier(uncapped):
    """``spill_to_disk=False``: the ladder stops at host RAM, still exact,
    with no disk traffic."""
    w0 = METRICS.counter_value("spill.bytes_written")
    seq = events.JOURNAL.last_seq()
    res = _port({**CAPPED, "spill_to_disk": False}).execute(AGG_SQL)
    assert sorted(res.rows) == sorted(uncapped[AGG_SQL])
    assert METRICS.counter_value("spill.bytes_written") == w0
    assert not events.JOURNAL.events(since=seq, kind="query.spill.disk")
    assert events.JOURNAL.events(since=seq, kind="memory.spill")


def test_spill_manager_accounting_and_lifecycle(tmp_path):
    """Run bytes go to the pool's spill ledger (outside ``reserved_bytes``),
    reads round-trip bit-exact, and ``close`` releases everything. The run
    is a PCOL file the reference reads too."""
    pool = MemoryPool("general", 1 << 20)
    mgr = spill.SpillManager("q_acct", pool, spill_dir=str(tmp_path))
    cols = [np.arange(1000, dtype=np.int64), np.linspace(0, 1, 1000),
            np.arange(1000) % 3 == 0]
    run = mgr.write_columns(["k", "x", "b"], cols, kind="t")
    assert pool.spill_by_query() == {"q_acct": run.nbytes} and run.rows == 1000
    assert pool.spill_bytes("q_acct") == run.nbytes == mgr.disk_bytes()
    assert pool.reserved_bytes() == 0 and pool.spilled_bytes() == run.nbytes
    read = mgr.read_columns(run)
    for (data, nulls, d), want in zip(read, cols):
        assert nulls is None and d is None and np.array_equal(data, want)
    ref_file = __import__("presto_tpu.formats.pcol", fromlist=["PcolFile"]).PcolFile(run.path)
    try:
        assert np.array_equal(ref_file.read_column("x")[0], cols[1])
    finally:
        ref_file.close()
    mgr.close()
    mgr.close()  # idempotent
    assert pool.spill_by_query() == {} and not os.path.exists(run.path)
    with pytest.raises(RuntimeError, match="closed"):
        mgr.write_columns(["k"], [cols[0]])


def test_write_columns_refuses_a_dtype_without_a_storage_type(tmp_path):
    mgr = spill.SpillManager("q_dtype", MemoryPool("general", 1 << 20),
                             spill_dir=str(tmp_path))
    try:
        assert spill.storage_type_for(np.complex128) is None
        assert spill.storage_type_for(np.int32) is not None
        with pytest.raises(ValueError, match="no pcol storage type"):
            mgr.write_columns(["g"], [np.zeros(4, dtype=np.complex128)])
    finally:
        mgr.close()


def test_spill_max_bytes_fails_query_like_a_memory_limit(tmp_path):
    """Over ``spill_max_bytes`` the write raises the reference's exception
    and message, journals ``query.spill.failed`` and releases the run."""
    from presto_tpu.memory import MemoryPool as RefPool

    pools = {"port": MemoryPool("general", 1 << 20), "ref": RefPool("general", 1 << 20)}
    mgrs = {"port": spill.SpillManager("q_cap", pools["port"], str(tmp_path / "p"), 64),
            "ref": ref_spill.SpillManager("q_cap", pools["ref"], str(tmp_path / "r"), 64)}
    msgs = {}
    seq = events.JOURNAL.last_seq()
    for k, mgr in mgrs.items():
        with pytest.raises(Exception) as ei:
            mgr.write_columns(["k"], [np.arange(4096, dtype=np.int64)])
        msgs[k] = (type(ei.value).__name__, str(ei.value))
        mgr.close()
        assert pools[k].spill_by_query() == {}
    assert msgs["port"] == msgs["ref"] and msgs["port"][0] == "ExceededMemoryLimitException"
    failed = events.JOURNAL.events(since=seq, kind="query.spill.failed")
    assert failed and failed[-1]["op"] == "limit" and failed[-1]["limit_bytes"] == 64


def test_spill_max_bytes_session_key_fails_the_query():
    """The session's ``spill_max_bytes`` bounds the query's disk bytes: a
    capped grouping over the bound fails with the memory limit's exception,
    in both packages, and leaves nothing behind."""
    props = {**CAPPED, "spill_max_bytes": 256, "driver_parallelism": 1}
    with pytest.raises(Exception) as want:
        _ref(props).execute(AGG_SQL)
    with pytest.raises(ExceededMemoryLimitException) as got:
        _port(props).execute(AGG_SQL)
    assert str(got.value) == str(want.value)
    assert got.value.failure_trace_path
    assert not _own_spill_dirs() and shared_general_pool().spill_by_query() == {}


def test_multi_tenant_spill_independent_and_residue_free(uncapped):
    """Three capped queries at once spill into their own directories; each
    result equals the uncapped run and the shared ledger is empty after."""
    results, errors = {}, {}

    def run_one(i):
        try:
            results[i] = sorted(_port(CAPPED).execute(AGG_SQL).rows)
        except BaseException as e:  # noqa: BLE001 - inspected below
            errors[i] = e

    threads = [threading.Thread(target=run_one, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120.0)
    assert not errors, errors
    assert len(results) == 3
    assert all(rows == sorted(uncapped[AGG_SQL]) for rows in results.values())
    assert shared_general_pool().spill_by_query() == {}
    assert not _own_spill_dirs(), "spill directories left behind"


@pytest.mark.parametrize("point", ["spill.write", "spill.read"])
def test_injected_spill_fault_fails_only_owner(uncapped, point):
    """A spill fault fails the owning query loudly, with its forensic trace
    attached and ``query.spill.failed`` journaled, while a concurrent
    uncapped query finishes; the next query runs clean."""
    faults.install(faults.FaultInjector.from_spec(f"{point}:error:times=1", seed=7))
    box = {}

    def tenant():
        try:
            box["rows"] = _port({}).execute(AGG_SQL).rows
        except BaseException as e:  # noqa: BLE001 - inspected below
            box["tenant_error"] = e

    t = threading.Thread(target=tenant)
    seq = events.JOURNAL.last_seq()
    t.start()
    try:
        with pytest.raises(faults.InjectedFault) as exc_info:
            _port(CAPPED).execute(AGG_SQL)
    finally:
        t.join(timeout=120.0)
        faults.clear()
    assert "tenant_error" not in box and sorted(box["rows"]) == sorted(uncapped[AGG_SQL])
    assert getattr(exc_info.value, "failure_trace_path", None), "no forensic trace"
    failed = events.JOURNAL.events(since=seq, kind="query.spill.failed")
    assert failed and failed[-1]["op"] == point.split(".")[1]
    dumped = events.JOURNAL.events(since=seq, kind="query.forensic_dumped")
    assert dumped and dumped[-1]["error"] == "InjectedFault"
    assert not _own_spill_dirs() and shared_general_pool().spill_by_query() == {}
    assert sorted(_port(CAPPED).execute(AGG_SQL).rows) == sorted(uncapped[AGG_SQL])


def test_fault_spec_grammar_matches_reference():
    from presto_tpu.cluster import faults as ref_faults

    assert faults.FIRE_POINTS == ref_faults.FIRE_POINTS and faults.KINDS == ref_faults.KINDS
    spec = "spill.write:delay:delay_s=0,after=1,times=2;spill.*:error:probability=0.5,seed=3"
    inj, ref_inj = faults.FaultInjector.from_spec(spec), ref_faults.FaultInjector.from_spec(spec)
    assert repr(inj.rules) == repr(ref_inj.rules) and inj.seed == ref_inj.seed == 3
    for bad in ("spill.wirte:error", "spill.write:explode", "spill.write"):
        with pytest.raises(ValueError):
            faults.FaultInjector.from_spec(bad)
    fired = []
    for mod, injector in ((faults, inj), (ref_faults, ref_inj)):
        seen = []
        for _ in range(6):
            try:
                injector.fire("spill.read")
                seen.append("ok")
            except Exception as e:  # noqa: BLE001 - the injected kind is compared
                seen.append(type(e).__name__)
        fired.append(seen)
    assert fired[0] == fired[1]
    assert faults.install_from_env({"PRESTO_TPU_FAULTS": "spill.read:error"}) is not None
    faults.clear()
    assert faults.active() is None


def test_crash_leftover_runs_gc(tmp_path):
    """A directory whose leading pid is dead is swept by the next manager;
    this process's own survives, and ``spill.gc`` is journaled."""
    root = str(tmp_path / "spillroot")
    os.makedirs(root)
    dead = os.path.join(root, "999999999-1-q_dead")
    os.makedirs(dead)
    with open(os.path.join(dead, "run-1.pcol"), "wb") as f:
        f.write(b"leftover")
    mine = os.path.join(root, f"{os.getpid()}-1-q_live")
    os.makedirs(mine)
    seq = events.JOURNAL.last_seq()
    mgr = spill.SpillManager("q_gc", MemoryPool("general", 1 << 20), spill_dir=root)
    assert not os.path.exists(dead), "a dead process's leftover survived"
    assert os.path.exists(mine), "a live process's directory was swept"
    gc = events.JOURNAL.events(since=seq, kind="spill.gc")
    assert gc and gc[-1]["removed_dirs"] == 1
    mgr.close()
    assert spill.gc_leftover_runs(root) == 0  # once per root per process


def test_spill_roots_are_the_packages_own():
    """The two packages never share a spill directory in one process."""
    assert spill.spill_root("") == os.path.join(tempfile.gettempdir(),
                                                "presto-tpu-torch-spill")
    assert spill.spill_root("") != ref_spill.spill_root("")
    assert spill.spill_root("/x/y") == "/x/y"


@pytest.mark.slow
def test_disk_spill_sf1_q1_q3_row_identical():
    """TPC-H Q1 and Q3 at SF1 under a one-byte pool equal the uncapped rows
    through the disk rung, with no spill file left."""
    w0 = METRICS.counter_value("spill.bytes_written")
    for q in (1, 3):
        want = LocalQueryRunner(Session(catalog="tpch", schema="sf1"), device="cpu") \
            .execute(QUERIES[q]).rows
        got = LocalQueryRunner(Session(catalog="tpch", schema="sf1",
                                       properties={"memory_pool_bytes": 1}),
                               device="cpu").execute(QUERIES[q]).rows
        assert sorted(got) == sorted(want), f"q{q} rows diverged"
    assert METRICS.counter_value("spill.bytes_written") > w0
    assert not _own_spill_dirs()
