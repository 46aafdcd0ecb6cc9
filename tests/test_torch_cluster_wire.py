"""The cluster's wire against presto_tpu, on the CPU: page frames, row
routing, the control-plane codec, output buffers and Backoff.

- ``serialize_pages`` of the port gives the reference's ``PSER1`` frames
  byte for byte for the same seeded pages (BIGINT, DOUBLE, DATE and
  dictionary VARCHAR columns, with and without nulls, masked-off rows, an
  empty page set, both codecs), and each package's ``deserialize_pages``
  reads the other's frames to equal pages.
- A task's routing (``task.partition_rows``, on the device) gives every row
  the reference's ``partition_ids_np(combined_key_np(keys), n)``.
- ``codec.dumps`` of the port's SubPlan for TPC-H Q3 and Q9 at ``tiny``
  equals the reference's as plain JSON; no field differs.
- The counterparts of ``tests/test_codec.py``, the token protocol and
  backpressure of ``tests/test_cluster.py`` and the Backoff units of
  ``tests/test_fault_tolerance.py``.
"""
import datetime
import decimal
import json
import random
import threading
import time

import numpy as np
import pytest
import torch

from presto_tpu import block as rblock
from presto_tpu import types as rtypes
from presto_tpu.cluster import serde as rserde
from presto_tpu.cluster.task import combined_key_np, partition_ids_np
from presto_tpu_torch import block as pblock
from presto_tpu_torch import types as ptypes
from presto_tpu_torch.cluster import codec, serde
from presto_tpu_torch.cluster.buffers import PARTITIONED, OutputBuffer
from presto_tpu_torch.cluster.retry import Backoff
from presto_tpu_torch.cluster.task import TaskInfo, TaskUpdateRequest, partition_rows
from presto_tpu_torch.metadata import Session

WORDS = ["AIR", "MAIL", "RAIL", "SHIP", "TRUCK", "FOB", "REG AIR"]
TYPES = ("BIGINT", "DOUBLE", "DATE", "VARCHAR")


def _pages(seed: int, n_pages: int, cap: int, with_nulls: bool, masked: bool):
    """The same pages for both packages: numpy columns from ``seed``."""
    rng = np.random.default_rng(seed)
    rdict, pdict = rblock.Dictionary(WORDS), pblock.Dictionary(WORDS)
    cols = {
        "BIGINT": lambda: rng.integers(-(1 << 40), 1 << 40, cap, dtype=np.int64),
        "DOUBLE": lambda: rng.standard_normal(cap),
        "DATE": lambda: rng.integers(8035, 10440, cap).astype(np.int32),
        "VARCHAR": lambda: rng.integers(0, len(WORDS), cap).astype(np.int32),
    }
    ref, port = [], []
    for _ in range(n_pages):
        rb, pb = [], []
        for name in TYPES:
            data = cols[name]()
            nulls = (rng.random(cap) < 0.2) if with_nulls else None
            d_r, d_p = (rdict, pdict) if name == "VARCHAR" else (None, None)
            rb.append(rblock.Block(getattr(rtypes, name), data, nulls, d_r))
            pb.append(pblock.Block(getattr(ptypes, name), torch.from_numpy(data.copy()),
                                   None if nulls is None else torch.from_numpy(nulls.copy()),
                                   d_p))
        mask = (rng.random(cap) < 0.7) if masked else np.ones(cap, dtype=bool)
        ref.append(rblock.Page(tuple(rb), mask))
        port.append(pblock.Page(tuple(pb), torch.from_numpy(mask.copy())))
    return ref, port


CASES = [
    # (n_pages, capacity, nulls, masked rows, compress)
    (1, 16, False, False, False),
    (1, 16, True, False, False),
    (3, 700, False, True, True),
    (3, 700, True, True, True),
    (2, 4096, True, False, True),
    (2, 4096, False, True, False),
    (0, 16, False, False, True),
]


@pytest.mark.parametrize("n_pages,cap,nulls,masked,compress", CASES)
def test_frames_byte_identical_to_reference(n_pages, cap, nulls, masked, compress):
    ref, port = _pages(cap * 7 + n_pages, n_pages, cap, nulls, masked)
    rt = [getattr(rtypes, n) for n in TYPES]
    pt = [getattr(ptypes, n) for n in TYPES]
    want = rserde.serialize_pages(ref, rt, compress=compress)
    got = serde.serialize_pages(port, pt, compress=compress)
    assert got == want
    header = json.loads(got[9:9 + int.from_bytes(got[5:9], "little")])
    if n_pages:
        assert header["codec"] == ("zlib1" if compress else "raw")
        assert [c["nulls"] for c in header["cols"]] == [nulls] * 4
    else:
        assert header["rows"] == 0


def _host_rows(pages):
    return [r for p in pages for r in p.to_pylists()]


@pytest.mark.parametrize("n_pages,cap,nulls,masked,compress", CASES)
def test_each_package_reads_the_others_frames(n_pages, cap, nulls, masked, compress):
    ref, port = _pages(cap * 11 + n_pages, n_pages, cap, nulls, masked)
    rt = [getattr(rtypes, n) for n in TYPES]
    pt = [getattr(ptypes, n) for n in TYPES]
    rd = [None, None, None, ref[0].blocks[3].dictionary] if ref else [None] * 4
    pd = [None, None, None, port[0].blocks[3].dictionary] if port else [None] * 4
    rframe = rserde.serialize_pages(ref, rt, compress=compress)
    pframe = serde.serialize_pages(port, pt, compress=compress)
    read_by_port = serde.deserialize_pages(rframe, pt, pd, 1 << 10)
    read_by_ref = rserde.deserialize_pages(pframe, rt, rd, 1 << 10)
    assert [p.capacity for p in read_by_port] == [p.capacity for p in read_by_ref]
    assert _host_rows(read_by_port) == _host_rows(read_by_ref)
    for pp, rp in zip(read_by_port, read_by_ref):
        assert pp.mask.device.type == "cpu"  # host pages: the scan uploads them
        np.testing.assert_array_equal(pp.mask.numpy(), np.asarray(rp.mask))
        for pb, rb in zip(pp.blocks, rp.blocks):
            np.testing.assert_array_equal(pb.data.numpy(), np.asarray(rb.data))
            assert (pb.nulls is None) == (rb.nulls is None)


def test_array_handles_refused_on_the_wire():
    """An ARRAY/MAP handle column's store is filled at run time: it cannot
    ride a frame, and the refusal is loud."""
    store = pblock.ArrayValues("array")
    page = pblock.Page((pblock.Block(ptypes.BIGINT, torch.zeros(4, dtype=torch.int32),
                                     None, store),), torch.ones(4, dtype=torch.bool))
    with pytest.raises(NotImplementedError, match="cannot cross the page wire"):
        serde.serialize_pages([page], [ptypes.BIGINT])


@pytest.mark.parametrize("n_keys", [1, 2, 3])
@pytest.mark.parametrize("n_parts", [2, 3, 5, 8])
def test_row_routing_equals_partition_ids_np(n_keys, n_parts):
    rng = np.random.default_rng(100 * n_keys + n_parts)
    n = 5000
    keys = [rng.integers(-(1 << 62), 1 << 62, n, dtype=np.int64) for _ in range(n_keys)]
    keys[0][:50] = np.arange(50)  # dense small keys too
    want = partition_ids_np(combined_key_np(keys), n_parts)
    got = partition_rows([torch.from_numpy(k) for k in keys], n_parts)
    np.testing.assert_array_equal(got.numpy(), want)


def test_task_sink_routes_like_the_reference():
    """The port's TaskOutputOperator (device routing, one copy per column)
    fills each consumer's buffer with the frames the reference's fills."""
    from presto_tpu.cluster import buffers as rbuffers
    from presto_tpu.cluster.task import TaskOutputOperator as RefSink
    from presto_tpu.ops.operator import OperatorContext as RefCtx
    from presto_tpu_torch.cluster.task import TaskOutputOperator
    from presto_tpu_torch.ops.operator import OperatorContext

    ref, port = _pages(5, 3, 700, True, True)
    rt = [getattr(rtypes, n) for n in TYPES]
    pt = [getattr(ptypes, n) for n in TYPES]
    rout = rbuffers.OutputBuffer(rbuffers.PARTITIONED, 3)
    pout = OutputBuffer(PARTITIONED, 3)
    rsink = RefSink(RefCtx(0, "TaskOutput"), rt, rout, "repartition", [0, 2], 256)
    psink = TaskOutputOperator(OperatorContext(0, "TaskOutput"), pt, pout, "repartition",
                               [0, 2], 256)
    for rp, pp in zip(ref, port):
        rsink.add_input(rp)
        psink.add_input(pp)
    rsink.finish()
    psink.finish()
    for b in range(3):
        token = 0
        while True:
            want = rout.get(b, token, wait_s=0.0)
            got = pout.get(b, token, wait_s=0.0)
            assert got == want
            if want[0] is None:
                assert want[2]  # complete
                break
            token = want[1]


# ---------------------------------------------------------------------------
# the control-plane codec
# ---------------------------------------------------------------------------

def _subplan_json(pkg: str, sql: str) -> dict:
    import importlib

    def m(name):
        return importlib.import_module(f"{pkg}.{name}")
    kw = {} if pkg == "presto_tpu" else {"device": "cpu"}
    runner = m("runner").LocalQueryRunner(
        m("metadata").Session(catalog="tpch", schema="tiny"), **kw)
    planner = m("sql.planner.planner").LogicalPlanner(runner.metadata, runner.session)
    plan = m("sql.planner.optimizer").optimize(planner.plan(runner.parser.parse(sql)),
                                               runner.metadata, runner.session)
    plan = m("sql.planner.add_exchanges").add_exchanges(
        plan, planner.symbols, runner.metadata, runner.session, n_workers=2)
    return json.loads(m("cluster.codec").dumps(m("sql.planner.fragmenter").fragment_plan(plan)))


# fields that only one package's plan classes carry: none today
FIELDS_ONLY_ONE_PACKAGE_CARRIES = ()


def _drop(obj, fields):
    if isinstance(obj, dict):
        return {k: _drop(v, fields) for k, v in obj.items() if k not in fields}
    if isinstance(obj, list):
        return [_drop(v, fields) for v in obj]
    return obj


@pytest.mark.parametrize("q", [3, 9])
def test_subplan_json_equals_reference(q):
    from presto_tpu.models.tpch_sql import QUERIES as REF_QUERIES
    from presto_tpu_torch.models.tpch_sql import QUERIES

    assert QUERIES[q] == REF_QUERIES[q]
    got = _subplan_json("presto_tpu_torch", QUERIES[q])
    want = _subplan_json("presto_tpu", REF_QUERIES[q])
    assert _drop(got, FIELDS_ONLY_ONE_PACKAGE_CARRIES) == \
        _drop(want, FIELDS_ONLY_ONE_PACKAGE_CARRIES)
    # the frame names every fragment of both
    assert len(got["f"]["fragments"]) == len(want["f"]["fragments"]) >= 3


def test_roundtrip_scalars_and_containers():
    vals = [None, True, 1, 2.5, "x", [1, 2], (3, 4), {"a": 1, 2: "b"},
            decimal.Decimal("1.23"), datetime.date(1995, 6, 17), b"\x00\xff"]
    for v in vals:
        got = codec.loads(codec.dumps(v))
        assert got == v and type(got) is type(v)


def test_roundtrip_task_update_request():
    from presto_tpu_torch.cluster.coordinator import ClusterQueryRunner
    from presto_tpu_torch.sql.planner.fragmenter import SubPlan

    coord = ClusterQueryRunner(session=Session(catalog="tpch", schema="tiny"), device="cpu")
    coord.detector.stop()
    sql = ("select l_orderkey, sum(l_extendedprice) from lineitem "
           "join orders on l_orderkey = o_orderkey "
           "where l_shipdate > date '1995-03-15' group by l_orderkey "
           "order by 2 desc limit 10")
    subplan = coord.plan_sql(sql)
    assert isinstance(subplan, SubPlan)
    req = TaskUpdateRequest(
        task_id="q1.0.0", query_id="q1", subplan=subplan, fragment_id=0,
        worker_index=0, task_counts={0: 2, 1: 1},
        input_locations={1: ["http://127.0.0.1:1/v1/task/t/results"]},
        session=coord.session, output_buffers=2)
    wire = codec.dumps(req)
    json.loads(wire.decode())  # body must be honest JSON
    back = codec.loads(wire)
    assert isinstance(back, TaskUpdateRequest)
    assert back.task_id == req.task_id
    assert back.task_counts == req.task_counts
    assert len(back.subplan.fragments) == len(subplan.fragments)
    assert codec.dumps(back) == wire  # a stable wire


def test_unknown_class_rejected():
    with pytest.raises(ValueError, match="unknown wire class"):
        codec.loads(b'{"$c": "os.system", "f": {}}')
    with pytest.raises(ValueError, match="unknown wire class"):
        codec.loads(b'{"$c": "WorkerTaskManager", "f": {}}')


def test_unregistered_class_not_encodable():
    class Foo:
        pass

    with pytest.raises(TypeError):
        codec.dumps(Foo())


def test_task_info_roundtrip():
    info = TaskInfo(task_id="t0", state="RUNNING", error=None, rows_out=7)
    assert codec.loads(codec.dumps(info)) == info


# ---------------------------------------------------------------------------
# output buffers and Backoff
# ---------------------------------------------------------------------------

def test_output_buffer_token_protocol():
    buf = OutputBuffer(PARTITIONED, 2)
    buf.enqueue(0, b"frame-a")
    buf.enqueue(0, b"frame-b")
    buf.enqueue(1, b"frame-c")
    frame, nxt, complete = buf.get(0, 0)
    assert frame == b"frame-a" and nxt == 1 and not complete
    frame2, _, _ = buf.get(0, 0)  # re-request is idempotent
    assert frame2 == b"frame-a"
    frame, nxt, complete = buf.get(0, 1)
    assert frame == b"frame-b" and nxt == 2
    buf.set_no_more_pages()
    frame, _, complete = buf.get(0, 2, wait_s=0.1)
    assert frame is None and complete
    frame, _, complete = buf.get(1, 0)
    assert frame == b"frame-c" and not complete
    frame, _, complete = buf.get(1, 1, wait_s=0.1)
    assert frame is None and complete


def test_output_buffer_backpressure_unblocks():
    buf = OutputBuffer(PARTITIONED, 1, max_bytes=64)
    buf.enqueue(0, b"x" * 60)
    done = threading.Event()

    def producer():
        buf.enqueue(0, b"y" * 60)  # blocks until the consumer acks frame 0
        done.set()

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    time.sleep(0.1)
    assert not done.is_set()
    buf.get(0, 0)
    buf.get(0, 1, wait_s=2.0)  # acks frame 0
    assert done.wait(2.0)
    t.join(2.0)


def test_spool_overflow_makes_the_stream_unreplayable():
    from presto_tpu_torch.cluster.buffers import ReplayWindowLost

    buf = OutputBuffer(PARTITIONED, 1, spool_max_bytes=0)
    buf.enqueue(0, b"a")
    buf.enqueue(0, b"b")
    buf.get(0, 0)
    buf.get(0, 1)  # acks frame 0, which the zero-byte spool retires
    assert not buf.replayable(0)
    with pytest.raises(ReplayWindowLost):
        buf.get(0, 0)


class _FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def test_backoff_budget_needs_min_tries_and_interval():
    clock = _FakeClock()
    b = Backoff(max_failure_interval_s=1.5, min_tries=3, clock=clock, sleep=lambda s: None)
    assert not b.failure()
    clock.now = 1.0
    assert not b.failure()
    clock.now = 1.2
    assert not b.failure()
    clock.now = 2.0
    assert b.failure()
    b.success()
    clock.now = 10.0
    assert not b.failure()
    assert b.failure_count == 1


def test_backoff_delay_grows_exponentially_with_jitter_bounds():
    sleeps = []
    b = Backoff(max_failure_interval_s=100.0, initial_delay_s=0.1, max_delay_s=1.0,
                rng=random.Random(7), clock=_FakeClock(), sleep=sleeps.append)
    for base in [0.1, 0.2, 0.4, 0.8, 1.0, 1.0]:
        b.failure()
        delay = b.wait()
        assert base * 0.5 <= delay <= base, (base, delay)
    assert b.total_backoff_s == pytest.approx(sum(sleeps))
    assert len(sleeps) == 6


def test_backoff_no_delay_before_any_failure():
    b = Backoff(sleep=lambda s: pytest.fail("must not sleep"))
    assert b.backoff_delay_s() == 0.0
    assert b.wait() == 0.0


def test_backoff_equals_reference_sequence():
    from presto_tpu.cluster.retry import Backoff as RefBackoff

    def seq(cls):
        clock = _FakeClock()
        b = cls(max_failure_interval_s=0.5, initial_delay_s=0.05, max_delay_s=0.3,
                rng=random.Random(3), clock=clock, sleep=lambda s: None)
        out = []
        for i in range(8):
            clock.now = 0.1 * i
            out.append((b.failure(), b.wait()))
        return out
    assert seq(Backoff) == seq(RefBackoff)


def test_union_refuses_a_remote_source_of_unknown_dictionaries():
    """A remote source planned without its producer's dictionaries may hide
    live VARCHAR codes behind a None dictionary: a UNION must refuse to
    adopt a sibling's dictionary for it (the reference's
    ``unreliable_dicts`` mark), and plans once the dictionaries are known."""
    from presto_tpu_torch.block import Dictionary
    from presto_tpu_torch.exec.local_planner import LocalExecutionPlanner
    from presto_tpu_torch.metadata import MetadataManager
    from presto_tpu_torch.runner import LocalQueryRunner
    from presto_tpu_torch.sql.planner.plan import (OutputNode, RemoteSourceNode, Symbol,
                                                   UnionNode, ValuesNode)
    from presto_tpu_torch.types import VARCHAR

    remote = RemoteSourceNode(0, [Symbol("a", VARCHAR)])
    values = ValuesNode([Symbol("b", VARCHAR)], [["x"]])
    out = Symbol("u", VARCHAR)
    root = OutputNode(UnionNode([remote, values], [out], [[remote.symbols[0]],
                                                         [values.symbols[0]]]), ["u"], [out])
    metadata = MetadataManager(LocalQueryRunner(device="cpu").catalogs)
    session = Session(catalog="tpch", schema="tiny")
    with pytest.raises(NotImplementedError, match="unknown dictionaries"):
        LocalExecutionPlanner(metadata, session, "cpu").plan(root)
    known = LocalExecutionPlanner(metadata, session, "cpu",
                                  remote_dicts={0: [Dictionary(["y"])]})
    assert known.plan(root).output_dicts[0] is not None
