"""Card-only tests of the port's CUDA kernels (skipped without a GPU).

Run on a machine with an NVIDIA GPU (where JAX need not be installed):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Each kernel is held bit-identical to its plain PyTorch version on the same
CUDA tensors, and each wrapper counts exactly its own launches.
"""
import numpy as np
import pytest
import torch

from presto_tpu_torch.ops import pallas_hash as ph
from presto_tpu_torch.ops.aggregates import AggregateCall, resolve_aggregate
from presto_tpu_torch.ops.hash_agg import SINGLE, HashAggregationOperatorFactory
from presto_tpu_torch.types import BIGINT

pytestmark = pytest.mark.cuda


def test_stream_join_on_the_card_equals_the_cpu_run(cuda, tmp_path):
    """A kafka topic of ``tiny``'s orders (JSON, two partitions, a poison
    line) joined with ``tpch``'s ``customer``: on the card the customer
    build takes the insert and the topic's pages the probe, with the CPU
    run's rows, which equal the same query over ``tpch``."""
    import json

    from presto_tpu_torch.connectors.kafka import KafkaConnector
    from presto_tpu_torch.metadata import Session
    from presto_tpu_torch.runner import LocalQueryRunner

    base = LocalQueryRunner(Session(catalog="tpch", schema="tiny"), device="cpu")
    rows = base.execute("select o_orderkey, o_custkey, o_totalprice from orders").rows
    fields = [{"name": "o_orderkey", "type": "bigint", "mapping": "k"},
              {"name": "o_custkey", "type": "bigint", "mapping": "c"},
              {"name": "o_totalprice", "type": "decimal(12,2)", "mapping": "p"}]
    (tmp_path / "default.orders.json").write_text(json.dumps(
        {"topic": "orders", "message": {"dataFormat": "json", "fields": fields}}))
    for part in range(2):
        lines = [json.dumps({"k": k, "c": c, "p": float(p)}) for k, c, p in rows[part::2]]
        (tmp_path / f"orders-{part}.log").write_text("\n".join(lines + ["{poison"]) + "\n")
    sql = ("select c_mktsegment, count(*), sum(o_totalprice) from {} join customer "
           "on o_custkey = c_custkey group by c_mktsegment order by c_mktsegment")
    runs = {}
    for dev in ("cpu", cuda):
        r = LocalQueryRunner(Session(catalog="tpch", schema="tiny",
                                     properties={"hash_kernels": "pallas"}), device=dev)
        r.catalogs.register("kafka", KafkaConnector("kafka", str(tmp_path)))
        r.execute(sql.format("kafka.default.orders"))  # the decode
        ph.insert_table.launches = ph.probe_table.launches = 0
        runs[str(dev)] = r.execute(sql.format("kafka.default.orders")).rows
        launches = (ph.insert_table.launches, ph.probe_table.launches)
    assert runs[str(cuda)] == runs["cpu"] == base.execute(sql.format("orders")).rows
    assert launches[0] >= 1 and launches[1] >= 1


EDGE_CASES = ("all_masked", "one_row", "ragged", "tail_crossing", "one_trip")


def insert_edge_case(name: str):
    """``(comps (ncomps, n) int64, mask (n,) bool, slots, trips)`` as numpy,
    for one edge of the insert's worklist."""
    rng = np.random.RandomState(23)
    trips = ph.INSERT_TRIPS
    if name == "all_masked":
        n = 300
        comps = (rng.permutation(8 * n)[:n].astype(np.int64) * 5)[None]
        mask = np.zeros(n, dtype=bool)
    elif name == "one_row":
        comps, mask = np.array([[42]], dtype=np.int64), np.ones(1, dtype=bool)
    elif name == "ragged":  # n not a multiple of the kernels' 256-thread blocks
        n = 1000
        comps = rng.randint(-50, 50, size=(2, n)).astype(np.int64)
        mask = rng.rand(n) < 0.8
    elif name == "tail_crossing":
        # 40 keys share one home slot, 60 rows each, beside 600 other keys:
        # one key places per round, so the worklist stays above 1,024 rows
        # for 24 rounds, then falls below it and empties after round 40
        n_same, copies, n_other = 40, 60, 600
        slots = ph.table_slots(n_same * copies + n_other)
        cands = np.arange(1, 1 << 21, dtype=np.int64) * 7
        home = ph._hash_base(torch.from_numpy(cands)[None], slots).numpy()
        keys = np.concatenate([np.repeat(cands[home == home[0]][:n_same], copies),
                               cands[home != home[0]][:n_other]])
        comps = rng.permutation(keys)[None]
        mask = np.ones(keys.shape[0], dtype=bool)
    elif name == "one_trip":
        n = 700
        comps = rng.randint(0, 300, size=(1, n)).astype(np.int64)
        mask = np.ones(n, dtype=bool)
        trips = 1
    else:
        raise AssertionError(name)
    return comps, mask, ph.table_slots(comps.shape[1]), trips


def grouping_case(n: int, groups: int, ncomps: int, live: float, seed: int = 31):
    """The aggregation's use of the insert (``GroupedAggregationBuilder.
    _page_hash_partial``): ``(comps (ncomps, n) int64, mask (n,) bool, slots)``
    as numpy, for a page whose live rows carry ``groups`` distinct keys, many
    copies of each. Three components are Q3's (orderkey, orderdate,
    shippriority); six add the builder's null flag after each. ``slots`` is
    the table the builder sizes for that group count."""
    rng = np.random.RandomState(seed)
    okey = rng.permutation(1 << 22)[:groups].astype(np.int64) * 4 + 1
    cols = [okey, 8000 + okey % 2000, np.zeros(groups, np.int64)]
    if ncomps == 6:
        cols = [x for c in cols for x in (c, np.zeros(groups, np.int64))]
    elif ncomps != 3:
        raise AssertionError(ncomps)
    comps = np.stack(cols)[:, rng.randint(0, groups, n)]
    mask = rng.rand(n) < live
    slots = max(1 << 10, 1 << max(4, (4 * groups - 1).bit_length()))
    return np.ascontiguousarray(comps), mask, slots


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("ncomps,dup", [(1, False), (2, True), (3, True)])
def test_insert_kernel_matches_plain_version(cuda, ncomps, dup):
    rng = np.random.RandomState(ncomps)
    n = 1 << 14
    if dup:
        comps = rng.randint(0, 40, size=(ncomps, n)).astype(np.int64)
    else:
        comps = (rng.permutation(8 * n)[:n].astype(np.int64) * 7 - 3)[None]
    comps = torch.from_numpy(comps).to(cuda)
    mask = torch.from_numpy(rng.rand(n) < 0.8).to(cuda)
    slots = ph.table_slots(n)
    before = ph.insert_table.launches
    got = ph.insert_table(comps, mask, slots)
    assert ph.insert_table.launches == before + 1
    want = ph.insert_table_reference(comps, mask, slots)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_insert_kernel_overflow_and_full_table(cuda):
    comps = (torch.arange(32, dtype=torch.int64, device=cuda) * 1009).unsqueeze(0)
    mask = torch.ones(32, dtype=torch.bool, device=cuda)
    got = ph.insert_table(comps.contiguous(), mask, 16, trips=4)
    want = ph.insert_table_reference(comps, mask, 16, trips=4)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[3][0].item() == 1


def test_probe_kernel_matches_plain_version(cuda):
    rng = np.random.RandomState(9)
    n = 1 << 14
    keys = torch.from_numpy(rng.permutation(8 * n)[:n].astype(np.int64)).to(cuda)
    mask = torch.ones(n, dtype=torch.bool, device=cuda)
    slots = ph.table_slots(n)
    slot_comps, slot_rows, _gid, stats = ph.insert_table(keys.unsqueeze(0).contiguous(),
                                                         mask, slots)
    trips = ph.probe_trips_for(int(stats[1]))
    probe = torch.from_numpy(rng.randint(0, 16 * n, 2 * n).astype(np.int64)).to(cuda)
    pmask = torch.from_numpy(rng.rand(2 * n) < 0.9).to(cuda)
    before = ph.probe_table.launches
    got = ph.probe_table(slot_comps[0], slot_rows, probe, pmask, trips)
    assert ph.probe_table.launches == before + 1
    want = ph.probe_table_reference(slot_comps[0], slot_rows, probe, pmask, trips)
    assert torch.equal(got, want)
    assert (got >= 0).any() and (got < 0).any()


def test_probe_of_an_empty_page_launches_nothing(cuda):
    slot_keys = torch.zeros(16, dtype=torch.int64, device=cuda)
    slot_rows = torch.full((16,), ph.EMPTY, dtype=torch.int32, device=cuda)
    keys = torch.zeros(0, dtype=torch.int64, device=cuda)
    mask = torch.zeros(0, dtype=torch.bool, device=cuda)
    before = ph.probe_table.launches
    got = ph.probe_table(slot_keys, slot_rows, keys, mask, 4)
    assert ph.probe_table.launches == before
    assert got.shape == (0,) and got.dtype == torch.int32 and got.device.type == "cuda"


@pytest.mark.parametrize("case", EDGE_CASES)
def test_insert_kernel_worklist_edges(cuda, case):
    comps, mask, slots, trips = insert_edge_case(case)
    comps = torch.from_numpy(comps).to(cuda)
    mask = torch.from_numpy(mask).to(cuda)
    got = ph.insert_table(comps, mask, slots, trips)
    want = ph.insert_table_reference(comps, mask, slots, trips)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_insert_kernel_stops_at_empty_worklist(cuda):
    """The rounds end when the worklist empties, before ``trips``: nothing
    is left pending, and the kernel's per-round counts are the ones its
    outputs imply (across the grid-to-one-block hand-over at 1,024 rows)."""
    comps, mask, slots, trips = insert_edge_case("tail_crossing")
    comps = torch.from_numpy(comps).to(cuda)
    mask = torch.from_numpy(mask).to(cuda)
    _sc, _sr, gid, stats, counts = ph._insert_cuda(comps, mask, slots, trips)
    counts = counts.tolist()
    tail = ph.insert_kernel_config(cuda)["tail_rows"]
    assert counts[0] == int(mask.sum()) > tail
    assert any(0 < c <= tail for c in counts)
    stop = counts.index(0)
    assert 0 < stop < trips and not any(counts[stop:])
    assert stats[0].item() == 0 and bool((gid[mask] >= 0).all())
    assert counts == ph.insert_round_profile(comps, mask, gid, slots, trips)


def test_insert_kernel_config(cuda):
    cfg = ph.insert_kernel_config(cuda)
    props = torch.cuda.get_device_properties(cuda)
    assert cfg["grid_blocks"] % props.multi_processor_count == 0
    assert cfg["grid_blocks"] >= props.multi_processor_count
    assert cfg["block_threads"] == 256 and cfg["tail_rows"] == 1024


def test_aggregation_of_empty_input_stays_on_the_card(cuda):
    calls = [AggregateCall(resolve_aggregate("sum", [BIGINT]), [1])]
    op = HashAggregationOperatorFactory(0, [0], [BIGINT], [None], calls, SINGLE, 64,
                                        device=cuda).create_operator()
    op.finish()
    page = op.get_output()
    assert page is not None and page.mask.device == cuda
    assert all(b.data.device == cuda for b in page.blocks)
    assert not bool(page.mask.any())


@pytest.mark.parametrize("ncomps", [3, 6])
def test_insert_kernel_matches_plain_version_at_q3_sf1_grouping_shape(cuda, ncomps):
    """A 2^20-row page with ~1,500 groups among its live rows into 8,192
    slots: Q3's grouping at SF1."""
    comps, mask, slots = grouping_case(1 << 20, 1500, ncomps, live=0.02)
    assert slots == 8192
    comps, mask = torch.from_numpy(comps).to(cuda), torch.from_numpy(mask).to(cuda)
    before = ph.insert_table.launches
    got = ph.insert_table(comps, mask, slots)
    assert ph.insert_table.launches == before + 1
    want = ph.insert_table_reference(comps, mask, slots)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[3][0].item() == 0 and 1400 < got[3][2].item() <= 1500


@pytest.mark.parametrize("q", [5, 9])
def test_join_queries_on_the_card_equal_the_cpu_run(cuda, q):
    """SQL Q5 and Q9 at ``tiny`` with ``hash_kernels="pallas"``: the card's
    rows and counters equal the CPU run's (the same page capacity on both),
    and the card launched the insert once per join build and grouped page.
    One driver per pipeline on both, so the same pages reach the same
    builders in the same order."""
    from presto_tpu_torch.metadata import Session
    from presto_tpu_torch.models.tpch_sql import QUERIES
    from presto_tpu_torch.runner import LocalQueryRunner
    from presto_tpu_torch.utils.metrics import METRICS

    names = ("pallas.join_builds", "pallas.join_fallbacks", "pallas.agg_pages",
             "pallas.agg_fallbacks", "join.expansion_chunks", "join.expanded_rows")
    runs = {}
    for dev in ("cpu", cuda):
        session = Session(catalog="tpch", schema="tiny",
                          properties={"hash_kernels": "pallas", "page_capacity": 1 << 18,
                                      "driver_parallelism": 1})
        before = {k: METRICS.counter_value(k) for k in names}
        inserts = ph.insert_table.launches
        rows = LocalQueryRunner(session, device=dev).execute(QUERIES[q]).rows
        delta = {k: METRICS.counter_value(k) - before[k] for k in names}
        runs[str(dev)] = rows, delta, ph.insert_table.launches - inserts
    (cpu_rows, cpu_delta, _), (rows, delta, inserts) = runs["cpu"], runs[str(cuda)]
    assert rows == cpu_rows and len(rows) == {5: 5, 9: 168}[q]
    assert delta == cpu_delta
    assert delta["pallas.join_builds"] == {5: 3, 9: 4}[q]
    assert delta["pallas.join_fallbacks"] == 0 == delta["pallas.agg_fallbacks"]
    assert inserts == delta["pallas.join_builds"] + delta["pallas.agg_pages"]


@pytest.mark.parametrize("q", [3, 9])
def test_fused_segments_on_the_card_equal_the_cpu_run(cuda, q):
    """SQL Q3 and Q9 at ``tiny`` under the defaults (fused segments,
    coalesced pages): the card's rows, segments and dispatches equal the CPU
    run's, and on the card the fused probe stages launched the probe kernel
    once per page and probed table. One driver per pipeline on both, so
    the coalesced pages are the same."""
    from presto_tpu_torch.metadata import Session
    from presto_tpu_torch.models.tpch_sql import QUERIES
    from presto_tpu_torch.runner import LocalQueryRunner

    runs = {}
    for dev in ("cpu", cuda):
        session = Session(catalog="tpch", schema="tiny",
                          properties={"hash_kernels": "pallas", "page_capacity": 1 << 18,
                                      "driver_parallelism": 1})
        res = LocalQueryRunner(session, device=dev).execute(QUERIES[q])
        segs = res.stats["segments"]["segments"]
        runs[str(dev)] = res.rows, [(s["operators"], s["dispatches"]) for s in segs], segs
    (cpu_rows, cpu_segs, cpu_raw), (rows, segs, raw) = runs["cpu"], runs[str(cuda)]
    assert rows == cpu_rows and segs == cpu_segs
    assert all(s["probe_launches"] == 0 for s in cpu_raw)
    probes = [sum(n.startswith("LookupJoin") for n in s["operators"]) for s in raw]
    assert [s["probe_launches"] for s in raw] == [p * s["dispatches"]
                                                  for p, s in zip(probes, raw)]
    assert sum(s["probe_launches"] for s in raw) > 0


@pytest.mark.parametrize("q", [4, 7, 10, 16, 18, 19, 20, 2, 8, 11, 12, 14, 15, 17, 21, 22])
def test_never_run_queries_on_the_card_equal_the_cpu_run(cuda, q):
    """The queries no earlier card run reached (SEMI/ANTI and null-aware
    NOT IN probes among them; then CASE, division, min/max, scalar
    subqueries and filtered semi joins), at ``tiny`` under the full defaults: four
    drivers per cut pipeline and the staged scan on the card, one driver
    on the CPU; the rows are equal, DOUBLE to 1e-12 relative, and the card
    launched no plain kernel: the insert once per join build and grouped
    page. The join fallbacks equal the CPU run's, which tier-1 holds equal
    to the reference's."""
    import math

    from presto_tpu_torch.metadata import Session
    from presto_tpu_torch.models.tpch_sql import QUERIES
    from presto_tpu_torch.runner import LocalQueryRunner
    from presto_tpu_torch.utils.metrics import METRICS

    runs = {}
    for dev in ("cpu", cuda):
        session = Session(catalog="tpch", schema="tiny",
                          properties={"hash_kernels": "pallas", "page_capacity": 1 << 18})
        builds, pages, fallbacks = (METRICS.counter_value(k) for k in (
            "pallas.join_builds", "pallas.agg_pages", "pallas.join_fallbacks"))
        inserts = ph.insert_table.launches
        res = LocalQueryRunner(session, device=dev).execute(QUERIES[q])
        delta = METRICS.counter_value("pallas.join_builds") - builds + \
            METRICS.counter_value("pallas.agg_pages") - pages
        fell = METRICS.counter_value("pallas.join_fallbacks") - fallbacks
        runs[str(dev)] = res, delta, ph.insert_table.launches - inserts, fell
    (cpu, _, _, cpu_fell), (card, delta, inserts, card_fell) = runs["cpu"], runs[str(cuda)]
    assert card_fell == cpu_fell
    assert card.rows and len(card.rows) == len(cpu.rows)
    assert max(card.drivers) == 4 and max(cpu.drivers) == 1
    for g, w in zip(card.rows, cpu.rows):
        for a, b in zip(g, w):
            if isinstance(a, float):
                assert math.isclose(a, b, rel_tol=1e-12, abs_tol=0.0), (g, w)
            else:
                assert a == b, (g, w)
    assert inserts == delta



CARD_SETOPS = {
    "rollup": "select l_returnflag, l_linestatus, count(*), sum(l_extendedprice) "
              "from lineitem group by rollup(l_returnflag, l_linestatus) order by 1, 2",
    "except": "select c_custkey from customer except select o_custkey from orders order by 1",
}


def _card_against_cpu(cuda, catalog: str, sql: str):
    """One query at ``tiny`` under the full defaults with ``pallas``, on the
    CPU and on the card: equal rows (DOUBLE to 1e-12 relative), no fallback,
    and the card's insert launched once per join build and grouped page."""
    import math

    from presto_tpu_torch.metadata import Session
    from presto_tpu_torch.runner import LocalQueryRunner
    from presto_tpu_torch.utils.metrics import METRICS

    runs = {}
    for dev in ("cpu", cuda):
        session = Session(catalog=catalog, schema="tiny",
                          properties={"hash_kernels": "pallas", "page_capacity": 1 << 18})
        before = {k: METRICS.counter_value(k) for k in (
            "pallas.join_builds", "pallas.agg_pages", "pallas.join_fallbacks",
            "pallas.agg_fallbacks")}
        inserts = ph.insert_table.launches
        res = LocalQueryRunner(session, device=dev).execute(sql)
        delta = {k: METRICS.counter_value(k) - v for k, v in before.items()}
        runs[str(dev)] = res, delta, ph.insert_table.launches - inserts
    (cpu, _, _), (card, delta, inserts) = runs["cpu"], runs[str(cuda)]
    assert len(card.rows) == len(cpu.rows)
    for g, w in zip(card.rows, cpu.rows):
        for a, b in zip(g, w):
            if isinstance(a, float):
                assert math.isclose(a, b, rel_tol=1e-12, abs_tol=0.0), (g, w)
            else:
                assert a == b, (g, w)
    assert delta["pallas.join_fallbacks"] == 0 == delta["pallas.agg_fallbacks"]
    assert inserts == delta["pallas.join_builds"] + delta["pallas.agg_pages"]
    return card, delta


@pytest.mark.parametrize("q", [27, 64, 72])
def test_tpcds_queries_on_the_card_equal_the_cpu_run(cuda, q):
    """TPC-DS Q27 (ROLLUP through the union replay), Q64 and Q72 (date +
    interval, a 7-way join with expansion) at ``tpcds.tiny``; each builds
    on the open-addressing table on the card."""
    from presto_tpu_torch.models.tpcds_sql import QUERIES

    card, delta = _card_against_cpu(cuda, "tpcds", QUERIES[q])
    assert card.rows and delta["pallas.join_builds"] > 0


@pytest.mark.parametrize("name", sorted(CARD_SETOPS))
def test_set_operations_on_the_card_equal_the_cpu_run(cuda, name):
    """A ROLLUP and an EXCEPT at ``tpch.tiny``: the union branches drain
    into their buffers on the card and the replay scan reads them back."""
    card, _ = _card_against_cpu(cuda, "tpch", CARD_SETOPS[name])
    assert card.rows


CARD_WRITES = [
    "create table memory.default.cw_o as select o_orderkey, o_custkey, o_orderdate, "
    "o_orderpriority, o_totalprice from orders where o_totalprice > 100000",
    "insert into memory.default.cw_o select o_orderkey, o_custkey, o_orderdate, "
    "o_orderpriority, o_totalprice from orders where o_totalprice <= 100000 "
    "and o_orderkey < 20000",
    "insert into memory.default.cw_o values (1, null, date '1999-01-01', 'ZNEW', 1.50)",
    "select o_orderpriority, count(*), sum(o_totalprice), max(o_orderdate) "
    "from memory.default.cw_o group by 1 order by 1",
    "select c_name, o_totalprice from memory.default.cw_o join customer "
    "on o_custkey = c_custkey order by o_totalprice desc, c_name limit 20",
    "select count(*) from memory.default.cw_o where o_orderpriority = 'ZNEW'",
]


def test_writes_on_the_card_equal_the_cpu_run(cuda):
    """CTAS of a filtered scan, INSERT SELECT and INSERT VALUES (a NULL and
    a new dictionary value), then reads that group and join the written
    table, at ``tpch.tiny``: the card's sinks copy its pages to pinned host
    RAM and its scans upload them back; every result equals the CPU run's."""
    from presto_tpu_torch.metadata import Session
    from presto_tpu_torch.runner import LocalQueryRunner

    runs = {}
    for dev in ("cpu", cuda):
        r = LocalQueryRunner(Session(catalog="tpch", schema="tiny",
                                     properties={"hash_kernels": "pallas"}), device=dev)
        runs[str(dev)] = [r.execute(sql).rows for sql in CARD_WRITES]
        mem = r.catalogs.get("memory").metadata()
        pages = mem.table_data(mem.get_table_handle(mem.list_tables("default")[0])).pages
        assert all(p.mask.device.type == "cpu" for p in pages)
        if str(dev) != "cpu":
            assert all(p.mask.is_pinned() for p in pages)
    cpu, card = runs["cpu"], runs[str(cuda)]
    for c, g in zip(cpu, card):
        assert sorted(map(repr, g)) == sorted(map(repr, c))
    assert card[-1] == [[1]]


def test_collect_grouping_on_the_card_equals_the_cpu_run(cuda):
    """array_agg with cardinality and histogram beside count(*), grouped:
    arrays compared as multisets."""
    from collections import Counter

    from presto_tpu_torch.metadata import Session
    from presto_tpu_torch.runner import LocalQueryRunner

    sql = ("select o_custkey, array_agg(o_orderkey), cardinality(array_agg(o_orderkey)), "
           "histogram(o_orderstatus), count(*) from orders group by o_custkey")
    runs = {}
    for dev in ("cpu", cuda):
        rows = LocalQueryRunner(Session(catalog="tpch", schema="tiny"),
                                device=dev).execute(sql).rows
        runs[str(dev)] = sorted((r[0], tuple(sorted(Counter(r[1]).items())), r[2], r[3], r[4])
                                for r in rows)
    assert runs[str(cuda)] == runs["cpu"] and len(runs["cpu"]) == 1000


def test_pressured_q3_launches_on_the_card(cuda):
    """SQL Q3 at ``tiny`` with ``hash_kernels="pallas"`` under a one-byte
    pool: every build page goes to host RAM and on to a PCOL run on disk
    (the default ladder), and comes back before the table is built, so the
    card's rows, counters and runs equal the CPU run's and each insert and
    probe ran as a CUDA launch (a build over host pages would run the plain
    version and count none)."""
    from presto_tpu_torch.metadata import Session
    from presto_tpu_torch.models.tpch_sql import QUERIES
    from presto_tpu_torch.runner import LocalQueryRunner
    from presto_tpu_torch.utils import events
    from presto_tpu_torch.utils.metrics import METRICS

    names = ("pallas.join_builds", "pallas.join_fallbacks", "pallas.agg_pages",
             "memory.revoked_bytes")
    runs = {}
    for dev in ("cpu", cuda):
        session = Session(catalog="tpch", schema="tiny",
                          properties={"hash_kernels": "pallas", "page_capacity": 1 << 12,
                                      "driver_parallelism": 1, "memory_pool_bytes": 1})
        before = {k: METRICS.counter_value(k) for k in names}
        seq = events.JOURNAL.last_seq()
        inserts, probes = ph.insert_table.launches, ph.probe_table.launches
        rows = LocalQueryRunner(session, device=dev).execute(QUERIES[3]).rows
        delta = {k: METRICS.counter_value(k) - before[k] for k in names}
        spills = len(events.JOURNAL.events(since=seq, kind="memory.spill", limit=1 << 20))
        disk = sorted(e["run_kind"] for e in events.JOURNAL.events(
            since=seq, kind="query.spill.disk", limit=1 << 20))
        runs[str(dev)] = (rows, delta, spills, ph.insert_table.launches - inserts,
                          ph.probe_table.launches - probes, disk)
    cpu_rows, cpu_delta, cpu_spills, cpu_inserts, cpu_probes, cpu_disk = runs["cpu"]
    rows, delta, spills, inserts, probes, disk = runs[str(cuda)]
    assert disk == cpu_disk and "join" in disk
    assert rows == cpu_rows and len(rows) == 10
    # the bytes moved differ: on the CPU the grouping shrinks its partials
    # to the first page's group count (``_decide_strategy``), on the card not
    counts = [k for k in names if k != "memory.revoked_bytes"]
    assert {k: delta[k] for k in counts} == {k: cpu_delta[k] for k in counts}
    assert spills == cpu_spills > 0
    assert delta["pallas.join_builds"] == 2 and delta["pallas.join_fallbacks"] == 0
    assert delta["memory.revoked_bytes"] > 0 and cpu_delta["memory.revoked_bytes"] > 0
    assert cpu_inserts == cpu_probes == 0  # the CPU runs the plain versions
    assert inserts == delta["pallas.join_builds"] + delta["pallas.agg_pages"] and probes > 0


def test_grouped_query_on_the_card_equals_the_cpu_run(cuda, tmp_path):
    """A co-bucketed hive join and grouping at ``tiny`` runs one bucket at
    a time on the card (``last_grouped == 4``), with the CPU run's rows."""
    from presto_tpu_torch.connectors.hive import HiveConnector
    from presto_tpu_torch.metadata import Session
    from presto_tpu_torch.runner import LocalQueryRunner

    sql = ("select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue, "
           "o_orderdate, o_shippriority from hive.default.lineitem join hive.default.orders "
           "on l_orderkey = o_orderkey where o_orderdate < date '1995-03-15' and "
           "l_shipdate > date '1995-03-15' group by l_orderkey, o_orderdate, o_shippriority "
           "order by revenue desc, o_orderdate limit 10")
    runs = {}
    for dev in ("cpu", cuda):
        r = LocalQueryRunner(Session(catalog="tpch", schema="tiny",
                                     properties={"hash_kernels": "pallas"}), device=dev)
        r.catalogs.register("hive", HiveConnector("hive", str(tmp_path / str(dev))))
        r.execute("create table hive.default.lineitem with (bucketed_by = array['l_orderkey'], "
                  "bucket_count = 4) as select l_orderkey, l_extendedprice, l_discount, "
                  "l_shipdate from lineitem")
        r.execute("create table hive.default.orders with (bucketed_by = array['o_orderkey'], "
                  "bucket_count = 4) as select o_orderkey, o_orderdate, o_shippriority "
                  "from orders")
        runs[str(dev)] = r.execute(sql).rows
        assert r.last_grouped == 4
    assert runs[str(cuda)] == runs["cpu"] and len(runs["cpu"]) == 10


def test_dense_join_on_the_card_equals_the_cpu_run(cuda):
    """The DENSE build and probe (plain PyTorch, no hand kernel) on the card
    give the CPU run's rows and row table."""
    from presto_tpu_torch.block import page_from_arrays
    from presto_tpu_torch.ops import hash_join as hj
    from presto_tpu_torch.types import DOUBLE

    rng = np.random.RandomState(16)
    bkeys = rng.choice(np.arange(-50, 200), size=90, replace=False).astype(np.int64)
    bvals = rng.randint(-1000, 1000, size=90).astype(np.int64)
    pkeys = rng.randint(-80, 260, size=200).astype(np.int64)
    pw = rng.rand(200)
    runs = {}
    for dev in ("cpu", cuda):
        bf = hj.JoinBuildOperatorFactory(0, [0], [1], [(BIGINT, None)], strategy="dense",
                                         unique=True, dense_min=int(bkeys.min()),
                                         dense_max=int(bkeys.max()), device=dev)
        b = bf.create_operator()
        b.add_input(page_from_arrays([BIGINT, BIGINT], [bkeys, bvals], device=dev))
        b.finish()
        pf = hj.LookupJoinOperatorFactory(1, bf.lookup_factory, [0], [0, 1],
                                          [(BIGINT, None), (DOUBLE, None)], [0],
                                          [(BIGINT, None)], hj.LEFT)
        j = pf.create_operator()
        j.add_input(page_from_arrays([BIGINT, DOUBLE], [pkeys, pw], device=dev))
        rows = []
        while (o := j.get_output()) is not None:
            rows.extend(o.to_pylists())
        runs[str(dev)] = (rows, bf.lookup_factory.get().table.cpu().numpy())
    assert runs[str(cuda)][0] == runs["cpu"][0] and len(runs["cpu"][0]) == 200
    np.testing.assert_array_equal(runs[str(cuda)][1], runs["cpu"][1])


def test_distributed_q3_on_four_workers_of_the_card(cuda):
    """Q3 at ``tiny`` through ``DistributedQueryRunner`` on
    ``MeshContext([cuda] * 4)`` gives the port's local rows, the join builds
    on the insert kernel and the probes on the probe kernel, and no page
    reaches an exchange from host memory."""
    from presto_tpu_torch.metadata import Session
    from presto_tpu_torch.models.tpch_sql import QUERIES
    from presto_tpu_torch.parallel.mesh import MeshContext
    from presto_tpu_torch.parallel.runner import EXCHANGE_STATS, DistributedQueryRunner
    from presto_tpu_torch.runner import LocalQueryRunner

    session = Session(catalog="tpch", schema="tiny", properties={"hash_kernels": "pallas"})
    want = LocalQueryRunner(session, device="cpu").execute(QUERIES[3]).rows
    r = DistributedQueryRunner(MeshContext([cuda] * 4), session, device=cuda)
    uploads = EXCHANGE_STATS["host_uploads"]
    ph.insert_table.launches = ph.probe_table.launches = 0
    got = r.execute(QUERIES[3]).rows
    assert got == want and len(want) == 10
    assert ph.insert_table.launches >= 8 and ph.probe_table.launches >= 1
    assert EXCHANGE_STATS["host_uploads"] == uploads


def test_cluster_q3_on_two_workers_of_the_card(cuda):
    """Q3 at ``tiny`` through a ``ClusterQueryRunner`` and two HTTP
    ``WorkerServer``s on the card gives the port's local rows, with both
    kernels launched by the workers' tasks."""
    import threading

    from presto_tpu_torch.cluster import ClusterQueryRunner, WorkerServer
    from presto_tpu_torch.metadata import Session
    from presto_tpu_torch.models.tpch_sql import QUERIES
    from presto_tpu_torch.runner import LocalQueryRunner

    session = Session(catalog="tpch", schema="tiny", properties={"hash_kernels": "pallas"})
    want = LocalQueryRunner(session, device=cuda).execute(QUERIES[3]).rows
    runner = ClusterQueryRunner(session, min_workers=2, worker_wait_s=10.0, device=cuda)
    workers = [WorkerServer(port=0, device=cuda).start() for _ in range(2)]
    stop = threading.Event()

    def keep_alive():
        while not stop.wait(1.0):
            for w in workers:
                runner.nodes.announce(w.node_id, w.uri)
    for w in workers:
        runner.nodes.announce(w.node_id, w.uri)
    t = threading.Thread(target=keep_alive, daemon=True)
    t.start()
    try:
        ph.insert_table.launches = ph.probe_table.launches = 0
        got = runner.execute(QUERIES[3]).rows
        assert got == want and len(want) == 10
        assert ph.insert_table.launches >= 4 and ph.probe_table.launches >= 1
    finally:
        stop.set()
        t.join(5.0)
        runner.detector.stop()
        for w in workers:
            w.stop()
        for w in workers:
            assert w.join_tasks(60.0)


def test_server_q3_on_the_card(cuda):
    """Q3 at ``tiny`` served by ``PrestoTpuServer`` over a runner on the card
    and fetched through ``StatementClient``: the rows of the in-process
    run after the JSON round trip, with the insert and the probe launched."""
    from presto_tpu_torch.client import StatementClient
    from presto_tpu_torch.metadata import Session
    from presto_tpu_torch.models.tpch_sql import QUERIES
    from presto_tpu_torch.runner import LocalQueryRunner
    from presto_tpu_torch.server import PrestoTpuServer

    session = Session(catalog="tpch", schema="tiny", properties={"hash_kernels": "pallas"})
    runner = LocalQueryRunner(session, device=cuda)
    server = PrestoTpuServer(runner, port=0, page_rows=3)
    server.start()
    try:
        want = [server.manager._to_json_row(r) for r in runner.execute(QUERIES[3]).rows]
        ph.insert_table.launches = ph.probe_table.launches = 0
        client = StatementClient(f"http://127.0.0.1:{server.port}", QUERIES[3])
        got = list(client.rows())
        assert got == want and len(want) == 10
        assert client.stats["state"] == "FINISHED"
        assert ph.insert_table.launches >= 2 and ph.probe_table.launches >= 1
    finally:
        server.stop()
