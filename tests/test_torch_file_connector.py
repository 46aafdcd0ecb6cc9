"""The port's file catalog (``presto_tpu_torch/connectors/file``), its
pushed-down scan constraint and its split-reader scan, against presto_tpu
on the CPU at ``tpch.tiny``.

One reference runner and one port runner per write format (PCOL, Parquet,
ORC), each with a ``FileConnector`` of its own, run the same statements:
CTAS from ``tpch``, several INSERTs (so the re-batch crosses file
boundaries), Q1/Q3/Q6 over the written tables and mixed with ``tpch``, an
INSERT VALUES that grows a dictionary (the older files remap into the
union), and DROP. Every statement's rows (or its error) must be equal,
exact but for DOUBLE sums (``DOUBLE_REL_TOL``, 1e-12 relative); each
package also reads the other's files to the same rows. Besides:

- the splits a constraint keeps, in both packages;
- ``_extract_constraint``'s domains on every scan of Q1-Q22;
- ``_native_prefilter``'s mask, ``remap_codes`` and ``external_strings``
  against the reference's code on the same input;
- ``split_readers`` opens no file when it is set up, and the split-parallel
  scan gives the serial scan's rows in order;
- the scaled writers write as many files as the reference's;
- the PCOL catalog cases of ``tests/test_pcol.py`` and the stale-file
  errors of both packages.
"""
import os

import numpy as np
import pytest

from presto_tpu.connectors import file as ref_file
from presto_tpu.exec import local_planner as ref_local_planner
from presto_tpu.metadata import Session as RefSession
from presto_tpu.runner import LocalQueryRunner as RefRunner
from presto_tpu_torch.connectors import file as port_file
from presto_tpu_torch.connectors.file import FileConnector
from presto_tpu_torch.exec import local_planner
from presto_tpu_torch.metadata import Session
from presto_tpu_torch.models.tpch_sql import QUERIES
from presto_tpu_torch.runner import LocalQueryRunner
from presto_tpu_torch.spi.connector import Constraint, SchemaTableName
from presto_tpu_torch.utils.metrics import METRICS
from test_torch_sql import assert_same_rows
from test_torch_writers import run_both

LI_COLS = ("l_orderkey, l_partkey, l_quantity, l_extendedprice, l_discount, l_tax, "
           "l_returnflag, l_linestatus, l_shipdate, l_comment")


def _runners(tmp_path, fmt: str, **props):
    """(reference runner, port runner), each with a ``wh`` file catalog of
    its own under ``tmp_path`` in write format ``fmt``, and a read-only
    ``other`` catalog over the other package's directory."""
    ref_dir, port_dir = str(tmp_path / f"ref-{fmt}"), str(tmp_path / f"port-{fmt}")
    ref = RefRunner(RefSession(catalog="tpch", schema="tiny", properties=dict(props)))
    ref.catalogs.register("wh", ref_file.FileConnector("wh", ref_dir, write_format=fmt))
    ref.catalogs.register("other", ref_file.FileConnector("other", port_dir, write_format=fmt))
    port = LocalQueryRunner(Session(catalog="tpch", schema="tiny", properties=dict(props)),
                            device="cpu")
    port.catalogs.register("wh", FileConnector("wh", port_dir, write_format=fmt))
    port.catalogs.register("other", FileConnector("other", ref_dir, write_format=fmt))
    return ref, port


def _over(sql: str, tables: dict) -> str:
    for name, qualified in tables.items():
        sql = sql.replace(f"from {name}", f"from {qualified}")
    return sql


Q3_TABLES = "from customer, orders, lineitem"


@pytest.fixture(scope="module", params=["pcol", "parquet", "orc"])
def warehouse(request, tmp_path_factory):
    """Both runners after the same CTAS from ``tpch`` and two INSERTs (the
    re-batch crosses file boundaries), one warehouse per write format,
    written once for the module's tests."""
    ref, port = _runners(tmp_path_factory.mktemp(request.param), request.param)
    run_both((ref, port), [
        f"create table wh.default.li as select {LI_COLS} from lineitem where l_orderkey < 20000",
        f"insert into wh.default.li select {LI_COLS} from lineitem "
        "where l_orderkey >= 20000 and l_orderkey < 40000",
        f"insert into wh.default.li select {LI_COLS} from lineitem where l_orderkey >= 40000",
        "create table wh.default.orders as select * from orders",
        "create table wh.default.customer as select * from customer",
    ])
    return ref, port


def test_writes_and_queries_equal(warehouse):
    run_both(warehouse, [
        "select count(*), sum(l_quantity), min(l_comment), max(l_shipdate) from wh.default.li",
        _over(QUERIES[1], {"lineitem": "wh.default.li"}),
        _over(QUERIES[6], {"lineitem": "wh.default.li"}),
        QUERIES[3].replace(Q3_TABLES, "from wh.default.customer, wh.default.orders, "
                                      "wh.default.li"),
        QUERIES[3].replace(Q3_TABLES, "from tpch.tiny.customer, tpch.tiny.orders, "
                                      "wh.default.li"),
        "select o_orderpriority, count(*) from wh.default.orders "
        "where o_orderstatus = 'F' and o_comment like '%special%' group by 1 order by 1",
    ])


def test_each_package_reads_the_others_files(warehouse):
    ref, port = warehouse
    for sql in ("select count(*), sum(l_extendedprice), min(l_comment) from {}.default.li",
                "select c_mktsegment, count(*) from {}.default.customer group by 1 order by 1",
                _over(QUERIES[6], {"lineitem": "{}.default.li"})):
        want = ref.execute(sql.format("wh")).rows
        assert_same_rows(port.execute(sql.format("other")).rows, want)
        assert_same_rows(ref.execute(sql.format("other")).rows, want)


def test_grown_dictionary_remaps_older_files(warehouse):
    """A dictionary grows: the older files remap into the table's union."""
    run_both(warehouse, [
        "create table wh.default.nat as select n_nationkey, n_name from nation",
        "insert into wh.default.nat values (100, 'ATLANTIS')",
        "insert into wh.default.nat select n_nationkey + 200, n_name from nation "
        "where n_regionkey = 2",
        "select n_name from wh.default.nat where n_nationkey = 100",
        "select n_name, count(*) from wh.default.nat group by 1 order by 1",
        "select count(*) from wh.default.nat where n_name = 'CANADA'",
        "drop table wh.default.nat",
        "select count(*) from wh.default.nat",
    ])


def test_drops_equal(warehouse):
    ref, port = warehouse
    for t in ("li", "orders", "customer"):
        run_both(warehouse, [f"drop table wh.default.{t}"])
    assert port.execute("show tables from wh.default").rows == []
    assert ref.execute("show tables from wh.default").rows == []


def test_refusals_equal(tmp_path):
    ref, port = _runners(tmp_path, "pcol")
    run_both((ref, port), [
        "create table wh.default.t as select n_nationkey from nation",
        "create table wh.default.t as select n_nationkey from nation",
    ])
    # a parquet catalog over the pcol tables cannot write into them
    ref.catalogs.register("pc", ref_file.FileConnector("pc", str(tmp_path / "ref-pcol"),
                                                       write_format="parquet"))
    port.catalogs.register("pc", FileConnector("pc", str(tmp_path / "port-pcol"),
                                               write_format="parquet"))
    run_both((ref, port), ["insert into pc.default.t select n_nationkey from nation",
                           "select count(*) from pc.default.t"])
    with pytest.raises(ValueError, match="unknown file write format"):
        FileConnector("x", str(tmp_path / "x"), write_format="csv")


# ------------------------------------------------ split pruning and domains

@pytest.fixture(scope="module")
def year_tables(tmp_path_factory):
    """lineitem's Q6 columns, one l_shipdate year per INSERT, in both
    packages (PCOL)."""
    tmp = tmp_path_factory.mktemp("years")
    ref, port = _runners(tmp, "pcol")
    cols = "l_orderkey, l_quantity, l_extendedprice, l_discount, l_shipdate"
    stmts = [f"create table wh.default.y as select {cols} from lineitem where l_orderkey < 0"]
    for year in range(1992, 1999):
        stmts.append(f"insert into wh.default.y select {cols} from lineitem where "
                     f"l_shipdate >= date '{year}-01-01' and l_shipdate < date '{year + 1}-01-01'")
    run_both((ref, port), stmts)
    return ref, port


def _splits(runner, catalog: str, table: str, constraint):
    conn = runner.metadata.connector(catalog)
    handle = conn.metadata().get_table_handle(SchemaTableName("default", table))
    return [os.path.basename(s.payload[1]) if len(s.payload) == 2 else
            (os.path.basename(s.payload[1]), s.payload[2])
            for s in conn.split_manager().get_splits(handle, constraint, 8)]


def test_year_inserts_prune_to_one_year(year_tables):
    ref, port = year_tables
    from presto_tpu.spi.connector import Constraint as RefConstraint

    lo, hi = 8766, 9130  # 1994-01-01 .. 1994-12-31 in days
    got = _splits(port, "wh", "y", Constraint({"l_shipdate": (lo, hi)}))
    want = _splits(ref, "wh", "y", RefConstraint({"l_shipdate": (lo, hi)}))
    assert len(got) == len(want) == 1
    # the port's files have other names: compare what each split holds
    assert len(_splits(port, "wh", "y", Constraint.all())) == \
        len(_splits(ref, "wh", "y", RefConstraint.all())) == 7
    run_both(year_tables, [_over(QUERIES[6], {"lineitem": "wh.default.y"})])
    assert port.execute(_over(QUERIES[6], {"lineitem": "wh.default.y"})).rows == \
        port.execute(QUERIES[6]).rows


def test_external_splits_keep_the_same_chunks(tmp_path):
    """Parquet row groups and ORC stripes, pruned by their statistics."""
    import pyarrow as pa
    import pyarrow.orc as pa_orc
    import pyarrow.parquet as pq
    from presto_tpu.spi.connector import Constraint as RefConstraint

    base = tmp_path / "ext"
    for name, write in (("pq", lambda t, p: pq.write_table(t, p + ".parquet",
                                                           row_group_size=5000)),
                        ("oc", lambda t, p: pa_orc.write_table(t, p + ".orc",
                                                               stripe_size=2048))):
        (base / "default" / name).mkdir(parents=True)
        k = np.arange(50000)
        write(pa.table({"k": pa.array(k), "s": pa.array([f"g{i % 7}" for i in k])}),
              str(base / "default" / name / "part0"))
    ref = RefRunner(RefSession(catalog="wh", schema="default"))
    ref.catalogs.register("wh", ref_file.FileConnector("wh", str(base)))
    port = LocalQueryRunner(Session(catalog="wh", schema="default"), device="cpu")
    port.catalogs.register("wh", FileConnector("wh", str(base)))
    for name in ("pq", "oc"):
        for dom in ((12000, 13000), (None, 100), (10 ** 9, None), (None, None)):
            got = _splits(port, "wh", name, Constraint({"k": dom}))
            assert got == _splits(ref, "wh", name, RefConstraint({"k": dom}))
        assert 0 < len(_splits(port, "wh", name, Constraint({"k": (12000, 13000)}))) < \
            len(_splits(port, "wh", name, Constraint.all()))
        run_both((ref, port), [
            f"select count(*), min(k), max(k) from {name} where k between 12000 and 13000",
            f"select s, count(*) from {name} where k < 777 group by s order by s"])


def _scan_domains(module, planner_cls, runner, sql, **kw):
    """The domains ``_extract_constraint`` gives at each scan of ``sql``'s
    local plan, as (table, sorted domains) in plan order."""
    seen = []
    real = module._extract_constraint

    def record(filter_parts, scan):
        c = real(filter_parts, scan)
        seen.append((scan.table.schema_table.table, sorted(c.domains.items())))
        return c

    module._extract_constraint = record
    try:
        planner_cls(runner.metadata, runner.session, **kw).plan(runner.plan_sql(sql))
    finally:
        module._extract_constraint = real
    return seen


@pytest.mark.parametrize("q", range(1, 23))
def test_extract_constraint_equal_on_tpch(q):
    ref = RefRunner(RefSession(catalog="tpch", schema="tiny"))
    port = LocalQueryRunner(Session(catalog="tpch", schema="tiny"), device="cpu")
    got = _scan_domains(local_planner, local_planner.LocalExecutionPlanner, port, QUERIES[q],
                        device="cpu")
    want = _scan_domains(ref_local_planner, ref_local_planner.LocalExecutionPlanner, ref,
                         QUERIES[q])
    assert sorted(got, key=repr) == sorted(want, key=repr)
    if q in (1, 6, 14):  # date ranges on lineitem
        assert any(t == "lineitem" and d for t, d in got)


def test_extract_constraint_cases():
    """Flipped comparisons, AND trees, DECIMAL and DATE bounds, strict
    bounds on DOUBLE, equalities and string constants, in both packages."""
    ref = RefRunner(RefSession(catalog="tpch", schema="tiny"))
    port = LocalQueryRunner(Session(catalog="tpch", schema="tiny"), device="cpu")
    for where in (
            "0.05 < l_discount and l_discount <= 0.07 and 24 > l_quantity",
            "l_shipdate >= date '1994-01-01' and l_shipdate < date '1994-01-01' + interval '1' year",
            "l_quantity = 7 and l_returnflag = 'R'",
            "l_extendedprice > 1000.5 and l_extendedprice < 1000.75",
            "(l_quantity > 3 and l_quantity < 9) and l_orderkey >= 100 and l_tax = 0.04",
            "l_discount > 0.051 and l_discount < 0.069",
            "l_quantity < 10 or l_quantity > 40"):
        sql = f"select count(*) from lineitem where {where}"
        got = _scan_domains(local_planner, local_planner.LocalExecutionPlanner, port, sql,
                            device="cpu")
        want = _scan_domains(ref_local_planner, ref_local_planner.LocalExecutionPlanner, ref, sql)
        assert got == want, where
    sql = "select count(*) from orders where o_totalprice > 100.5 and o_custkey = 7"
    got = _scan_domains(local_planner, local_planner.LocalExecutionPlanner, port, sql,
                        device="cpu")
    assert got == _scan_domains(ref_local_planner, ref_local_planner.LocalExecutionPlanner, ref,
                                sql)


# ------------------------------------------------------------ host pieces

def test_native_prefilter_equal(year_tables):
    """Both packages' ``_native_prefilter`` on the same files: the same
    masks, whole and per row range, keeping exactly the rows inside the
    domains (substrate units: DECIMAL(12,2) in cents, DATE in days)."""
    from presto_tpu.formats import pcol as ref_pcol
    from presto_tpu.spi.connector import Constraint as RefConstraint
    from presto_tpu_torch.formats import pcol

    ref, port = year_tables
    base = os.path.join(port.metadata.connector("wh").metadata().base, "default", "y")
    doms = {"l_shipdate": (8766, 9130), "l_quantity": (None, 2300), "l_discount": (5, 7),
            "l_extendedprice": (100050, None)}
    port_src = port_file.FilePageSource(None, None, [], 1 << 10, Constraint(doms))
    ref_src = ref_file.FilePageSource(None, None, [], 1 << 10, RefConstraint(doms))
    kept = 0
    for name in _splits(port, "wh", "y", Constraint.all()):
        f, g = pcol.PcolFile(os.path.join(base, name)), ref_pcol.PcolFile(os.path.join(base, name))
        try:
            got, want = port_src._native_prefilter(f), ref_src._native_prefilter(g)
            assert got.dtype == want.dtype and np.array_equal(got, want)
            kept += int(got.sum())
            for lo, hi in pcol.row_ranges(f.rows, 1000):
                assert np.array_equal(port_src._native_prefilter(f, lo, hi),
                                      ref_src._native_prefilter(g, lo, hi))
            assert port_file.FilePageSource(None, None, [], 8, Constraint.all()) \
                ._native_prefilter(f) is None
        finally:
            f.close()
            g.close()
    want = port.execute(
        "select count(*) from wh.default.y where l_shipdate between date '1994-01-01' and "
        "date '1994-12-31' and l_quantity <= 23 and l_discount between 0.05 and 0.07 "
        "and l_extendedprice >= 1000.50").rows
    assert kept == want[0][0] > 0


def test_remap_codes_equal_to_reference_loop():
    rng = np.random.default_rng(81)
    for n_codes, n_rows in ((0, 10), (1, 50), (300, 5000), (5000, 200)):
        uniq = np.unique(rng.integers(-5, 10 ** 6, n_codes))
        data = np.concatenate([rng.choice(uniq, n_rows) if len(uniq) else
                               np.zeros(0, dtype=np.int64),
                               rng.integers(-10, 10 ** 6, n_rows // 3)])  # absent codes too
        code_map = {int(c): i for i, c in enumerate(uniq)}
        want = np.asarray([code_map.get(int(x), 0) for x in data], dtype=np.int32)
        got = port_file.remap_codes(uniq, data.astype(np.int64))
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_materialize_dicts_equal():
    """A virtual dictionary's written codes, NULLs and masked rows included,
    re-encode to the reference's dictionary and codes."""
    import torch

    from presto_tpu import types as ref_types
    from presto_tpu.block import Block as RefBlock, Page as RefPage
    from presto_tpu.connectors.tpch.generator import FormattedDictionary as RefFormatted
    from presto_tpu_torch import types
    from presto_tpu_torch.block import Block, Page
    from presto_tpu_torch.connectors.tpch.generator import FormattedDictionary

    def fmt(c):
        return np.array([f"Clerk#{int(v):09d}" for v in c], dtype=object)

    rng = np.random.default_rng(82)
    d, rd = FormattedDictionary(fmt, 1000), RefFormatted(fmt, 1000)
    port_pages, ref_pages = [], []
    for p in range(3):
        codes = rng.integers(0, 1000, 256).astype(np.int32)
        nulls = rng.random(256) < 0.1
        mask = rng.random(256) < 0.7
        port_pages.append(Page((Block(types.VARCHAR, torch.from_numpy(codes),
                                      torch.from_numpy(nulls), d),),
                               torch.from_numpy(mask)))
        ref_pages.append(RefPage((RefBlock(ref_types.VARCHAR, codes, nulls, rd),), mask))
    got_d, got_pages = port_file._materialize_dicts(port_pages)
    want_d, want_pages = ref_file._materialize_dicts(ref_pages)
    assert list(got_d[0].values) == list(want_d[0].values)
    for g, w in zip(got_pages, want_pages):
        assert np.array_equal(g.blocks[0].data.numpy(), w.blocks[0].data)
        assert np.array_equal(g.blocks[0].nulls.numpy(), w.blocks[0].nulls)
        assert np.array_equal(g.mask.numpy(), w.mask)


def test_external_strings_equal():
    rng = np.random.default_rng(83)
    for vals in (np.array([None, "a", "", "bb", None], dtype=object),
                 np.array([f"v{int(x)}" if x % 5 else None for x in rng.integers(0, 99, 999)],
                          dtype=object),
                 np.array([], dtype=object),
                 np.array(["x", "y"], dtype=object)):
        want = np.asarray([u"" if v is None else v for v in vals], dtype=object).astype(str)
        got = port_file.external_strings(vals)
        assert got.dtype == want.dtype and np.array_equal(got, want)


# ------------------------------------------------------ the split readers

@pytest.fixture()
def pcol_runner(tmp_path):
    def make(**props):
        r = LocalQueryRunner(Session(catalog="tpch", schema="tiny",
                                     properties=dict(page_capacity=1 << 10, **props)),
                             device="cpu")
        r.catalogs.register("store", FileConnector("store", str(tmp_path)))
        return r
    return make


def test_split_parallel_rows_identical_to_serial(pcol_runner):
    writer = pcol_runner()
    writer.execute("create table store.w.li as select l_orderkey, l_quantity, l_shipdate, "
                   "l_comment from lineitem")
    writer.execute("insert into store.w.li select l_orderkey, l_quantity, l_shipdate, "
                   "l_comment from lineitem where l_orderkey < 500")
    q = ("select l_orderkey, l_quantity, l_comment from store.w.li "
         "where l_quantity < 30 and l_shipdate >= date '1995-01-01'")
    opens = METRICS.counter_value("pcol.native_opens")
    pipelined = pcol_runner(scan_pipeline=True, driver_parallelism=1).execute(q)
    assert METRICS.counter_value("pcol.native_opens") > opens
    serial = pcol_runner(scan_pipeline=False, driver_parallelism=1).execute(q)
    # identical rows IN ORDER: the reorder buffer makes the parallel read
    # indistinguishable from the serial one
    assert pipelined.rows == serial.rows and len(pipelined.rows) > 0
    st = pipelined.stats["scan_pipeline"]
    # the prefilter compacted rows away before the re-batch: full pages of
    # exactly the target size, then one tail
    assert st["rows"] < 60175 + 500 * 4 and st["pages"] >= 2
    parallel = pcol_runner(scan_pipeline=True, driver_parallelism=4).execute(q)
    assert sorted(parallel.rows) == sorted(serial.rows)


def test_rebatched_pages_have_the_target_size(pcol_runner):
    """Re-batching across file boundaries after the prefilter: every page
    but the last is exactly ``target_rows`` live rows."""
    from presto_tpu_torch.spi.connector import ConcatPageSource
    from presto_tpu_torch.ops.scan_pipeline import ScanPipeline

    r = pcol_runner()
    r.execute("create table store.w.rb as select l_orderkey, l_quantity from lineitem "
              "where l_orderkey < 3000")
    for lo in (3000, 9000, 20000):
        r.execute(f"insert into store.w.rb select l_orderkey, l_quantity from lineitem "
                  f"where l_orderkey >= {lo} and l_orderkey < {lo + 2000}")
    conn = r.metadata.connector("store")
    handle = conn.metadata().get_table_handle(SchemaTableName("w", "rb"))
    cols = list(conn.metadata().get_column_handles(handle).values())
    constraint = Constraint({"l_quantity": (1000, 3000)})  # DECIMAL(12,2): 10.00 .. 30.00
    splits = conn.split_manager().get_splits(handle, constraint, 8)
    assert len(splits) == 4
    src = ConcatPageSource(conn.page_source_provider().create_page_source(
        s, cols, 1 << 10, constraint) for s in splits)
    pipe = ScanPipeline(src, "cpu", target_rows=700)
    pages = []
    try:
        while (p := pipe.next()) is not None:
            pages.append(p)
    finally:
        pipe.close()
    live = [int(p.mask.sum()) for p in pages]
    assert all(n == 700 for n in live[:-1]) and 0 < live[-1] <= 700
    q = pages and np.concatenate([p.blocks[1].data.numpy()[p.mask.numpy()] for p in pages])
    assert ((q >= 1000) & (q <= 3000)).all()
    want = r.execute("select count(*) from store.w.rb where l_quantity between 10 and 30").rows
    assert sum(live) == want[0][0]


def test_split_reader_setup_is_lazy(pcol_runner, monkeypatch):
    """split_readers opens NO file when it is set up: headers come from the
    metadata cache and dictionary remaps wait for the first reader."""
    r = pcol_runner()
    r.execute("create table store.w.lazy as select l_orderkey, l_comment "
              "from lineitem where l_orderkey < 400")
    conn = r.metadata.connector("store")
    table = conn.metadata().get_table_handle(SchemaTableName("w", "lazy"))
    splits = conn.split_manager().get_splits(table, Constraint.all(), 8)
    cols = list(conn.metadata().get_table_metadata(table).columns)
    src = conn.page_source_provider().create_page_source(splits[0], cols, 1 << 10,
                                                         Constraint.all())
    opens = []
    real = port_file.PcolFile

    def counting(path, *a, **kw):
        opens.append(path)
        return real(path, *a, **kw)

    monkeypatch.setattr(port_file, "PcolFile", counting)
    readers = src.split_readers(1 << 10)
    assert readers, "libpcol builds here: the split readers exist"
    assert opens == []  # setting up touched no file
    chunk = next(iter(readers[0]()))
    assert chunk.rows > 0 and opens  # the reader did the deferred open


def test_split_pruning_opens_no_file(pcol_runner, monkeypatch):
    """The split manager prunes with the headers the metadata load cached:
    the same splits as the reference's pruning, and no file opened."""
    r = pcol_runner()
    r.execute("create table store.default.pr as select l_orderkey, l_shipdate from lineitem "
              "where l_orderkey < 2000")
    r.execute("insert into store.default.pr select l_orderkey, l_shipdate from lineitem "
              "where l_orderkey >= 50000")
    opens = []
    real = port_file.PcolFile

    def counting(path, *a, **kw):
        opens.append(path)
        return real(path, *a, **kw)

    r.execute("select count(*) from store.default.pr")  # the metadata load
    monkeypatch.setattr(port_file, "PcolFile", counting)
    kept = _splits(r, "store", "pr", Constraint({"l_orderkey": (50000, None)}))
    assert len(kept) == 1 and len(_splits(r, "store", "pr", Constraint.all())) == 2
    assert opens == []


def test_dictionary_remaps_computed_once_per_file(pcol_runner, monkeypatch):
    """A file's remap into the table's dictionary is kept while the files'
    signature holds: a second scan computes none, and a scan after an
    INSERT computes them again, into the grown dictionary."""
    r = pcol_runner()
    r.execute("create table store.w.rm as select n_nationkey, n_name from nation")
    r.execute("insert into store.w.rm values (99, 'ATLANTIS')")
    calls = []
    real = port_file.pcol_dict_remaps

    def counting(*a, **kw):
        out = real(*a, **kw)
        calls.append(out)
        return out

    monkeypatch.setattr(port_file, "pcol_dict_remaps", counting)
    q = "select n_name, count(*) from store.w.rm group by 1 order by 1"
    want = r.execute("select n_name, count(*) from nation group by 1 order by 1").rows
    want = sorted(want + [["ATLANTIS", 1]])
    assert r.execute(q).rows == want
    assert calls and any(calls)  # the files' names remap into the union
    n = len(calls)
    assert r.execute(q).rows == want and len(calls) == n
    r.execute("insert into store.w.rm values (98, 'NARNIA')")
    assert r.execute(q).rows == sorted(want + [["NARNIA", 1]]) and len(calls) > n


def test_min_max_over_comment_text(tmp_path):
    """min/max of a written text column compare its strings, as the
    reference's do; over the generator's packed dictionary, whose codes do
    not keep the strings' order, the port refuses instead of comparing
    codes."""
    ref, port = _runners(tmp_path, "pcol")
    sql = ("select count(*), min(l_comment), max(l_comment) from {} "
           "where l_comment like '%special%requests%'")
    run_both((ref, port), ["create table wh.default.c as select l_orderkey, l_comment "
                           "from lineitem", sql.format("wh.default.c")])
    assert port.execute(sql.format("wh.default.c")).rows[0][0] > 0
    with pytest.raises(NotImplementedError, match="non-monotonic virtual dictionary"):
        port.execute(sql.format("lineitem"))


def test_split_readers_without_libpcol_take_the_serial_path(pcol_runner, monkeypatch):
    import presto_tpu_torch.native as native

    r = pcol_runner()
    r.execute("create table store.w.nl as select n_nationkey from nation")
    rows = r.execute("select sum(n_nationkey) from store.w.nl").rows
    monkeypatch.setattr(native, "native_available", lambda: False)
    conn = r.metadata.connector("store")
    table = conn.metadata().get_table_handle(SchemaTableName("w", "nl"))
    split = conn.split_manager().get_splits(table, Constraint.all(), 8)[0]
    src = conn.page_source_provider().create_page_source(
        split, list(conn.metadata().get_table_metadata(table).columns), 64, Constraint.all())
    assert src.split_readers(64) is None
    assert r.execute("select sum(n_nationkey) from store.w.nl").rows == rows == [[300]]


def test_scaled_writers_write_as_many_files(tmp_path):
    props = {"writer_min_rows_per_driver": 5000, "task_concurrency": 3}
    ref, port = _runners(tmp_path, "pcol", **props)
    from presto_tpu.ops.scan import RESIDENT_CACHE as REF_CACHE
    from presto_tpu_torch.ops.scan import RESIDENT_CACHE

    for table, sql in (("ord", "select o_orderkey, o_totalprice from orders"),
                       ("nat", "select n_name from nation")):
        REF_CACHE.clear()
        RESIDENT_CACHE.clear()
        run_both((ref, port), [f"create table wh.default.{table} as {sql}",
                               f"select count(*), sum(length(cast({sql.split()[1][:-1]} "
                               f"as varchar))) from wh.default.{table}"])
        counts = [len([f for f in os.listdir(tmp_path / d / "default" / table)
                       if f != "00000000.pcol"]) for d in ("ref-pcol", "port-pcol")]
        assert counts[0] == counts[1] == (3 if table == "ord" else 1), counts


# ----------------------------------------- tests/test_pcol.py, in both

def test_pcol_catalog_cases(tmp_path):
    ref, port = _runners(tmp_path, "pcol")
    run_both((ref, port), [
        "create table wh.default.nat as select * from nation",
        "select n_name, n_regionkey from wh.default.nat where n_regionkey < 3",
        # comments use packed virtual dictionaries; the files decode them
        "insert into wh.default.nat select * from nation where n_regionkey = 0",
        "select count(*) from wh.default.nat",
        "select n_comment from wh.default.nat where n_nationkey = 0",
        "create table wh.default.ord as select o_orderkey, o_totalprice from orders "
        "where o_orderkey < 5000",
        "insert into wh.default.ord select o_orderkey, o_totalprice from orders "
        "where o_orderkey >= 5000",
        "select count(*) from wh.default.ord where o_orderkey < 100",
        "create table wh.default.o2 as select o_orderkey, o_custkey from orders",
        "select count(*), sum(o_custkey) from wh.default.o2 "
        "where o_orderkey >= 1000 and o_orderkey <= 2000",
        "create table wh.default.tt as select 1 as x",
        "drop table wh.default.tt",
        "select * from wh.default.tt",
    ])
    c = port.execute("select n_comment from wh.default.nat where n_nationkey = 0").rows
    assert len(c) == 2 and c[0][0] == c[1][0] and len(c[0][0]) > 0
    assert len(_splits(port, "wh", "ord", Constraint.all())) == 2
    assert len(_splits(port, "wh", "ord", Constraint({"o_orderkey": (None, 100)}))) == 1
    assert _splits(port, "wh", "ord", Constraint({"o_orderkey": (10 ** 9, None)})) == []


def _freeze(path: str):
    st = os.stat(path)
    return lambda: os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns))


@pytest.mark.parametrize("fmt", ["pcol", "parquet"])
def test_stale_file_errors_equal(tmp_path, fmt):
    """A file changed in place under an unchanged signature (its mtime
    restored) holds a value the cached table dictionary lacks: both
    packages refuse to read it, with the same error (on the serial scan,
    which opens the file anew; the split readers trust the cached
    header)."""
    import re

    from presto_tpu.block import Block as RefBlock, Dictionary as RefDictionary
    from presto_tpu.block import Page as RefPage
    from presto_tpu import types as ref_types

    ref, port = _runners(tmp_path, fmt, scan_pipeline=False)
    run_both((ref, port), ["create table wh.default.s as select n_name from nation"])
    errors = []
    for runner, d in ((ref, "ref"), (port, "port")):
        run = runner.execute("select count(*) from wh.default.s").rows
        assert run == [[25]]
        tdir = tmp_path / f"{d}-{fmt}" / "default" / "s"
        path = str(sorted(p for p in tdir.iterdir() if not p.name.startswith("0000"))[0])
        restore = _freeze(path)
        names = np.array(["NARNIA"], dtype=object)
        page = RefPage((RefBlock(ref_types.VARCHAR, np.zeros(1, dtype=np.int32), None,
                                 RefDictionary(names)),), np.ones(1, dtype=bool))
        if fmt == "pcol":
            from presto_tpu.formats.pcol import write_pcol
            write_pcol(path, ["n_name"], [ref_types.VARCHAR], [RefDictionary(names)], [page])
        else:
            from presto_tpu.formats.parquet_writer import write_parquet
            write_parquet(path, ["n_name"], [ref_types.VARCHAR], [RefDictionary(names)], [page])
        restore()
        with pytest.raises(Exception) as e:
            runner.execute("select n_name from wh.default.s")
        msg = str(e.value).replace(str(tmp_path), "").replace(f"/{d}-", "/")
        errors.append((type(e.value).__name__, re.sub(r"/[0-9a-f]{12}\.", "/FILE.", msg)))
    assert errors[0] == errors[1]
    assert "NARNIA" in errors[0][1]


# --------------------------------------------------- TPC-H over Parquet

@pytest.fixture(scope="module")
def parquet_warehouse(tmp_path_factory):
    """tiny TPC-H lineitem/orders/customer exported through pyarrow, as
    ``tests/test_parquet.py`` does, under one directory both packages
    read."""
    from test_parquet import _tpch_parquet_catalog

    tmp = tmp_path_factory.mktemp("pq")
    _tpch_parquet_catalog(tmp)
    base = str(tmp / "warehouse")
    ref = RefRunner(RefSession(catalog="files", schema="default"))
    ref.catalogs.register("files", ref_file.FileConnector("files", base))
    port = LocalQueryRunner(Session(catalog="files", schema="default"), device="cpu")
    port.catalogs.register("files", FileConnector("files", base))
    return ref, port


PARQUET_SQL = {
    1: QUERIES[1], 3: QUERIES[3], 6: QUERIES[6],
    "strings": "select l_returnflag, l_linestatus, count(*), sum(l_quantity) from lineitem "
               "where l_returnflag <> 'N' and l_linestatus = 'F' group by 1, 2 order by 1, 2",
    "segments": "select c_mktsegment, count(*) from customer "
                "where c_mktsegment in ('BUILDING', 'MACHINERY') or c_mktsegment like 'H%' "
                "group by 1 order by 1",
}


@pytest.mark.parametrize("key", [1, 3, 6, "strings", "segments"])
def test_tpch_over_parquet_equal(parquet_warehouse, key):
    ref, port = parquet_warehouse
    want = ref.execute(PARQUET_SQL[key]).rows
    got = port.execute(PARQUET_SQL[key]).rows
    assert got, "the query returned no rows"
    assert_same_rows(got, want)


# ------------------------------------------------------------ RCFile

def test_rcfile_scan_and_ingest_only(tmp_path):
    from presto_tpu import types as ref_types
    from presto_tpu.formats.rcfile import write_rcfile_table

    base = tmp_path / "rc" / "default" / "events"
    base.mkdir(parents=True)
    cols = [[str(i) for i in range(50)],
            [None if i == 13 else f"u{i % 4}" for i in range(50)],
            [f"{i}.5" for i in range(50)]]
    write_rcfile_table(str(base / "part0.rc"), ["id", "name", "score"],
                       [ref_types.BIGINT, ref_types.VARCHAR, ref_types.DOUBLE], cols,
                       rows_per_group=16)
    ref = RefRunner(RefSession(catalog="tpch", schema="tiny"))
    ref.catalogs.register("rc", ref_file.FileConnector("rc", str(tmp_path / "rc")))
    port = LocalQueryRunner(Session(catalog="tpch", schema="tiny"), device="cpu")
    port.catalogs.register("rc", FileConnector("rc", str(tmp_path / "rc")))
    out = run_both((ref, port), [
        "select name, count(*), sum(score) from rc.default.events where id >= 10 "
        "group by name order by name",
        "select count(*) from rc.default.events where name is null",
        "insert into rc.default.events select 3, 'x', 1e0"])
    assert out[1] == ("rows", [[1]])
    assert out[2][0] == "error" and "read-only" in out[2][1][1]
