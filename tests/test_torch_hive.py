"""The port's hive connector (``presto_tpu_torch/connectors/hive``) against
presto_tpu on the CPU at ``tpch.tiny``.

One reference runner and one port runner, each with a ``hive`` catalog of
its own and a read-only ``other`` catalog over the other package's
warehouse, run the statements of the cases of ``tests/test_hive.py``: rows
(or errors) equal, exact but for DOUBLE (1e-12 relative), and the same
splits kept. Every table both packages write has a byte-identical
``.hive.json``, the same partition directories, and byte-identical data
files per (partition, bucket) (PCOL, Parquet and ORC alike; the file names
carry a random uuid, so files compare by place, not name). Besides:

- each package reads the other's warehouse to the same rows;
- ``bucket_ids`` equals the reference's ``_bucket_ids`` on the same pages,
  NULLs and multi-column keys included;
- the sink's numpy partition routing (``partition_groups``) gives the
  reference's per-row loop's buffers, in its order, with string, integer,
  DOUBLE, BOOLEAN and NULL keys.
"""
import os

import numpy as np
import pytest
import torch

from presto_tpu import block as ref_block
from presto_tpu import types as ref_types
from presto_tpu.connectors import hive as ref_hive
from presto_tpu.metadata import Session as RefSession
from presto_tpu.runner import LocalQueryRunner as RefRunner
from presto_tpu.spi import connector as ref_spi
from presto_tpu_torch import block, types
from presto_tpu_torch.connectors import hive
from presto_tpu_torch.metadata import Session
from presto_tpu_torch.runner import LocalQueryRunner
from presto_tpu_torch.spi import connector as port_spi
from test_torch_sql import assert_same_rows
from test_torch_writers import run_both


@pytest.fixture(scope="module")
def warehouses(tmp_path_factory):
    """(reference runner, port runner, reference base, port base): each
    runner's ``hive`` catalog writes its own warehouse, and its ``other``
    catalog reads the other package's."""
    base = tmp_path_factory.mktemp("hive")
    ref_dir, port_dir = str(base / "ref"), str(base / "port")
    ref = RefRunner(RefSession(catalog="tpch", schema="tiny"))
    ref.catalogs.register("hive", ref_hive.HiveConnector("hive", ref_dir))
    ref.catalogs.register("other", ref_hive.HiveConnector("other", port_dir))
    port = LocalQueryRunner(Session(catalog="tpch", schema="tiny"), device="cpu")
    port.catalogs.register("hive", hive.HiveConnector("hive", port_dir))
    port.catalogs.register("other", hive.HiveConnector("other", ref_dir))
    return ref, port, ref_dir, port_dir


def _both(wh, statements):
    return run_both(wh[:2], statements)


def _layout(root: str, table: str):
    """(the descriptor's bytes, the table's directories, {(directory,
    bucket, extension): the data files' bytes, sorted})."""
    tdir = os.path.join(root, "default", table)
    with open(os.path.join(tdir, hive.DESCRIPTOR), "rb") as f:
        desc = f.read()
    dirs, files = set(), {}
    for dirpath, _dirnames, filenames in os.walk(tdir):
        rel = os.path.relpath(dirpath, tdir)
        dirs.add(rel)
        for name in filenames:
            if name == hive.DESCRIPTOR:
                continue
            with open(os.path.join(dirpath, name), "rb") as f:
                files.setdefault((rel, hive._bucket_of_file(name), os.path.splitext(name)[1]),
                                 []).append(f.read())
    return desc, dirs, {k: sorted(v) for k, v in files.items()}


def _same_layout(wh, table: str):
    """Both packages wrote ``table`` alike; -> the port's directories."""
    want, got = _layout(wh[2], table), _layout(wh[3], table)
    assert got[0] == want[0]  # .hive.json, byte for byte
    assert got[1] == want[1]
    assert sorted(got[2]) == sorted(want[2])
    for key in want[2]:
        assert got[2][key] == want[2][key], key
    return got[1]


def _spi(runner):
    """The SPI module of ``runner``'s package."""
    return port_spi if isinstance(runner, LocalQueryRunner) else ref_spi


def _handle(runner, table: str):
    spi = _spi(runner)
    return runner.catalogs.get("hive").metadata().get_table_handle(
        spi.SchemaTableName("default", table))


def _splits(runner, table: str, domains=None):
    return runner.catalogs.get("hive").split_manager().get_splits(
        _handle(runner, table), _spi(runner).Constraint(dict(domains or {})), 8)


def _partitions(wh, table):
    return sorted(d for d in _same_layout(wh, table) if d != ".")


# ------------------------------------------------- tests/test_hive.py's cases

def test_ctas_partitioned_layout_and_roundtrip(warehouses):
    _both(warehouses, [
        "create table hive.default.nat with (partitioned_by = array['n_regionkey']) "
        "as select * from nation",
        "select n_name, n_regionkey from hive.default.nat"])
    assert _partitions(warehouses, "nat") == [f"n_regionkey={i}" for i in range(5)]


def test_partition_pruning_is_exact(warehouses):
    ref, port = warehouses[:2]
    _both(warehouses, [
        "create table hive.default.nat_prune with (partitioned_by = array['n_regionkey']) "
        "as select * from nation",
        "select n_name from hive.default.nat_prune where n_regionkey = 2"])
    for r in (ref, port):
        assert len(_splits(r, "nat_prune")) == 5
        assert len(_splits(r, "nat_prune", {"n_regionkey": (2, 2)})) == 1
    kept = [[s.payload[1] for s in _splits(r, "nat_prune", {"n_regionkey": (1, 3)})]
            for r in (ref, port)]
    assert kept[0] == kept[1] == [f"n_regionkey={i}" for i in (1, 2, 3)]


def test_string_partition_keys(warehouses):
    _both(warehouses, [
        "create table hive.default.reg with (partitioned_by = array['r_name']) "
        "as select * from region",
        "select r_regionkey, r_comment from hive.default.reg where r_name = 'ASIA'",
        "select r_name, count(*) from hive.default.reg where r_name in ('ASIA', 'EUROPE') group by 1"])
    assert "r_name=MIDDLE%20EAST" in _partitions(warehouses, "reg")


def test_null_partition_key_roundtrip(warehouses):
    _both(warehouses, [
        "create table hive.default.n2 with (partitioned_by = array['k']) "
        "as select n_name, case when n_regionkey = 2 then null else n_regionkey end as k "
        "from nation",
        "select count(*) from hive.default.n2 where k is null",
        "select count(*) from hive.default.n2",
        "select k, count(*) from hive.default.n2 group by k"])
    assert "k=__HIVE_NULL__" in _partitions(warehouses, "n2")


def test_bucketed_table(warehouses):
    ref, port = warehouses[:2]
    _both(warehouses, [
        "create table hive.default.natb "
        "with (bucketed_by = array['n_nationkey'], bucket_count = 4) as select * from nation",
        "select n_name, n_nationkey from hive.default.natb"])
    _same_layout(warehouses, "natb")
    buckets = []
    for r in (ref, port):
        provider = r.catalogs.get("hive").node_partitioning_provider()
        assert provider.bucket_count(_handle(r, "natb")) == 4
        assert provider.bucket_columns(_handle(r, "natb")) == ("n_nationkey",)
        buckets.append(sorted(s.bucket for s in _splits(r, "natb")))
    assert buckets[0] == buckets[1] and set(buckets[1]) <= set(range(4))


def test_insert_appends_new_partitions(warehouses):
    _both(warehouses, [
        "create table hive.default.nat_ins with (partitioned_by = array['n_regionkey']) "
        "as select * from nation where n_regionkey < 3",
        "insert into hive.default.nat_ins select * from nation where n_regionkey >= 3",
        "select n_name, n_regionkey from hive.default.nat_ins"])
    assert _partitions(warehouses, "nat_ins") == [f"n_regionkey={i}" for i in range(5)]


@pytest.mark.parametrize("fmt", ["parquet", "orc"])
def test_format_property(warehouses, fmt):
    _both(warehouses, [
        f"create table hive.default.nat_{fmt} "
        f"with (partitioned_by = array['n_regionkey'], format = '{fmt}') as select * from nation",
        f"select n_name from hive.default.nat_{fmt} where n_regionkey = 1",
        f"select n_regionkey, count(*), min(n_comment) from hive.default.nat_{fmt} group by 1"])
    _same_layout(warehouses, f"nat_{fmt}")
    assert {k[2] for k in _layout(warehouses[3], f"nat_{fmt}")[2]} == {f".{fmt}"}


def test_unknown_property_rejected(warehouses):
    out = _both(warehouses, [
        "create table hive.default.bad with (nope = 1) as select * from region"])
    assert out[0][0] == "error" and "unknown hive table propert" in out[0][1][1]


def test_partition_stats_feed_cbo(warehouses):
    ref, port = warehouses[:2]
    _both(warehouses, [
        "create table hive.default.nat_stats with (partitioned_by = array['n_regionkey']) "
        "as select * from nation"])
    stats = []
    for r in (ref, port):
        cons = _spi(r).Constraint
        got = []
        for c in (cons.all(), cons({"n_regionkey": (0, 1)})):
            st = r.catalogs.get("hive").metadata().get_table_statistics(
                _handle(r, "nat_stats"), c)
            col = st.columns["n_regionkey"]
            got.append((st.row_count, col.distinct_count, col.null_fraction,
                        col.min_value, col.max_value))
        stats.append(got)
    assert stats[1] == stats[0]
    assert stats[1][0][:2] == (25.0, 5.0) and stats[1][1][0] == 10.0


def test_show_tables_and_drop(warehouses):
    out = _both(warehouses, [
        "create table hive.default.t1 as select * from region",
        "show tables from hive.default",
        "drop table hive.default.t1",
        "show tables from hive.default"])
    assert ["t1"] in out[1][1] and ["t1"] not in out[3][1]
    for root in warehouses[2:]:
        assert not os.path.exists(os.path.join(root, "default", "t1"))


def test_descriptor_roundtrip(tmp_path):
    """The port's descriptor file is the reference's, byte for byte, and
    each package loads the other's."""
    ref_d = ref_hive.TableDescriptor([("a", ref_types.BIGINT), ("b", ref_types.VARCHAR)],
                                     ["a"], [], 0, "pcol", {"b": ["x"]})
    d = hive.TableDescriptor([("a", types.BIGINT), ("b", types.VARCHAR)], ["a"], [], 0,
                             "pcol", {"b": ["x"]})
    ref_d.save(str(tmp_path / "ref"))
    d.save(str(tmp_path / "port"))
    with open(tmp_path / "ref" / ".hive.json", "rb") as f, \
            open(tmp_path / "port" / ".hive.json", "rb") as g:
        assert f.read() == g.read()
    assert hive.TableDescriptor.load(str(tmp_path / "ref")).to_json() == ref_d.to_json()
    assert ref_hive.TableDescriptor.load(str(tmp_path / "port")).to_json() == d.to_json()
    with pytest.raises(ValueError, match="unknown hive storage format"):
        hive.TableDescriptor([("a", types.BIGINT)], [], [], 0, "csv", {})


# ------------------------------------------------------------- across packages

def test_each_package_reads_the_others_warehouse(warehouses):
    ref, port = warehouses[:2]
    _both(warehouses, [
        "create table hive.default.xr_part with (partitioned_by = array['l_returnflag', "
        "'l_linestatus']) as select l_orderkey, l_quantity, l_shipdate, l_returnflag, "
        "l_linestatus from lineitem where l_orderkey < 5000",
        "create table hive.default.xr_bkt with (bucketed_by = array['o_orderkey', "
        "'o_custkey'], bucket_count = 3) as select o_orderkey, o_custkey, o_orderstatus, "
        "o_totalprice from orders",
        "create table hive.default.xr_pq with (partitioned_by = array['c_mktsegment'], "
        "format = 'parquet') as select c_custkey, c_name, c_mktsegment from customer"])
    for t in ("xr_part", "xr_bkt", "xr_pq"):
        _same_layout(warehouses, t)
    for sql in ("select l_returnflag, l_linestatus, count(*), sum(l_quantity), "
                "max(l_shipdate) from {}.default.xr_part group by 1, 2 order by 1, 2",
                "select count(*) from {}.default.xr_part where l_returnflag = 'R'",
                "select o_orderstatus, count(*), sum(o_totalprice) from {}.default.xr_bkt "
                "group by 1 order by 1",
                "select c_mktsegment, count(*), min(c_name) from {}.default.xr_pq "
                "group by 1 order by 1"):
        want = ref.execute(sql.format("hive")).rows
        assert want
        assert_same_rows(port.execute(sql.format("other")).rows, want)
        assert_same_rows(ref.execute(sql.format("other")).rows, want)
        assert_same_rows(port.execute(sql.format("hive")).rows, want)


# ------------------------------------------------ the routing, against the code

def _columns(seed: int, n: int):
    """Seeded host columns with NULLs: {name: (data, nulls or None)}."""
    rng = np.random.RandomState(seed)
    dbl = np.array([0.5, -0.0, 0.0, 2.25, -1.5])
    return {
        "x": (rng.randint(-1 << 40, 1 << 40, n).astype(np.int64), rng.rand(n) < 0.1),
        "s": (rng.randint(0, 5, n).astype(np.int32), rng.rand(n) < 0.1),
        "i": (rng.randint(-3, 3, n).astype(np.int64), rng.rand(n) < 0.15),
        "dt": (rng.randint(8000, 8010, n).astype(np.int32), None),
        "d": (dbl[rng.randint(0, len(dbl), n)], rng.rand(n) < 0.05),
        "b": (rng.rand(n) < 0.5, rng.rand(n) < 0.1),
    }


TYPES = {"x": "BIGINT", "s": "VARCHAR", "i": "BIGINT", "dt": "DATE", "d": "DOUBLE",
         "b": "BOOLEAN"}
WORDS = ["alpha", "beta", "gamma", "delta", "eps ilon/x"]


def _pages(cols, names, mask):
    """(reference page, port page) of the same host columns."""
    ref_d, d = ref_block.Dictionary(WORDS), block.Dictionary(WORDS)
    ref_blocks, blocks = [], []
    for n in names:
        data, nulls = cols[n]
        ref_blocks.append(ref_block.Block(getattr(ref_types, TYPES[n]), data, nulls,
                                          ref_d if n == "s" else None))
        blocks.append(block.Block(getattr(types, TYPES[n]), torch.from_numpy(data.copy()),
                                  None if nulls is None else torch.from_numpy(nulls.copy()),
                                  d if n == "s" else None))
    return ref_block.Page(tuple(ref_blocks), mask), block.Page(tuple(blocks),
                                                              torch.from_numpy(mask.copy()))


@pytest.mark.parametrize("bucketed_by", [["x"], ["x", "i"], ["s", "dt", "b"], ["i", "d"]])
def test_bucket_ids_equal_reference(bucketed_by):
    n = 5000
    cols = _columns(7, n)
    names = list(TYPES)
    ref_page, page = _pages(cols, names, np.ones(n, dtype=bool))
    sink = ref_hive.HivePageSink.__new__(ref_hive.HivePageSink)
    sink._desc = ref_hive.TableDescriptor(
        [(c, getattr(ref_types, TYPES[c])) for c in names], [], bucketed_by, 8, "pcol", {})
    sel = np.flatnonzero(np.random.RandomState(3).rand(n) < 0.7)
    col_of = {c: i for i, c in enumerate(names)}
    want = sink._bucket_ids(ref_page, col_of, sel)
    got = hive.bucket_ids([page.blocks[col_of[c]] for c in bucketed_by], sel, 8)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert len(np.unique(got)) == 8


@pytest.mark.parametrize("partitioned_by,bucketed_by", [
    (["s"], []), (["i", "b"], []), (["s", "i", "d", "b"], []), (["d"], ["x"]),
    (["s", "dt"], ["x", "i"])])
def test_partition_routing_equal_reference_loop(tmp_path, partitioned_by, bucketed_by):
    """The same page through the reference's sink and the port's: the same
    (partition directory, bucket) buffers in the same order, with the same
    rows, and the same files written."""
    n = 3000
    names = list(TYPES)
    cols = _columns(11, n)
    mask = np.random.RandomState(5).rand(n) < 0.9
    props = {"partitioned_by": partitioned_by}
    if bucketed_by:
        props.update(bucketed_by=bucketed_by, bucket_count=3)
    sinks = []
    for pkg, mod, tp, root in ((ref_hive, ref_spi, ref_types, tmp_path / "ref"),
                               (hive, port_spi, types, tmp_path / "port")):
        conn = pkg.HiveConnector("hive", str(root))
        meta = conn.metadata()
        name = mod.SchemaTableName("default", "pk")
        meta.create_table(mod.TableMetadata(name, tuple(
            mod.ColumnMetadata(c, getattr(tp, TYPES[c])) for c in names)), properties=props)
        sinks.append(conn.page_sink_provider().create_page_sink(meta.get_table_handle(name)))
    ref_sink, sink = sinks
    for seed in (0, 1):  # two pages: a key first seen on the second page
        perm = np.random.RandomState(seed).permutation(n)
        cols_p = {c: (d[perm], None if nl is None else nl[perm]) for c, (d, nl) in cols.items()}
        ref_page, page = _pages(cols_p, names, mask[perm])
        ref_sink.append_page(ref_page)
        sink.append_page(page)
    assert list(sink._buffers) == list(ref_sink._buffers)
    assert len(sink._buffers) > 1
    for key, ref_pages in ref_sink._buffers.items():
        pages = sink._buffers[key]
        assert len(pages) == len(ref_pages)
        for p, rp in zip(pages, ref_pages):
            for b, rb in zip(p.blocks, rp.blocks):
                assert np.array_equal(b.data.numpy(), np.asarray(rb.data)), key
                assert (b.nulls is None) == (rb.nulls is None), key
                if b.nulls is not None:
                    assert np.array_equal(b.nulls.numpy(), np.asarray(rb.nulls)), key
    ref_files, files = ref_sink.finish(), sink.finish()
    assert [os.path.relpath(os.path.dirname(f), tmp_path / "port") for f in files] == \
        [os.path.relpath(os.path.dirname(f), tmp_path / "ref") for f in ref_files]
    for f, rf in zip(files, ref_files):
        assert hive._bucket_of_file(f) == ref_hive._bucket_of_file(rf)
        with open(f, "rb") as a, open(rf, "rb") as b:
            assert a.read() == b.read()


def test_partition_groups_keys_each_group_by_its_first_row():
    """0.0 and -0.0 are one key; the group's directory takes the first
    row's value, as the reference's dict does."""
    keys = [(types.VARCHAR, block.Dictionary(["a", "b"]), np.array([0, 1, 1, 0], np.int32),
             None),
            (types.DOUBLE, None, np.array([0.0, -0.0, 0.0, -0.0]), None)]
    got = hive.partition_groups(keys)
    assert list(got) == [("a", 0.0), ("b", -0.0)]
    assert [np.signbit(k[1]) for k in got] == [False, True]
    assert [r.tolist() for r in got.values()] == [[0, 3], [1, 2]]


def test_partition_keys_of_several_types(warehouses):
    """The scan fills partition keys in as constant blocks of the column's
    type and dictionary, equal to the reference's, NULL keys included."""
    _both(warehouses, [
        "create table hive.default.keys with (partitioned_by = array['flag', 'day', 'k']) "
        "as select o_orderkey, o_orderstatus as flag, o_orderdate as day, "
        "case when o_orderkey % 7 = 0 then null else o_orderkey % 3 end as k "
        "from orders where o_orderkey < 100",
        "select flag, day, k, count(*) from hive.default.keys group by 1, 2, 3",
        "select o_orderkey, flag from hive.default.keys where day = date '1996-01-02'",
        "select count(*) from hive.default.keys where k = 1 and flag = 'O'"])
    _same_layout(warehouses, "keys")
