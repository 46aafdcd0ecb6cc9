"""The port's Parquet writer (``presto_tpu_torch/formats/parquet_writer.py``)
against the reference's, on the CPU.

The same seeded pages (numpy, made once) go to each package's
``write_parquet``: uncompressed files must be byte-identical; gzip files
(whose header carries the time) must decode to equal columns in both
readers and in ``pyarrow``; every file each package writes reads back equal
in the other package and in ``pyarrow`` (the verifier here, never the
writer). ``encode_rle_bitpacked`` and ``dict_min_max`` are held against the
reference's. Tolerance: exact everywhere.
"""
import numpy as np
import pyarrow.parquet as pq
import pytest
import torch

from presto_tpu import types as ref_types
from presto_tpu.block import Block as RefBlock
from presto_tpu.block import Dictionary as RefDictionary
from presto_tpu.block import Page as RefPage
from presto_tpu.formats import parquet as ref_parquet
from presto_tpu.formats import parquet_writer as ref_writer
from presto_tpu_torch import types
from presto_tpu_torch.block import Block, Dictionary, Page
from presto_tpu_torch.formats import parquet, parquet_writer
from test_torch_parquet import read_all, same_files
from test_torch_pcol import _seeded_columns
from test_torch_pcol import _typ as _pcol_typ


def _typ(mod, name):
    if name in ("smallint", "timestamp"):
        return getattr(mod, name.upper())
    return _pcol_typ(mod, name)


def pages_both(seed: int, n: int, pages_n: int, mask_p: float, extra=()):
    """The same seeded pages in both packages -> (names, port types,
    reference types, port dicts, reference dicts, port pages, reference
    pages). ``extra``: (name, type name, data, nulls) columns added to
    the seeded ones."""
    cols = _seeded_columns(seed, n * pages_n)
    for name, tname, data, nulls in extra:
        cols[name] = (tname, data, nulls, None)
    names = sorted(cols)
    masks = np.random.default_rng(seed + 1).random(n * pages_n) >= mask_p
    port_dicts = {c: Dictionary(v[3]) for c, v in cols.items() if v[3] is not None}
    ref_dicts = {c: RefDictionary(v[3]) for c, v in cols.items() if v[3] is not None}
    port_pages, ref_pages = [], []
    for p in range(pages_n):
        sl = slice(p * n, (p + 1) * n)
        port_pages.append(Page(tuple(
            Block(_typ(types, cols[c][0]), torch.from_numpy(np.ascontiguousarray(cols[c][1][sl])),
                  None if cols[c][2] is None else torch.from_numpy(cols[c][2][sl].copy()),
                  port_dicts.get(c)) for c in names), torch.from_numpy(masks[sl].copy())))
        ref_pages.append(RefPage(tuple(
            RefBlock(_typ(ref_types, cols[c][0]), cols[c][1][sl],
                     None if cols[c][2] is None else cols[c][2][sl], ref_dicts.get(c))
            for c in names), masks[sl]))
    return (names, [_typ(types, cols[c][0]) for c in names],
            [_typ(ref_types, cols[c][0]) for c in names],
            [port_dicts.get(c) for c in names], [ref_dicts.get(c) for c in names],
            port_pages, ref_pages)


CASES = {"one page": (41, 3000, 1, 0.3), "three pages": (42, 700, 3, 0.5),
         "all live": (43, 1500, 1, 0.0), "all masked": (44, 64, 2, 1.0)}


def _write(tmp_path, case, codec, row_group_rows=None):
    names, pt, rt, pd, rd, pp, rp = pages_both(*CASES[case])
    kw = {"codec": codec}
    if row_group_rows:
        kw["row_group_rows"] = row_group_rows
    port_path, ref_path = str(tmp_path / "port.parquet"), str(tmp_path / "ref.parquet")
    rows = parquet_writer.write_parquet(port_path, names, pt, pd, pp, **kw)
    ref_rows = ref_writer.write_parquet(ref_path, names, rt, rd, rp, **kw)
    assert rows == ref_rows
    return port_path, ref_path, names


@pytest.mark.parametrize("case", sorted(CASES))
def test_uncompressed_files_are_byte_identical(tmp_path, case):
    port_path, ref_path, names = _write(tmp_path, case, "uncompressed", row_group_rows=512)
    assert open(port_path, "rb").read() == open(ref_path, "rb").read()


@pytest.mark.parametrize("codec", ["uncompressed", "gzip"])
@pytest.mark.parametrize("case", ["one page", "three pages"])
def test_files_cross_read_and_read_by_pyarrow(tmp_path, case, codec):
    port_path, ref_path, names = _write(tmp_path, case, codec, row_group_rows=1000)
    # each package reads the other's file, and its own, to equal columns
    port_reads_ref = read_all(parquet, ref_path, ("s",))
    ref_reads_port = read_all(ref_parquet, port_path, ("s",))
    same_files(port_reads_ref, ref_reads_port)
    same_files(read_all(parquet, port_path, ("s",)), ref_reads_port)
    # pyarrow reads both to the same table
    got, want = pq.read_table(port_path), pq.read_table(ref_path)
    assert got.equals(want)
    assert got.num_rows == port_reads_ref["rows"]
    assert got.column("s").to_pylist() == [
        v for g in port_reads_ref["groups"] for v in g[1]["s"][0]]


def test_zstd_writes_the_same_or_raises_the_same(tmp_path):
    def outcome(write, path, bundle):
        try:
            write(path, *bundle, codec="zstd")
            return "ok", None
        except ImportError as e:
            return "import error", e.name

    names, pt, rt, pd, rd, pp, rp = pages_both(*CASES["one page"])
    got = outcome(parquet_writer.write_parquet, str(tmp_path / "p.parquet"), (names, pt, pd, pp))
    want = outcome(ref_writer.write_parquet, str(tmp_path / "r.parquet"), (names, rt, rd, rp))
    assert got == want
    if got[0] == "ok":
        same_files(read_all(parquet, str(tmp_path / "p.parquet")),
                   read_all(ref_parquet, str(tmp_path / "r.parquet")))


def test_smallint_timestamp_and_nullable_groups(tmp_path):
    """SMALLINT and TIMESTAMP columns, and a nullable column whose NULLs
    all fall in one row group, in both packages."""
    n = 3000
    rng = np.random.default_rng(9)
    nulls = np.zeros(n, dtype=bool)
    nulls[:40] = True
    extra = [("t16", "smallint", rng.integers(-2**14, 2**14, n).astype(np.int16), None),
             ("ts", "timestamp", rng.integers(0, 2**41, n), None),
             ("late", "bigint", np.where(nulls, 0, np.arange(n)), nulls)]
    names, pt, rt, pd, rd, pp, rp = pages_both(51, n, 1, 0.0, extra)
    p, r = str(tmp_path / "p.parquet"), str(tmp_path / "r.parquet")
    parquet_writer.write_parquet(p, names, pt, pd, pp, row_group_rows=1000)
    ref_writer.write_parquet(r, names, rt, rd, rp, row_group_rows=1000)
    assert open(p, "rb").read() == open(r, "rb").read()
    f = parquet.ParquetFile(p)
    try:
        assert dict(f.schema)["ts"] is types.TIMESTAMP
    finally:
        f.close()


def test_empty_seed_file_is_byte_identical(tmp_path):
    """The file catalog's CREATE TABLE seed: no pages, one dictionary."""
    names = ["k", "s"]
    p, r = str(tmp_path / "p.parquet"), str(tmp_path / "r.parquet")
    parquet_writer.write_parquet(p, names, [types.BIGINT, types.VARCHAR],
                                 [None, Dictionary([])], [])
    ref_writer.write_parquet(r, names, [ref_types.BIGINT, ref_types.VARCHAR],
                             [None, RefDictionary([])], [])
    assert open(p, "rb").read() == open(r, "rb").read()


def test_rle_encoder_equal():
    rng = np.random.default_rng(12)
    for width in (0, 1, 2, 4, 7, 13, 20):
        for n in (0, 1, 8, 9, 257, 4000):
            hi = 1 << width if width else 1
            for vals in (rng.integers(0, hi, n), np.full(n, hi - 1)):
                for prefixed in (False, True):
                    got = parquet_writer.encode_rle_bitpacked(vals, width, prefixed)
                    assert got == ref_writer.encode_rle_bitpacked(vals, width, prefixed)


def test_dict_min_max_equal():
    rng = np.random.default_rng(13)
    words = [f"w{int(x):04d}" for x in rng.integers(0, 10 ** 4, 300)]
    codes = rng.integers(0, len(words), 1000)
    assert parquet_writer.dict_min_max(Dictionary(words), codes) == \
        ref_writer.dict_min_max(RefDictionary(words), codes)


def test_virtual_dictionary_is_refused_the_same(tmp_path):
    from presto_tpu.connectors.tpch.generator import FormattedDictionary as RefFormatted
    from presto_tpu_torch.connectors.tpch.generator import FormattedDictionary

    def fmt(c):
        return np.array([f"x{v}" for v in c], dtype=object)

    d, rd = FormattedDictionary(fmt, 4), RefFormatted(fmt, 4)
    page = Page((Block(types.VARCHAR, torch.arange(4, dtype=torch.int32), None, d),),
                torch.ones(4, dtype=torch.bool))
    ref_page = RefPage((RefBlock(ref_types.VARCHAR, np.arange(4, dtype=np.int32), None, rd),),
                       np.ones(4, dtype=bool))
    msgs = []
    for write, args in ((parquet_writer.write_parquet, ([types.VARCHAR], [d], [page])),
                        (ref_writer.write_parquet, ([ref_types.VARCHAR], [rd], [ref_page]))):
        with pytest.raises(ValueError) as e:
            write(str(tmp_path / "v.parquet"), ["s"], *args)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "virtual dictionaries" in msgs[0]
