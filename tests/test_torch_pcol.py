"""The port's PCOL format (``presto_tpu_torch/formats/pcol.py``) and its
``libpcol`` against the reference's, on the CPU.

``tests/test_pcol.py:21-56``, and the exchange between the packages: the
same seeded pages written by each package give byte-identical files, and
each package reads the other's file back to the same columns. The cases
through a ``file`` catalog wait for the port's ``connectors/file``.
"""
import os

import numpy as np
import pytest
import torch

from presto_tpu.block import Block as RefBlock
from presto_tpu.block import Dictionary as RefDictionary
from presto_tpu.block import Page as RefPage
from presto_tpu.formats import pcol as ref_pcol
from presto_tpu import types as ref_types
from presto_tpu_torch import types
from presto_tpu_torch.block import Block, Dictionary, Page
from presto_tpu_torch.formats import pcol
from presto_tpu_torch.utils.metrics import METRICS


def test_native_library_builds():
    from presto_tpu_torch import native

    assert native.native_available(), "libpcol must compile with g++"
    lib = native.libpcol()
    assert os.path.dirname(lib._name) == os.path.join(os.path.dirname(native.__file__), "build")


def test_roundtrip_with_nulls_and_dict(tmp_path):
    d = Dictionary(["a", "b", "c"])
    pages = [Page((Block(types.BIGINT, torch.arange(10)),
                   Block(types.VARCHAR, torch.arange(10, dtype=torch.int32) % 3, None, d),
                   Block(types.DecimalType(12, 2), torch.arange(10) * 100,
                         torch.arange(10) % 4 == 0, None)),
                  torch.arange(10) % 2 == 0)]
    path = str(tmp_path / "t.pcol")
    opens = METRICS.counter_value("pcol.native_opens")
    rows = pcol.write_pcol(path, ["k", "s", "v"],
                           [types.BIGINT, types.VARCHAR, types.DecimalType(12, 2)],
                           [None, d, None], pages)
    assert rows == 5
    f = pcol.PcolFile(path)
    assert METRICS.counter_value("pcol.native_opens") == opens + 1
    assert f.column_stats("k") == (0, 8)
    out = []
    for p in f.pages(["k", "s", "v"], 4):
        out.extend(p.to_pylists())
    f.close()
    assert [r[0] for r in out] == [0, 2, 4, 6, 8]
    assert [r[1] for r in out] == ["a", "c", "b", "a", "c"]
    assert out[0][2] is None and str(out[1][2]) == "2"


def _seeded_columns(seed: int, n: int):
    """name -> (type name, numpy data, null mask or None, dictionary values
    or None), from a numpy generator."""
    rng = np.random.default_rng(seed)
    words = sorted({"".join(rng.choice(list("abcdefgh"), 5)) for _ in range(12)})
    return {
        "k": ("bigint", rng.integers(-1 << 40, 1 << 40, n), None, None),
        "i": ("integer", rng.integers(-1000, 1000, n).astype(np.int32),
              rng.random(n) < 0.2, None),
        "x": ("double", rng.normal(size=n), rng.random(n) < 0.1, None),
        "f": ("real", rng.normal(size=n).astype(np.float32), None, None),
        "b": ("boolean", rng.random(n) < 0.5, None, None),
        "d": ("date", rng.integers(8000, 11000, n).astype(np.int32), None, None),
        "m": ("decimal", rng.integers(0, 10 ** 9, n), rng.random(n) < 0.05, None),
        "s": ("varchar", rng.integers(0, len(words), n).astype(np.int32), None, words),
    }


def _typ(mod, name):
    if name == "decimal":
        return mod.DecimalType(12, 2)
    return {"bigint": mod.BIGINT, "integer": mod.INTEGER, "double": mod.DOUBLE,
            "real": mod.REAL, "boolean": mod.BOOLEAN, "date": mod.DATE,
            "varchar": mod.VARCHAR}[name]


def _write_both(tmp_path, seed: int, n: int, pages_n: int, mask_p: float):
    """The same seeded pages written by each package -> (port path,
    reference path, column names)."""
    cols = _seeded_columns(seed, n * pages_n)
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
    port_path, ref_path = str(tmp_path / "port.pcol"), str(tmp_path / "ref.pcol")
    rows = pcol.write_pcol(port_path, names, [_typ(types, cols[c][0]) for c in names],
                           [port_dicts.get(c) for c in names], port_pages)
    ref_rows = ref_pcol.write_pcol(ref_path, names, [_typ(ref_types, cols[c][0]) for c in names],
                                   [ref_dicts.get(c) for c in names], ref_pages)
    assert rows == ref_rows == int(masks.sum())
    return port_path, ref_path, names


EXCHANGE_CASES = {"one page": (11, 1000, 1, 0.3), "three pages": (12, 257, 3, 0.5),
                  "all masked": (13, 64, 2, 1.0), "all live": (14, 333, 1, 0.0)}


@pytest.mark.parametrize("case", sorted(EXCHANGE_CASES))
def test_files_are_byte_identical_and_cross_readable(tmp_path, case):
    port_path, ref_path, names = _write_both(tmp_path, *EXCHANGE_CASES[case])
    assert open(port_path, "rb").read() == open(ref_path, "rb").read()
    # each package reads the other's file to the same columns
    port_reads_ref = pcol.PcolFile(ref_path)
    ref_reads_port = ref_pcol.PcolFile(port_path)
    try:
        assert port_reads_ref.header == ref_reads_port.header
        for c in names:
            got, got_nulls, got_dict = port_reads_ref.read_column(c)
            want, want_nulls, want_dict = ref_reads_port.read_column(c)
            assert got.dtype == want.dtype and np.array_equal(got, want, equal_nan=True)
            assert (got_nulls is None) == (want_nulls is None)
            if got_nulls is not None:
                assert np.array_equal(got_nulls, want_nulls)
            assert (got_dict is None) == (want_dict is None)
            if got_dict is not None:
                assert list(got_dict.values) == list(want_dict.values)
            assert port_reads_ref.column_stats(c) == ref_reads_port.column_stats(c)
        got_rows = [r for p in port_reads_ref.pages(names, 128) for r in p.to_pylists()]
        want_rows = [r for p in ref_reads_port.pages(names, 128) for r in p.to_pylists()]
        assert len(got_rows) == len(want_rows) == port_reads_ref.rows
        assert repr(got_rows) == repr(want_rows)
    finally:
        port_reads_ref.close()
        ref_reads_port.close()


def test_numpy_path_reads_and_writes_the_same(tmp_path, monkeypatch):
    """Without libpcol the port writes the same bytes (numpy statistics)
    and reads through ``np.fromfile``, counted as such."""
    port_path, ref_path, names = _write_both(tmp_path, 21, 500, 2, 0.25)
    monkeypatch.setattr(pcol, "_libpcol", lambda: None)
    again = str(tmp_path / "numpy.pcol")
    opens = METRICS.counter_value("pcol.numpy_opens")
    f = pcol.PcolFile(port_path)
    try:
        pages = list(f.pages(names, 1000))
        dicts = [f.read_column(c)[2] for c in names]
        pcol.write_pcol(again, names, [pcol._type_from_tag(f.columns[c]["type"],
                                                           f.columns[c]["scale"])
                                       for c in names], dicts, pages)
    finally:
        f.close()
    assert METRICS.counter_value("pcol.numpy_opens") == opens + 1
    assert open(again, "rb").read() == open(ref_path, "rb").read()


def test_row_ranges_and_range_reads_match_reference(tmp_path):
    port_path, ref_path, names = _write_both(tmp_path, 31, 700, 1, 0.1)
    assert pcol.row_ranges(1000, 256) == ref_pcol.row_ranges(1000, 256)
    assert pcol.row_ranges(0, 8) == ref_pcol.row_ranges(0, 8) == []
    f, g = pcol.PcolFile(port_path), ref_pcol.PcolFile(ref_path)
    try:
        for lo, hi in pcol.row_ranges(f.rows, 97):
            for c in names:
                a, an, _ = f.read_column_range(c, lo, hi)
                b, bn, _ = g.read_column_range(c, lo, hi)
                assert np.array_equal(a, b, equal_nan=True)
                assert (an is None and bn is None) or np.array_equal(an, bn)
    finally:
        f.close()
        g.close()


def test_not_a_pcol_file_raises(tmp_path):
    path = tmp_path / "junk.pcol"
    path.write_bytes(b"NOTPCOL\n" + b"\0" * 64)
    with pytest.raises(ValueError, match="not a pcol file"):
        pcol.PcolFile(str(path))


def test_virtual_dictionary_is_refused(tmp_path):
    from presto_tpu_torch.connectors.tpch.generator import FormattedDictionary

    d = FormattedDictionary(lambda c: np.array([f"x{v}" for v in c], dtype=object), 4)
    page = Page((Block(types.VARCHAR, torch.arange(4, dtype=torch.int32), None, d),),
                torch.ones(4, dtype=torch.bool))
    with pytest.raises(ValueError, match="virtual dictionaries"):
        pcol.write_pcol(str(tmp_path / "v.pcol"), ["s"], [types.VARCHAR], [d], [page])
