"""The port's ORC writer (``presto_tpu_torch/formats/orc_writer.py``)
against the reference's, on the CPU.

The same seeded pages go to each package's ``write_orc``: ZLIB and
uncompressed files must be byte-identical; every file each package writes
reads back equal in the other package and in ``pyarrow`` (the verifier
here, never the writer). ``encode_byte_rle``, ``encode_rlev2``,
``encode_bool_rle`` and the numpy ``_encode_varint_stream`` are held
against the reference's. Tolerance: exact everywhere.
"""
import numpy as np
import pyarrow.orc as pa_orc
import pytest

from presto_tpu import types as ref_types
from presto_tpu.block import Dictionary as RefDictionary
from presto_tpu.formats import orc as ref_orc
from presto_tpu.formats import orc_writer as ref_writer
from presto_tpu_torch import types
from presto_tpu_torch.block import Dictionary
from presto_tpu_torch.formats import orc, orc_writer
from test_torch_orc import read_all, same_files
from test_torch_parquet_writer import pages_both

CASES = {"one page": (61, 3000, 1, 0.3), "three pages": (62, 700, 3, 0.5),
         "all live": (63, 1500, 1, 0.0), "all masked": (64, 64, 2, 1.0)}


def _write(tmp_path, case, codec, stripe_rows=None, extra=()):
    """``case``: a CASES key, or its (seed, rows, pages, masked share)."""
    args = CASES[case] if isinstance(case, str) else case
    names, pt, rt, pd, rd, pp, rp = pages_both(*args, extra=extra)
    kw = {"codec": codec}
    if stripe_rows:
        kw["stripe_rows"] = stripe_rows
    port_path, ref_path = str(tmp_path / "port.orc"), str(tmp_path / "ref.orc")
    rows = orc_writer.write_orc(port_path, names, pt, pd, pp, **kw)
    ref_rows = ref_writer.write_orc(ref_path, names, rt, rd, rp, **kw)
    assert rows == ref_rows
    return port_path, ref_path, names


@pytest.mark.parametrize("codec", ["zlib", "none"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_files_are_byte_identical(tmp_path, case, codec):
    port_path, ref_path, _ = _write(tmp_path, case, codec, stripe_rows=600)
    assert open(port_path, "rb").read() == open(ref_path, "rb").read()


@pytest.mark.parametrize("case", ["one page", "three pages"])
def test_files_cross_read_and_read_by_pyarrow(tmp_path, case):
    port_path, ref_path, names = _write(tmp_path, case, "zlib", stripe_rows=1000)
    port_reads_ref = read_all(orc, ref_path, ("s",))
    ref_reads_port = read_all(ref_orc, port_path, ("s",))
    same_files(port_reads_ref, ref_reads_port)
    same_files(read_all(orc, port_path, ("s",)), ref_reads_port)
    got, want = pa_orc.read_table(port_path), pa_orc.read_table(ref_path)
    assert got.equals(want)
    assert got.num_rows == port_reads_ref["rows"]
    assert got.column("s").to_pylist() == [
        v for s in port_reads_ref["stripes"] for v in s[1]["s"][0]]


def test_smallint_column_is_byte_identical(tmp_path):
    n = 3000
    extra = [("t16", "smallint",
              np.random.default_rng(65).integers(-2**14, 2**14, n).astype(np.int16), None)]
    port_path, ref_path, _ = _write(tmp_path, (65, n, 1, 0.2), "zlib", extra=extra)
    assert open(port_path, "rb").read() == open(ref_path, "rb").read()


def test_empty_seed_file_is_byte_identical(tmp_path):
    """The file catalog's CREATE TABLE seed: no pages, one dictionary."""
    p, r = str(tmp_path / "p.orc"), str(tmp_path / "r.orc")
    orc_writer.write_orc(p, ["k", "s"], [types.BIGINT, types.VARCHAR],
                         [None, Dictionary([])], [])
    ref_writer.write_orc(r, ["k", "s"], [ref_types.BIGINT, ref_types.VARCHAR],
                         [None, RefDictionary([])], [])
    assert open(p, "rb").read() == open(r, "rb").read()
    assert read_all(orc, p)["rows"] == 0


def test_encoders_equal():
    rng = np.random.default_rng(66)
    for n in (0, 1, 2, 3, 127, 128, 130, 511, 512, 513, 3000):
        raw = rng.integers(0, 3, n).astype(np.uint8)
        raw[n // 3: n // 2] = 5  # runs beside literals
        assert orc_writer.encode_byte_rle(raw) == ref_writer.encode_byte_rle(raw)
        bits = rng.integers(0, 2, n).astype(bool)
        assert orc_writer.encode_bool_rle(bits) == ref_writer.encode_bool_rle(bits)
        for signed in (True, False):
            lo = -2**50 if signed else 0
            for vals in (rng.integers(lo, 2**50, n), np.full(n, 3)):
                assert orc_writer.encode_rlev2(vals, signed) == \
                    ref_writer.encode_rlev2(vals, signed)


VARINT_CASES = {
    "edges": np.asarray([0, -1, 1, 63, -64, 64, -65, 2**62, -2**63, 2**63 - 1]),
    "random int64": np.random.default_rng(67).integers(-2**63, 2**63 - 1, 3000,
                                                       dtype=np.int64),
    "small decimals": np.random.default_rng(68).integers(-10**6, 10**6, 5000),
    "every byte length": np.asarray([(1 << (7 * k)) - 1 for k in range(1, 10)]
                                    + [-(1 << (7 * k)) for k in range(9)]),
    "empty": np.zeros(0, dtype=np.int64),
}


@pytest.mark.parametrize("case", sorted(VARINT_CASES))
def test_varint_stream_encode_equal(case):
    """The numpy varint encoder against the reference's per-value loop,
    and back through the reference's decoder."""
    vals = VARINT_CASES[case]
    got = orc_writer._encode_varint_stream(vals)
    assert got == ref_writer._encode_varint_stream(vals)
    assert np.array_equal(ref_orc._decode_varint_stream(got, len(vals)), vals)
