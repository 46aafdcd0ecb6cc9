"""The port's ORC reader (``presto_tpu_torch/formats/orc.py``) against the
reference's, on the CPU.

``pyarrow`` appears only as the writer of the fixture files, as in
``tests/test_orc.py``: in each compression that test covers, with NULLs,
several stripes and every RLEv2 sub-format, both packages must read equal
columns, NULL masks, stripe statistics and distinct strings (exactly).
``decode_rlev2``, ``decode_byte_rle``, ``decode_bool_rle`` and the numpy
``_decode_varint_stream`` are held against the reference's functions on the
same bytes.
"""
import decimal

import numpy as np
import pyarrow as pa
import pyarrow.orc as pa_orc
import pytest

from presto_tpu.formats import orc as ref_orc
from presto_tpu.formats import orc_writer as ref_orc_writer
from presto_tpu_torch.formats import orc
from test_torch_parquet import same_columns


def read_all(mod, path: str, distinct_cols=()):
    """Everything one package's reader gives for a file: the schema, each
    stripe's columns and statistics, the file statistics' schema and the
    distinct strings."""
    f = mod.OrcFile(path)
    try:
        names = [n for n, _ in f.schema]
        out = {"schema": [(n, str(t)) for n, t in f.schema], "rows": f.num_rows,
               "stripes": [], "distinct": {c: f.column_distinct_strings(c)
                                           for c in distinct_cols}}
        for s in range(f.n_stripes):
            out["stripes"].append((f.stripe_rows(s), f.read_stripe(s, names),
                                   {n: f.stripe_col_stats(s, n) for n in names}))
        return out
    finally:
        f.close()


def same_files(got: dict, want: dict) -> None:
    assert got["schema"] == want["schema"] and got["rows"] == want["rows"]
    assert got["distinct"] == want["distinct"]
    assert len(got["stripes"]) == len(want["stripes"])
    for (gr, gc, gs), (wr, wc, ws) in zip(got["stripes"], want["stripes"]):
        assert gr == wr and gs == ws
        same_columns(gc, wc)


def _write(tmp_path, tbl, name="t.orc", **kw):
    path = str(tmp_path / name)
    pa_orc.write_table(tbl, path, **kw)
    return path


def _fixture_table(n: int, seed: int) -> pa.Table:
    rng = np.random.default_rng(seed)
    return pa.table({
        "c_i64": pa.array(rng.integers(-2**40, 2**40, n)),
        "c_i32": pa.array(rng.integers(-2**30, 2**30, n), type=pa.int32()),
        "c_i16": pa.array(rng.integers(-2**14, 2**14, n), type=pa.int16()),
        "c_i8": pa.array(rng.integers(-128, 128, n), type=pa.int8()),
        "c_f64": pa.array(rng.standard_normal(n)),
        "c_f32": pa.array(rng.standard_normal(n).astype(np.float32)),
        "c_bool": pa.array(rng.integers(0, 2, n).astype(bool)),
        "c_date": pa.array(rng.integers(8000, 12000, n).astype("int32"),
                           type=pa.int32()).cast(pa.date32()),
        "c_str": pa.array([f"val{int(x)}" for x in rng.integers(0, 30, n)]),
        "c_wide": pa.array([f"w{int(x)}" for x in rng.integers(0, 10 ** 6, n)]),
        "c_dec": pa.array([decimal.Decimal(int(x)) / 100
                           for x in rng.integers(-10**7, 10**7, n)],
                          type=pa.decimal128(12, 2)),
        "c_null": pa.array([None if i % 7 == 0 else i * 3 for i in range(n)]),
        "c_nstr": pa.array([None if i % 11 == 0 else f"s{i % 9}" for i in range(n)]),
    })


@pytest.mark.parametrize("compression", ["uncompressed", "zlib", "snappy"])
def test_scalar_types_equal(tmp_path, compression):
    tbl = _fixture_table(5000, seed=len(compression))
    path = _write(tmp_path, tbl, compression=compression, stripe_size=4096)
    got = read_all(orc, path, ("c_str", "c_nstr", "c_wide"))
    same_files(got, read_all(ref_orc, path, ("c_str", "c_nstr", "c_wide")))
    assert got["rows"] == 5000
    strs = np.concatenate([s[1]["c_str"][0] for s in got["stripes"]])
    assert list(strs) == tbl["c_str"].to_pylist()


def test_zstd_file_same_in_both(tmp_path):
    """A zstd file decodes equal in both packages, or, without the
    ``zstandard`` module, raises the same ImportError in both."""
    path = _write(tmp_path, _fixture_table(2000, seed=3), compression="zstd")

    def outcome(mod):
        try:
            return "ok", read_all(mod, path, ("c_str",))
        except ImportError as e:
            return "import error", e.name

    got, want = outcome(orc), outcome(ref_orc)
    assert got[0] == want[0]
    if got[0] == "ok":
        same_files(got[1], want[1])
    else:
        assert got[1] == want[1]


def test_multi_stripe_stats_equal(tmp_path):
    n = 100_000
    tbl = pa.table({"k": pa.array(np.arange(n)), "v": pa.array(np.arange(n) % 997),
                    "x": pa.array((np.arange(n) % 19).astype(np.float64))})
    path = _write(tmp_path, tbl, compression="zlib", stripe_size=1024)
    got = read_all(orc, path)
    same_files(got, read_all(ref_orc, path))
    assert len(got["stripes"]) > 1
    assert got["stripes"][0][2]["k"][0] == 0


RLE_ARRAYS = {
    "short repeat": np.full(100, 42),
    "ascending delta": np.arange(1000) * 7,
    "descending delta": np.arange(1000)[::-1] * 3,
    "wide direct": np.asarray([0, 1, -1, 2**33, -2**33] * 50),
    "patched base": np.where(np.arange(5000) % 701 == 0, 2**40 + np.arange(5000),
                             np.random.default_rng(5).integers(0, 512, 5000)),
    "int64 extremes": np.asarray([-2**63, 2**63 - 1, 0, -1] * 30),
}


@pytest.mark.parametrize("case", sorted(RLE_ARRAYS))
def test_rlev2_runs_equal(tmp_path, case):
    """pyarrow's encoder picks SHORT_REPEAT / DELTA / DIRECT / PATCHED_BASE
    runs for these arrays; both decoders read them equal."""
    arr = RLE_ARRAYS[case]
    path = _write(tmp_path, pa.table({"x": pa.array(arr)}), compression="uncompressed")
    got = read_all(orc, path)
    same_files(got, read_all(ref_orc, path))
    assert np.array_equal(np.concatenate([s[1]["x"][0] for s in got["stripes"]]), arr)


def test_decoders_equal_on_encoder_output():
    rng = np.random.default_rng(17)
    for n in (0, 1, 3, 130, 511, 512, 513, 5000):
        for signed in (True, False):
            lo = -2**50 if signed else 0
            for vals in (rng.integers(lo, 2**50, n), rng.integers(0, 5, n), np.full(n, 9)):
                data = ref_orc_writer.encode_rlev2(vals, signed)
                assert np.array_equal(orc.decode_rlev2(data, n, signed),
                                      ref_orc.decode_rlev2(data, n, signed))
        raw = rng.integers(0, 4, n).astype(np.uint8)
        raw[: n // 2] = 7  # a long run beside literals
        data = ref_orc_writer.encode_byte_rle(raw)
        got = orc.decode_byte_rle(data, n)
        assert np.array_equal(got, ref_orc.decode_byte_rle(data, n))
        assert np.array_equal(got, raw)
        bits = rng.integers(0, 2, n).astype(bool)
        data = ref_orc_writer.encode_bool_rle(bits)
        assert np.array_equal(orc.decode_bool_rle(data, n), ref_orc.decode_bool_rle(data, n))


VARINT_CASES = {
    "edges": np.asarray([0, -1, 1, 63, -64, 64, -65, 2**62, -2**63, 2**63 - 1]),
    "random int64": np.random.default_rng(19).integers(-2**63, 2**63 - 1, 3000,
                                                       dtype=np.int64),
    "small decimals": np.random.default_rng(20).integers(-10**6, 10**6, 5000),
    "empty": np.zeros(0, dtype=np.int64),
}


@pytest.mark.parametrize("case", sorted(VARINT_CASES))
def test_varint_stream_decode_equal(case):
    """The numpy varint decoder against the reference's per-value loop."""
    vals = VARINT_CASES[case]
    data = ref_orc_writer._encode_varint_stream(vals)
    got = orc._decode_varint_stream(data, len(vals))
    want = ref_orc._decode_varint_stream(data, len(vals))
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(got, vals)


def test_varint_stream_decode_reads_a_prefix():
    """``count`` varints from a longer stream, as the reference reads."""
    data = ref_orc_writer._encode_varint_stream(np.arange(-50, 50))
    assert np.array_equal(orc._decode_varint_stream(data, 10),
                          ref_orc._decode_varint_stream(data, 10))


def test_nested_rejected_in_both(tmp_path):
    path = _write(tmp_path, pa.table({"a": pa.array([[1, 2], [3]])}))
    for mod in (orc, ref_orc):
        with pytest.raises(NotImplementedError):
            mod.OrcFile(path)
