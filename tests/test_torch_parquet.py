"""The port's Parquet reader (``presto_tpu_torch/formats/parquet.py``)
against the reference's, on the CPU.

``pyarrow`` appears only as the writer of the fixture files, as in
``tests/test_parquet.py``: every file it writes, in each codec and page
version that test covers, with dictionary and PLAIN strings, FLBA decimals
and NULLs, is read by both packages, and the columns, NULL masks, row-group
statistics and distinct strings must be equal (exactly; doubles bit for
bit). ``snappy_decompress`` and ``_decode_rle_bitpacked`` are held against
the reference's on the same bytes. Without ``zstandard`` a zstd file must
raise the same ImportError in both packages.
"""
import decimal
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from presto_tpu.formats import parquet as ref_parquet
from presto_tpu_torch.formats import parquet


def same_columns(got: dict, want: dict) -> None:
    """name -> (values, null mask or None): equal keys, dtypes and values
    (NaN equal to NaN), equal null masks."""
    assert list(got) == list(want)
    for name in want:
        gv, gn = got[name]
        wv, wn = want[name]
        assert gv.dtype == wv.dtype, name
        if wv.dtype == object:
            assert list(gv) == list(wv), name
        else:
            assert np.array_equal(gv, wv, equal_nan=wv.dtype.kind == "f"), name
        assert (gn is None) == (wn is None), name
        if wn is not None:
            assert np.array_equal(gn, wn), name


def read_all(mod, path: str, distinct_cols=()):
    """Everything one package's reader gives for a file: the schema, each
    row group's columns and statistics, and the distinct strings."""
    f = mod.ParquetFile(path)
    try:
        names = [n for n, _ in f.schema]
        out = {"schema": [(n, str(t)) for n, t in f.schema], "rows": f.num_rows,
               "groups": [], "distinct": {c: f.column_distinct_strings(c) for c in distinct_cols}}
        for g in range(f.n_row_groups):
            out["groups"].append((f.row_group_rows(g), f.read_row_group(g, names),
                                  {n: f.row_group_stats(g, n) for n in names}))
        return out
    finally:
        f.close()


def same_files(got: dict, want: dict) -> None:
    assert got["schema"] == want["schema"] and got["rows"] == want["rows"]
    assert got["distinct"] == want["distinct"]
    assert len(got["groups"]) == len(want["groups"])
    for (gr, gc, gs), (wr, wc, ws) in zip(got["groups"], want["groups"]):
        assert gr == wr and gs == ws
        same_columns(gc, wc)


def _fixture_table(n: int, seed: int) -> pa.Table:
    rng = np.random.default_rng(seed)
    return pa.table({
        "a_i64": pa.array(rng.integers(-2**40, 2**40, n)),
        "a_i32": pa.array(rng.integers(-2**30, 2**30, n), type=pa.int32()),
        "a_i16": pa.array(rng.integers(-2**14, 2**14, n), type=pa.int16()),
        "a_f64": pa.array(rng.standard_normal(n)),
        "a_f32": pa.array(rng.standard_normal(n).astype(np.float32)),
        "a_bool": pa.array(rng.integers(0, 2, n).astype(bool)),
        "a_str": pa.array([f"v{int(x)}" for x in rng.integers(0, 40, n)]),
        "a_dec": pa.array([decimal.Decimal(int(x)) / 100
                           for x in rng.integers(-10**6, 10**6, n)],
                          type=pa.decimal128(12, 2)),
        "a_date": pa.array(rng.integers(8000, 12000, n).astype("int32"),
                           type=pa.int32()).cast(pa.date32()),
        "a_null": pa.array([None if i % 7 == 0 else i for i in range(n)]),
        "a_nstr": pa.array([None if i % 5 == 0 else f"s{i % 13}" for i in range(n)]),
    })


# the codecs and page versions of tests/test_parquet.py::test_reader_matrix
MATRIX = [("snappy", False), ("gzip", False), ("none", False), ("snappy", True),
          ("gzip", True)]


@pytest.mark.parametrize("codec,v2", MATRIX)
@pytest.mark.parametrize("dictionary", [True, False])
def test_reader_matrix_equal(tmp_path, codec, v2, dictionary):
    tbl = _fixture_table(4000, seed=len(codec) + 2 * v2)
    path = str(tmp_path / "t.parquet")
    pq.write_table(tbl, path, compression=codec, use_dictionary=dictionary,
                   data_page_version="2.0" if v2 else "1.0", row_group_size=1500)
    got = read_all(parquet, path, ("a_str", "a_nstr"))
    want = read_all(ref_parquet, path, ("a_str", "a_nstr"))
    same_files(got, want)
    # and both against pyarrow's own values
    assert got["rows"] == 4000
    strs = np.concatenate([g[1]["a_str"][0] for g in got["groups"]])
    assert list(strs) == tbl["a_str"].to_pylist()


def test_zstd_file_same_in_both(tmp_path):
    """A zstd file decodes equal in both packages, or, without the
    ``zstandard`` module, raises the same ImportError in both."""
    path = str(tmp_path / "z.parquet")
    pq.write_table(_fixture_table(2000, seed=5), path, compression="zstd",
                   row_group_size=700)

    def outcome(mod):
        try:
            return "ok", read_all(mod, path, ("a_str",))
        except ImportError as e:
            return "import error", (type(e).__name__, e.name)

    got, want = outcome(parquet), outcome(ref_parquet)
    assert got[0] == want[0]
    if got[0] == "ok":
        same_files(got[1], want[1])
    else:
        assert got[1] == want[1]


def test_multi_row_group_stats_equal(tmp_path):
    tbl = pa.table({"k": pa.array(np.arange(10000)), "v": pa.array(np.arange(10000) * 2),
                    "s": pa.array([f"w{i % 97:03d}" for i in range(10000)])})
    path = str(tmp_path / "t.parquet")
    pq.write_table(tbl, path, row_group_size=1000)
    got, want = read_all(parquet, path, ("s",)), read_all(ref_parquet, path, ("s",))
    same_files(got, want)
    assert len(got["groups"]) == 10
    assert got["groups"][0][2]["k"] == (0, 999) and got["groups"][9][2]["k"] == (9000, 9999)


SNAPPY_CASES = {
    "repeats and random": b"abcdefgh" * 500 + bytes(range(256)) * 2 + b"x" * 1000,
    "empty": b"",
    "short literal": b"presto",
    "overlapping copies": b"ab" * 3000 + b"abc" * 1000,
}


@pytest.mark.parametrize("case", sorted(SNAPPY_CASES))
def test_snappy_decompress_equal(case):
    data = SNAPPY_CASES[case]
    comp = pa.compress(data, codec="snappy", asbytes=True)
    assert parquet.snappy_decompress(comp) == ref_parquet.snappy_decompress(comp) == data


def test_snappy_decompress_random_equal():
    rng = np.random.default_rng(7)
    for i in range(20):
        n = int(rng.integers(0, 20000))
        # runs of a small alphabet: literals and copies of every length
        data = rng.integers(0, 1 + i, n).astype(np.uint8).tobytes() + os.urandom(i * 3)
        comp = pa.compress(data, codec="snappy", asbytes=True)
        assert parquet.snappy_decompress(comp) == ref_parquet.snappy_decompress(comp) == data


def test_rle_bitpacked_decode_equal():
    """The hybrid decoder on the writer's runs (both kinds), on a pyarrow
    file's definition levels, and on hand-made streams with several runs."""
    from presto_tpu.formats.parquet_writer import encode_rle_bitpacked

    rng = np.random.default_rng(3)
    for width in (0, 1, 2, 3, 5, 8, 12, 17, 20):
        for n in (1, 7, 8, 9, 100, 1001):
            hi = 1 << width if width else 1
            for vals in (rng.integers(0, hi, n), np.full(n, hi - 1)):
                for prefixed in (False, True):
                    data = encode_rle_bitpacked(vals, width, prefixed)
                    got = parquet._decode_rle_bitpacked(data, width, n, prefixed)
                    want = ref_parquet._decode_rle_bitpacked(data, width, n, prefixed)
                    assert got.dtype == want.dtype and np.array_equal(got, want)
                    assert np.array_equal(got, vals if width else np.zeros(n))
    # several runs in one stream: RLE(5 x 3), bit-packed(8 values), RLE(4 x 1)
    stream = bytes([5 << 1, 3, (1 << 1) | 1, 0b10001000, 0b11000110, 0b11111010, 4 << 1, 1])
    got = parquet._decode_rle_bitpacked(stream, 3, 17, False)
    assert np.array_equal(got, ref_parquet._decode_rle_bitpacked(stream, 3, 17, False))
    assert list(got[:5]) == [3] * 5 and list(got[13:]) == [1] * 4


def test_plain_byte_array_and_flba_decode_equal():
    rng = np.random.default_rng(11)
    words = ["", "a", "ü", "long " * 40] + [f"w{i}" for i in range(50)]
    picks = [words[int(i)] for i in rng.integers(0, len(words), 500)]
    data = b"".join(len(w.encode()).to_bytes(4, "little") + w.encode() for w in picks)
    got = parquet._decode_byte_array(data, len(picks))
    assert list(got) == list(ref_parquet._decode_byte_array(data, len(picks))) == picks
    for width in (1, 3, 8, 9, 16):
        vals = rng.integers(-(1 << min(8 * width - 1, 62)), 1 << min(8 * width - 1, 62), 200)
        raw = b"".join(int(v).to_bytes(width, "big", signed=True) for v in vals)
        got = parquet._decode_flba_decimal(raw, len(vals), width)
        assert np.array_equal(got, ref_parquet._decode_flba_decimal(raw, len(vals), width))
        assert np.array_equal(got, vals)


def test_not_a_parquet_file_raises_the_same(tmp_path):
    path = tmp_path / "junk.parquet"
    path.write_bytes(b"\0" * 64)
    for mod in (parquet, ref_parquet):
        with pytest.raises(ValueError, match="not a parquet file"):
            mod.ParquetFile(str(path))
