"""The port's RCFile reader and writer (``presto_tpu_torch/formats/rcfile.py``)
against the reference's, on the CPU.

``tests/test_rcfile.py``'s cases in both packages: seeded text cells
(NULLs and the escaped ``\\N`` family included) written by each package's
``write_rcfile`` must give byte-identical files, compressed or not; both
readers must read the same groups and cells; ``decode_cells`` must give the
same typed values and NULL masks for every type; ``write_rcfile_table``
and its sidecar schema must be identical. Tolerance: exact.
"""
import numpy as np
import pytest

from presto_tpu import types as ref_types
from presto_tpu.formats import rcfile as ref_rcfile
from presto_tpu_torch import types
from presto_tpu_torch.formats import rcfile


def _cells(seed: int, n: int):
    """Seeded text columns: bigint, varchar (NULLs, escapes), decimal,
    double, date, boolean, timestamp."""
    rng = np.random.default_rng(seed)
    words = ["a", "bb", "", "\\N", "\\\\N", "x\ty", "ünï", "long" * 30]
    return [
        [str(int(v)) for v in rng.integers(-10 ** 12, 10 ** 12, n)],
        [None if i % 7 == 0 else words[int(w)] for i, w in
         enumerate(rng.integers(0, len(words), n))],
        [f"{int(v) / 100:.2f}" for v in rng.integers(-10 ** 8, 10 ** 8, n)],
        [None if i % 5 == 0 else repr(float(v)) for i, v in enumerate(rng.normal(size=n))],
        [f"{1992 + int(v) % 7}-{1 + int(v) % 12:02d}-{1 + int(v) % 28:02d}"
         for v in rng.integers(0, 10 ** 6, n)],
        [("true", "false", "1", "0")[int(v)] for v in rng.integers(0, 4, n)],
        [f"1995-03-{1 + int(v) % 28:02d} {int(v) % 24:02d}:{int(v) % 60:02d}:07"
         for v in rng.integers(0, 10 ** 6, n)],
    ]


NAMES = ["id", "name", "price", "score", "day", "flag", "at"]


def _types(mod):
    return [mod.BIGINT, mod.VARCHAR, mod.DecimalType(12, 2), mod.DOUBLE, mod.DATE,
            mod.BOOLEAN, mod.TIMESTAMP]


def test_vlong_equal():
    for v in (0, 1, -1, 127, 128, -112, -113, 255, 1 << 20, -(1 << 20),
              1 << 40, -(1 << 40), (1 << 62), -(1 << 63)):
        data = rcfile.write_vlong(v)
        assert data == ref_rcfile.write_vlong(v)
        assert rcfile._Cursor(data).read_vlong() == ref_rcfile._Cursor(data).read_vlong() == v


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("n,per_group", [(1000, 256), (37, 4096), (0, 16)])
def test_files_byte_identical_and_read_equal(tmp_path, compress, n, per_group):
    cols = _cells(71 + n, n)
    p, r = str(tmp_path / "p.rc"), str(tmp_path / "r.rc")
    rcfile.write_rcfile(p, cols, rows_per_group=per_group, compress=compress)
    ref_rcfile.write_rcfile(r, cols, rows_per_group=per_group, compress=compress)
    assert open(p, "rb").read() == open(r, "rb").read()
    f, g = rcfile.RcFile(r), ref_rcfile.RcFile(p)
    assert (f.num_rows, f.n_groups, f.compressed, f.n_columns) == \
        (g.num_rows, g.n_groups, g.compressed, g.n_columns)
    assert f.num_rows == n
    for grp in range(f.n_groups):
        assert f.group_rows(grp) == g.group_rows(grp)
        got, want = f.read_group(grp, [1, 3]), g.read_group(grp, [1, 3])
        assert got == want and set(got) == {1, 3}  # lazy: only the columns asked
        full = f.read_group(grp, list(range(len(cols))))
        assert full == g.read_group(grp, list(range(len(cols))))
        for i, (pt, rt) in enumerate(zip(_types(types), _types(ref_types))):
            vals, nulls = rcfile.decode_cells(full[i], pt)
            rvals, rnulls = ref_rcfile.decode_cells(full[i], rt)
            assert vals.dtype == rvals.dtype
            assert list(vals) == list(rvals) if vals.dtype == object \
                else np.array_equal(vals, rvals)
            assert (nulls is None) == (rnulls is None)
            if nulls is not None:
                assert np.array_equal(nulls, rnulls)


def test_table_files_and_sidecar_identical(tmp_path):
    cols = _cells(72, 300)
    p, r = str(tmp_path / "p.rc"), str(tmp_path / "r.rc")
    rcfile.write_rcfile_table(p, NAMES, _types(types), cols, rows_per_group=64)
    ref_rcfile.write_rcfile_table(r, NAMES, _types(ref_types), cols, rows_per_group=64)
    assert open(p, "rb").read() == open(r, "rb").read()
    assert open(p + ".schema").read() == open(r + ".schema").read()
    f, g = rcfile.RcTableFile(r), ref_rcfile.RcTableFile(p)
    try:
        assert [(n, str(t)) for n, t in f.schema] == [(n, str(t)) for n, t in g.schema]
        assert f.n_chunks == g.n_chunks == 5
        for c in range(f.n_chunks):
            assert f.chunk_rows(c) == g.chunk_rows(c)
            assert f.chunk_stats(c, "id") is g.chunk_stats(c, "id") is None
            got, want = f.read_chunk(c, NAMES), g.read_chunk(c, NAMES)
            for name in NAMES:
                gv, gn = got[name]
                wv, wn = want[name]
                assert list(gv) == list(wv) if gv.dtype == object else np.array_equal(gv, wv)
                assert (gn is None and wn is None) or np.array_equal(gn, wn)
        assert f.column_distinct_strings("name") is g.column_distinct_strings("name") is None
    finally:
        f.close()
        g.close()


def test_sidecar_mismatch_raises_the_same(tmp_path):
    p = str(tmp_path / "t.rc")
    rcfile.write_rcfile_table(p, ["a", "b"], [types.BIGINT, types.BIGINT], [["1"], ["2"]])
    with open(p + ".schema", "w") as f:
        f.write('{"columns": [["a", "bigint", 0]]}')
    msgs = []
    for mod in (rcfile, ref_rcfile):
        with pytest.raises(ValueError) as e:
            mod.RcTableFile(p)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "sidecar schema" in msgs[0]
