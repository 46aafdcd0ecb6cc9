"""The port's verifier against presto_tpu, on the CPU
(``tests/test_verifier.py``).

The checksum cases run on the port's ``column_checksums``; the end-to-end
cases verify the port's engine against the sqlite oracle at ``tiny``. Both
packages' ``column_checksums`` of the same rows are equal field for field:
the digests exactly, the floating totals to ``DOUBLE_REL_TOL`` relative.
"""
import dataclasses
import datetime
import math
from decimal import Decimal

import numpy as np
import pytest

from presto_tpu.verifier import column_checksums as ref_column_checksums
from presto_tpu_torch.verifier import (CONTROL_ERROR, MATCH, MISMATCH, TEST_ERROR, Verifier,
                                       column_checksums, make_oracle_verifier)

DOUBLE_REL_TOL = 1e-12


def test_checksums_order_independent():
    a = column_checksums([[1, "x"], [2, "y"], [3, None]])
    b = column_checksums([[3, None], [1, "x"], [2, "y"]])
    assert all(x.matches(y, 1e-6) for x, y in zip(a, b))


def test_checksums_detect_value_change():
    a = column_checksums([[1], [2]])
    b = column_checksums([[1], [3]])
    assert not a[0].matches(b[0], 1e-6)


def test_float_columns_use_tolerance():
    a = column_checksums([[1.0000001], [2.0]])
    b = column_checksums([[1.0], [2.0000001]])
    assert a[0].matches(b[0], 1e-4)
    c = column_checksums([[10.0], [2.0]])
    assert not a[0].matches(c[0], 1e-4)


def test_null_counts_matter():
    a = column_checksums([[None], [1]])
    b = column_checksums([[1], [1]])
    assert not a[0].matches(b[0], 1e-6)


def test_verifier_reports_status():
    v = Verifier(control=lambda s: [[1], [2]],
                 test=lambda s: [[2], [1]] if s == "ok" else [[9]])
    assert v.verify("a", "ok").status == MATCH
    assert v.verify("b", "bad").status == MISMATCH
    v2 = Verifier(control=lambda s: [[1]],
                  test=lambda s: (_ for _ in ()).throw(RuntimeError("x")))
    assert v2.verify("c", "q").status == TEST_ERROR
    v3 = Verifier(control=lambda s: (_ for _ in ()).throw(RuntimeError("y")),
                  test=lambda s: [[1]])
    assert v3.verify("d", "q").status == CONTROL_ERROR


@pytest.fixture(scope="module")
def oracle_verifier():
    return make_oracle_verifier(device="cpu")


@pytest.mark.parametrize("qid", [6, 12])
def test_oracle_verification_end_to_end(oracle_verifier, qid):
    from presto_tpu_torch.models.tpch_sql import QUERIES

    r = oracle_verifier.verify(f"q{qid}", QUERIES[qid])
    assert r.status == MATCH, r


ROWS = {
    "ints and strings": [[1, "x"], [2, "y"], [3, None], [3, "y"]],
    "decimals and dates": [[Decimal("1.50"), datetime.date(1995, 3, 15)],
                           [Decimal("-2.25"), datetime.date(1970, 1, 1)],
                           [None, datetime.date(1998, 12, 1)]],
    "floats": [[1.25, 0.1], [float("nan"), 2.0], [None, 3.0], [3.0, -0.3]],
    "numpy scalars": [[np.int64(4), np.float64(2.5)], [np.int32(5), np.float64(3.0)]],
    "integral floats": [[3.0], [4.0], [5]],
    "bools": [[True], [False], [None]],
    "empty": [],
}


@pytest.mark.parametrize("label", sorted(ROWS))
def test_column_checksums_equal_reference(label):
    got = column_checksums(ROWS[label])
    want = ref_column_checksums(ROWS[label])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = dataclasses.asdict(g), dataclasses.asdict(w)
        gt, wt = g.pop("total"), w.pop("total")
        assert g == w, (label, g, w)
        assert (gt is None) == (wt is None)
        if gt is not None:
            assert math.isclose(gt, wt, rel_tol=DOUBLE_REL_TOL), (label, gt, wt)


def test_distributed_verification_end_to_end():
    """The single-node engine as control, four logical workers as test."""
    from presto_tpu_torch.models.tpch_sql import QUERIES
    from presto_tpu_torch.verifier import make_distributed_verifier

    r = make_distributed_verifier(device="cpu").verify("q6", QUERIES[6])
    assert r.status == MATCH, r
