"""Hand-built TPC-H Q1 and Q6, ``source_rows``, and the package's helpers:
the PyTorch port against the JAX reference on the CPU.

The pipelines run at ``tiny`` with 2^14-row pages, as
``tests/test_tpch_queries.py`` runs the reference's. Rows are exact but
for Q1's DOUBLE averages, compared to 1e-12 relative: the port averages a
DECIMAL by its exact scaled sum (ROADMAP standing difference 1). Both
packages' rows also go against the sqlite oracle. One reference run of
each query and one oracle load serve the whole file.
"""
import datetime
import math
import os
import subprocess
import sys
from decimal import Decimal

import numpy as np
import pytest
import torch

import presto_tpu
import presto_tpu_torch
from presto_tpu import block as ref_block
from presto_tpu import types as ref_types
from presto_tpu.models import hand_queries as ref_hq
from presto_tpu.utils import kernel_cache as ref_kernel_cache
from presto_tpu_torch import block as tb
from presto_tpu_torch import types as tt
from presto_tpu_torch.exec import shared_pools
from presto_tpu_torch.models import hand_queries as hq
from presto_tpu_torch.ops.hash_agg import DirectAggregationBuilder, GlobalAggregationBuilder
from presto_tpu_torch.utils import kernel_cache
from presto_tpu_torch.utils.testing import SqliteOracle, assert_rows_equal

DOUBLE_REL_TOL = 1e-12
PAGE = 1 << 14

ORACLE_SQL = {
    "q6": """
        SELECT sum(l_extendedprice * l_discount)
        FROM lineitem
        WHERE l_shipdate >= 8766 AND l_shipdate < 9131
          AND l_discount BETWEEN 0.05 AND 0.07 AND l_quantity < 24
    """,
    "q1": """
        SELECT l_returnflag, l_linestatus, sum(l_quantity), sum(l_extendedprice),
               sum(l_extendedprice * (1 - l_discount)),
               sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)),
               avg(l_quantity), avg(l_extendedprice), avg(l_discount), count(*)
        FROM lineitem
        WHERE l_shipdate <= 10471
        GROUP BY l_returnflag, l_linestatus
    """,
}
BUILDERS = {"q1": "build_q1", "q6": "build_q6"}


@pytest.fixture(scope="module")
def reference_rows():
    return {q: ref_hq.run_query(getattr(ref_hq, b), "tiny", PAGE) for q, b in BUILDERS.items()}


@pytest.fixture(scope="module")
def oracle():
    o = SqliteOracle()
    o.load_tpch(0.01, ["lineitem"])
    return o


def _assert_same_rows(got, want):
    assert len(got) == len(want) > 0, (got, want)
    for g, w in zip(got, want):
        assert len(g) == len(w), (g, w)
        for a, b in zip(g, w):
            assert type(a) is type(b), (a, b)
            if isinstance(a, float):
                assert math.isclose(a, b, rel_tol=DOUBLE_REL_TOL, abs_tol=0.0), (a, b)
            else:
                assert a == b, (a, b)


@pytest.mark.parametrize("q", ["q1", "q6"])
def test_hand_query_rows_match_reference_and_oracle(reference_rows, oracle, q):
    rows = hq.run_query(getattr(hq, BUILDERS[q]), "tiny", PAGE, device="cpu")
    _assert_same_rows(rows, reference_rows[q])
    exp = oracle.query(ORACLE_SQL[q])
    assert_rows_equal(rows, exp, rel_tol=1e-9)
    assert_rows_equal(reference_rows[q], exp, rel_tol=1e-9)


@pytest.mark.parametrize("q,builder_type", [("q1", DirectAggregationBuilder),
                                            ("q6", GlobalAggregationBuilder)])
def test_hand_query_aggregation_strategy_and_output_types(q, builder_type):
    """Q1 groups DIRECT over the two dictionary domains, Q6 is GLOBAL; the
    sink's types (``agg_output_types``) are the reference's."""
    driver, sink = getattr(hq, BUILDERS[q])("tiny", PAGE, device="cpu")
    assert isinstance(driver.operators[1].builder, builder_type)
    _ref_driver, ref_sink = getattr(ref_hq, BUILDERS[q])("tiny", PAGE)
    assert [str(t) for t in sink.types] == [str(t) for t in ref_sink.types]
    assert len(sink.types) == (10 if q == "q1" else 1)


@pytest.mark.parametrize("builder", ["build_q1", "build_q6"])
def test_builders_default_to_cuda_and_raise_without_it(monkeypatch, builder):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        hq.run_query(getattr(hq, builder), "tiny", PAGE)


@pytest.mark.parametrize("schema", ["tiny", "sf1", "sf10", "sf100"])
@pytest.mark.parametrize("q", ["q1", "q3", "q6"])
def test_source_rows_match_reference(q, schema):
    assert hq.source_rows(q, schema) == ref_hq.source_rows(q, schema) > 0


def test_concat_page_source_under_the_reference_name():
    from presto_tpu_torch.spi.connector import ConcatPageSource

    assert hq.ConcatPageSource is ConcatPageSource
    assert list(hq.ConcatPageSource([[1, 2], [], [3]])) == [1, 2, 3]


# --- the block helpers and the package's exports ------------------------------

PYLIST_ROWS = [[1, Decimal("2.50"), datetime.date(1995, 3, 15), "x", 1.5],
               [None, None, None, None, None],
               [7, Decimal("-0.01"), 9000, "b", -2.0]]


def _types(mod):
    return [mod.BIGINT, mod.DecimalType(12, 2), mod.DATE, mod.VARCHAR, mod.DOUBLE]


def _helper_pages(helper):
    if helper == "page_from_pylists":
        return (ref_block.page_from_pylists(_types(ref_types), PYLIST_ROWS, capacity=5),
                tb.page_from_pylists(_types(tt), PYLIST_ROWS, capacity=5, device="cpu"))
    if helper == "empty_page":
        return (ref_block.empty_page(_types(ref_types), 4),
                tb.empty_page(_types(tt), 4, device="cpu"))
    arr = np.array([3, 1, 2], dtype=np.int32)
    nulls = np.array([False, True, False])
    ref = ref_block.Page((ref_block.block_from_numpy(ref_types.BIGINT, arr, None, nulls),),
                         np.ones(3, dtype=np.bool_))
    port = tb.Page((tb.block_from_numpy(tt.BIGINT, arr, None, nulls, device="cpu"),),
                   torch.ones(3, dtype=torch.bool))
    return ref, port


@pytest.mark.parametrize("helper", ["page_from_pylists", "empty_page", "block_from_numpy"])
def test_block_helpers_match_reference(helper):
    ref, port = _helper_pages(helper)
    assert port.to_pylists() == ref.to_pylists()
    assert port.capacity == int(np.asarray(ref.mask).shape[0])
    assert port.device == torch.device("cpu")


def test_block_from_numpy_casts_to_the_types_dtype():
    b = tb.block_from_numpy(tt.BIGINT, np.array([1, 2], dtype=np.int8), device="cpu")
    assert b.data.dtype == torch.int64 and b.nulls is None


def test_package_exports_the_references_names():
    for name in ("Block", "Dictionary", "Page", "page_from_arrays", "page_from_pylists"):
        assert hasattr(presto_tpu, name)
        assert getattr(presto_tpu_torch, name) is getattr(tb, name)


# --- utils.testing, kernel_cache, shared_pools --------------------------------

@pytest.mark.parametrize("actual,expected,equal", [
    ([[2, "b"], [1, None]], [(1, None), (2, "b")], True),        # any order
    ([[1, 0.30000000000000004]], [(1, 0.3)], True),               # floats to rel_tol
    ([[1, Decimal("0.5")], [datetime.date(1970, 1, 3), 2]], [(1, 0.5), (2, 2)], True),
    ([[1, "a"]], [(1, "b")], False),
    ([[1], [2]], [(1,)], False),
])
def test_assert_rows_equal(actual, expected, equal):
    if equal:
        assert_rows_equal(actual, expected)
    else:
        with pytest.raises(AssertionError):
            assert_rows_equal(actual, expected)


def test_assert_rows_equal_ordered():
    with pytest.raises(AssertionError):
        assert_rows_equal([[2], [1]], [(1,), (2,)], ordered=True)
    assert_rows_equal([[1], [2]], [(1,), (2,)], ordered=True)


def test_kernel_cache_stats_has_the_references_keys():
    got = kernel_cache.stats()
    assert set(got) == set(ref_kernel_cache.stats()) == {"entries", "building"}
    assert got["entries"] >= 0 and got["building"] == 0


@pytest.mark.parametrize("value,want", [("3", 3), ("", 7), ("many", 7), ("0", 7), ("-2", 7),
                                        (None, 7)])
def test_pool_size_reads_its_variable(monkeypatch, value, want):
    env = "PRESTO_TPU_TORCH_SCAN_POOL_THREADS"
    if value is None:
        monkeypatch.delenv(env, raising=False)
    else:
        monkeypatch.setenv(env, value)
    assert shared_pools._pool_size(env, 7) == want


def test_pool_variables_size_the_pools_at_import():
    """A fresh process with both variables set sizes both pools from them."""
    env = {**os.environ, "PRESTO_TPU_TORCH_SCAN_POOL_THREADS": "3",
           "PRESTO_TPU_TORCH_EXCHANGE_POOL_THREADS": "2"}
    code = ("from presto_tpu_torch.exec import shared_pools as p; "
            "print(p.SCAN_POOL.size, p.EXCHANGE_POOL.size)")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["3", "2"]


@pytest.mark.parametrize("package", ["presto_tpu", "presto_tpu_torch"])
def test_generation_cache_clear_makes_the_next_scan_generate(package):
    """The port's ``_GenCache.clear`` is the reference's: a hit before it, a
    new generation after it."""
    import importlib

    cache = importlib.import_module(f"{package}.connectors.tpch.connector")._GenCache()
    calls = []

    def generate():
        calls.append(1)
        return {"a": np.zeros(4, dtype=np.int64)}

    key = ("lineitem", 0.01, 0, 4, ("a",))
    cache.get_or_generate(key, generate)
    cache.get_or_generate(key, generate)
    assert len(calls) == 1
    cache.clear()
    cache.get_or_generate(key, generate)
    assert len(calls) == 2
