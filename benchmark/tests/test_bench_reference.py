"""The reference against the program, at ``tiny`` on the CPU: the frozen
generator's columns against the program's generator, and each query's
reference against the program's CPU run for several seeds' parameters."""
import numpy as np
import pytest

from benchmark.core import compare, spec, traffic
from benchmark.reference import tpch_gen as frozen
from benchmark.reference.common import EXACT
from benchmark.reference.db import Database

SF = 0.01
QUERIES = ["q01", "q03", "q06", "q09", "q13", "q14", "q22"]


@pytest.mark.parametrize("table", sorted(frozen.TPCH_TABLES))
def test_frozen_columns_equal_the_programs(table):
    from presto_tpu_torch.connectors.tpch import generator as g

    cols = [c.name for c in frozen.TPCH_TABLES[table].columns]
    n = frozen.table_row_count(table, SF)
    assert n == g.table_row_count(table, SF)
    got = frozen.generate_rows(table, 0, n, SF, cols)
    want = g.generate_rows(table, 0, n, SF, cols)
    for c in cols:
        assert np.array_equal(got[c], want[c]), c


def test_frozen_lineitem_equals_the_programs():
    from presto_tpu_torch.connectors.tpch import generator as g

    cols = [c for c, _, _ in frozen.LINEITEM_COLUMNS]
    orders = frozen.table_row_count("orders", SF)
    got = frozen.lineitem_for_orders(0, orders, SF, cols)
    want = g.lineitem_for_orders(0, orders, SF, cols)
    assert frozen.lineitem_row_count(SF) == g.lineitem_row_count(SF)
    for c in cols:
        assert np.array_equal(got[c], want[c]), c


def test_database_columns_and_cache(tmp_path):
    db = Database(SF, cache_dir=str(tmp_path))
    a = db.columns("lineitem", ["l_orderkey", "l_discount"])
    again = Database(SF, cache_dir=str(tmp_path)).columns("lineitem", ["l_orderkey", "l_discount"])
    assert a["l_orderkey"].dtype == np.int64
    assert len(a["l_orderkey"]) == frozen.lineitem_row_count(SF)
    for c in a:
        assert np.array_equal(a[c], again[c])
    assert len(list(tmp_path.rglob("*.npy"))) == 2


def test_phone_country_code_is_the_decoded_prefix():
    codes = Database(SF).column("customer", "c_phone")
    decoded = [p[:2] for p in frozen.DICT_PHONE.lookup(codes)]
    assert decoded == [str(11 + c % 25) for c in codes]


@pytest.fixture(scope="module")
def cpu_runner():
    from presto_tpu_torch.metadata import Session
    from presto_tpu_torch.runner import LocalQueryRunner

    return LocalQueryRunner(Session(catalog="tpch", schema="tiny",
                                    properties={"hash_kernels": "pallas"}), device="cpu")


@pytest.mark.parametrize("seed", [3, 2026, 2 ** 31 + 7])
@pytest.mark.parametrize("qname", QUERIES)
def test_reference_equals_the_programs_cpu_run(cpu_runner, qname, seed):
    from presto_tpu_torch.server.protocol import QueryManager

    q = spec.query(qname)
    rng_streams = traffic.streams({"streams": 2, "queries": [qname]}, {qname: q}, seed)
    db = Database(SF)
    for st in rng_streams:
        s = st[0]
        got = [QueryManager._to_json_row(r) for r in cpu_runner.execute(s.sql).rows]
        want = spec.reference(qname).run(db, s.param_dict(), EXACT)
        ok, gap = compare.compare(q, got, want)
        assert ok and gap <= compare.LIMITS["double_rel_err"], (s.params, got[:3], want[:3])
