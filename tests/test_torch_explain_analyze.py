"""EXPLAIN ANALYZE of the port against the reference's, on the CPU at ``tiny``.

The port's ``LocalQueryRunner.execute("explain analyze ...")`` prints the
reference's table (``exec/explain.py``: the same header and columns): its
header line's driver and operator counts, and every operator's name, input
rows and output rows, equal the reference's. The times are left out. With
one driver per pipeline the pages, and so the row counts, are the same in
both packages; under 4 drivers the driver counts and the operators are.
"""
import re

import pytest

from presto_tpu.exec import explain as ref_explain
from presto_tpu.metadata import Session as RefSession
from presto_tpu.models.tpcds_sql import QUERIES as REF_DS
from presto_tpu.models.tpch_sql import QUERIES as REF_H
from presto_tpu.runner import LocalQueryRunner as RefRunner
from presto_tpu_torch.exec import explain
from presto_tpu_torch.metadata import Session
from presto_tpu_torch.models.tpcds_sql import QUERIES as DS
from presto_tpu_torch.models.tpch_sql import QUERIES as H
from presto_tpu_torch.runner import LocalQueryRunner

WINDOW_SQL = ("select o_orderpriority, count(*), sum(rn), max(rk) from (select "
              "o_orderpriority, row_number() over (partition by o_orderpriority "
              "order by o_orderkey) rn, rank() over (partition by o_custkey order by "
              "o_totalprice desc) rk from orders) t group by 1 order by 1")
FULL_SQL = ("select count(*), count(o_orderkey), count(c_custkey) from orders "
            "full join customer on o_custkey = c_custkey")
# (port text, reference text, schema)
CASES = {"tpch q1": (H[1], REF_H[1], "tiny"), "tpch q3": (H[3], REF_H[3], "tiny"),
         "tpch q9": (H[9], REF_H[9], "tiny"), "tpcds q3": (DS[3], REF_DS[3], "tiny"),
         "full join": (FULL_SQL, FULL_SQL, "tiny"), "window": (WINDOW_SQL, WINDOW_SQL, "tiny")}


def parse(rows):
    """(header without the wall, [(pipeline, operator, in rows, out rows)])."""
    lines = [r[0] for r in rows]
    header = re.sub(r"\d+ms wall", "ms wall", lines[0])
    assert lines[2] == explain.HEADER and lines[3] == explain.RULE
    ops, pipe = [], None
    for line in lines[4:]:
        if not line.strip():
            break
        if line.startswith("pipeline "):
            pipe = line
            continue
        parts = line.split()
        ops.append((pipe, " ".join(parts[:-5]), int(parts[-5]), int(parts[-4])))
    return header, ops


def _analyze(sql_pair, catalog, schema, props):
    port_sql, ref_sql = sql_pair
    want = RefRunner(RefSession(catalog=catalog, schema=schema, properties=dict(props))) \
        .execute("explain analyze " + ref_sql)
    got = LocalQueryRunner(Session(catalog=catalog, schema=schema, properties=dict(props)),
                           device="cpu").execute("explain analyze " + port_sql)
    assert got.column_names == want.column_names == ["Query Plan"]
    return parse(got.rows), parse(want.rows), got.rows, want.rows


def test_header_and_columns_are_the_reference_s():
    assert explain.HEADER == ref_explain.HEADER and explain.RULE == ref_explain.RULE
    stats = [{"pipeline": p, "operator_id": i, "name": n, "input_rows": 1000 * i + p,
              "output_rows": 7 * i, "total_ns": 1234567 * i, "blocked_ns": 98765 * p,
              "peak_memory_bytes": 4096 * i * (p + 1), "input_pages": i, "output_pages": p}
             for p in range(3) for i, n in enumerate(["TableScan", "JoinBuild", "x" * 40])]
    stats += stats[:4]  # repeated instances roll up
    assert explain.rollup(stats) == ref_explain.rollup(stats)
    for pipelines in (False, True):
        assert explain.table(explain.rollup(stats), indent="  ", pipelines=pipelines) == \
            ref_explain.table(ref_explain.rollup(stats), indent="  ", pipelines=pipelines)


@pytest.mark.parametrize("case", sorted(CASES))
def test_operators_rows_and_drivers_match_reference(case):
    """One driver per pipeline: the header (drivers, operators) and every
    operator's rows equal the reference's; the plan text follows the table
    in both."""
    port_sql, ref_sql, schema = CASES[case]
    catalog = "tpcds" if case.startswith("tpcds") else "tpch"
    (gh, gops), (wh, wops), got, want = _analyze((port_sql, ref_sql), catalog, schema,
                                                 {"driver_parallelism": 1})
    assert gh == wh
    assert gops == wops
    assert len(gops) == int(gh.split(" drivers, ")[1].split(" operators")[0])
    plan = LocalQueryRunner(Session(catalog=catalog, schema=schema), device="cpu") \
        .explain(port_sql).split("\n")
    assert [r[0] for r in got[-len(plan):]] == plan


@pytest.mark.parametrize("case", ["tpch q3", "tpch q9"])
def test_parallel_drivers_match_reference(case):
    """Four drivers: the same drivers, operators and operator order as the
    reference's (the cut pipelines' producers and consumer)."""
    (gh, gops), (wh, wops), _, _ = _analyze(CASES[case][:2], "tpch", "tiny",
                                            {"driver_parallelism": 4})
    assert gh == wh
    assert [(p, n) for p, n, _, _ in gops] == [(p, n) for p, n, _, _ in wops]
    # the scans read the same rows, split for split
    assert [r for r in gops if r[1] == "TableScan"] == [r for r in wops if r[1] == "TableScan"]


def _drivers(header: str) -> int:
    return int(header.split("wall, ")[1].split(" drivers")[0])


def test_parallel_driver_count_in_explain_analyze():
    """``tests/test_local_exchange.py::test_parallel_driver_count_in_explain_analyze``
    through both packages: with 4 drivers the scan's pipeline is cut into
    producers and a consumer, with 1 it is one driver."""
    sql = "select count(*) from lineitem where l_quantity < 10"
    counts = {}
    for dp in (1, 4):
        (gh, _), (wh, _), _, _ = _analyze((sql, sql), "tpch", "tiny",
                                          {"driver_parallelism": dp})
        assert _drivers(gh) == _drivers(wh)
        counts[dp] = _drivers(gh)
    assert counts[4] > 1 and counts[1] == 1


def test_blocked_time_and_peak_memory_are_reported():
    """A probe driver waits for its build: some operator reports blocked
    time, and the build and grouping report their accounted peak."""
    res = LocalQueryRunner(Session(catalog="tpch", schema="tiny"), device="cpu") \
        .execute("explain analyze " + H[3])
    rows = []
    for line in (r[0] for r in res.rows[4:]):
        if not line.strip():
            break
        if not line.startswith("pipeline "):
            rows.append(line.split())
    assert max(float(r[-1]) for r in rows if r[0] == "JoinBuild") > 0
    assert any(float(r[-2]) > 0 for r in rows), "no operator reported blocked time"
