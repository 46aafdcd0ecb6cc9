"""UNION [ALL], INTERSECT, EXCEPT, ROLLUP, CUBE, GROUPING SETS and VALUES
through the port's SQL runner against presto_tpu's, on the CPU.

Every set operation and grouping set plans as a ``UnionNode``: each branch
drains into a page buffer in one driver, and a replay scan reads the
buffers once every branch has finished. Held against the reference at
``tpch.tiny``:

- each SQL string of ``tests/test_sql_breadth.py`` that plans a
  ``UnionNode``, and the UNION strings of ``tests/test_sql_e2e.py``: rows,
  fused segments and ``pallas.`` counter deltas under the defaults with
  ``pallas``, and unfused with ``sorted``; pipeline cuts at 4 drivers;
- a UNION of two VARCHAR columns with different dictionaries (the remap),
  a ROLLUP inside a join's build side, and ``SELECT`` without ``FROM``;
- ``DictionaryRemapOperator`` page for page against the reference's;
- ``EXCEPT ALL`` raising as the reference does.

``python tests/test_torch_sql_setops.py`` runs the sweep of the
reference's own SQL strings (``sweep``: the strings of eight test files,
through one reference runner and one port runner whose ``memory`` catalogs
hold the ``na``/``nb``/``ca`` tables those files seed) and prints one line
per string and the totals: equal, differ, refuse (the port raises
NotImplementedError) or fail in the reference. Arrays compare as
multisets. Since the plugin function libraries were ported it prints 106
equal, 0 differ, 0 refuse and 16 reference failures (a ``?`` parameter,
``EXCEPT ALL``, the libraries' ten analysis errors and four queries of a
table their test file seeds in its own runner); ``test_sweep_refuses_nothing``
runs every string through the port alone and fails on any refusal.
"""
import ast
import os
import re
import threading

import numpy as np
import pytest
import torch

from presto_tpu.exec.local_planner import LocalExecutionPlanner as RefPlanner
from presto_tpu.metadata import Session as RefSession
from presto_tpu.runner import LocalQueryRunner as RefRunner
from presto_tpu.utils.metrics import METRICS as REF_METRICS
from presto_tpu_torch.block import Block, Dictionary, Page
from presto_tpu_torch.exec.driver import ProcessState
from presto_tpu_torch.exec.local_planner import LocalExecutionPlanner, _ReplaySource
from presto_tpu_torch.metadata import Session
from presto_tpu_torch.ops.coalesce import DictionaryRemapOperatorFactory
from presto_tpu_torch.ops.scan import RESIDENT_CACHE, TableScanOperator
from presto_tpu_torch.runner import LocalQueryRunner
from presto_tpu_torch.sql.planner.plan import UnionNode
from presto_tpu_torch.types import BIGINT, VARCHAR
from presto_tpu_torch.utils.metrics import METRICS
from test_torch_sql import COUNTERS, UNFUSED, assert_same_rows
from test_torch_sql_tpch_exprs import segment_view

# the strings of tests/test_sql_breadth.py that plan a UnionNode, and the
# UNION strings of tests/test_sql_e2e.py:191-195
BREADTH_SETOPS = {
    "intersect": "select n_regionkey from nation where n_nationkey < 10 "
                 "intersect "
                 "select n_regionkey from nation where n_nationkey >= 5 "
                 "order by 1",
    "except": "select n_nationkey % 7 from nation "
              "except select n_regionkey from nation order by 1",
    "intersect_multi_column": "select n_regionkey, n_nationkey % 3 from nation "
                              "intersect select n_regionkey, n_nationkey % 2 from nation "
                              "order by 1, 2",
    "rollup": "select n_regionkey, n_nationkey % 2, count(*), sum(n_nationkey) "
              "from nation group by rollup(n_regionkey, n_nationkey % 2) "
              "order by 1, 2",
    "cube": "select n_regionkey, n_nationkey % 2, count(*) "
            "from nation group by cube(n_regionkey, n_nationkey % 2) "
            "order by 1, 2",
    "grouping_sets": "select n_regionkey, count(*) from nation "
                     "group by grouping sets ((n_regionkey), ()) order by 1",
    "grouping_marker": "select n_regionkey, grouping(n_regionkey) as g, count(*) "
                       "from nation group by rollup(n_regionkey) order by 2, 1",
    "rollup_having": "select n_regionkey, count(*) as c from nation "
                     "group by rollup(n_regionkey) having count(*) > 5 order by 1",
    "union_all": "select n_regionkey from nation union all select r_regionkey from region",
    "union_distinct": "select n_regionkey from nation union select r_regionkey from region",
}
# the port's own cases: two dictionaries merged (the second branch's codes
# remap into the union dictionary), a ROLLUP feeding a join's build side,
# and set operations over several pages (customer, orders, lineitem)
OWN_SETOPS = {
    "union_two_dictionaries": "select n_name from nation union select r_name from region "
                              "order by 1",
    "union_all_two_dictionaries": "select r_name, r_regionkey from region union all "
                                  "select n_name, n_nationkey from nation",
    "rollup_in_a_build": "select r_name, c from region join "
                         "(select n_regionkey k, count(*) c from nation "
                         "group by rollup(n_regionkey)) t on r_regionkey = k order by 1",
    "except_customers": "select c_custkey from customer except "
                        "select o_custkey from orders order by 1",
    "rollup_lineitem": "select l_returnflag, l_linestatus, count(*), sum(l_extendedprice) "
                       "from lineitem group by rollup(l_returnflag, l_linestatus) "
                       "order by 1, 2",
}
SETOPS = {**BREADTH_SETOPS, **OWN_SETOPS}
# rows are compared in order, also for the strings without ORDER BY: the
# replay keeps branch order, as the reference's does
PROPS = {"pallas_defaults": {"hash_kernels": "pallas"},
         "sorted_unfused": {"hash_kernels": "sorted", **UNFUSED}}


def _ref(sql, props):
    before = {k: REF_METRICS.counter_value(k) for k in COUNTERS}
    res = RefRunner(RefSession(catalog="tpch", schema="tiny", properties=dict(props))).execute(sql)
    delta = {k: REF_METRICS.counter_value(k) - before[k] for k in COUNTERS}
    return res.rows, segment_view((res.stats or {}).get("segments")), delta


def _port(sql, props):
    before = {k: METRICS.counter_value(k) for k in COUNTERS}
    res = LocalQueryRunner(Session(catalog="tpch", schema="tiny", properties=dict(props)),
                           device="cpu").execute(sql)
    delta = {k: METRICS.counter_value(k) - before[k] for k in COUNTERS}
    return res.rows, segment_view((res.stats or {}).get("segments")), delta


@pytest.fixture(scope="module")
def reference():
    cache = {}

    def get(name, props_id):
        key = (name, props_id)
        if key not in cache:
            cache[key] = _ref(SETOPS[name], PROPS[props_id])
        return cache[key]
    return get


def _has_union(node) -> bool:
    return isinstance(node, UnionNode) or any(_has_union(c) for c in node.children())


@pytest.mark.parametrize("name", sorted(SETOPS))
def test_each_string_plans_a_union(name):
    r = LocalQueryRunner(Session(catalog="tpch", schema="tiny"), device="cpu")
    assert _has_union(r.plan_sql(SETOPS[name]))


@pytest.mark.parametrize("props_id", sorted(PROPS))
@pytest.mark.parametrize("name", sorted(SETOPS))
def test_rows_segments_and_counters_match_reference(reference, name, props_id):
    want_rows, want_seg, want_delta = reference(name, props_id)
    rows, seg, delta = _port(SETOPS[name], PROPS[props_id])
    assert rows, "the query returned no rows"
    assert_same_rows(rows, want_rows)
    assert seg == want_seg
    assert delta == want_delta
    assert delta["pallas.join_fallbacks"] == 0


def _plan_view(pipelines):
    return [([f.name for f in p], getattr(p[0], "parallel_drivers", 1)) for p in pipelines]


@pytest.mark.parametrize("name", sorted(SETOPS))
def test_pipeline_cuts_match_reference(name):
    """At 4 drivers the branches stay single pipelines (one driver each, in
    the reference's order) and the replay scan heads its own pipeline."""
    props = {"driver_parallelism": 4, "hash_kernels": "pallas"}
    rr = RefRunner(RefSession(catalog="tpch", schema="tiny", properties=props))
    want = RefPlanner(rr.metadata, rr.session).plan(rr.plan_sql(SETOPS[name]))
    pr = LocalQueryRunner(Session(catalog="tpch", schema="tiny", properties=props), device="cpu")
    got = LocalExecutionPlanner(pr.metadata, pr.session, "cpu").plan(pr.plan_sql(SETOPS[name]))
    assert _plan_view(got.pipelines) == _plan_view(want.pipelines)
    assert got.segment_decisions == want.segment_decisions


@pytest.mark.parametrize("name", ["union_two_dictionaries", "rollup_in_a_build",
                                  "except_customers", "rollup_lineitem"])
def test_four_drivers_match_reference(reference, name):
    """4 drivers per cut pipeline: the replay scan waits for the branch
    buffers under the threaded executor, and the rows do not change."""
    want = reference(name, "pallas_defaults")[0]
    out = {}

    def run():
        out["rows"] = _port(SETOPS[name], {"hash_kernels": "pallas", "driver_parallelism": 4})[0]
    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(120)
    assert not t.is_alive(), "the union deadlocked under 4 drivers"
    assert_same_rows(out["rows"], want)


def test_remap_is_taken_and_the_union_dictionary_carried():
    """The union dictionary is r_name's 5 values, then n_name's 25: the
    region branch is its prefix and is only rebound, the nation branch's
    codes are remapped (code + 5); every output block carries the union
    dictionary."""
    r = LocalQueryRunner(Session(catalog="tpch", schema="tiny"), device="cpu")
    ep = LocalExecutionPlanner(r.metadata, r.session, "cpu").plan(
        r.plan_sql(SETOPS["union_all_two_dictionaries"]))
    remaps = [f for p in ep.pipelines for f in p if isinstance(f, DictionaryRemapOperatorFactory)]
    assert len(remaps) == 2 and remaps[0].remaps == [None, None]
    region_dict = remaps[0].target_dicts[0]
    assert list(region_dict.values[:5]) == ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
    nation = remaps[1].remaps[0]
    assert nation.dtype == torch.int32 and remaps[1].remaps[1] is None
    assert nation.tolist() == list(range(5, 30))
    rows = r.execute(SETOPS["union_all_two_dictionaries"]).rows
    assert rows[:5] == [["AFRICA", 0], ["AMERICA", 1], ["ASIA", 2], ["EUROPE", 3],
                        ["MIDDLE EAST", 4]]
    assert len(rows) == 30 and rows[5] == ["ALGERIA", 0]


def test_distinct_virtual_dictionaries_raise_as_in_the_reference():
    sql = "select c_name from customer union all select s_name from supplier"
    with pytest.raises(NotImplementedError, match="VIRTUAL dictionaries") as ref_err:
        RefRunner(RefSession(catalog="tpch", schema="tiny")).execute(sql)
    with pytest.raises(NotImplementedError, match="VIRTUAL dictionaries") as port_err:
        LocalQueryRunner(Session(catalog="tpch", schema="tiny"), device="cpu").execute(sql)
    assert str(port_err.value) == str(ref_err.value)


def test_replay_scan_parks_until_branches_finish_and_is_never_cached():
    """The replay scan's driver reports BLOCKED until every branch buffer has
    finished; its source has no cache token, so nothing of the union
    enters the resident cache."""
    RESIDENT_CACHE.clear()
    r = LocalQueryRunner(Session(catalog="tpch", schema="tiny",
                                 properties={"scan_pipeline": False}), device="cpu")
    ep = LocalExecutionPlanner(r.metadata, r.session, "cpu").plan(
        r.plan_sql(SETOPS["union_all"]))
    drivers = ep.create_drivers()
    replay = [d for d in drivers if isinstance(d.operators[0], TableScanOperator)
              and isinstance(d.operators[0].source, _ReplaySource)]
    assert len(replay) == 1
    assert replay[0].operators[0].source.cache_token is None
    assert replay[0].process() == ProcessState.BLOCKED
    for d in drivers:
        if d is not replay[0]:
            d.run_to_completion()
    assert replay[0].blocked_on() is None
    replay[0].run_to_completion()
    rows = ep.sink.rows()
    assert len(rows) == 30
    tokens = list(RESIDENT_CACHE._pages)
    assert len(tokens) == 2 and all(t[0][0] == "concat" for t in tokens)
    RESIDENT_CACHE.clear()


# ------------------------------------------------ DictionaryRemapOperator

def test_dictionary_remap_matches_reference_page_for_page():
    import jax.numpy as jnp
    from presto_tpu.block import Block as RefBlock
    from presto_tpu.block import Dictionary as RefDictionary
    from presto_tpu.block import Page as RefPage
    from presto_tpu.ops.coalesce import DictionaryRemapOperatorFactory as RefRemapFactory

    rng = np.random.default_rng(7)
    cap = 64
    codes = rng.integers(0, 5, cap).astype(np.int32)
    nulls = rng.random(cap) < 0.2
    keys = rng.integers(0, 1000, cap).astype(np.int64)
    mask = rng.random(cap) < 0.8
    remap = np.asarray([3, 0, 4, 1, 2], dtype=np.int32)
    union = ["a", "b", "c", "d", "e"]
    tgt, ref_tgt = Dictionary(union), RefDictionary(union)
    ref_op = RefRemapFactory(0, [VARCHAR, BIGINT], [remap, None],
                             target_dicts=[ref_tgt, None]).create_operator()
    ref_op.add_input(RefPage((RefBlock(VARCHAR, jnp.asarray(codes), jnp.asarray(nulls),
                                       RefDictionary(list("dbeac"))),
                              RefBlock(BIGINT, jnp.asarray(keys), None, None)),
                             jnp.asarray(mask)))
    want = ref_op.get_output()
    op = DictionaryRemapOperatorFactory(0, [VARCHAR, BIGINT], [remap, None],
                                        target_dicts=[tgt, None], device="cpu").create_operator()
    op.add_input(Page((Block(VARCHAR, torch.from_numpy(codes), torch.from_numpy(nulls),
                             Dictionary(list("dbeac"))),
                       Block(BIGINT, torch.from_numpy(keys), None, None)),
                      torch.from_numpy(mask)))
    got = op.get_output()
    np.testing.assert_array_equal(got.blocks[0].data.numpy(), np.asarray(want.blocks[0].data))
    assert got.blocks[0].data.dtype == torch.int32
    np.testing.assert_array_equal(got.blocks[0].nulls.numpy(), np.asarray(want.blocks[0].nulls))
    np.testing.assert_array_equal(got.blocks[1].data.numpy(), np.asarray(want.blocks[1].data))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert got.blocks[0].dictionary is tgt and got.blocks[1].dictionary is None
    assert got.to_pylists() == want.to_pylists()


def test_dictionary_remap_rebinds_a_dictionary_less_block():
    """A grouping set's NULL branch carries no dictionary: the block is
    rebound to the union dictionary, its codes untouched."""
    tgt = Dictionary(["x", "y"])
    op = DictionaryRemapOperatorFactory(0, [VARCHAR], [None], target_dicts=[tgt],
                                        device="cpu") \
        .create_operator()
    data = torch.zeros(4, dtype=torch.int32)
    op.add_input(Page((Block(VARCHAR, data, torch.ones(4, dtype=torch.bool), None),),
                      torch.ones(4, dtype=torch.bool)))
    out = op.get_output()
    assert out.blocks[0].dictionary is tgt and out.blocks[0].data is data
    op.finish()
    assert op.is_finished()


# ---------------------------------------------------- VALUES, EXCEPT ALL

VALUES_SQL = ["select 1, 'a'",
              "select 1 + 2 as x, 'hello' as s",
              "select cast(null as bigint), 'b' union all select 7, 'a' order by 2",
              "select 3 except select 4"]


@pytest.mark.parametrize("sql", VALUES_SQL)
def test_select_without_from_matches_reference(sql):
    want = RefRunner(RefSession(catalog="tpch", schema="tiny")).execute(sql).rows
    got = LocalQueryRunner(Session(catalog="tpch", schema="tiny"), device="cpu").execute(sql).rows
    assert_same_rows(got, want)


def test_except_all_raises_as_in_the_reference():
    with pytest.raises(Exception, match="EXCEPT ALL") as ref_err:
        RefRunner(RefSession(catalog="tpch", schema="tiny")).execute("select 1 except all select 2")
    with pytest.raises(Exception, match="EXCEPT ALL") as port_err:
        LocalQueryRunner(Session(catalog="tpch", schema="tiny"), device="cpu") \
            .execute("select 1 except all select 2")
    assert type(port_err.value).__name__ == type(ref_err.value).__name__
    assert str(port_err.value) == str(ref_err.value)


# ------------------------------------------------------------------ sweep

SWEEP_FILES = ("test_sql_e2e.py", "test_sql_breadth.py", "test_null_semantics.py",
               "test_tpch_queries.py", "test_functions.py", "test_collect_agg.py",
               "test_unnest.py", "test_function_libraries.py")


def sweep_strings():
    """Every string literal of the reference's SQL test files that starts
    with SELECT or WITH, in file order, without repeats."""
    here = os.path.dirname(os.path.abspath(__file__))
    out = []
    for name in SWEEP_FILES:
        with open(os.path.join(here, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                text = node.value.strip()
                if text.lower().startswith(("select", "with")) and text not in out:
                    out.append(text)
    return out


def seed_sweep_tables(runner):
    """The tables the swept files seed through the ``memory`` catalog:
    ``tests/test_null_semantics.py``'s ``na``/``nb`` and
    ``tests/test_collect_agg.py``'s ``ca``, by CTAS of an empty two-BIGINT
    table and INSERT VALUES that may carry NULLs, as those files do."""
    runner.execute("create table memory.default.sweep_seed as "
                   "select o_orderkey as k, o_custkey as v from tpch.tiny.orders limit 0")
    rows = {"na": [(1, 10), (2, None), (3, 10), (4, None), (5, 20), (6, None), (7, None)],
            "nb": [(1, 10), (2, None), (3, 30)],
            "ca": [(1, 10), (1, None), (2, None), (2, None)]}
    for name, vals in rows.items():
        runner.execute(f"create table memory.default.{name} as "
                       "select * from memory.default.sweep_seed")
        for k, v in vals:
            runner.execute(f"insert into memory.default.{name} values "
                           f"({k}, {'null' if v is None else v})")
    return runner


def sweep_runners():
    """One seeded reference runner and one seeded port runner (default
    sessions at ``tpch.tiny``)."""
    return (seed_sweep_tables(RefRunner(RefSession(catalog="tpch", schema="tiny"))),
            seed_sweep_tables(LocalQueryRunner(Session(catalog="tpch", schema="tiny"),
                                               device="cpu")))


def sweep_sql(sql: str) -> str:
    """``tests/test_null_semantics.py`` names its tables ``na``/``nb`` and
    qualifies them when it runs them (its ``check``); the sweep does too."""
    if re.search(r"\bfrom na\b", sql.lower()):
        return re.sub(r"\bn([ab])\b", r"memory.default.n\1", sql)
    return sql


def canon_rows(rows):
    """Rows with every array as a multiset: element order inside an array is
    engine-defined."""
    return [[("array", sorted(map(repr, v))) if isinstance(v, list) else v for v in r]
            for r in rows]


def sweep():
    """(string, outcome, detail) per string: ``equal``, ``differ``,
    ``refuse`` (the port raises NotImplementedError) or ``reference fails``
    (the reference raises at tpch.tiny). Default sessions, seeded runners."""
    ref, port = sweep_runners()
    results = []
    for sql in sweep_strings():
        try:
            want = canon_rows(ref.execute(sweep_sql(sql)).rows)
        except Exception as e:  # noqa: BLE001 - recorded as the outcome
            results.append((sql, "reference fails", f"{type(e).__name__}: {e}"))
            continue
        try:
            got = canon_rows(port.execute(sweep_sql(sql)).rows)
        except NotImplementedError as e:
            results.append((sql, "refuse", str(e)))
            continue
        try:
            assert_same_rows(got, want)
            results.append((sql, "equal", ""))
        except AssertionError:
            try:  # no ORDER BY: the same rows in another order
                assert_same_rows(sorted(got, key=repr), sorted(want, key=repr))
                results.append((sql, "equal", "unordered"))
            except AssertionError as e:
                results.append((sql, "differ", str(e)[:200]))
    return results


# every sweep string but the 16 below runs (and equals the reference)
SWEEP_RAN = 106
# the sweep strings that fail in the reference itself at tpch.tiny (and so
# in the port): a ``?`` parameter, EXCEPT ALL, the plugin libraries' table
# that ``tests/test_function_libraries.py`` seeds in its own runner
SWEEP_REFERENCE_FAILURES = re.compile(r"= \?|except all|from memory\.s\.pts")
SWEEP_FAILED = 16


def _analysis_errors():
    """The plugin libraries' strings that both packages refuse at analysis
    (wrong types and arities, a per-row polygon)."""
    from test_torch_function_libraries import BAD

    return set(BAD) | {"select st_geometryfromtext(n_name) from nation"}


def test_sweep_refuses_nothing():
    """Every sweep string runs through the seeded port runner on the CPU
    without a NotImplementedError: SWEEP_RAN run, and the SWEEP_FAILED that
    fail in the reference fail in the port's front end. The rows are held
    against the reference by ``sweep`` and by each operator's own test
    file."""
    port = sweep_runners()[1]
    ran, failed, refused = [], [], []
    for sql in sweep_strings():
        try:
            port.execute(sweep_sql(sql))
            ran.append(sql)
        except NotImplementedError as e:
            refused.append((sql, str(e)))
        except Exception:  # noqa: BLE001 - a front-end error, checked below
            failed.append(sql)
    assert refused == []
    assert len(ran) == SWEEP_RAN and len(failed) == SWEEP_FAILED
    assert all(SWEEP_REFERENCE_FAILURES.search(sql.lower()) or sql in _analysis_errors()
               for sql in failed)


if __name__ == "__main__":
    import collections

    res = sweep()
    for sql, outcome, detail in res:
        print(f"{outcome:16s} {' '.join(sql.split())[:90]!r} {detail[:120]}")
    print(dict(collections.Counter(o for _, o, _ in res)), "of", len(res))
