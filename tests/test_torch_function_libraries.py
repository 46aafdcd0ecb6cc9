"""The plugin function libraries of the port (``presto_tpu_torch/functions/``)
against the reference's (``presto_tpu/functions/``), on the CPU.

Every test of ``tests/test_function_libraries.py`` runs its SQL through both
packages at ``tpch.tiny`` (the ml tests over the same 500-row ``memory``
table, seeded in each package's runner) and holds the port's rows to the
reference's: exact, but for DOUBLE columns to 1e-12 relative
(``assert_same_rows``), and the learned models' coefficients to 1e-12 of
their magnitude; each test also keeps its own checks. One reference runner
and one port runner per module.
"""
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

import presto_tpu_torch  # noqa: F401 - registers the libraries
from presto_tpu.connectors.memory import MemoryConnector as RefMemoryConnector
from presto_tpu.metadata import CatalogManager as RefCatalogs
from presto_tpu.metadata import Session as RefSession
from presto_tpu.runner import LocalQueryRunner as RefRunner
from presto_tpu.sql.analyzer import SemanticError as RefSemanticError
from presto_tpu_torch.connectors.memory import MemoryConnector
from presto_tpu_torch.metadata import CatalogManager, Session
from presto_tpu_torch.runner import LocalQueryRunner
from presto_tpu_torch.sql.analyzer import SemanticError
from test_torch_sql import assert_same_rows

COEF_REL_TOL = 1e-12


@pytest.fixture(scope="module")
def runners():
    """(reference, port) runners at tpch.tiny."""
    return (RefRunner(session=RefSession(catalog="tpch", schema="tiny")),
            LocalQueryRunner(Session(catalog="tpch", schema="tiny"), device="cpu"))


def _feature_sql() -> str:
    """The CTAS of ``tests/test_function_libraries.py``'s ``_feature_table``:
    y = 3 + 2*x1 - 0.5*x2 at 4 decimals, 500 rows from seed 0."""
    rng = np.random.default_rng(0)
    n = 500
    x1 = np.round(rng.standard_normal(n), 4)
    x2 = np.round(rng.standard_normal(n), 4)
    y = np.round(3.0 + 2.0 * x1 - 0.5 * x2, 4)
    return ("create table memory.s.pts as select * from (values "
            + ", ".join(f"({float(x1[i])!r}, {float(x2[i])!r}, {float(y[i])!r})"
                        for i in range(n))
            + ") as t(x1, x2, y)")


@pytest.fixture(scope="module")
def ml_runners():
    """(reference, port) runners over a ``memory`` catalog holding the
    feature table."""
    sql = _feature_sql()
    rc = RefCatalogs()
    rc.register("memory", RefMemoryConnector("memory"))
    ref = RefRunner(session=RefSession(catalog="memory", schema="s"), catalogs=rc)
    ref.execute(sql)
    pc = CatalogManager()
    pc.register("memory", MemoryConnector("memory"))
    port = LocalQueryRunner(Session(catalog="memory", schema="s"), catalogs=pc, device="cpu")
    port.execute(sql)
    return ref, port


def both(pair, sql):
    """The port's rows, after holding them to the reference's."""
    ref, port = pair
    want = ref.execute(sql).rows
    got = port.execute(sql).rows
    assert_same_rows(got, want)
    return got


def assert_same_model(got: str, want: str):
    g, w = json.loads(got), json.loads(want)
    assert g["type"] == w["type"]
    gc = [g["intercept"]] + g["coefficients"]
    wc = [w["intercept"]] + w["coefficients"]
    scale = max(abs(v) for v in wc)
    assert len(gc) == len(wc)
    assert all(abs(a - b) <= COEF_REL_TOL * scale for a, b in zip(gc, wc)), (gc, wc)


# ------------------------------------------------------------- geospatial

def test_st_point_distance(runners):
    rows = both(runners, "select st_distance(st_point(0, 0), st_point(3, 4)), "
                         "st_x(st_point(2.5, 7)), st_y(st_point(2.5, 7))")
    assert rows == [[5.0, 2.5, 7.0]]


def test_st_contains_polygon(runners):
    rows = both(runners, "select n_nationkey, st_contains(st_geometryfromtext("
                         "'POLYGON((0 0, 10 0, 10 10, 0 10))'), "
                         "st_point(n_nationkey, n_nationkey)) inside "
                         "from nation order by n_nationkey limit 12")
    assert len(rows) == 12
    for k, inside in rows:
        assert inside == (0 <= k < 10), (k, inside)  # boundary: even-odd


def test_st_area_and_within(runners):
    rows = both(runners, "select st_area(st_geometryfromtext("
                         "'POLYGON((0 0, 4 0, 4 3, 0 3))')), "
                         "st_within(st_point(1, 1), st_geometryfromtext("
                         "'POLYGON((0 0, 2 0, 2 2, 0 2))'))")
    assert rows == [[12.0, True]]


def test_great_circle_distance(runners):
    rows = both(runners, "select great_circle_distance(51.5074, -0.1278, 48.8566, 2.3522)")
    assert abs(rows[0][0] - 343.5) < 2.0


def test_geometry_output_renders_as_wkt(runners):
    assert both(runners, "select st_point(1.5, -2)") == [["POINT (1.5 -2)"]]
    # a point column over a table, and the geometry functions over it
    both(runners, "select n_nationkey, st_point(n_nationkey, n_regionkey), "
                  "st_distance(st_point(n_nationkey, n_regionkey), st_point(0, 0)) "
                  "from nation order by n_nationkey")


def test_per_row_polygon_rejected(runners):
    ref, port = runners
    with pytest.raises(RefSemanticError):
        ref.execute("select st_geometryfromtext(n_name) from nation")
    with pytest.raises(SemanticError):
        port.execute("select st_geometryfromtext(n_name) from nation")


BAD = [
    "select st_contains(st_geometryfromtext("
    "'POLYGON((0 0, 1 0, 1 1, 0 1))'), n_name) from nation",
    "select st_geometryfromtext() from nation",
    "select st_distance(st_point(0, 0)) from nation",
    "select st_geometryfromtext('POLYGON((a b, 1 1, 2 2))')",
    "select regr_slope(n_name, n_nationkey) from nation",
    "select learn_linear_regressor(n_name, n_nationkey) from nation",
    "select index(n_name) from nation",
    "select index(n_name, 'A', 'B') from nation",
    "select char_length(n_name, n_name) from nation",
]


def test_type_and_arity_validation(runners):
    """Wrong types and arities fail at analysis in both packages, with the
    same message."""
    ref, port = runners
    for sql in BAD:
        with pytest.raises(RefSemanticError) as want:
            ref.execute(sql)
        with pytest.raises(SemanticError) as got:
            port.execute(sql)
        assert str(got.value) == str(want.value), sql


# --------------------------------------------------------------- teradata

def test_index_and_strpos(runners):
    rows = both(runners, "select n_name, index(n_name, 'AN'), strpos(n_name, 'AN') "
                         "from nation where n_nationkey < 4 order by n_nationkey")
    assert len(rows) == 4
    for name, idx, sp in rows:
        assert idx == sp == name.find("AN") + 1


def test_char2hexint(runners):
    rows = both(runners, "select char2hexint(n_name) from nation where n_name = 'CANADA'")
    assert rows == [["".join(f"{ord(c):04X}" for c in "CANADA")]]


def test_reverse_trim_char_length(runners):
    rows = both(runners, "select reverse(n_name), char_length(n_name) from nation "
                         "where n_nationkey = 3")
    assert rows == [["ADANAC", 6]]
    both(runners, "select trim(c_mktsegment), ltrim(c_mktsegment), rtrim(c_mktsegment), "
                  "character_length(c_mktsegment), count(*) from customer "
                  "group by 1, 2, 3, 4 order by 1")


# --------------------------------------------------------------------- ml

def test_regr_slope_intercept_r2(runners):
    rows = both(runners, "select regr_slope(l_extendedprice, l_quantity), "
                         "regr_intercept(l_extendedprice, l_quantity), "
                         "regr_r2(l_extendedprice, l_quantity) from lineitem")
    slope, intercept, r2 = rows[0]
    from presto_tpu_torch.connectors.tpch import generator as g
    data = g.lineitem_for_orders(0, g.TPCH_TABLES["orders"].row_count(0.01), 0.01,
                                 ["l_quantity", "l_extendedprice"])
    x = data["l_quantity"].astype(float) / 100.0   # DECIMAL scale 2
    y = data["l_extendedprice"].astype(float) / 100.0
    want_slope, want_icept = np.polyfit(x, y, 1)
    assert abs(slope - want_slope) / abs(want_slope) < 1e-6
    assert abs(intercept - want_icept) / abs(want_icept) < 1e-6
    assert 0.0 <= r2 <= 1.0


def _model(pair, sql):
    ref, port = pair
    want = ref.execute(sql).rows
    got = port.execute(sql).rows
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:-1] == w[:-1]
        assert_same_model(g[-1], w[-1])
    return got


def test_learn_linear_regressor_exact(ml_runners):
    rows = _model(ml_runners, "select learn_linear_regressor(y, x1, x2) from memory.s.pts")
    model = json.loads(rows[0][0])
    assert model["type"] == "regressor"
    assert abs(model["intercept"] - 3.0) < 1e-4
    assert abs(model["coefficients"][0] - 2.0) < 1e-4
    assert abs(model["coefficients"][1] + 0.5) < 1e-4


def test_regress_applies_model(ml_runners):
    """The mean residual is a difference of values near |y| (about 3): the
    two packages' models differ in the last bits, so the residuals are held
    to 1e-12 of the mean |y|, not of the residual itself."""
    sql = ("select avg(abs(regress(m, x1, x2) - y)), avg(abs(y)) from memory.s.pts, "
           "(select learn_linear_regressor(y, x1, x2) m from memory.s.pts)")
    ref, port = ml_runners
    (want, scale), = ref.execute(sql).rows
    (got, got_scale), = port.execute(sql).rows
    assert math.isclose(got_scale, scale, rel_tol=1e-12)  # the port averages DECIMAL exactly
    assert abs(got - want) <= 1e-12 * scale, (got, want)
    assert got < 1e-3  # y rounds to 4 decimals in the table


def test_learn_classifier_separates(ml_runners):
    rows = both(ml_runners,
                "select sum(case when classify(m, x1, x2) = "
                "(case when y > 3.0 then 1 else 0 end) then 1 else 0 end), count(*) "
                "from memory.s.pts, (select learn_classifier("
                "case when y > 3.0 then 1 else -1 end, x1, x2) m from memory.s.pts)")
    correct, total = rows[0]
    assert correct / total > 0.95


def test_learn_grouped(ml_runners):
    rows = _model(ml_runners,
                  "select g, learn_linear_regressor(y2, x1) from (select x1, "
                  "case when x2 > 0 then 1 else 0 end g, "
                  "case when x2 > 0 then 2*x1 + 1 else -3*x1 + 4 end y2 "
                  "from memory.s.pts) group by g order by g")
    assert len(rows) == 2
    m0, m1 = json.loads(rows[0][1]), json.loads(rows[1][1])
    assert abs(m0["coefficients"][0] + 3.0) < 1e-6 and abs(m0["intercept"] - 4.0) < 1e-6
    assert abs(m1["coefficients"][0] - 2.0) < 1e-6 and abs(m1["intercept"] - 1.0) < 1e-6


# ----------------------------------------------------------- registration

_REGISTRIES = """
import json
import presto_tpu, presto_tpu_torch
from presto_tpu.ops.aggregates import EXTERNAL_AGGREGATES as REF_AGGS
from presto_tpu.ops.expressions import EXTERNAL_COMPILERS as REF_COMPILERS
from presto_tpu.sql.analyzer import EXTERNAL_FUNCTIONS as REF_FUNCTIONS
from presto_tpu_torch.ops.aggregates import EXTERNAL_AGGREGATES
from presto_tpu_torch.ops.expressions import EXTERNAL_COMPILERS
from presto_tpu_torch.sql.analyzer import EXTERNAL_FUNCTIONS, PLUGIN_FUNCTIONS
print(json.dumps({name: sorted(names) for name, names in (
    ("functions", EXTERNAL_FUNCTIONS), ("ref_functions", REF_FUNCTIONS),
    ("plugin_functions", PLUGIN_FUNCTIONS), ("compilers", EXTERNAL_COMPILERS),
    ("ref_compilers", REF_COMPILERS), ("aggregates", EXTERNAL_AGGREGATES),
    ("ref_aggregates", REF_AGGS))}))
"""


def test_import_registers_the_reference_libraries():
    """``import presto_tpu_torch`` registers every function the reference's
    libraries register, and no other name. The registries are read in a
    fresh interpreter: a test that registers a plugin function in this
    process cannot reach them."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _REGISTRIES], capture_output=True,
                         text=True, timeout=300, cwd=repo,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    got = {name: set(names) for name, names in json.loads(out.stdout.splitlines()[-1]).items()}
    assert got["functions"] == got["ref_functions"] == got["plugin_functions"]
    assert got["compilers"] == got["ref_compilers"]
    assert got["aggregates"] == got["ref_aggregates"]


@pytest.mark.parametrize("name,sql", [
    ("st_point", "select st_point(1.5, -2)"),
    ("index", "select index(n_name, 'AN') from nation")])
def test_unregistered_plugin_function_refuses_naming_itself(runners, monkeypatch, name, sql):
    """Without its library registered, a plugin function raises
    NotImplementedError naming itself (the port's rule), not an unknown
    function error."""
    from presto_tpu_torch.sql import analyzer

    monkeypatch.delitem(analyzer.EXTERNAL_FUNCTIONS, name)
    with pytest.raises(NotImplementedError, match=name):
        runners[1].execute(sql)
