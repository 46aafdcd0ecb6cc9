"""The port's compile sanitizer (presto_tpu_torch/utils/compilesan.py), case
for case against tests/test_compilesan.py, on the CPU.

Unit tests drive the census directly (pow2 bucketing, the compile-storm
verdict, budget overrides, the dump); the install tests wrap the port's
real composition funnel, ``utils/kernel_cache.get_or_build``; the
reconciliation test holds the sanitizer's family totals to the engine's
own counters (fused-segment compositions, kernel-cache misses) on a
distributed Q3 at ``tiny`` on four logical CPU workers and on a local Q3,
with rows equal to the sanitizer-off run and the reference's runner.
"""
import json

import pytest
import torch

from presto_tpu.metadata import Session as RefSession
from presto_tpu.models.tpch_sql import QUERIES as REF_QUERIES
from presto_tpu.runner import LocalQueryRunner as RefRunner
from presto_tpu_torch.utils import compilesan, kernel_cache
from presto_tpu_torch.utils.compilesan import SANITIZER, pow2_bucket
from presto_tpu_torch.utils.metrics import METRICS
from test_torch_sql import assert_same_rows


@pytest.fixture(autouse=True)
def _clean_sanitizer():
    """A fresh census per test; the funnel is left as the environment had
    it (a leaked install would tax every later test's compositions)."""
    env_installed = compilesan.enabled()
    prior = SANITIZER.findings()
    SANITIZER.reset()
    yield
    compilesan.uninstall()
    SANITIZER.reset()
    SANITIZER.absorb(prior)
    if env_installed:
        compilesan.install()


def _note(key):
    SANITIZER.note_build(key)


def _feed(key):
    """Two helper frames between test and note_build, so every build of a
    test is charged to one stable site (the `_note` call above)."""
    _note(key)


def _only_site():
    sites = SANITIZER.site_stats()
    assert len(sites) == 1, sites
    return next(iter(sites))


# ------------------------------------------------------------- canonical form

def test_pow2_bucket():
    assert [pow2_bucket(n) for n in (0, 1, 2, 3, 64, 100, 1 << 20)] == \
        [0, 1, 2, 4, 64, 128, 1 << 20]


def test_canonical_buckets_only_shape_scale_ints():
    # small discrete domains stay as they are; shape-scale ints go to
    # their pow2 bucket, recursively
    assert compilesan._canonical(("k", 3, 100, (65, True))) == ("k", 3, 128, (128, True))
    # bool is not bucketed, and an unhashable falls back to repr
    assert compilesan._canonical((True, [1, 2])) == (True, "[1, 2]")


# ------------------------------------------------------------- storm verdict

def test_storm_when_one_signature_absorbs_data_tracking_keys():
    for n in (100, 101, 102):        # three row counts in one pow2 bucket
        _feed(("kern", n))
    findings = SANITIZER.findings()
    assert len(findings) == 1, findings
    f = findings[0]
    assert f["kind"] == "compile-storm"
    assert "3 distinct 'kern' kernels" in f["message"]
    assert f["site"].startswith("tests/test_torch_compilesan.py:")


def test_no_storm_for_distinct_discrete_domains():
    for n in (1, 2, 3):              # three channel indices: three kernels
        _feed(("kern", n))
    for n in (128, 256, 512):        # three pow2 capacities: three shapes
        _feed(("cap", n))
    assert SANITIZER.findings() == []
    assert SANITIZER.total_builds() == 6


def test_two_keys_sharing_a_bucket_is_not_yet_a_storm():
    for n in (100, 120):
        _feed(("kern", n))
    SANITIZER.check_exit()
    assert SANITIZER.findings() == []


def test_budget_extra_raises_one_site_above_the_bucket_default():
    for n in (100, 101):
        _feed(("kern", n))
    SANITIZER.set_budget_extra(_only_site(), 2)
    _feed(("kern", 102))  # keys 3, budget 1 + 2: not exceeded
    SANITIZER.check_exit()
    assert SANITIZER.findings() == []
    _feed(("kern", 103))  # keys 4 > 3, and 4 under one signature: a storm
    assert len(SANITIZER.findings()) == 1


def test_rebuild_of_the_same_key_is_not_a_distinct_key():
    for _ in range(5):
        _feed(("kern", 128))
    stats = SANITIZER.site_stats()[_only_site()]
    assert stats["builds"] == 5 and stats["distinct_keys"] == 1
    assert SANITIZER.findings() == []


def test_dump_shape_and_absorb(tmp_path):
    for n in (100, 101, 102):
        _feed(("kern", n))
    path = SANITIZER.dump(str(tmp_path / "dump.json"))
    with open(path) as f:
        doc = json.load(f)
    assert doc["total_builds"] == 3
    assert doc["families"] == {"fused-segment": 0, "other": 3}
    (site,) = doc["sites"]
    assert site["distinct_keys"] == 3 and site["budget"] == 1
    assert len(doc["findings"]) == 1
    kept = SANITIZER.findings()
    SANITIZER.reset()
    assert SANITIZER.findings() == []
    SANITIZER.absorb(kept)
    assert SANITIZER.findings() == kept


# ---------------------------------------------------------------- the funnel

def test_install_observes_builds_not_hits():
    compilesan.install()
    key = ("compilesan-test", 128)
    kernel_cache.get_or_build(key, lambda: "kernel")
    kernel_cache.get_or_install(key, lambda: "kernel")  # a hit: not charged
    assert SANITIZER.total_builds() == 1
    stats = SANITIZER.site_stats()
    (site,) = stats
    # the funnel's own frame is elided: the site is this test
    assert site.startswith("tests/test_torch_compilesan.py:"), stats
    assert stats[site]["prefix"] == "compilesan-test"
    gauges = METRICS.snapshot("compilesan")
    assert gauges["compilesan.builds"] == 1
    assert gauges["compilesan.storm_sites"] == 0


def test_per_page_key_through_the_funnel_is_a_storm():
    """A row count in a composition key composes anew per page: three
    pages of one pow2 shape through the real funnel are a storm."""
    compilesan.install()
    for rows in (1000, 1001, 1002):
        kernel_cache.get_or_install(("fused-segment", "cpu", rows), lambda: "fn")
    (f,) = SANITIZER.findings()
    assert f["kind"] == "compile-storm" and "'fused-segment'" in f["message"]
    assert SANITIZER.family_totals() == {"fused-segment": 3, "other": 0}


def test_uninstall_restores_the_raw_funnel():
    compilesan.install()
    wrapped = kernel_cache.get_or_build
    compilesan.uninstall()
    assert kernel_cache.get_or_build is not wrapped
    assert kernel_cache.get_or_build.__module__ == "presto_tpu_torch.utils.kernel_cache"
    kernel_cache.get_or_build(("compilesan-test", 256), lambda: "kernel")
    assert SANITIZER.total_builds() == 0
    assert not compilesan.enabled()


def test_install_from_env(monkeypatch):
    monkeypatch.setenv("PRESTO_TPU_TORCH_COMPILESAN", "0")
    # the reference's variable arms only the reference's sanitizer
    monkeypatch.setenv("PRESTO_TPU_COMPILESAN", "1")
    compilesan.uninstall()
    assert not compilesan.install_from_env()
    assert not compilesan.enabled()
    monkeypatch.setenv("PRESTO_TPU_TORCH_COMPILESAN", "1")
    assert compilesan.install_from_env()
    assert compilesan.enabled()


# ----------------------------------------------------- counter reconciliation

def test_compile_reconciliation_distributed_q3():
    """The family totals equal the engine's own counters on a cold
    distributed Q3 (four logical CPU workers) and on a local Q3, with rows
    equal to the sanitizer-off run and to the reference's runner."""
    from presto_tpu_torch.metadata import Session
    from presto_tpu_torch.models.tpch_sql import QUERIES
    from presto_tpu_torch.parallel.mesh import MeshContext
    from presto_tpu_torch.parallel.runner import DistributedQueryRunner
    from presto_tpu_torch.runner import LocalQueryRunner

    session = Session(catalog="tpch", schema="tiny")

    def run_q3():
        return DistributedQueryRunner(MeshContext([torch.device("cpu")] * 4),
                                      session=session, device="cpu").execute(QUERIES[3])

    off = run_q3()   # sanitizer off: the oracle rows
    ref = RefRunner(RefSession(catalog="tpch", schema="tiny")).execute(REF_QUERIES[3]).rows
    assert_same_rows(off.rows, ref)

    compilesan.install()
    SANITIZER.reset()
    kernel_cache.clear()   # real builds inside the sanitized window
    misses0 = METRICS.counter_value("kernel_cache.misses")
    seg0 = METRICS.counter_value("segments.compiles")
    on = run_q3()
    assert_same_rows(on.rows, off.rows)
    fam = SANITIZER.family_totals()
    total = SANITIZER.total_builds()
    assert total > 0, "the cold run composed nothing: the funnel is not observed"
    assert total == METRICS.counter_value("kernel_cache.misses") - misses0
    assert fam["fused-segment"] == METRICS.counter_value("segments.compiles") - seg0
    SANITIZER.assert_clean()

    SANITIZER.reset()
    kernel_cache.clear()
    lr = LocalQueryRunner(session, device="cpu").execute(QUERIES[3])
    seg_stats = (lr.stats or {}).get("segments") or {"compiles": 0}
    assert SANITIZER.family_totals()["fused-segment"] == seg_stats["compiles"] > 0
    assert_same_rows(lr.rows, ref)
    SANITIZER.assert_clean()
