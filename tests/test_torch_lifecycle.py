"""The port's lifecycle drives (``chip_smoke.py`` phase 26) on the CPU at
``tiny``: the churn, rolling-upgrade, chaos and failure-forensics drives of
``__graft_entry__`` (``dryrun_churn``, ``dryrun_rolling_upgrade``,
``dryrun_chaos``, ``dryrun_forensics``) run through the same functions the
card runs, with ``device="cpu"``, and held against the reference's rows,
taken once from ``presto_tpu.runner.LocalQueryRunner``. Each drive raises
on a broken invariant; the tests also read its record."""
import os
import subprocess
import sys

import pytest
import torch

from presto_tpu.metadata import Session as RefSession
from presto_tpu.models.tpch_sql import QUERIES as REF_QUERIES
from presto_tpu.runner import LocalQueryRunner as RefRunner

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402 - the phase's functions live beside the repo root

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def ref():
    runner = RefRunner(session=RefSession(catalog="tpch", schema="tiny"))
    rows = {q: runner.execute(REF_QUERIES[q]).rows for q in cs.ROLLING_QUERIES}
    rows["churn"] = runner.execute(cs.CHURN_SQL).rows
    rows["chaos"] = runner.execute(cs.CHAOS_SQL).rows
    return rows


def test_rolling_upgrade_cycles_every_worker_with_the_references_rows(ref):
    rec = cs.lifecycle_rolling_upgrade(CPU, "tiny", want={q: ref[q] for q in cs.ROLLING_QUERIES}
                                       )["LIFECYCLE rolling upgrade"]
    assert rec["workers_cycled"] == cs.ROLLING_WORKERS
    assert rec["queries_failed"] == 0 and rec["queries_mismatched"] == 0
    assert rec["queries_ok"] >= 3
    assert len(rec["drain_s"]) == cs.ROLLING_WORKERS
    assert len(rec["queries"]) == rec["queries_ok"]  # every query's attempts are kept
    # a planned drain never costs a query attempt
    assert all(q in cs.ROLLING_QUERIES and attempts == 1 for q, _w, attempts, _r in rec["queries"])


def test_churn_joins_a_worker_and_drains_the_victim_mid_stream(ref):
    rec = cs.lifecycle_churn(CPU, "tiny", want=ref["churn"])["LIFECYCLE churn"]
    churn = rec["churn"]
    assert rec["clean"]["rows_match"] and churn["rows_match"]
    assert churn["query_attempts"] == 1 and churn["task_retries"] >= 1
    assert churn["drain"]["state"] == "DRAINED" and churn["drain"]["tasks_handed_off"] >= 1
    assert churn["drain"]["joiner"] != churn["drain"]["node"]
    assert isinstance(churn["spooled_bytes_peak_drain_window"], int)
    # the workers' own high-water mark: no poll has to land on the short query
    assert churn["spooled_bytes_peak"] > 0 and rec["clean"]["spooled_bytes_peak"] > 0


def test_chaos_kill_and_speculation_keep_the_references_rows(ref):
    recs = cs.lifecycle_chaos(CPU, "tiny", want=ref["chaos"])
    kill = recs["LIFECYCLE chaos mid_stream_kill"]
    assert all(rec["rows_match"] for rec in recs.values())
    assert kill["query_attempts"] == 1 and kill["task_retries"] >= 1
    assert kill["spooled_bytes_peak"] > 0
    assert recs["LIFECYCLE chaos speculation"]["task_speculations"] >= 1


def test_forensics_over_the_servers_endpoints():
    """A statement that exhausts its retries into FAILED: the forensic trace
    at ``/v1/query/{id}/trace``, the journal at ``/v1/events`` and
    ``/v1/cluster/metrics`` equal to the hand-merged oracle (the drive
    raises otherwise)."""
    rec = cs.lifecycle_forensics(CPU, "tiny")["LIFECYCLE forensics"]
    assert rec["state"] == "FAILED"
    assert rec["forensic_spans"].get("http", 0) > 0
    assert rec["retry_events"] >= 1 and rec["attempt_failures"] >= 2
    assert rec["workers_merged"] == 1 and rec["merged_hist_keys"] > 0
    assert set(rec["launches"]) == {"insert", "probe"}  # read from the counters, not set


@pytest.mark.skipif(torch.cuda.is_available(), reason="this machine has CUDA")
def test_lifecycle_walls_exits_without_cuda_unless_asked_for_the_cpu():
    out = subprocess.run([sys.executable, os.path.join(ROOT, "lifecycle_walls.py"), "--drives",
                          "", "--out", os.devnull], capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert out.returncode == 2 and "CUDA is not available" in out.stderr
    assert out.stdout == ""
