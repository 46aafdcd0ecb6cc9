"""The harness on the CPU at ``tiny``: parts found by name, the result
line's keys, a new cell added as files alone, and the refusals."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.core import harness, spec, traffic

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]
# the BENCHMARK.json entries of the SF1 cell, kept out of the file (PERF.md)
SF1_MIX = json.loads((BENCH / "tests" / "sf1_mix_entries.json").read_text())


def test_parts_are_found_by_name():
    bench = spec.benchmark()
    for w in bench["workloads"]:
        c = spec.cell(w["name"])
        assert c["config"]["name"] == w["config"]
        for q in c["traffic"]["queries"]:
            meta = spec.query(q)
            assert meta["sql"] and meta["tables"] and meta["columns"]
            assert callable(spec.reference(q).run)
        assert [m["name"] for m in c["end_to_end"]] == [
            m["name"] for m in bench["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in [m["name"] for m in c["end_to_end"]] and len(c["end_to_end"]) > 1
    for m in bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))
    for c in bench["configs"]:
        assert (ROOT / c["file"]).exists()
    with pytest.raises(spec.SpecError):
        spec.cell("no_such_cell")
    with pytest.raises(spec.SpecError):
        spec.metric_reader("no_such_metric")


def test_the_same_seed_gives_the_same_statements():
    tr = json.loads((BENCH / "workloads" / "two_streams_seven_queries.json").read_text())
    qs = spec.queries_of(tr)
    a, b = traffic.streams(tr, qs, 2 ** 31 + 11), traffic.streams(tr, qs, 2 ** 31 + 11)
    assert a == b
    assert a != traffic.streams(tr, qs, 12)
    assert len(a) == 2 and all(sorted(s.query for s in st) == sorted(tr["queries"]) for st in a)
    q22 = [s for st in a for s in st if s.query == "q22"][0].param_dict()
    assert len(set(q22.values())) == 7


def _check_line(result, trace):
    assert list(result)[:5] == CONTRACT_KEYS
    assert list(result)[-1] == "checks"
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert json.loads(json.dumps(result)) == result


def test_a_run_gives_the_contracts_line():
    r = harness.run_cell("sf10_join", 41, 8.0, False, device="cpu", scale=harness.TINY)
    _check_line(r, False)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"source_rows_per_s", "queries_per_s", "latency_p90_s", "setup_s"}
    assert all(m["value"] > 0 for m in r["metrics"].values())


def test_a_traced_run_gives_the_span_metrics():
    r = harness.run_cell("sf10_join", 42, 8.0, True, device="cpu", scale=harness.TINY)
    _check_line(r, True)
    assert r["correct"] is True
    # the CPU has no device trace: only the span readers find something
    assert set(r["metrics"]) == {"served_overhead_ms", "planning_ms", "execute_ms"}


def _copy_checkout(dst: Path) -> Path:
    shutil.copytree(BENCH, dst / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    return dst


def test_a_cell_added_as_files_runs(tmp_path):
    """A new traffic file and a new BENCHMARK.json entry, no other edit."""
    root = _copy_checkout(tmp_path)
    (root / "presto_tpu_torch").symlink_to(ROOT / "presto_tpu_torch")
    (root / "benchmark" / "workloads" / "one_stream_q6.json").write_text(
        json.dumps({"streams": 1, "queries": ["q06"]}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "sf10_q6", "config": "tpch_sf10",
                               "traffic": "one_stream_q6", "chips": 1, "why": "a test cell"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, sys\nsys.path.insert(0, sys.argv[1])\n"
            "from benchmark.core import harness\n"
            "print(json.dumps(harness.run_cell('sf10_q6', 7, 1.0, False, device='cpu', "
            "scale=harness.TINY)))")
    out = subprocess.run([sys.executable, "-c", code, str(root)], capture_output=True,
                         text=True, timeout=600, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["attempted"] > 0


def test_a_config_added_as_files_runs(tmp_path):
    """A new configuration file, a new cell on it and their BENCHMARK.json
    entries, no other edit: its scale comes from its own file."""
    root = _copy_checkout(tmp_path)
    (root / "presto_tpu_torch").symlink_to(ROOT / "presto_tpu_torch")
    config = json.loads((root / "benchmark" / "configs" / "tpch_sf1.json").read_text())
    config.update(name="tpch_small", schema=harness.TINY[0], scale_factor=harness.TINY[1])
    (root / "benchmark" / "configs" / "tpch_small.json").write_text(json.dumps(config))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tpch_small", "source": "a test configuration",
                             "file": "benchmark/configs/tpch_small.json", "reduced": [],
                             "why": "a test configuration"})
    bench["workloads"].append({"name": "small_join", "config": "tpch_small",
                               "traffic": "one_stream_q3_q9", "chips": 1,
                               "why": "a test cell"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, sys\nsys.path.insert(0, sys.argv[1])\n"
            "from benchmark.core import harness\n"
            "print(json.dumps(harness.run_cell('small_join', 8, 1.0, False, device='cpu')))")
    out = subprocess.run([sys.executable, "-c", code, str(root)], capture_output=True,
                         text=True, timeout=600, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["attempted"] > 0
    # served, and compared with the reference, at the new file's scale
    assert "configuration tpch_small: schema tiny, scale factor 0.01" in out.stderr


def test_sf1_mix_comes_back_as_entries_alone(tmp_path):
    """The SF1 cell, out of BENCHMARK.json while its rates spread wider
    than a bound can hold, returns with its two entries: its configuration
    and traffic files are kept."""
    root = _copy_checkout(tmp_path)
    (root / "presto_tpu_torch").symlink_to(ROOT / "presto_tpu_torch")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(SF1_MIX["config"])
    bench["workloads"].append(SF1_MIX["workload"])
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, sys\nsys.path.insert(0, sys.argv[1])\n"
            "from benchmark.core import harness\n"
            "print(json.dumps(harness.run_cell('sf1_mix', 6, 2.0, False, device='cpu', "
            "scale=harness.TINY)))")
    out = subprocess.run([sys.executable, "-c", code, str(root)], capture_output=True,
                         text=True, timeout=600, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["attempted"] > 0
    assert set(r["metrics"]) == {"source_rows_per_s", "queries_per_s", "setup_s"}


def _run_py(cwd: Path, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "sf10_join",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_no_cuda_means_no_result():
    out = _run_py(ROOT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout == ""


def test_only_the_benchmarks_files_means_no_result(tmp_path):
    out = _run_py(_copy_checkout(tmp_path))
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "sf10_join", "--seed",
                          "5", "--seconds", "3", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    _check_line(r, False)
    assert r["correct"] is True and r["device"]["platform"] == "gpu"
