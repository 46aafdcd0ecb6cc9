"""Find the benchmark's parts by name.

``BENCHMARK.json`` at the checkout's root lists the configurations, the
cells (``workloads``) and the metrics. Everything that belongs to one of
them sits in a file of its own under ``benchmark/``, found by its name:

- a configuration: the ``file`` that ``BENCHMARK.json`` names for it;
- a cell: ``workloads/<cell>.json`` (its traffic);
- a query: ``queries/<query>.sql`` (the template), ``queries/<query>.json``
  (parameter domains, tables read, column types, sort key) and
  ``reference/<query>.py`` (its plain reference);
- a per-layer metric: ``metrics/<metric>.py``, whose ``read(run)`` returns
  the number, or None where the run holds nothing to read.

Adding a query, a cell or a metric adds files and entries; no file that is
already there changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Dict

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


class SpecError(ValueError):
    pass


def _json(path: Path) -> dict:
    try:
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    except FileNotFoundError as e:
        raise SpecError(f"missing file {path}") from e


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def cell(name: str, root: Path = ROOT) -> dict:
    """The cell's entry in BENCHMARK.json, its traffic file and its
    configuration, as one dict: ``entry``, ``traffic``, ``config``."""
    bench = benchmark(root)
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise SpecError(f"no workload named {name!r} in BENCHMARK.json")
    entry = entries[0]
    configs = [c for c in bench["configs"] if c["name"] == entry["config"]]
    if not configs:
        raise SpecError(f"workload {name!r} names an unknown config {entry['config']!r}")
    traffic = _json(root / "benchmark" / "workloads" / f"{entry['traffic']}.json")
    config = _json(root / configs[0]["file"])
    end_to_end = [m for m in bench["end_to_end"]
                  if name in m.get("workloads", [name])]
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name])]
    return {"name": name, "entry": entry, "traffic": traffic, "config": config,
            "end_to_end": end_to_end, "per_layer": per_layer}


def query(name: str, root: Path = ROOT) -> dict:
    """A query's template, its parameter file and its reference module."""
    qdir = root / "benchmark" / "queries"
    meta = _json(qdir / f"{name}.json")
    try:
        meta["sql"] = (qdir / f"{name}.sql").read_text(encoding="utf-8")
    except FileNotFoundError as e:
        raise SpecError(f"missing file {qdir / (name + '.sql')}") from e
    meta["name"] = name
    return meta


def reference(name: str):
    """The plain reference of query ``name`` (``reference/<name>.py``)."""
    if not (BENCH_DIR / "reference" / f"{name}.py").exists():
        raise SpecError(f"no reference for query {name!r}")
    return importlib.import_module(f"benchmark.reference.{name}")


def metric_reader(name: str, root: Path = ROOT):
    """``read(run)`` of the per-layer metric ``name`` (``metrics/<name>.py``)."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    if not path.exists():
        raise SpecError(f"no reader for metric {name!r} at {path}")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def queries_of(traffic: dict, root: Path = ROOT) -> Dict[str, dict]:
    return {q: query(q, root) for q in traffic["queries"]}
