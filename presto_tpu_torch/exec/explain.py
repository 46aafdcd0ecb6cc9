"""EXPLAIN ANALYZE rendering of the PyTorch port (``presto_tpu/exec/explain.py``):
one operator-stats table with the reference's header and columns.

``driver_stats`` flattens the drivers' ``OperatorStats`` into dicts (each
tagged with its driver's index as its pipeline), ``rollup`` sums them
across instances of one operator (peak memory takes the maximum),
``format_rows`` and ``table`` print them. Live progress
(``exec/progress.py``) reads the same roll-up while a query runs.
"""
from __future__ import annotations

from typing import Dict, List, Optional

HEADER = (f"{'Operator':<28}{'In rows':>10}{'Out rows':>10}"
          f"{'Wall ms':>9}{'Blk ms':>9}{'Peak MB':>9}")
RULE = "-" * len(HEADER)

_SUM_FIELDS = ("input_rows", "output_rows", "total_ns", "blocked_ns",
               "input_pages", "output_pages")


def driver_stats(drivers) -> List[dict]:
    """Every operator of every driver as a stat dict, the driver's index as
    its ``pipeline``."""
    out: List[dict] = []
    for di, d in enumerate(drivers):
        for op in d.operators:
            s = op.context.stats.to_dict()
            s["pipeline"] = di
            out.append(s)
    return out


def rollup(stat_dicts: List[dict]) -> List[dict]:
    """Stats summed per (pipeline, operator_id, name), in first-seen order;
    ``peak_memory_bytes`` takes the maximum and ``instances`` counts them."""
    agg: Dict[tuple, dict] = {}
    order: List[tuple] = []
    for s in stat_dicts:
        key = (s.get("pipeline", 0), s.get("operator_id", 0), s.get("name"))
        cur = agg.get(key)
        if cur is None:
            cur = agg[key] = dict(s)
            cur["instances"] = 1
            order.append(key)
        else:
            for f in _SUM_FIELDS:
                cur[f] = cur.get(f, 0) + s.get(f, 0)
            cur["peak_memory_bytes"] = max(cur.get("peak_memory_bytes", 0),
                                           s.get("peak_memory_bytes", 0))
            cur["instances"] += 1
    return [agg[k] for k in order]


def format_rows(stat_dicts: List[dict], indent: str = "  ") -> List[str]:
    """One line per stat dict: rows in and out, wall, blocked, peak."""
    lines = []
    for s in stat_dicts:
        name = str(s.get("name", "?"))[:26]
        lines.append(
            f"{indent}{name:<26}{s.get('input_rows', 0):>10}"
            f"{s.get('output_rows', 0):>10}"
            f"{s.get('total_ns', 0) / 1e6:>9.1f}"
            f"{s.get('blocked_ns', 0) / 1e6:>9.1f}"
            f"{s.get('peak_memory_bytes', 0) / 1e6:>9.2f}")
    return lines


def table(stat_dicts: List[dict], indent: str = "", pipelines: bool = False) -> List[str]:
    """Header and rows; with ``pipelines`` the rows group under their
    pipeline tag."""
    lines = [f"{indent}{HEADER}", f"{indent}{RULE}"]
    if not pipelines:
        return lines + format_rows(stat_dicts, indent + "  ")
    current: Optional[int] = None
    for s in stat_dicts:
        p = s.get("pipeline", 0)
        if p != current:
            current = p
            lines.append(f"{indent}pipeline {p}:")
        lines += format_rows([s], indent + "  ")
    return lines
