"""Counter registry of the PyTorch port.

Counterpart of the counter half of ``presto_tpu/utils/metrics.py``. The join
build counts ``pallas.join_builds`` when it builds an open-addressing table
and ``pallas.join_fallbacks`` when it falls back to the sorted build, under
the same names as the reference. The expanding probe counts the rows it
expands (``join.expanded_rows``) and the pages it emits them in
(``join.expansion_chunks``), and the filtered semi probe the pages it
takes (``join.semi_pages``) and the chunks of candidate pairs it checks
(``join.semi_chunks``); the reference has no such counters. Fused
segments count their calls (``segments.dispatches``) and compositions
(``segments.compiles``) under the reference's names; page coalescing counts
the pages it takes and emits (``coalesce.pages_in``, ``coalesce.pages_out``),
which the reference does not count.
"""
from __future__ import annotations

import threading
from typing import Dict


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}

    def count(self, name: str, delta: float = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + delta

    def counter_value(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0)

    def snapshot(self, prefix: str = "") -> Dict[str, float]:
        with self._lock:
            return {k: v for k, v in self._counters.items() if k.startswith(prefix)}


METRICS = MetricsRegistry()
