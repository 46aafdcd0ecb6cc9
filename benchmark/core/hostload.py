"""What the serving process did over the window, for the run's log.

Every cell here is paced by host work in one interpreter, so each run logs
(standard error) what could spread its numbers: the process's CPU seconds,
its threads, and the garbage collector's collections and pauses, a pause
holding every thread. None of it is a metric; it reads the same with
``--trace`` 0 or 1.
"""
from __future__ import annotations

import gc
import resource
import threading
import time
from typing import Dict


class HostLoad:
    """Counters taken at ``start`` and read as differences by ``stop``."""

    def __init__(self):
        self._gc_t0: Dict[int, float] = {}
        self.gc_pause_s = 0.0
        self.gc_longest_s = 0.0

    def _on_gc(self, phase: str, info: dict) -> None:
        ident = threading.get_ident()
        if phase == "start":
            self._gc_t0[ident] = time.perf_counter()
        elif ident in self._gc_t0:
            d = time.perf_counter() - self._gc_t0.pop(ident)
            self.gc_pause_s += d
            self.gc_longest_s = max(self.gc_longest_s, d)

    def start(self) -> None:
        self._t0 = time.perf_counter()
        self._ru0 = resource.getrusage(resource.RUSAGE_SELF)
        self._gc0 = [s["collections"] for s in gc.get_stats()]
        gc.callbacks.append(self._on_gc)

    def stop(self) -> Dict[str, float]:
        if self._on_gc in gc.callbacks:
            gc.callbacks.remove(self._on_gc)
        ru = resource.getrusage(resource.RUSAGE_SELF)
        out = {"wall_s": time.perf_counter() - self._t0,
               "threads": threading.active_count(),
               "process_user_s": ru.ru_utime - self._ru0.ru_utime,
               "process_sys_s": ru.ru_stime - self._ru0.ru_stime,
               "gc_pause_s": self.gc_pause_s, "gc_longest_s": self.gc_longest_s}
        for gen, (s, c0) in enumerate(zip(gc.get_stats(), self._gc0)):
            out[f"gc_gen{gen}"] = s["collections"] - c0
        return out
