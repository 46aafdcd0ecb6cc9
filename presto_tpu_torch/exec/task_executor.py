"""Task executor of the PyTorch port: a single-threaded round-robin.

Counterpart of ``presto_tpu/exec/task_executor.py`` with the same contract
on one thread instead of a pool: ``execute(drivers)`` runs every driver to
completion or raises the first exception a driver raises (the others are
closed and abandoned); a driver whose probe waits for its lookup source is
parked and taken up again once the source is set. The drivers come in
dependency order (join builds before their probes), so each turn runs one
driver until it blocks or finishes. Device work stays asynchronous: the
host loop syncs only where an operator reads a value.
"""
from __future__ import annotations

from typing import List, Sequence

from .driver import Driver, ProcessState


class TaskExecutor:
    def execute(self, drivers: Sequence[Driver]) -> None:
        pending: List[Driver] = list(drivers)
        try:
            while pending:
                parked = []
                finished = 0
                for d in pending:
                    if d.process() == ProcessState.FINISHED:
                        finished += 1
                    else:
                        parked.append(d)
                if parked and not finished and \
                        all(d.blocked_on() is not None for d in parked):
                    # one thread: nothing else can unblock them
                    raise RuntimeError(
                        f"{len(parked)} driver(s) blocked with no runnable driver left")
                pending = parked
        except BaseException:
            for d in pending:
                d.close()
            raise
