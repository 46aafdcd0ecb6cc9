"""Task executor of the PyTorch port: time-sliced drivers on runner threads.

Counterpart of ``presto_tpu/exec/task_executor.py``: ``execute(drivers)``
runs every driver to completion on ``n_threads`` runner threads. The ready
drivers wait in one heap ordered by the time each has consumed, so the
least-served driver runs next; a driver runs for at most one quantum per
turn (``Driver.process(quantum_ns)``). A driver that reports BLOCKED (a
probe waiting for its build, a consumer waiting for its producers, a
producer waiting for room in a full exchange) is parked with its callback
and put back on the heap once the callback says it can move. A driver is
held by one runner at a time.

Device work stays asynchronous: a runner thread syncs only where an
operator reads a value, and PyTorch releases the GIL inside its kernels and
copies, so host page assembly, uploads and device work of several drivers
overlap. With one thread (or one driver) the same scheduler runs on the
calling thread.

The first error any driver raises is recorded and raised in the caller
once every runner thread has left; the other drivers are not run further
(the caller closes them). When every unfinished driver is parked, none is
running and no callback clears, nothing can unblock them: the run stops
with an error instead of waiting forever. ``external``, when given, says
whether a party outside the run (a streaming exchange's pump) may still
unblock a parked driver; while it does, the run keeps polling.

The calling thread's flight recorder (``utils/trace.py``) is captured when
the run is made and bound in every runner thread, which records one
``driver`` span per quantum (``Driver.trace_label``, with the state the
quantum ended in).
"""
from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Callable, List, Optional, Sequence

from ..utils import trace
from .driver import Driver, ProcessState

_DEFAULT_QUANTUM_NS = 200_000_000
_POLL_S = 0.001  # how often an idle runner re-polls the parked callbacks


class TaskExecutor:
    """Run many drivers to completion on ``n_threads`` runner threads."""

    def __init__(self, n_threads: int = 4, quantum_ns: int = _DEFAULT_QUANTUM_NS):
        self.n_threads = max(1, int(n_threads))
        self.quantum_ns = quantum_ns

    def execute(self, drivers: Sequence[Driver],
                external: Optional[Callable[[], bool]] = None) -> None:
        if not drivers:
            return
        run = _Run(list(drivers), self.quantum_ns, external)
        n = min(self.n_threads, len(drivers))
        if n == 1:
            run.runner_loop()
        else:
            threads = [threading.Thread(target=run.runner_loop, name=f"task-runner-{i}",
                                        daemon=True)
                       for i in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        if run.error is not None:
            raise run.error
        if run.outstanding:
            raise RuntimeError(f"task executor finished with {run.outstanding} "
                               "unfinished drivers")


class _Run:
    """The state of one execute() call."""

    def __init__(self, drivers: List[Driver], quantum_ns: int,
                 external: Optional[Callable[[], bool]] = None):
        self.quantum_ns = quantum_ns
        self.external = external
        self.cv = threading.Condition()
        self.ready: List = []            # heap of (consumed_ns, seq, driver)
        self.blocked: List = []          # [(driver, consumed_ns, unblock callback)]
        self.outstanding = len(drivers)  # unfinished drivers
        self.running = 0                 # drivers a runner holds right now
        self.error: Optional[BaseException] = None
        self._seq = itertools.count()
        # the submitting (query) thread's recorder rides with the run, so
        # runner threads attribute their driver spans to the right query
        self.recorder = trace.active()
        for d in drivers:
            heapq.heappush(self.ready, (0, next(self._seq), d))

    def _next_driver(self):
        """Pop the least-consumed ready driver, after promoting the parked
        drivers whose callbacks cleared. None when the run is over: every
        driver finished, one raised, or the parked ones can never move."""
        with self.cv:
            while True:
                if self.error is not None or self.outstanding == 0:
                    self.cv.notify_all()
                    return None
                still = []
                for d, consumed, cb in self.blocked:
                    try:
                        unblocked = cb()
                    except BaseException as e:  # noqa: BLE001 - raised in the caller
                        self.error = e
                        self.cv.notify_all()
                        return None
                    if unblocked:
                        heapq.heappush(self.ready, (consumed, next(self._seq), d))
                    else:
                        still.append((d, consumed, cb))
                self.blocked = still
                if self.ready:
                    consumed, _, d = heapq.heappop(self.ready)
                    self.running += 1
                    return d, consumed
                if self.running == 0 and not (self.external is not None and self.external()):
                    self.error = RuntimeError(
                        f"{len(self.blocked)} driver(s) blocked with no runnable "
                        "driver left")
                    self.cv.notify_all()
                    return None
                self.cv.wait(timeout=_POLL_S)

    def runner_loop(self) -> None:
        with trace.bound(self.recorder):
            self._runner_loop()

    def _runner_loop(self) -> None:
        while True:
            nxt = self._next_driver()
            if nxt is None:
                return
            driver, consumed = nxt
            t0 = time.perf_counter_ns()
            try:
                state = driver.process(self.quantum_ns)
                cb = driver.blocked_on() if state == ProcessState.BLOCKED else None
            except BaseException as e:  # noqa: BLE001 - raised in the caller
                with self.cv:
                    self.running -= 1
                    if self.error is None:
                        self.error = e
                    self.cv.notify_all()
                return
            spent = time.perf_counter_ns() - t0
            if trace.active() is not None:
                trace.record(trace.DRIVER, driver.trace_label, t0, spent,
                             {"state": state.name})
            with self.cv:
                self.running -= 1
                if state == ProcessState.FINISHED:
                    self.outstanding -= 1
                elif state == ProcessState.BLOCKED:
                    self.blocked.append((driver, consumed + spent, cb or (lambda: True)))
                else:  # YIELDED or MADE_PROGRESS
                    heapq.heappush(self.ready, (consumed + spent, next(self._seq), driver))
                self.cv.notify_all()
