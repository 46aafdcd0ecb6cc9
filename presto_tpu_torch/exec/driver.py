"""Driver: the operator-chain pump of the PyTorch port.

Counterpart of ``presto_tpu/exec/driver.py``: for each adjacent operator
pair, pull a page from the upstream operator and push it into the next one;
propagate finish; honour blocking. A page hand-off passes tensor handles, so
the host loop runs ahead while the device works and syncs only where an
operator must read a value (a finished build's stats, a fold's group count).
"""
from __future__ import annotations

import enum
import time
from typing import Callable, List, Optional

from ..ops.operator import Operator


class ProcessState(enum.Enum):
    MADE_PROGRESS = 1
    BLOCKED = 2
    FINISHED = 3


class Driver:
    """One pipeline instance: source operator .. sink operator."""

    def __init__(self, operators: List[Operator]):
        if not operators:
            raise ValueError("driver needs at least one operator")
        self.operators = operators
        self._closed = False

    def is_finished(self) -> bool:
        return self._closed or self.operators[-1].is_finished()

    def blocked_on(self) -> Optional[Callable[[], bool]]:
        for op in self.operators:
            b = op.is_blocked()
            if b is not None and not b():
                return b
        return None

    def process(self) -> ProcessState:
        """Run until blocked or finished."""
        while True:
            if self.is_finished():
                self._close_operators()
                return ProcessState.FINISHED
            if self.blocked_on() is not None:
                return ProcessState.BLOCKED
            progressed = self._process_once()
            if self.is_finished():
                self._close_operators()
                return ProcessState.FINISHED
            if not progressed:
                if self.blocked_on() is not None:
                    return ProcessState.BLOCKED
                # no operator moved and none is blocked: drain the finishes
                self._propagate_finish()

    def _process_once(self) -> bool:
        """One sweep over adjacent pairs."""
        ops = self.operators
        progressed = False
        for i in range(len(ops) - 1):
            cur, nxt = ops[i], ops[i + 1]
            if cur.is_finished() and not nxt.is_finished() and nxt.needs_input():
                nxt.finish()
                progressed = True
                continue
            if nxt.needs_input() and not cur.is_finished() and cur.is_blocked() is None \
                    and nxt.is_blocked() is None:
                page = cur.get_output()
                if page is not None:
                    nxt.add_input(page)
                    progressed = True
        last = ops[-1]
        if not last.is_finished() and last.is_blocked() is None:
            if last.get_output() is not None:
                progressed = True
        return progressed

    def _propagate_finish(self) -> None:
        for i in range(len(self.operators) - 1):
            cur, nxt = self.operators[i], self.operators[i + 1]
            if cur.is_finished() and not nxt.is_finished():
                nxt.finish()

    def close(self) -> None:
        """Close every operator (idempotent); an abandoned driver's teardown."""
        self._close_operators()

    def _close_operators(self) -> None:
        if not self._closed:
            for op in self.operators:
                op.close()
            self._closed = True

    def run_to_completion(self, poll_sleep_s: float = 0.001) -> None:
        """Drive until FINISHED, sleeping while the pipeline is blocked."""
        while self.process() != ProcessState.FINISHED:
            b = self.blocked_on()
            while b is not None and not b():
                time.sleep(poll_sleep_s)
