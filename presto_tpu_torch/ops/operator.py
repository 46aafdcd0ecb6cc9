"""Physical operator protocol and operator context of the PyTorch port.

Counterpart of ``presto_tpu/ops/operator.py``: the same
needs_input/add_input/get_output/is_blocked/finish protocol, with
per-operator stats (wall time, rows and pages in and out, time spent
blocked, peak accounted memory) that EXPLAIN ANALYZE prints. Operators hold
device tensors. When the planner wires the query's memory, each operator
context forks the query's user and revocable contexts: an accumulating
operator accounts its device bytes with ``update_revocable``, which revokes
them on the operator's own thread when the pressure probe fires. The
context also carries the query's disk tier (``spill``, an
``exec/spill.SpillManager`` or None), the last rung of a revocation.

``timed`` is also the flight recorder's operator tap: while a full trace is
recording, every call above ``trace.MIN_OPERATOR_SPAN_NS`` becomes an
``operator`` span ``<name>.<method>``, from the same clock read as the
stats.
"""
from __future__ import annotations

import abc
import dataclasses
import time
from typing import Callable, List, Optional

from ..block import Page
from ..memory import AggregatedMemoryContext, MemoryTrackingContext
from ..types import Type
from ..utils import trace


@dataclasses.dataclass
class OperatorStats:
    operator_id: int = 0
    name: str = ""
    add_input_calls: int = 0
    get_output_calls: int = 0
    input_rows: int = 0
    input_pages: int = 0
    output_rows: int = 0
    output_pages: int = 0
    add_input_ns: int = 0
    get_output_ns: int = 0
    finish_ns: int = 0
    # time this operator held its driver blocked (a build wait, a full
    # exchange), charged by the Driver when the parked driver runs again
    blocked_ns: int = 0
    peak_memory_bytes: int = 0

    def total_ns(self) -> int:
        return self.add_input_ns + self.get_output_ns + self.finish_ns

    def to_dict(self) -> dict:
        """JSON-safe form: what EXPLAIN ANALYZE and live progress roll up."""
        return {"operator_id": self.operator_id, "name": self.name,
                "input_rows": self.input_rows, "output_rows": self.output_rows,
                "total_ns": self.total_ns(), "blocked_ns": self.blocked_ns,
                "peak_memory_bytes": self.peak_memory_bytes,
                "input_pages": self.input_pages, "output_pages": self.output_pages}


class OperatorContext:
    def __init__(self, operator_id: int, name: str,
                 memory: Optional[MemoryTrackingContext] = None,
                 revoke_check: Optional[Callable[[], bool]] = None, spill=None,
                 worker: int = 0):
        self.stats = OperatorStats(operator_id, name)
        # the logical worker this operator runs for (the distributed runner
        # plans one factory list per fragment and creates drivers per worker)
        self.worker = worker
        self.memory = memory or MemoryTrackingContext(
            AggregatedMemoryContext(), AggregatedMemoryContext(), AggregatedMemoryContext())
        # the pressure probe: operators revoke their own state, on their own
        # thread, when it fires (no other thread touches operator state)
        self._revoke_check = revoke_check
        # the query's disk tier (exec/spill.SpillManager) or None: operators
        # that can write their host state to disk use it as the ladder's
        # last rung
        self.spill = spill
        self.user_memory = self.memory.user.new_local_memory_context(name)
        self.revocable_memory = self.memory.revocable.new_local_memory_context(name)

    def should_revoke(self) -> bool:
        return self._revoke_check is not None and self._revoke_check()

    def update_revocable(self, used: int, on_revoke: Callable[[], None]) -> None:
        """Account the operator's revocable device bytes (computed from
        shapes and dtypes, never read from the device); revoke them when
        the pool is over its target."""
        self.revocable_memory.set_bytes(used)
        self.stats.peak_memory_bytes = max(self.stats.peak_memory_bytes, used)
        if used and self.should_revoke():
            from ..utils import events
            events.emit("memory.spill", severity=events.WARN,
                        operator=self.stats.name, revocable_bytes=used)
            on_revoke()

    def release_memory(self) -> None:
        self.user_memory.close()
        self.revocable_memory.close()

    def record_input(self, page: Page, rows: int) -> None:
        self.stats.add_input_calls += 1
        self.stats.input_pages += 1
        self.stats.input_rows += rows

    def record_output(self, page: Page, rows: int) -> None:
        self.stats.output_pages += 1
        self.stats.output_rows += rows


class Operator(abc.ABC):
    """Page-at-a-time pull/push protocol.

    Lifecycle: while not finished: if needs_input and input available:
    add_input(page); out = get_output(); finish() when upstream is exhausted.
    is_blocked() returns None or a poll-able 'done?' callable."""

    def __init__(self, context: OperatorContext):
        self.context = context
        self._finishing = False

    @property
    @abc.abstractmethod
    def output_types(self) -> List[Type]:
        ...

    def needs_input(self) -> bool:
        return not self._finishing

    @abc.abstractmethod
    def add_input(self, page: Page) -> None:
        ...

    @abc.abstractmethod
    def get_output(self) -> Optional[Page]:
        ...

    def finish(self) -> None:
        self._finishing = True

    def is_finished(self) -> bool:
        return self._finishing

    def is_blocked(self) -> Optional[Callable[[], bool]]:
        return None

    def close(self) -> None:
        # a retired operator's reservations go, so the pool's pressure
        # falls as operators finish
        self.context.release_memory()

    # revocation protocol: the bytes an operator could give back, and the
    # call that gives them back
    def revocable_bytes(self) -> int:
        return 0

    def start_memory_revoke(self) -> None:
        pass


class OperatorFactory(abc.ABC):
    """One per plan node; creates the per-driver operator instances. One
    factory serves every worker of its fragment: ``worker`` selects the
    worker-scoped state (splits, lookup sources, exchange buffers).

    A factory that allocates on a device sets ``device``; the distributed
    planner sets ``devices``, and worker w's operators then work on
    ``devices[w]`` (``worker_device``)."""

    device = None
    devices: Optional[List] = None

    def __init__(self, operator_id: int, name: str):
        self.operator_id = operator_id
        self.name = name
        # wired by the local planner when the query has a memory context
        self.memory_ctx: Optional[MemoryTrackingContext] = None
        self.revoke_check: Optional[Callable[[], bool]] = None
        self.spill_manager = None  # exec/spill.SpillManager (the disk tier)

    @abc.abstractmethod
    def create_operator(self, worker: int = 0) -> Operator:
        ...

    def worker_device(self, worker: int = 0):
        """The device worker ``worker``'s operators allocate on."""
        if self.devices is not None:
            return self.devices[worker % len(self.devices)]
        return self.device

    def context(self, worker: int = 0) -> OperatorContext:
        mem = self.memory_ctx.fork() if self.memory_ctx is not None else None
        return OperatorContext(self.operator_id, self.name, memory=mem,
                               revoke_check=self.revoke_check, spill=self.spill_manager,
                               worker=worker)


def timed(stats_field: str):
    """Decorator: accumulate the wall-clock ns of an operator method into
    stats, and record it as an ``operator`` span when a trace is active."""
    method = stats_field.rsplit("_", 1)[0]  # "add_input_ns" -> "add_input"

    def deco(fn):
        def wrapper(self, *a, **kw):
            t0 = time.perf_counter_ns()
            try:
                return fn(self, *a, **kw)
            finally:
                dt = time.perf_counter_ns() - t0
                stats = self.context.stats
                setattr(stats, stats_field, getattr(stats, stats_field) + dt)
                if trace.active() is not None and dt >= trace.MIN_OPERATOR_SPAN_NS:
                    trace.record(trace.OPERATOR, f"{stats.name}.{method}", t0, dt)
        return wrapper
    return deco
