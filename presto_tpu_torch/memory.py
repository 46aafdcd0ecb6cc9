"""Memory accounting of the PyTorch port (``presto_tpu/memory.py``).

Advisory accounting, as in the reference, not an allocator: on the card
torch's caching allocator owns the memory. Operator-local contexts
aggregate into the query's user, revocable and system contexts, which
reserve in a pool: the process-wide GENERAL pool (``shared_general_pool``),
with one ledger per query. When the pool, or the query against its
session's budget, is over the revoke target, an operator revokes its
revocable state on its own thread, walking the reference's ladder: device
-> host RAM -> disk. A join build moves its device pages to host RAM, a
grouping spills its folds, a window offloads its pages; when the query has
a disk tier (``spill_to_disk``, ``exec/spill.py``), the join build's host
pages and the grouping's host partials go on to PCOL runs on disk. Disk
bytes are charged to the pool's spill ledger (``reserve_spill``,
``spill_bytes``, ``spill_by_query``, ``spilled_bytes``), which
``reserved_bytes()`` leaves out: spilling to disk relieves the pressure
instead of moving it to another ledger.
``QueryContextMemory`` raises ``ExceededMemoryLimitException`` when a
query's user memory passes ``query_max_memory_bytes``, journaling
``query.memory_exceeded`` first. ``MemoryRevoker`` is the revoking
scheduler for single-threaded callers.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional


class ExceededMemoryLimitException(RuntimeError):
    def __init__(self, what: str, limit: int):
        super().__init__(f"Query exceeded {what} memory limit of {limit} bytes")


class LocalMemoryContext:
    """Leaf context owned by one operator."""

    def __init__(self, parent: "AggregatedMemoryContext", tag: str = ""):
        self._parent = parent
        self._bytes = 0
        self.tag = tag

    def set_bytes(self, new_bytes: int) -> None:
        delta = new_bytes - self._bytes
        if delta:
            self._parent._update(delta)
            self._bytes = new_bytes

    def get_bytes(self) -> int:
        return self._bytes

    def close(self) -> None:
        self.set_bytes(0)


class AggregatedMemoryContext:
    """Interior node summing its children; the query's roots pass every
    change to a reservation handler."""

    def __init__(self, parent: Optional["AggregatedMemoryContext"] = None,
                 reservation_handler: Optional[Callable[[int, int], None]] = None):
        self._parent = parent
        self._bytes = 0
        self._handler = reservation_handler
        self._lock = threading.Lock()

    def _update(self, delta: int) -> None:
        with self._lock:
            self._bytes += delta
        if self._handler is not None:
            self._handler(delta, self._bytes)
        if self._parent is not None:
            self._parent._update(delta)

    def get_bytes(self) -> int:
        return self._bytes

    def new_local_memory_context(self, tag: str = "") -> LocalMemoryContext:
        return LocalMemoryContext(self, tag)

    def new_aggregated_memory_context(self) -> "AggregatedMemoryContext":
        return AggregatedMemoryContext(self)


class MemoryTrackingContext:
    """The user, revocable and system contexts an operator context carries."""

    def __init__(self, user: AggregatedMemoryContext, revocable: AggregatedMemoryContext,
                 system: AggregatedMemoryContext):
        self.user = user
        self.revocable = revocable
        self.system = system

    def fork(self) -> "MemoryTrackingContext":
        return MemoryTrackingContext(self.user.new_aggregated_memory_context(),
                                     self.revocable.new_aggregated_memory_context(),
                                     self.system.new_aggregated_memory_context())

    def total_bytes(self) -> int:
        return self.user.get_bytes() + self.revocable.get_bytes() + self.system.get_bytes()


class MemoryPool:
    """A pool with per-query reserved and revocable ledgers. ``reserve``
    blocks nothing: going over marks the pool over target, and the
    operators' pressure probe revokes."""

    def __init__(self, pool_id: str, max_bytes: int):
        self.id = pool_id
        self.max_bytes = max_bytes
        self._reserved: Dict[str, int] = {}   # query id -> bytes
        self._revocable: Dict[str, int] = {}
        # bytes each query holds in on-disk runs; not RAM, so outside
        # reserved_bytes() and query_bytes()
        self._spill: Dict[str, int] = {}
        self._lock = threading.Lock()

    def reserve(self, query_id: str, delta: int, revocable: bool = False) -> None:
        with self._lock:
            d = self._revocable if revocable else self._reserved
            d[query_id] = d.get(query_id, 0) + delta
            if d[query_id] <= 0:
                d.pop(query_id)

    def reserve_spill(self, query_id: str, delta: int) -> None:
        """Charge (or, with a negative delta, release) disk-spill bytes."""
        with self._lock:
            self._spill[query_id] = self._spill.get(query_id, 0) + delta
            if self._spill[query_id] <= 0:
                self._spill.pop(query_id)

    def clear_query(self, query_id: str) -> None:
        """Drop every reservation of one query: the end-of-query backstop,
        so a teardown that failed to release leaves no pressure behind for
        later queries of the process."""
        with self._lock:
            self._reserved.pop(query_id, None)
            self._revocable.pop(query_id, None)
            self._spill.pop(query_id, None)

    def by_query(self) -> Dict[str, int]:
        with self._lock:
            totals: Dict[str, int] = dict(self._reserved)
            for q, b in self._revocable.items():
                totals[q] = totals.get(q, 0) + b
            return totals

    def spill_by_query(self) -> Dict[str, int]:
        """{query id: bytes on disk}: the disk rung's ledger."""
        with self._lock:
            return dict(self._spill)

    def reserved_bytes(self) -> int:
        with self._lock:
            return sum(self._reserved.values()) + sum(self._revocable.values())

    def spilled_bytes(self) -> int:
        with self._lock:
            return sum(self._spill.values())

    def spill_bytes(self, query_id: str) -> int:
        with self._lock:
            return self._spill.get(query_id, 0)

    def query_bytes(self, query_id: str) -> int:
        with self._lock:
            return self._reserved.get(query_id, 0) + self._revocable.get(query_id, 0)


GENERAL_POOL = "general"

_SHARED_LOCK = threading.Lock()
_SHARED_POOL: Optional[MemoryPool] = None


def shared_general_pool(max_bytes: Optional[int] = None) -> MemoryPool:
    """The process-wide GENERAL pool. It is sized at first use and later
    calls can only grow it: one session's small budget must not shrink the
    pool under every other query."""
    global _SHARED_POOL
    with _SHARED_LOCK:
        if _SHARED_POOL is None:
            _SHARED_POOL = MemoryPool(GENERAL_POOL, int(max_bytes or 8 << 30))
        elif max_bytes:
            _SHARED_POOL.max_bytes = max(_SHARED_POOL.max_bytes, int(max_bytes))
        return _SHARED_POOL


class QueryContextMemory:
    """A query's memory root, with a hard limit on its user memory."""

    def __init__(self, query_id: str, pool: MemoryPool, max_user_bytes: int):
        self.query_id = query_id
        self.pool = pool
        self.max_user_bytes = max_user_bytes
        self.memory = MemoryTrackingContext(
            AggregatedMemoryContext(reservation_handler=self._on_user),
            AggregatedMemoryContext(reservation_handler=self._on_revocable),
            AggregatedMemoryContext())

    def _on_user(self, delta: int, total: int) -> None:
        if total > self.max_user_bytes:
            # journaled before raising: the exception may surface far away
            # (through a consumer's queue), the event keeps the numbers
            from .utils import events
            events.emit("query.memory_exceeded", severity=events.ERROR,
                        query_id=self.query_id, limit_bytes=self.max_user_bytes,
                        reserved_bytes=total)
            raise ExceededMemoryLimitException("per-query user", self.max_user_bytes)
        self.pool.reserve(self.query_id, delta, revocable=False)

    def _on_revocable(self, delta: int, total: int) -> None:
        self.pool.reserve(self.query_id, delta, revocable=True)


class MemoryRevoker:
    """Asks registered operators to revoke, largest first, until the
    requested bytes cover the pool's excess over its target."""

    def __init__(self, pool: MemoryPool, target_fraction: float = 0.9):
        self.pool = pool
        self.target_fraction = target_fraction
        self._revocables: List = []  # objects with revocable_bytes()/start_memory_revoke()

    def register(self, op) -> None:
        self._revocables.append(op)

    def maybe_revoke(self) -> int:
        """-> the bytes requested (0 when the pool is under target)."""
        target = int(self.pool.max_bytes * self.target_fraction)
        over = self.pool.reserved_bytes() - target
        if over <= 0:
            return 0
        requested = 0
        for op in sorted(self._revocables, key=lambda o: -o.revocable_bytes()):
            if requested >= over:
                break
            b = op.revocable_bytes()
            if b > 0:
                op.start_memory_revoke()
                requested += b
        if requested:
            from .utils import events
            events.emit("memory.revoke", severity=events.WARN, requested_bytes=requested,
                        pool_reserved_bytes=self.pool.reserved_bytes(),
                        pool_max_bytes=self.pool.max_bytes)
        return requested
