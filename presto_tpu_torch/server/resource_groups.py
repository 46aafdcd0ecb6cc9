"""Resource groups of the PyTorch port: admission control for the query
manager (``presto_tpu/server/resource_groups.py``).

A tree of groups, each bounding its running and its queued queries, with
weighted round-robin dequeueing among sibling subgroups and selectors that
route a (user, source) pair to a group. A CPU quota refills with time; a
group over it admits nothing until it refills. ``memory_limit_bytes`` gates
admission on the process-wide pool (``memory.shared_general_pool``): while
its reserved bytes are over the limit, queries queue and are promoted as
tenants release. Every outcome is journaled: ``query.admitted``,
``query.queued``, ``query.rejected`` and ``pool.saturated``.
"""
from __future__ import annotations

import dataclasses
import re
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class GroupSpec:
    """One group's configuration (file config analogue)."""
    name: str
    hard_concurrency_limit: int = 100
    max_queued: int = 1000
    scheduling_weight: int = 1
    # CPU seconds per second of wall (refill rate); None = unlimited
    cpu_quota_per_s: Optional[float] = None
    sub_groups: List["GroupSpec"] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class SelectorSpec:
    """Routes (user, source) to a group path ('root.etl' style)."""
    group: str
    user_regex: Optional[str] = None
    source_regex: Optional[str] = None

    def matches(self, user: str, source: str) -> bool:
        if self.user_regex and not re.fullmatch(self.user_regex, user or ""):
            return False
        if self.source_regex and not re.fullmatch(self.source_regex,
                                                  source or ""):
            return False
        return True


class QueryRejected(Exception):
    """Admission refused (queue full) — maps to the client error."""


class _Group:
    def __init__(self, spec: GroupSpec, parent: Optional["_Group"]):
        self.spec = spec
        self.parent = parent
        self.name = spec.name if parent is None else \
            f"{parent.name}.{spec.name}"
        self.children: Dict[str, _Group] = {}
        self.running = 0           # queries running in THIS subtree
        self.queue: List["_Ticket"] = []  # queued directly on this group
        self.cpu_tokens = 0.0
        self.cpu_updated = time.monotonic()
        self._rr = 0               # weighted round-robin position
        for sub in spec.sub_groups:
            child = _Group(sub, self)
            self.children[sub.name] = child

    # -- cpu quota ----------------------------------------------------------

    def _refill(self) -> None:
        if self.spec.cpu_quota_per_s is None:
            return
        now = time.monotonic()
        self.cpu_tokens = min(
            self.spec.cpu_quota_per_s,  # burst bound: 1s worth
            self.cpu_tokens + (now - self.cpu_updated) * self.spec.cpu_quota_per_s)
        self.cpu_updated = now

    def cpu_blocked(self) -> bool:
        self._refill()
        return self.spec.cpu_quota_per_s is not None and self.cpu_tokens <= 0

    def charge_cpu(self, seconds: float) -> None:
        g: Optional[_Group] = self
        while g is not None:
            if g.spec.cpu_quota_per_s is not None:
                g._refill()
                g.cpu_tokens -= seconds
            g = g.parent

    # -- admission ----------------------------------------------------------

    def can_run(self) -> bool:
        g: Optional[_Group] = self
        while g is not None:
            if g.running >= g.spec.hard_concurrency_limit or g.cpu_blocked():
                return False
            g = g.parent
        return True

    def start(self) -> None:
        g: Optional[_Group] = self
        while g is not None:
            g.running += 1
            g = g.parent

    def finish(self) -> None:
        g: Optional[_Group] = self
        while g is not None:
            g.running -= 1
            g = g.parent

    def eligible_queued(self) -> Optional["_Ticket"]:
        """Next queued ticket in this subtree per weighted round-robin over
        children, FIFO within a group (InternalResourceGroup's
        internalGetWaitingQueuedQueries + weighted scheduling policy)."""
        if self.queue and self.can_run():
            return self.queue[0]
        kids = [c for c in self.children.values()]
        if not kids:
            return None
        # weighted RR: repeat each child proportionally to its weight
        order: List[_Group] = []
        for c in kids:
            order.extend([c] * max(c.spec.scheduling_weight, 1))
        n = len(order)
        for i in range(n):
            c = order[(self._rr + i) % n]
            t = c.eligible_queued()
            if t is not None:
                self._rr = (self._rr + i + 1) % n
                return t
        return None


class _Ticket:
    def __init__(self, group: _Group, query_id: str):
        self.group = group
        self.query_id = query_id
        self.admitted = threading.Event()
        self.start_time = time.monotonic()


class ResourceGroupManager:
    """Admission controller: every query acquires a ticket before running.

    submit() either admits immediately, queues (blocking the caller's worker
    thread until capacity frees — the reference parks the query in QUEUED
    state the same way), or rejects when the group's queue is full.

    `memory_limit_bytes` adds memory-aware admission over the process-shared
    GENERAL pool (memory.shared_general_pool): while reserved bytes — which
    now include scan prefetch and exchange in-flight buffers, not just
    operator state — exceed the limit, nothing new is admitted; queued
    queries promote as running tenants release (the reference's
    softMemoryLimit admission gate over ClusterMemoryPool, narrowed to one
    process). `memory_fn` overrides the probe (tests; cluster coordinators
    wiring their aggregated view).
    """

    def __init__(self, root_spec: Optional[GroupSpec] = None,
                 selectors: Sequence[SelectorSpec] = (),
                 memory_limit_bytes: Optional[int] = None,
                 memory_fn=None):
        self.root = _Group(root_spec or GroupSpec("root", 1 << 30, 1 << 30),
                           None)
        self.selectors = list(selectors)
        self.memory_limit_bytes = memory_limit_bytes
        if memory_fn is None and memory_limit_bytes is not None:
            from ..memory import shared_general_pool

            memory_fn = shared_general_pool().reserved_bytes
        self._memory_fn = memory_fn
        self._lock = threading.Lock()

    def _memory_ok(self) -> bool:
        if self.memory_limit_bytes is None or self._memory_fn is None:
            return True
        return self._memory_fn() < self.memory_limit_bytes

    def _resolve(self, user: str, source: str) -> _Group:
        path = None
        for sel in self.selectors:
            if sel.matches(user, source):
                path = sel.group
                break
        if path is None:
            return self.root
        g = self.root
        for part in path.split(".")[1:]:  # path starts with root's name
            child = g.children.get(part)
            if child is None:
                # a selector naming a nonexistent subgroup is a config bug:
                # silently falling back to an ancestor would bypass the
                # intended admission limits (the reference validates resource
                # group config up front the same way)
                raise ValueError(
                    f"resource group selector names unknown group {path!r} "
                    f"(missing subgroup {part!r})")
            g = child
        return g

    def submit(self, query_id: str, user: str = "", source: str = "",
               timeout_s: float = 300.0) -> _Ticket:
        from ..utils import events
        # the outcome is DECIDED inside the lock (a concurrent finish()
        # could promote the queued ticket before we journal — re-reading
        # ticket.admitted outside would then emit a duplicate admitted and
        # suppress the queued event that actually happened); the emits
        # themselves stay OUTSIDE the lock (the journal's file sink does
        # I/O under its own lock)
        rejected = None
        queued = None
        with self._lock:
            group = self._resolve(user, source)
            ticket = _Ticket(group, query_id)
            memory_ok = self._memory_ok()
            if group.can_run() and memory_ok:
                group.start()
                ticket.admitted.set()
                outcome = "admitted"
            elif len(group.queue) >= group.spec.max_queued:
                rejected = QueryRejected(
                    f"Too many queued queries for {group.name!r} "
                    f"(max_queued {group.spec.max_queued})")
                outcome = "rejected"
            else:
                group.queue.append(ticket)
                queued = (group.name, len(group.queue), group.running)
                outcome = "queued"
        if outcome == "admitted":
            events.emit("query.admitted", query_id=query_id,
                        group=group.name)
            return ticket
        if outcome == "rejected":
            events.emit("query.rejected", severity=events.WARN,
                        query_id=query_id, group=group.name,
                        reason=str(rejected))
            raise rejected
        events.emit("query.queued", severity=events.WARN, query_id=query_id,
                    group=queued[0], queue_depth=queued[1],
                    running=queued[2])
        if not memory_ok:
            # the reason the query parked was pool pressure, not group
            # concurrency: that saturation is its own operational signal
            events.emit("pool.saturated", severity=events.WARN,
                        query_id=query_id,
                        reserved_bytes=self._memory_fn(),
                        limit_bytes=self.memory_limit_bytes)
        deadline = time.monotonic() + timeout_s
        while not ticket.admitted.wait(min(1.0, timeout_s)):
            # periodic re-promotion: cpu quotas refill with TIME, not only on
            # query completion — without this tick a cpu-gated group whose
            # last finish() ran while tokens were negative would starve its
            # queue until timeout
            with self._lock:
                promoted = self._promote_locked()
            self._emit_promotions(promoted)
            if ticket.admitted.is_set():
                break
            if time.monotonic() > deadline:
                with self._lock:
                    if ticket.admitted.is_set():
                        break
                    try:
                        ticket.group.queue.remove(ticket)
                    except ValueError:
                        pass
                events.emit("query.rejected", severity=events.WARN,
                            query_id=query_id, group=group.name,
                            reason="queued time limit exceeded")
                raise QueryRejected(
                    f"Query exceeded queued time limit in {group.name!r}")
        return ticket

    def _promote_locked(self) -> List["_Ticket"]:
        promoted: List[_Ticket] = []
        while True:
            if not self._memory_ok():
                return promoted  # pool over limit: admit nothing until tenants free
            nxt = self.root.eligible_queued()
            if nxt is None:
                return promoted
            nxt.group.queue.remove(nxt)
            nxt.group.start()
            nxt.admitted.set()
            promoted.append(nxt)

    @staticmethod
    def _emit_promotions(promoted: List["_Ticket"]) -> None:
        from ..utils import events
        for t in promoted:
            events.emit("query.admitted", query_id=t.query_id,
                        group=t.group.name, promoted=True,
                        queued_s=round(time.monotonic() - t.start_time, 3))

    def finish(self, ticket: _Ticket, cpu_seconds: float = 0.0) -> None:
        with self._lock:
            if cpu_seconds:
                ticket.group.charge_cpu(cpu_seconds)
            ticket.group.finish()
            promoted = self._promote_locked()
        self._emit_promotions(promoted)

    def stats(self) -> Dict[str, Tuple[int, int]]:
        """group name -> (running, queued), for /v1/resourceGroup."""
        out: Dict[str, Tuple[int, int]] = {}

        def walk(g: _Group):
            out[g.name] = (g.running, len(g.queue))
            for c in g.children.values():
                walk(c)

        with self._lock:
            walk(self.root)
        return out
