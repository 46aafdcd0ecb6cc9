"""Local exchange: page hand-off between the pipelines of one query.

Counterpart of ``presto_tpu/ops/local_exchange.py``: N producer drivers push
pages into a shared buffer and a consumer driver pulls them. This is what
runs one pipeline as several drivers: the stateless prefix (scan,
filter/project, join probes) runs in the producers, the stateful tail
downstream of the exchange. The payload is device pages: the exchange moves
tensor handles, never data.

``max_pages`` bounds the buffer: a producer whose sink finds it full reports
BLOCKED until the consumer drains it (the task executor parks it), and a
put into an empty buffer always succeeds. No operator call here waits:
blocking is the executor's business, through ``is_blocked``; only
``try_put``, the streaming exchange pump's delivery, waits a bounded
time for room. A producer driver that is
closed before it finished (its query failed) poisons the buffer, so the
consumer raises instead of reading a truncated stream.

With ``deal_slots`` the buffer DEALS pages round-robin to that many consumer
slots instead of letting consumers take from one shared list: the scaled
writers' exchange, where every writer driver must get a share however fast
the producer runs (``presto_tpu/ops/local_exchange.py`` ``deal_slots``).
``max_bytes`` bounds by payload bytes instead: the streaming mesh
exchange's consumer queues (``parallel/streaming_exchange.py``).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

from ..block import Page
from ..types import Type
from .operator import Operator, OperatorContext, OperatorFactory, timed


class LocalExchangeBuffer:
    """Shared page queue with producer completion tracking.

    ``max_bytes`` > 0 bounds the queue by payload bytes instead of pages:
    the streaming mesh exchange's per-worker consumer queues, whose pump
    delivers through ``try_put`` (a bounded wait, so a full queue parks the
    pump's step, never a pool thread). A put into an empty buffer always
    succeeds, so one oversized page cannot wedge the stream. ``abandon``
    drops a single consumer's queue when that consumer closes early (a
    satisfied LIMIT above a streaming exchange)."""

    def __init__(self, n_producers: int, max_pages: int = 0, deal_slots: int = 0,
                 max_bytes: int = 0):
        self._pages: List[Page] = []
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._open_producers = n_producers
        self.max_pages = max_pages
        self.max_bytes = max_bytes
        self._bytes = 0
        self._poison: Optional[BaseException] = None
        self._abandoned = False
        # deal_slots > 0: page i goes to slot i mod deal_slots
        self.deal_slots = deal_slots
        self._dealt: List[List[Page]] = [[] for _ in range(deal_slots)]
        self._deal_next = 0

    def _queue(self, slot: Optional[int]) -> List[Page]:
        return self._dealt[slot] if slot is not None else self._pages

    def _buffered(self) -> int:
        return len(self._pages) + sum(len(d) for d in self._dealt)

    def _has_room_locked(self) -> bool:
        n = self._buffered()
        if n == 0 or self._poison is not None:
            return True
        if self.max_pages > 0 and n >= self.max_pages:
            return False
        return not (self.max_bytes > 0 and self._bytes >= self.max_bytes)

    def _enqueue_locked(self, page: Page) -> None:
        if self.deal_slots:
            self._dealt[self._deal_next].append(page)
            self._deal_next = (self._deal_next + 1) % self.deal_slots
        else:
            self._pages.append(page)
        if self.max_bytes > 0:
            # only byte-bounded buffers pay the per-page size walk
            from .scan_pipeline import page_nbytes

            self._bytes += page_nbytes(page)
        self._cv.notify_all()

    def put(self, page: Page) -> None:
        with self._cv:
            if not self._abandoned:
                self._enqueue_locked(page)

    def try_put(self, page: Page, wait_s: float = 0.0) -> bool:
        """Enqueue if there is room, waiting at most ``wait_s`` for some;
        False when still full. Poison raises; an abandoned buffer accepts
        and discards."""
        with self._cv:
            if not self._abandoned and not self._has_room_locked() and wait_s > 0:
                self._cv.wait(timeout=wait_s)
            if self._poison is not None:
                raise RuntimeError("local exchange buffer poisoned") from self._poison
            if self._abandoned:
                return True
            if not self._has_room_locked():
                return False
            self._enqueue_locked(page)
            return True

    def has_room(self) -> bool:
        if self.max_pages <= 0 and self.max_bytes <= 0:
            return True
        with self._lock:
            return self._has_room_locked()

    def buffered_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def poison(self, exc: BaseException) -> None:
        """Fail every later poll: a producer failed or was abandoned."""
        with self._cv:
            if self._poison is None:
                self._poison = exc
            self._cv.notify_all()

    def abandon(self) -> None:
        """The sole consumer is gone: drop what is buffered and discard
        later puts, so the producer never blocks on a queue nobody reads."""
        with self._cv:
            self._abandoned = True
            self._pages.clear()
            for d in self._dealt:
                d.clear()
            self._bytes = 0
            self._cv.notify_all()

    def producer_finished(self) -> None:
        with self._cv:
            self._open_producers -= 1
            self._cv.notify_all()

    def poll(self, slot: Optional[int] = None) -> Optional[Page]:
        """The next page of ``slot`` (dealt mode) or of the shared list."""
        with self._cv:
            if self._poison is not None:
                raise RuntimeError("local exchange buffer poisoned") from self._poison
            pages = self._queue(slot)
            if not pages:
                return None
            page = pages.pop(0)
            if self.max_bytes > 0:
                from .scan_pipeline import page_nbytes

                self._bytes = max(0, self._bytes - page_nbytes(page))
            self._cv.notify_all()
            return page

    def is_done(self, slot: Optional[int] = None) -> bool:
        with self._lock:
            if self._poison is not None:
                return False  # poll must run, and raise
            return not self._queue(slot) and self._open_producers <= 0

    def has_output(self, slot: Optional[int] = None) -> bool:
        with self._lock:
            return self._poison is not None or bool(self._queue(slot)) \
                or self._open_producers <= 0


class LocalExchangeSink(Operator):
    """Tail of a producer driver: pages go into the shared buffer."""

    def __init__(self, context: OperatorContext, buffer: LocalExchangeBuffer,
                 types: List[Type]):
        super().__init__(context)
        self.buffer = buffer
        self._types = types
        self._closed_buffer = False

    @property
    def output_types(self) -> List[Type]:
        return self._types

    def needs_input(self) -> bool:
        return super().needs_input() and self.buffer.has_room()

    def is_blocked(self):
        if self.buffer.has_room():
            return None
        return self.buffer.has_room  # the consumer's drain frees a slot

    @timed("add_input_ns")
    def add_input(self, page: Page) -> None:
        self.context.record_input(page, page.capacity)
        self.buffer.put(page)

    def get_output(self) -> Optional[Page]:
        return None

    def finish(self) -> None:
        if not self._finishing and not self._closed_buffer:
            self.buffer.producer_finished()
            self._closed_buffer = True
        super().finish()

    def close(self) -> None:
        if not self._closed_buffer:
            # closed before it finished: its driver was abandoned
            self._closed_buffer = True
            self.buffer.poison(RuntimeError("a producer driver of the exchange "
                                            "was closed before it finished"))
        super().close()

    def is_finished(self) -> bool:
        return self._finishing


class LocalExchangeSource(Operator):
    """Head of the consumer driver: pulls from the shared buffer; blocked
    while producers are still running and no page is ready."""

    def __init__(self, context: OperatorContext, buffer: LocalExchangeBuffer,
                 types: List[Type], slot: Optional[int] = None):
        super().__init__(context)
        self.buffer = buffer
        self._types = types
        self._slot = slot  # dealt-mode consumer slot; None = the shared list
        self._ready = lambda: buffer.has_output(slot)

    @property
    def output_types(self) -> List[Type]:
        return self._types

    def needs_input(self) -> bool:
        return False

    def add_input(self, page: Page) -> None:
        raise RuntimeError("local exchange source takes no input")

    def is_blocked(self):
        if self.buffer.has_output(self._slot):
            return None
        return self._ready

    @timed("get_output_ns")
    def get_output(self) -> Optional[Page]:
        page = self.buffer.poll(self._slot)
        if page is not None:
            self.context.record_output(page, page.capacity)
        return page

    def is_finished(self) -> bool:
        return self._finishing or self.buffer.is_done(self._slot)


class LocalExchangeFactory:
    """One per pipeline cut: the buffer its sink and source factories
    share. ``max_pages`` > 0 bounds it (the planner passes 2n + 2 for n
    producers, so fast producers cannot pile up device pages);
    ``deal_slots`` > 0 deals pages round-robin to that many consumers, each
    created source taking the next slot."""

    def __init__(self, n_producers: int, max_pages: int = 0, deal_slots: int = 0):
        self.n_producers = n_producers
        self.max_pages = max_pages
        self.deal_slots = deal_slots
        self._buffers: Dict[int, LocalExchangeBuffer] = {}
        self._next_slot: Dict[int, int] = {}
        self._lock = threading.Lock()

    def buffer(self, worker: int = 0) -> LocalExchangeBuffer:
        """The buffer of ``worker``: its producers feed only its consumers."""
        with self._lock:
            b = self._buffers.get(worker)
            if b is None:
                b = self._buffers[worker] = LocalExchangeBuffer(
                    self.n_producers, self.max_pages, self.deal_slots)
            return b

    def next_slot(self, worker: int = 0) -> Optional[int]:
        """Dealt mode: the consumer slots of ``worker`` in creation order;
        else None."""
        if not self.deal_slots:
            return None
        with self._lock:
            slot = self._next_slot.get(worker, 0)
            self._next_slot[worker] = (slot + 1) % self.deal_slots
            return slot


class LocalExchangeSinkFactory(OperatorFactory):
    def __init__(self, operator_id: int, exchange: LocalExchangeFactory,
                 types: List[Type]):
        super().__init__(operator_id, "LocalExchangeSink")
        self.exchange = exchange
        self.types = types

    def create_operator(self, worker: int = 0) -> Operator:
        return LocalExchangeSink(self.context(worker), self.exchange.buffer(worker),
                                 self.types)


class LocalExchangeSourceFactory(OperatorFactory):
    def __init__(self, operator_id: int, exchange: LocalExchangeFactory,
                 types: List[Type]):
        super().__init__(operator_id, "LocalExchangeSource")
        self.exchange = exchange
        self.types = types

    def create_operator(self, worker: int = 0) -> Operator:
        return LocalExchangeSource(self.context(worker), self.exchange.buffer(worker),
                                   self.types, self.exchange.next_slot(worker))
