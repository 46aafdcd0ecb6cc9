"""Local exchange: page hand-off between the pipelines of one query.

Counterpart of ``presto_tpu/ops/local_exchange.py``: N producer drivers push
pages into a shared buffer and a consumer driver pulls them. This is what
runs one pipeline as several drivers: the stateless prefix (scan,
filter/project, join probes) runs in the producers, the stateful tail
downstream of the exchange. The payload is device pages: the exchange moves
tensor handles, never data.

``max_pages`` bounds the buffer: a producer whose sink finds it full reports
BLOCKED until the consumer drains it (the task executor parks it), and a
put into an empty buffer always succeeds. No call here waits: blocking is
the executor's business, through ``is_blocked``. A producer driver that is
closed before it finished (its query failed) poisons the buffer, so the
consumer raises instead of reading a truncated stream.

With ``deal_slots`` the buffer DEALS pages round-robin to that many consumer
slots instead of letting consumers take from one shared list: the scaled
writers' exchange, where every writer driver must get a share however fast
the producer runs (``presto_tpu/ops/local_exchange.py`` ``deal_slots``).
The reference's byte-bounded mode (its mesh exchange) is not ported.
"""
from __future__ import annotations

import threading
from typing import List, Optional

from ..block import Page
from ..types import Type
from .operator import Operator, OperatorContext, OperatorFactory, timed


class LocalExchangeBuffer:
    """Shared page queue with producer completion tracking."""

    def __init__(self, n_producers: int, max_pages: int = 0, deal_slots: int = 0):
        self._pages: List[Page] = []
        self._lock = threading.Lock()
        self._open_producers = n_producers
        self.max_pages = max_pages
        self._poison: Optional[BaseException] = None
        # deal_slots > 0: page i goes to slot i mod deal_slots
        self.deal_slots = deal_slots
        self._dealt: List[List[Page]] = [[] for _ in range(deal_slots)]
        self._deal_next = 0

    def _queue(self, slot: Optional[int]) -> List[Page]:
        return self._dealt[slot] if slot is not None else self._pages

    def _buffered(self) -> int:
        return len(self._pages) + sum(len(d) for d in self._dealt)

    def put(self, page: Page) -> None:
        with self._lock:
            if self.deal_slots:
                self._dealt[self._deal_next].append(page)
                self._deal_next = (self._deal_next + 1) % self.deal_slots
            else:
                self._pages.append(page)

    def has_room(self) -> bool:
        if self.max_pages <= 0:
            return True
        with self._lock:
            n = self._buffered()
            return n == 0 or n < self.max_pages or self._poison is not None

    def poison(self, exc: BaseException) -> None:
        """Fail every later poll: a producer failed or was abandoned."""
        with self._lock:
            if self._poison is None:
                self._poison = exc

    def producer_finished(self) -> None:
        with self._lock:
            self._open_producers -= 1

    def poll(self, slot: Optional[int] = None) -> Optional[Page]:
        """The next page of ``slot`` (dealt mode) or of the shared list."""
        with self._lock:
            if self._poison is not None:
                raise RuntimeError("local exchange buffer poisoned") from self._poison
            pages = self._queue(slot)
            return pages.pop(0) if pages else None

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
        self._buffer: Optional[LocalExchangeBuffer] = None
        self._next_slot = 0
        self._lock = threading.Lock()

    def buffer(self) -> LocalExchangeBuffer:
        with self._lock:
            if self._buffer is None:
                self._buffer = LocalExchangeBuffer(self.n_producers, self.max_pages,
                                                   self.deal_slots)
            return self._buffer

    def next_slot(self) -> Optional[int]:
        """Dealt mode: the consumer slots in creation order; else None."""
        if not self.deal_slots:
            return None
        with self._lock:
            slot = self._next_slot
            self._next_slot = (slot + 1) % self.deal_slots
            return slot


class LocalExchangeSinkFactory(OperatorFactory):
    def __init__(self, operator_id: int, exchange: LocalExchangeFactory,
                 types: List[Type]):
        super().__init__(operator_id, "LocalExchangeSink")
        self.exchange = exchange
        self.types = types

    def create_operator(self) -> Operator:
        return LocalExchangeSink(self.context(), self.exchange.buffer(), self.types)


class LocalExchangeSourceFactory(OperatorFactory):
    def __init__(self, operator_id: int, exchange: LocalExchangeFactory,
                 types: List[Type]):
        super().__init__(operator_id, "LocalExchangeSource")
        self.exchange = exchange
        self.types = types

    def create_operator(self) -> Operator:
        return LocalExchangeSource(self.context(), self.exchange.buffer(), self.types,
                                   self.exchange.next_slot())
