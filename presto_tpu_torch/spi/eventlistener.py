"""Event listener SPI and query monitor of the PyTorch port (counterpart of
``presto_tpu/spi/eventlistener.py``). Nothing in the port dispatches
events yet: the server's query manager does, in the reference.

Analogue of spi/eventlistener/ (EventListener.java, QueryCreatedEvent,
QueryCompletedEvent) and event/QueryMonitor.java:79,119,181: plugins register
listeners; the query manager emits created/completed events with timing,
state, row counts, and failure info. Listener exceptions are isolated — a
broken listener never fails a query (the reference wraps dispatch the same
way)."""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class QueryCreatedEvent:
    query_id: str
    sql: str
    user: str = ""
    source: str = ""
    # client-supplied correlation id (X-Presto-Trace-Token), threaded
    # through events and /v1/query so external tracing can stitch a
    # request to the engine's execution (QueryMonitor's trace token)
    trace_token: str = ""
    create_time: float = dataclasses.field(default_factory=time.time)


@dataclasses.dataclass(frozen=True)
class QueryCompletedEvent:
    query_id: str
    sql: str
    state: str = "FINISHED"            # FINISHED | FAILED | CANCELED
    user: str = ""
    trace_token: str = ""
    row_count: int = 0
    wall_seconds: float = 0.0
    error: Optional[Dict] = None
    end_time: float = dataclasses.field(default_factory=time.time)


class EventListener:
    """Base SPI class: override any subset (spi/eventlistener/EventListener.java)."""

    def query_created(self, event: QueryCreatedEvent) -> None:
        pass

    def query_completed(self, event: QueryCompletedEvent) -> None:
        pass


class QueryMonitor:
    """Dispatches lifecycle events to registered listeners (QueryMonitor.java)."""

    def __init__(self, listeners: Optional[List[EventListener]] = None):
        self.listeners: List[EventListener] = list(listeners or [])

    def add_listener(self, listener: EventListener) -> None:
        self.listeners.append(listener)

    def _dispatch(self, method: str, event) -> None:
        for lst in self.listeners:
            try:
                getattr(lst, method)(event)
            except Exception:  # noqa: BLE001 - listeners must never fail queries
                pass

    def query_created(self, event: QueryCreatedEvent) -> None:
        self._dispatch("query_created", event)

    def query_completed(self, event: QueryCompletedEvent) -> None:
        self._dispatch("query_completed", event)
