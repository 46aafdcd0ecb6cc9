"""Process-wide shared worker pools: the scan stages and the exchange pumps.

Counterpart of ``presto_tpu/exec/shared_pools.py``. Every scan pipeline's
reader, decode and upload stages run on :data:`SCAN_POOL`, and every
streaming exchange's pump (``parallel/streaming_exchange.py``) on
:data:`EXCHANGE_POOL`: pools sized once per process whose threads are
reused across queries, so N concurrent queries cost O(pool) threads instead
of O(N * stages).

- Work is submitted as generators: each ``next()`` advances a stage by one
  bounded step (one chunk read, one upload). A stage that cannot progress
  waits at most :data:`STEP_WAIT_S` inside its step and then yields, so no
  step holds a pool worker for long and the pool cannot deadlock. A source
  whose reads block on progress the engine does not control
  (``ConnectorPageSource.external_wait``) stays on dedicated threads; the
  scan pipeline enforces that.
- Fairness is round-robin across clients, one client per live query: a
  worker picks the next client with runnable work and advances one step of
  one of its generators.
- Clients are refcounted by key (``next_query_key``): every pipeline of one
  query shares one fairness slot, and the client goes away when its last
  owner releases it and its generators have drained.

The submitting thread's flight recorder (``utils/trace.py``) rides with
each generator, and a worker binds it around every step it takes for that
generator, recording a ``pool`` span ``<pool>_step``; ``PoolClient.steps``
counts the steps taken for a client (live progress reads it). The pools'
sizes come from ``PRESTO_TPU_TORCH_SCAN_POOL_THREADS`` and
``PRESTO_TPU_TORCH_EXCHANGE_POOL_THREADS``, read once at import (the
reference reads ``PRESTO_TPU_*``). The reference's lock-sanitizer hooks
and metric gauges are not ported.
"""
from __future__ import annotations

import itertools
import os
import sys
import threading
from collections import OrderedDict, deque
from typing import Dict, Iterator, List

from ..utils import trace

# what a stage generator yields; the pool treats every yield as a fairness
# checkpoint, the names document the yield site's intent
AGAIN = "again"   # made progress, more work pending
WAIT = "wait"     # could not progress; the step already waited its bound

# the bounded wait of a blocked step before it yields: long enough to catch
# a notify, short enough that a parked step frees its worker promptly
STEP_WAIT_S = 0.02

_IDLE_WAIT_S = 0.05   # a worker's park time when no client has work


class PoolClient:
    """One query's fairness slot in a pool, refcounted by key."""

    def __init__(self, pool: "SharedWorkerPool", key: str):
        self.pool = pool
        self.key = key
        self.refs = 0
        self.gens: deque = deque()   # runnable (generator, trace recorder)
        self.live = 0                # submitted, not yet finished
        self.steps = 0               # steps the pool took for this client

    def submit(self, gen: Iterator) -> None:
        """Enqueue a stage generator, with the submitting thread's active
        trace recorder, so the steps' spans land on the owning query."""
        self.pool._submit(self, gen, trace.active())

    def release(self) -> None:
        self.pool._release(self)


class SharedWorkerPool:
    """Fixed-size worker pool stepping client generators round-robin."""

    def __init__(self, name: str, size: int):
        self.name = name
        self.size = max(1, int(size))
        self._cv = threading.Condition()
        self._clients: "OrderedDict[str, PoolClient]" = OrderedDict()
        self._threads: List[threading.Thread] = []
        self._rr = 0

    def client(self, key: str) -> PoolClient:
        """Acquire (refcounted) the client for ``key``, creating it on first
        use. The worker threads start at the first acquire."""
        with self._cv:
            c = self._clients.get(key)
            if c is None:
                c = self._clients[key] = PoolClient(self, key)
            c.refs += 1
            while len(self._threads) < self.size:
                t = threading.Thread(target=self._worker,
                                     name=f"{self.name}-pool-{len(self._threads)}",
                                     daemon=True)
                self._threads.append(t)
                t.start()
        return c

    def _submit(self, client: PoolClient, gen: Iterator, recorder) -> None:
        with self._cv:
            client.gens.append((gen, recorder))
            client.live += 1
            self._cv.notify_all()

    def _release(self, client: PoolClient) -> None:
        with self._cv:
            client.refs -= 1
            self._maybe_drop_locked(client)

    def _maybe_drop_locked(self, client: PoolClient) -> None:
        if client.refs <= 0 and client.live <= 0 and not client.gens:
            self._clients.pop(client.key, None)  # prestocheck: ignore[shared-state-race]

    def _next_work(self):
        """The next client (from the rotation cursor) with a runnable
        generator, as (client, generator, recorder), or None after an idle
        wait."""
        with self._cv:
            keys = list(self._clients)
            n = len(keys)
            for i in range(n):
                c = self._clients[keys[(self._rr + i) % n]]
                if c.gens:
                    self._rr = (self._rr + i + 1) % n
                    gen, rec = c.gens.popleft()
                    return c, gen, rec
            self._cv.wait(_IDLE_WAIT_S)
            return None

    def _worker(self) -> None:
        while True:
            work = self._next_work()
            if work is None:
                continue
            client, gen, rec = work
            finished = False
            try:
                if rec is not None:
                    with trace.bound(rec):
                        with trace.span(trace.POOL, f"{self.name}_step", query=client.key):
                            next(gen)
                else:
                    next(gen)
            except StopIteration:
                finished = True
            except Exception as e:  # noqa: BLE001 - the stages route their own
                # errors to their consumers (ScanPipeline._guard); one that
                # escapes is a pool fault: keep the worker, drop the generator
                finished = True
                print(f"shared pool {self.name}: worker step failed: {e!r}",
                      file=sys.stderr)
            with self._cv:
                client.steps += 1
                if finished:
                    client.live -= 1
                    self._maybe_drop_locked(client)
                else:
                    client.gens.append((gen, rec))
                self._cv.notify_all()


def _pool_size(env: str, default: int) -> int:
    """A pool's thread count from ``env``; ``default`` where it is unset,
    empty, not a number or not positive."""
    try:
        n = int(os.environ.get(env) or 0)
    except ValueError:
        n = 0
    return n if n > 0 else default


# process-wide pools, sized once at import; their threads start at the
# first query that uses them:
#   PRESTO_TPU_TORCH_SCAN_POOL_THREADS      scan reader/decode/upload stages
#   PRESTO_TPU_TORCH_EXCHANGE_POOL_THREADS  streaming-exchange pumps
SCAN_POOL = SharedWorkerPool(
    "scan", _pool_size("PRESTO_TPU_TORCH_SCAN_POOL_THREADS",
                       max(4, min(8, os.cpu_count() or 4))))
EXCHANGE_POOL = SharedWorkerPool(
    "exchange", _pool_size("PRESTO_TPU_TORCH_EXCHANGE_POOL_THREADS", 4))

_QUERY_KEYS = itertools.count(1)


def pool_locks() -> Dict[str, object]:
    """The pools' condition variables by pool name. They are allocated at
    this module's import, after the lock sanitizer's import-time install,
    so under PRESTO_TPU_TORCH_LOCKSAN=1 each is an instrumented wrapper."""
    return {SCAN_POOL.name: SCAN_POOL._cv, EXCHANGE_POOL.name: EXCHANGE_POOL._cv}


def next_query_key(prefix: str = "q") -> str:
    """A fresh per-query pool key: every pipeline of one query acquires its
    pool client under the same key, one fairness slot per query."""
    return f"{prefix}{next(_QUERY_KEYS)}"
