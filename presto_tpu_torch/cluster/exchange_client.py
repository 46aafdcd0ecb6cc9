"""Consumer half of the cluster's shuffle: HTTP page pull with token acks.

The port's copy of ``presto_tpu/cluster/exchange_client.py`` (Presto's
operator/ExchangeClient.java:145 + HttpPageBufferClient.java:88,301): for
each upstream task location, GET {location}/results/{buffer_id}/{token}
long-polls one frame at a time; the next request's token acknowledges
everything before it. Transient HTTP errors back off and retry under the
shared cluster/retry.Backoff budget; a hard error or an upstream task
failure fails the consumer.

The pages a source yields are HOST pages (CPU tensors, ``serde.
columns_to_pages``): the consuming task's scan uploads each one to its
device once, on the device's default stream, as it uploads a connector's
pages (``ops/scan.py``); nothing here touches a device.

Fault tolerance: every client tracks a per-consumer CHUNK CURSOR (`token`,
the next sequence number it needs). When the scheduler recovers a failed
producer (POST /v1/task/{id}/sources -> SqlTask.update_sources ->
reset_location here) the client keeps its cursor and re-issues GET from it
against the replacement — the replacement re-produces the same deterministic
frame sequence (single sink driver; a nondeterministic sink marks its buffer
non-replayable server-side), its spool absorbs the prefix the consumer
already has, and a monotonic sequence check asserts exactly-once delivery.
A replayed token that was already retired from the producer's bounded spool
answers HTTP 410 (`replay window lost`) — a hard error that escalates
loudly to a query-level retry instead of silently skipping data."""
from __future__ import annotations

import threading
import time
import urllib.error
import urllib.request
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..block import Dictionary, Page
from ..spi.connector import ConnectorPageSource
from ..types import Type
from ..utils import trace
from . import faults
from .retry import Backoff
from .serde import deserialize_pages

# default transient-failure budget before a location is declared dead
# (the exchange_error_budget_s session default in metadata.py matches; use
# this constant as the fallback wherever that property might be None)
_MAX_ERROR_S = 60.0


class PageBufferClient:
    """One upstream location's pull loop state."""

    def __init__(self, location: str, buffer_id: int,
                 error_budget_s: float = _MAX_ERROR_S):
        self.location = location.rstrip("/")
        self.buffer_id = buffer_id
        self.token = 0
        self.complete = False
        self.done = False  # complete AND final ack sent
        self._backoff = Backoff(max_failure_interval_s=error_budget_s,
                                initial_delay_s=0.05, max_delay_s=1.0)
        self._instance_id: Optional[str] = None
        # guards token/complete/location/epoch against the rewire path: a
        # reset bumps the epoch, and a poll that was in flight against the
        # OLD location commits nothing (its frame is dropped) — without
        # this, a rewire accepted mid-poll could double-consume frame 0
        self._lock = threading.Lock()
        self._epoch = 0

    def poll(self, timeout_s: float = 10.0) -> Optional[bytes]:
        """One GET; returns a frame or None (no data yet / now complete)."""
        with self._lock:
            epoch = self._epoch
            location = self.location
            url = (f"{location}/results/{self.buffer_id}/{self.token}"
                   f"?wait={timeout_s:.1f}")
        req = urllib.request.Request(url, method="GET")
        t0 = time.perf_counter_ns()
        try:
            # token rides along so chaos callbacks can key on consumption
            # state (e.g. "fail this consumer once it has committed 2 chunks")
            faults.fire("client.results", location=location, token=self.token)
            with urllib.request.urlopen(req, timeout=timeout_s + 15.0) as resp:
                nxt = int(resp.headers.get("X-Next-Token", self.token))
                complete = resp.headers.get("X-Complete") == "true"
                instance = resp.headers.get("X-Task-Instance-Id")
                frame = resp.read()
            if trace.active() is not None:
                trace.record(trace.HTTP, "pull results", t0,
                             time.perf_counter_ns() - t0,
                             {"location": location,
                              "bytes": len(frame) if frame else 0})
        except urllib.error.HTTPError as e:
            if e.code == 410:
                # the producer retired this chunk from its replay spool
                # (overflow or nondeterministic sink): waiting cannot help
                # and skipping would lose rows — hard-fail; the message
                # marker classifies it QUERY-retryable upstream
                detail = e.read()[:300].decode(errors="replace")
                raise RuntimeError(
                    f"exchange source {location} cannot replay: "
                    f"{detail or 'replay window lost'}") from e
            if e.code == 404 or e.code >= 500:
                # 404: producer task not created yet (all-at-once scheduling
                # may reach the consumer first); 5xx: a server-side blip or
                # a failed buffer mid-recovery — both transient within the
                # budget (HttpPageBufferClient treats any non-OK response as
                # a retryable failure). Keep the body: if the budget
                # exhausts, the LAST server diagnostic must survive into
                # the error instead of a bare 'unreachable'
                detail = e.read()[:300].decode(errors="replace")
                return self._transient(RuntimeError(
                    f"HTTP {e.code}: {detail}" if detail else str(e)))
            raise RuntimeError(
                f"exchange source {location} failed: {e} "
                f"{e.read()[:500].decode(errors='replace')}") from e
        except (urllib.error.URLError, OSError, TimeoutError) as e:
            return self._transient(e)
        with self._lock:
            if self._epoch != epoch:
                return None  # rewired mid-flight: drop the stale frame
            if instance:
                if self._instance_id is None:
                    self._instance_id = instance
                elif self._instance_id != instance:
                    # the producer task was RECREATED behind our back: its
                    # tokens restarted at 0, so our token would silently
                    # skip/duplicate frames — fail the query loudly
                    # (reference: PRESTO_TASK_INSTANCE_ID mismatch aborts
                    # the page client). A scheduler-driven rewire instead
                    # goes through reset_location, which bumps the epoch
                    # and clears the pinned instance id first.
                    raise RuntimeError(
                        f"exchange source {location} was recreated "
                        f"(instance {self._instance_id} -> {instance}); "
                        f"stream tokens are no longer valid")
            self._backoff.success()
            if frame and nxt != self.token + 1:
                # exactly-once guard: a served frame must advance the cursor
                # by exactly one sequence number — anything else means the
                # producer skipped or re-delivered a chunk
                raise RuntimeError(
                    f"exchange source {location} sequence violation: "
                    f"cursor {self.token} answered with next token {nxt}")
            self.token = nxt
            self.complete = complete
        return frame if frame else None

    def _transient(self, e: Exception) -> None:
        if self._backoff.failure():
            raise RuntimeError(
                f"exchange source {self.location} unreachable after "
                f"{self._backoff.failure_count} tries over "
                f"{self._backoff.time_since_first_failure_s():.1f}s: {e}"
            ) from e
        self._backoff.wait()
        return None

    def can_reset(self) -> bool:
        # the chunk cursor makes a mid-stream rewire sound: the client
        # re-issues GET from `token` and the replacement's spool replays or
        # absorbs the already-consumed prefix (410 if it cannot)
        return True

    def reset_location(self, new_location: str) -> bool:
        """Point this client at a replacement producer, KEEPING the chunk
        cursor: the next poll re-issues GET from `token` and sequence
        numbers assert exactly-once delivery across the rewire. Bumps the
        epoch so an in-flight poll against the old location cannot commit;
        clears the pinned instance id (the replacement is a new instance by
        design). A finished (`done`) client acks the replacement's stream
        through its cursor, so the new task never wedges on backpressure:
        the re-produced frames land in the spool, where a later replacement
        of this consumer (same buffer id, cursor 0) replays them; a release
        would answer that replay with a 410 and retry the query."""
        was_done = False
        with self._lock:
            self.location = new_location.rstrip("/")
            self._instance_id = None
            self._epoch += 1
            self._backoff.success()
            was_done = self.done
        if was_done:
            self.ack_through()
        return True

    def ack_through(self) -> None:
        """Ack every frame below the cursor without waiting for one (a GET
        at ``token`` with ``wait=0``); the buffer stays replayable."""
        try:
            url = f"{self.location}/results/{self.buffer_id}/{self.token}?wait=0"
            urllib.request.urlopen(urllib.request.Request(url, method="GET"),
                                   timeout=5.0).read()
        except Exception:
            pass  # best-effort, as the final ack: task teardown frees the buffer

    def finished_ack(self) -> None:
        """Final ack freeing the server-side buffer (abort endpoint)."""
        try:
            url = f"{self.location}/results/{self.buffer_id}"
            req = urllib.request.Request(url, method="DELETE")
            urllib.request.urlopen(req, timeout=5.0).read()
        except Exception:
            pass  # buffer cleanup is best-effort; task teardown also frees it
        self.done = True


class StreamingRemoteSource(ConnectorPageSource):
    """Page source over N upstream task locations — the worker-side endpoint of
    a fragment's RemoteSourceNode (ExchangeOperator.java:35 analogue). Iterating
    round-robins the locations, yielding pages as frames arrive; exhausts when
    every location reports complete."""

    # reads long-poll upstream tasks: must never step on the shared pool
    external_wait = True

    def __init__(self, locations: Sequence[str], buffer_id: int,
                 types: Sequence[Type],
                 dicts: Sequence[Optional[Dictionary]],
                 page_capacity: int,
                 cancelled: Optional[threading.Event] = None,
                 error_budget_s: float = _MAX_ERROR_S):
        self._lock = threading.Lock()
        self.clients = [PageBufferClient(loc, buffer_id,
                                         error_budget_s=error_budget_s)
                        for loc in locations]
        self.types = list(types)
        self.dicts = list(dicts)
        self.page_capacity = page_capacity
        self.cancelled = cancelled

    def can_reset_location(self, old_location: str) -> bool:
        """Would a rewire of `old_location` be sound right now? (the check
        half of SqlTask.update_sources' check-then-apply)"""
        old = old_location.rstrip("/")
        with self._lock:
            for client in self.clients:
                if client.location == old:
                    return client.can_reset()
        return False

    def reset_location(self, old_location: str, new_location: str) -> bool:
        """Rewire the client pulling `old_location` to a replacement
        producer, cursor preserved (mid-stream rewires are sound under the
        chunk protocol); False only when no client matches that location."""
        old = old_location.rstrip("/")
        with self._lock:
            for client in self.clients:
                if client.location == old:
                    return client.reset_location(new_location)
        return False

    def __iter__(self) -> Iterator[Page]:
        # bounded idle wait replacing the old 10ms busy-spin: a stalled
        # producer backs the consumer off exponentially (capped), any
        # progress heals the streak
        idle = Backoff(max_failure_interval_s=float("inf"),
                       initial_delay_s=0.005, max_delay_s=0.1, min_tries=1)
        while True:
            with self._lock:
                live = [c for c in self.clients if not c.done]
            if not live:
                return
            if self.cancelled is not None and self.cancelled.is_set():
                raise RuntimeError("task cancelled while reading exchange")
            progressed = False
            for c in live:
                # short poll while multiple sources are live so one slow
                # producer cannot starve the others; the tail drains long-polled
                frame = c.poll(timeout_s=0.2 if len(live) > 1 else 10.0)
                if frame:
                    progressed = True
                    for page in deserialize_pages(frame, self.types, self.dicts,
                                                  self.page_capacity):
                        yield page
                if c.complete:
                    c.finished_ack()
            if progressed:
                idle.success()
            else:
                idle.failure()
                idle.wait()

    def close(self) -> None:
        # a CANCELLED consumer must NOT send final acks: the DELETE would
        # release the producer-side buffer (and its replay spool) that this
        # task's replacement — same buffer id, fresh cursor — still needs.
        # On the abort path the producers are torn down too, which frees
        # their buffers without any ack.
        if self.cancelled is not None and self.cancelled.is_set():
            return
        with self._lock:
            clients = list(self.clients)
        for c in clients:
            if not c.complete:
                c.finished_ack()


class MergingRemoteSource(ConnectorPageSource):
    """N-way merge over per-producer LOCALLY-SORTED streams — the HTTP-tier
    distributed sort (operator/MergeOperator.java + MergeSortedPages): each
    upstream task sorted its own rows (plan_subplan inserts the local
    SortNode under MERGE outputs), so the consumer only heap-merges K
    ordered streams instead of re-sorting the full row set.

    `orderings`: [(channel, descending, nulls_first)]; varchar channels
    compare by dictionary rank (Dictionary.sort_keys), exactly like the
    engine's sort operators."""

    # reads long-poll upstream tasks: must never step on the shared pool
    external_wait = True

    def __init__(self, locations: Sequence[str], buffer_id: int,
                 types: Sequence[Type],
                 dicts: Sequence[Optional[Dictionary]],
                 page_capacity: int,
                 orderings: Sequence[tuple],
                 cancelled: Optional[threading.Event] = None,
                 error_budget_s: float = _MAX_ERROR_S):
        self.locations = list(locations)
        self.buffer_id = buffer_id
        self.types = list(types)
        self.dicts = list(dicts)
        self.page_capacity = page_capacity
        self.orderings = list(orderings)
        self.cancelled = cancelled
        self.error_budget_s = error_budget_s
        self._lock = threading.Lock()
        self._started = False
        self._inner: List[StreamingRemoteSource] = []

    def can_reset_location(self, old_location: str) -> bool:
        old = old_location.rstrip("/")
        with self._lock:
            if self._started:
                inner = list(self._inner)
            else:
                return any(loc.rstrip("/") == old for loc in self.locations)
        return any(src.can_reset_location(old) for src in inner)

    def reset_location(self, old_location: str, new_location: str) -> bool:
        """Rewire one producer stream to a replacement. Before the merge
        starts this just swaps the location; after, it delegates to the
        per-stream inner source, whose chunk cursor makes the mid-stream
        rewire sound — the heap has consumed exactly the frames below that
        cursor, and already-deserialized rows stay buffered in the merge."""
        old = old_location.rstrip("/")
        with self._lock:
            for i, loc in enumerate(self.locations):
                if loc.rstrip("/") == old:
                    self.locations[i] = new_location
            if self._started:
                inner = list(self._inner)
            else:
                return any(loc.rstrip("/") == new_location.rstrip("/")
                           for loc in self.locations)
        return any(src.reset_location(old, new_location) for src in inner)

    def _row_iter(self, src: "StreamingRemoteSource"):
        """-> (sort key, row values tuple, row nulls tuple) per live row."""
        from ..exec.grouped import _Cmp, _Neg, _Null

        _NULLV = _Null()
        ranks = {}
        for ch, _d, _nf in self.orderings:
            d = self.dicts[ch]
            if d is None:
                continue
            if hasattr(d, "values"):
                ranks[ch] = np.asarray(d.sort_keys())
            elif not getattr(d, "monotonic", False):
                raise NotImplementedError(
                    f"distributed ORDER BY over non-monotonic virtual dictionary {d!r}")
        for page in src:
            mask = page.mask.numpy()
            datas = [b.data.numpy() for b in page.blocks]
            nulls = [None if b.nulls is None else b.nulls.numpy()
                     for b in page.blocks]
            for i in np.flatnonzero(mask):
                key = []
                for ch, desc, nf in self.orderings:
                    isnull = nulls[ch] is not None and nulls[ch][i]
                    if isnull:
                        key.append((0 if nf else 1, _NULLV))
                    else:
                        v = datas[ch][i]
                        if ch in ranks:
                            v = ranks[ch][int(v)]
                        key.append((1 if nf else 0,
                                    _Neg(v) if desc else _Cmp(v)))
                yield (tuple(key),
                       tuple(d[i] for d in datas),
                       tuple(False if n is None else bool(n[i])
                             for n in nulls))

    def __iter__(self) -> Iterator[Page]:
        import heapq

        from ..block import Block, Page as _Page

        with self._lock:
            # materialize one inner source per producer BEFORE marking
            # started: a rewire arriving from here on always finds a live
            # per-stream cursor to delegate to (no lazy-creation race)
            for loc in self.locations:
                self._inner.append(StreamingRemoteSource(
                    [loc], self.buffer_id, self.types, self.dicts,
                    self.page_capacity, cancelled=self.cancelled,
                    error_budget_s=self.error_budget_s))
            self._started = True
            inner = list(self._inner)
        merged = heapq.merge(*(self._row_iter(src) for src in inner),
                             key=lambda t: t[0])
        ncols = len(self.types)
        buf_vals: List[list] = [[] for _ in range(ncols)]
        buf_nulls: List[list] = [[] for _ in range(ncols)]
        n = 0

        def flush():
            blocks = []
            for c in range(ncols):
                data = np.asarray(buf_vals[c],
                                  dtype=self.types[c].np_dtype)
                nm = np.asarray(buf_nulls[c], dtype=bool)
                blocks.append(Block(self.types[c], torch.from_numpy(data),
                                    torch.from_numpy(nm) if nm.any() else None,
                                    self.dicts[c]))
            return _Page(tuple(blocks), torch.ones(n, dtype=torch.bool))

        for _key, vals, nls in merged:
            for c in range(ncols):
                buf_vals[c].append(vals[c])
                buf_nulls[c].append(nls[c])
            n += 1
            if n >= self.page_capacity:
                yield flush()
                buf_vals = [[] for _ in range(ncols)]
                buf_nulls = [[] for _ in range(ncols)]
                n = 0
        if n:
            yield flush()

    def close(self) -> None:
        # release producer-side buffers promptly on cancellation: an
        # unclosed stream would leave producers parked in OutputBuffer
        # backpressure until its timeout. Best-effort per stream — one
        # unreachable worker must not strand the remaining producers
        for src in self._inner:
            try:
                src.close()
            except Exception:
                pass  # close of the remaining streams is best-effort
