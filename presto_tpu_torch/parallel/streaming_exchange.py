"""Streaming mesh exchange: chunked inter-fragment exchanges while producers run.

Counterpart of ``presto_tpu/parallel/streaming_exchange.py``, the mesh
runner's default data plane (``streaming_exchange=True``):

- producer drivers of fragment F end in an :class:`ExchangeSinkOperator`
  whose pages go to per-worker CHUNK buffers of a fixed pow2 capacity;
- a pump dispatches one exchange per chunk (``parallel/exchange.py`` over
  the per-worker chunks) and delivers the routed rows to the consumers'
  per-worker queues as standard pages;
- delivery is double-buffered: chunk k is delivered after chunk k+1 was
  dispatched, so the compaction of one overlaps the routing of the other;
- REPARTITION/MERGE overflow rows (what ``repartition_by_pid`` would drop)
  come back as CARRY buffers fed into the next chunk, so skewed keys are
  correct by construction;
- in-flight bytes are bounded on both sides: producers park (BLOCKED, the
  task executor's poll) while staged plus undelivered bytes exceed
  ``exchange_inflight_bytes``, and a full consumer queue parks the pump.

The pump is a generator: its steps run on the shared ``EXCHANGE_POOL``
under the query's fairness slot, or on a dedicated thread when
``shared_pools`` is off. Every device op of the pump, the producers and the
consumers runs on its device's default stream (the current stream of every
thread here), so a tensor the pump hands to a consumer thread is ordered
before the consumer's kernels with no host synchronization; the pump's only
host reads are the batched live counts the reference syncs too.

MERGE exchanges fix their range splitters at the first dispatch and route
every chunk through the same ranges; the consumer fragment's per-worker sort
restores order within a worker.

Skew-aware routing (``skew_aware_exchange``, wired by
``parallel/runner._wire_skew`` onto the REPARTITION pair of a partitioned
INNER join): each side samples its own first chunk for heavy-hitter keys
and freezes them (:class:`SkewCoordinator`); a key hot on one side is split
round-robin over the partitions there and replicated to every partition on
the peer side, through a broadcast lane with its own capacity and carry.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..block import Block, Dictionary, Page, torch_dtype
from ..exec.shared_pools import AGAIN, EXCHANGE_POOL, STEP_WAIT_S, WAIT
from ..ops.hash_join import combined_key
from ..ops.local_exchange import LocalExchangeBuffer, LocalExchangeSource
from ..ops.operator import Operator, OperatorContext, OperatorFactory, timed
from ..ops.scan_pipeline import page_nbytes
from ..sql.planner.plan import BROADCAST, GATHER, MERGE, REPARTITION
from ..types import Type, is_string
from ..utils import trace
from ..utils.metrics import METRICS
from .exchange import (_scatter, broadcast_gather, gather_to_single, partition_ids,
                       range_partition_ids, repartition_by_pid_with_carry)
from .mesh import MeshContext

# ---------------------------------------------------------------------------
# exchange accounting, shared by both data planes (parallel/runner.py)
# ---------------------------------------------------------------------------

# process-wide: host_uploads counts pages that reached an exchange from host
# memory while their worker's device is not the host (must stay 0: fragment
# chains stay on the device); exchanges counts exchanges started
EXCHANGE_STATS = {"host_uploads": 0, "exchanges": 0}

_STATS_LOCK = threading.Lock()


class ExchangeStatsBook:
    """Per-query exchange counters (``QueryResult.stats["exchange"]``, and
    ``exchange.*`` metrics). Producer drivers, pumps and the runner write
    concurrently, hence the lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: Dict[str, float] = {}
        self.per_exchange: List[dict] = []

    def bump(self, name: str, delta: float = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + delta

    def add_exchange(self, entry: dict) -> None:
        with self._lock:
            self.per_exchange.append(entry)

    def snapshot(self) -> dict:
        with self._lock:
            out = {k: (round(v, 6) if isinstance(v, float) else v)
                   for k, v in self.counters.items()}
            if self.per_exchange:
                out["per_exchange"] = [dict(e) for e in self.per_exchange]
            return out


def record_exchange_stat(name: str, delta: int = 1,
                         book: Optional[ExchangeStatsBook] = None) -> None:
    """Bump the process-wide counter and, when given, the query's book."""
    with _STATS_LOCK:
        if name in EXCHANGE_STATS:
            EXCHANGE_STATS[name] += delta
    if book is not None:
        book.bump(name, delta)


def is_host_upload(page: Page, device: torch.device) -> bool:
    """A page whose rows lie in host memory while its worker's device is
    not the host: the data would cross host -> device in the exchange."""
    return torch.device(device).type != "cpu" and page.mask.device.type == "cpu"


def host_ints(tensors: Sequence[torch.Tensor]) -> List[int]:
    """0-d integer tensors -> Python ints, one host read per device."""
    out: List[Optional[int]] = [None] * len(tensors)
    by_dev: Dict[torch.device, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dev.setdefault(t.device, []).append(i)
    for dev, idx in by_dev.items():
        vals = torch.stack([tensors[i].to(torch.int64) for i in idx]).tolist()
        for i, v in zip(idx, vals):
            out[i] = int(v)
    return out


def _compact_pad(datas, nulls, mask: torch.Tensor, L: int):
    """(R,) columns + mask -> (L,) prefix-compacted columns + mask, on the
    inputs' device (rows past L are dropped; callers size L to the live
    count)."""
    tgt = torch.where(mask, torch.cumsum(mask.to(torch.int32), 0) - 1, L).clamp(max=L)
    return (tuple(_scatter(L, tgt, a) for a in datas),
            tuple(_scatter(L, tgt, n) for n in nulls),
            _scatter(L, tgt, mask))


def _range_key_for(data, nulls, type_, dictionary, descending: bool, nulls_first: bool):
    """One worker's MERGE routing key: the primary ORDER BY column as a
    monotone int64 or float64 code, the local sort's transform, so range
    routing and the per-worker sort agree on order."""
    x = data
    if is_string(type_) and dictionary is not None:
        if hasattr(dictionary, "values"):
            x = dictionary.sort_table("ranks", x.device)[x.long()]
        elif not getattr(dictionary, "monotonic", False):
            raise NotImplementedError(
                f"distributed ORDER BY over non-monotonic virtual dictionary {dictionary!r}")
    if x.is_floating_point():
        key = x.to(torch.float64)
        lo, hi = -float("inf"), float("inf")
    else:
        key = x.to(torch.int64)
        info = np.iinfo(np.int64)
        lo, hi = int(info.min) + 1, int(info.max)
    if descending:
        key = -key
    if nulls is not None:
        key = torch.where(nulls, torch.tensor(lo if nulls_first else hi, dtype=key.dtype,
                                              device=key.device), key)
    return key


def _pow2(n: int, floor: int = 1) -> int:
    return max(1 << (max(int(n), 1) - 1).bit_length(), floor)


def _combined(datas, nulls, key_idx) -> torch.Tensor:
    """The exchange's routing key: NULL-safe key columns combined as the
    join build hashes them."""
    return combined_key([torch.where(nulls[i], 0, datas[i].to(torch.int64)) for i in key_idx])


# default per-worker chunk rows and in-flight bytes; the session knobs
# exchange_chunk_rows / exchange_inflight_bytes override them. The
# reference's chunk is 2^12 rows, a collective's static shape on the TPU.
# Here a dispatch is host work (about 50 ms for four workers' 2^12-row
# chunks on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md section 6), so the
# chunk holds four of the runner's 2^14-row pages
DEFAULT_CHUNK_ROWS = 1 << 16
DEFAULT_INFLIGHT_BYTES = 1 << 28

# per-peer receive floor of the streaming repartition (carry-over makes a
# small capacity correct; it only costs dispatches under skew)
_MIN_STREAM_OUT_CAP = 1 << 6

# a hot key holds at least this fraction of the first chunk's sampled rows
SKEW_HOT_FRACTION = 0.4
# below this many sampled rows the first chunk says nothing about skew
SKEW_MIN_SAMPLE = 64
# the most hot keys a side keeps
SKEW_MAX_HOT = 8

BUILD_SIDE, PROBE_SIDE = "build", "probe"


class SkewCoordinator:
    """The frozen-hot-set handshake between one INNER join's build-side and
    probe-side exchanges. Each side freezes its own sample once (at its
    first dispatch, or empty at pump end or teardown, so the peer never
    hangs) and waits for the peer's before routing anything."""

    def __init__(self):
        self._freeze_lock = threading.Lock()
        self._events = {BUILD_SIDE: threading.Event(), PROBE_SIDE: threading.Event()}
        self._hot = {BUILD_SIDE: None, PROBE_SIDE: None}

    def freeze(self, side: str, hot_keys) -> None:
        # the pump's freeze and teardown's empty freeze race: the first wins
        with self._freeze_lock:
            if self._events[side].is_set():
                return
            self._hot[side] = np.asarray(hot_keys, dtype=np.int64)
            self._events[side].set()

    def frozen(self, side: str) -> bool:
        return self._events[side].is_set()

    def wait_peer(self, side: str, timeout: float) -> bool:
        peer = PROBE_SIDE if side == BUILD_SIDE else BUILD_SIDE
        return self._events[peer].wait(timeout)

    def plan(self, side: str):
        """-> (spray_keys, replicate_keys) for ``side``: build-hot keys split
        on the build side and replicate on the probe side; probe-hot keys
        (less any hot on the build side too) the other way round."""
        hb, hp = self._hot[BUILD_SIDE], self._hot[PROBE_SIDE]
        hp = np.setdiff1d(hp, hb)
        return (hb, hp) if side == BUILD_SIDE else (hp, hb)


def _fill_chunk(ch_d, ch_n, ch_m, count: int, pd, pn, pm, C: int):
    """(chunk state, page) -> (new chunk state, leftover page). A page's live
    rows append at chunk positions count.. ; rows past capacity C compact
    to the front of same-shape leftover buffers."""
    P = pm.shape[0]
    pos = count + torch.cumsum(pm.to(torch.int32), 0) - 1
    into = pm & (pos < C)
    tgt = torch.where(into, pos, C)

    def put(dst, src):  # rows that do not fit write the trash slot
        out = torch.cat([dst, dst.new_zeros(1)])
        out[tgt.long()] = src
        return out[:C]
    new_m = put(ch_m, into)
    new_d = tuple(put(d, p) for d, p in zip(ch_d, pd))
    new_n = tuple(put(x, p) for x, p in zip(ch_n, pn))
    left = pm & (pos >= C)
    ltgt = torch.where(left, torch.cumsum(left.to(torch.int32), 0) - 1, P)
    return (new_d, new_n, new_m, tuple(_scatter(P, ltgt, p) for p in pd),
            tuple(_scatter(P, ltgt, p) for p in pn), _scatter(P, ltgt, left))


class _Closed(Exception):
    """The pump's unwind signal for a close while it runs."""


class _ChunkState:
    """One worker's send chunk: fixed-capacity buffers and the fill count
    (rows are packed at the front, so ``count`` is the live prefix)."""

    __slots__ = ("datas", "nulls", "mask", "count")

    def __init__(self, datas, nulls, mask):
        self.datas = datas
        self.nulls = nulls
        self.mask = mask
        self.count = 0


class _QueuedPage:
    """A column batch waiting to be absorbed into a chunk. ``live`` is None
    until a batched host read resolves it; ``is_carry`` marks a carry
    buffer; ``charged_bytes`` is what ``add_page`` charged for the source
    page (0 for leftovers and carries), released when it is absorbed."""

    __slots__ = ("datas", "nulls", "mask", "live", "is_carry", "charged_bytes")

    def __init__(self, datas, nulls, mask, live=None, is_carry=False, charged_bytes=0):
        self.datas = datas
        self.nulls = nulls
        self.mask = mask
        self.live = live
        self.is_carry = is_carry
        self.charged_bytes = charged_bytes


class StreamingExchange:
    """Producer chunk buffers -> per-chunk exchange -> consumer queues.

    One per fragment boundary. Producer sinks call :meth:`add_page` and
    :meth:`producer_finished`; consumers read the per-worker buffer of
    :meth:`out_buffer`. The pump owns all the work between the two."""

    def __init__(self, mesh: MeshContext, fragment_id: int, kind: str,
                 key_idx: Optional[List[int]], types: Sequence[Type],
                 dicts: Sequence[Optional[Dictionary]], orderings=None, chunk_rows: int = 0,
                 inflight_bytes: int = 0, page_capacity: int = 1 << 14,
                 book: Optional[ExchangeStatsBook] = None, pool_key: Optional[str] = None,
                 memory=None):
        self.mesh = mesh
        self.fragment_id = fragment_id
        self.kind = kind
        self.key_idx = tuple(key_idx) if key_idx is not None else None
        self.types = list(types)
        self.dicts = list(dicts)
        self.orderings = orderings
        self.book = book
        W = mesh.n_workers
        self.W = W
        self.chunk_rows = _pow2(chunk_rows or DEFAULT_CHUNK_ROWS, floor=64)
        self.inflight_bytes = int(inflight_bytes or DEFAULT_INFLIGHT_BYTES)
        self.page_capacity = page_capacity
        if kind in (REPARTITION, MERGE):
            # a peer's slice of a chunk: twice the balanced share; overflow
            # carries over, so this trades dispatches against padding only
            self.out_cap = min(self.chunk_rows,
                               _pow2(-(-2 * self.chunk_rows // W), floor=_MIN_STREAM_OUT_CAP))
        else:
            self.out_cap = self.chunk_rows
        self._cv = threading.Condition()
        self._inbox: List[List[Page]] = [[] for _ in range(W)]
        self._inbox_bytes = 0
        self._open_producers: Optional[int] = None
        self._error: Optional[BaseException] = None
        self._closed = False
        # byte-bounded consumer queues: a slow consumer backpressures the
        # pump, and through it the producers
        per_worker_bytes = max(self.inflight_bytes // (2 * W), 1 << 16)
        self._out = [LocalExchangeBuffer(n_producers=1, max_bytes=per_worker_bytes)
                     for _ in range(W)]
        self._pump: Optional[threading.Thread] = None
        # with a pool key the pump runs as generator steps on EXCHANGE_POOL
        # under the query's fairness slot; None = a dedicated thread
        self._pool_key = pool_key
        self._pool = None
        self._pump_started = False
        self._pump_done = threading.Event()
        # staged and delivered-unconsumed bytes reserve as the query's user
        # memory, so exchange buffering competes with operator state
        self._memory = memory
        self._mem_lock = threading.Lock()
        self._recorder = trace.active()
        self._finished_ok = False
        self._skew: Optional[SkewCoordinator] = None
        self._skew_role: Optional[str] = None
        self._splitters: Optional[torch.Tensor] = None
        # partition_rows: live rows delivered per consumer partition (the
        # skew spread shows here)
        self.stats = {"fragment": fragment_id, "kind": kind, "chunk_rows": self.chunk_rows,
                      "out_cap": self.out_cap, "chunks": 0, "overlap_chunks": 0,
                      "rows_in": 0, "rows_out": 0, "carry_rows": 0, "dispatch_s": 0.0,
                      "overlap_s": 0.0, "stall_s": 0.0, "partition_rows": [0] * W,
                      "hot_keys": 0, "replicated_rows": 0}

    # ------------------------------------------------------------- lifecycle

    def set_skew(self, role: str, coordinator: SkewCoordinator) -> None:
        """Attach a skew side ("build" or "probe") before :meth:`start`."""
        assert role in (BUILD_SIDE, PROBE_SIDE), role
        self._skew_role = role
        self._skew = coordinator

    def start(self, n_producers: int) -> None:
        """Called once every producer sink exists (drivers are created before
        any runs, so the count is exact before a page flows)."""
        with self._cv:
            self._open_producers = n_producers
            self._cv.notify_all()
        record_exchange_stat("exchanges", 1, self.book)
        self._pump_started = True
        if self._pool_key:
            self._pool = EXCHANGE_POOL.client(self._pool_key)
            self._pool.submit(self._pump_steps())
            return
        self._pump = threading.Thread(target=self._pump_loop, daemon=True,
                                      name=f"exchange-pump-f{self.fragment_id}")
        self._pump.start()

    def close(self, error: Optional[BaseException] = None) -> None:
        """Tear down: wake every blocked party, poison the consumer queues
        (a consumer mid-stream raises instead of reading a truncated input)
        and wait for the pump to retire. Idempotent."""
        with self._cv:
            self._closed = True
            if error is not None and self._error is None:
                self._error = error
            self._cv.notify_all()
        if self._skew is not None:
            # the peer must never wait forever on a torn-down exchange
            self._skew.freeze(self._skew_role, np.zeros(0, dtype=np.int64))
        if error is not None or not self._finished_ok:
            exc = error or RuntimeError(
                f"streaming exchange (fragment {self.fragment_id}) closed "
                "before its stream completed")
            for b in self._out:
                b.poison(exc)
        if self._pump is not None:
            self._pump.join(timeout=10.0)
        elif self._pump_started:
            self._pump_done.wait(timeout=10.0)
        if self._pool is not None:
            self._pool.release()
            self._pool = None
        if self._memory is not None:
            with self._mem_lock:
                self._memory.close()

    def pumping(self) -> bool:
        """Started and not yet retired: the pump may still deliver."""
        return self._pump_started and not self._pump_done.is_set()

    # ---------------------------------------------------------- producer api

    def add_page(self, worker: int, page: Page) -> None:
        with self._cv:
            if self._error is not None:
                raise RuntimeError(
                    f"streaming exchange (fragment {self.fragment_id}) failed") from self._error
            if self._closed:
                raise RuntimeError(
                    f"streaming exchange (fragment {self.fragment_id}) is closed")
            self._inbox[worker].append(page)
            self._inbox_bytes += page_nbytes(page)
            self._cv.notify_all()
        # over the query's memory limit raises here, on the producer driver
        self._charge_memory()

    def has_capacity(self) -> bool:
        """The producers' backpressure poll; True on error or close too, so
        a parked sink wakes and meets the failure in add_input."""
        if self._error is not None or self._closed:
            return True
        out_bytes = sum(b.buffered_bytes() for b in self._out)
        with self._cv:
            return self._inbox_bytes + out_bytes < self.inflight_bytes

    def producer_finished(self) -> None:
        with self._cv:
            if self._open_producers is not None:
                self._open_producers -= 1
            self._cv.notify_all()

    # ---------------------------------------------------------- consumer api

    def out_buffer(self, worker: int) -> LocalExchangeBuffer:
        return self._out[worker]

    # -------------------------------------------------------------- the pump

    def _pump_loop(self) -> None:
        """The dedicated-thread scheduler (``shared_pools`` off)."""
        with trace.bound(self._recorder):
            for _ in self._pump_steps():
                pass

    def _pump_steps(self):
        """The pump's outer guard as a generator: one logic for both
        schedulers."""
        try:
            yield from self._pump_gen()
        except _Closed:
            pass  # close() already poisoned the consumer side
        except BaseException as e:  # noqa: BLE001 - relayed to both sides
            with self._cv:
                if self._error is None:
                    self._error = e
                self._cv.notify_all()
            for b in self._out:
                b.poison(e)
        else:
            self._finished_ok = True
            for b in self._out:
                b.producer_finished()
        finally:
            if self._skew is not None:
                # a stream that never dispatched has no skew to report
                self._skew.freeze(self._skew_role, np.zeros(0, dtype=np.int64))
            self._publish_stats()
            self._pump_done.set()

    def _check_live(self) -> None:
        with self._cv:
            if self._error is not None:
                raise self._error
            if self._closed:
                raise _Closed()

    def _charge_memory(self) -> None:
        """Publish staged + delivered-unconsumed bytes to the query memory
        context; raises the pool's limit error when over budget."""
        m = self._memory
        if m is None:
            return
        out_bytes = sum(b.buffered_bytes() for b in self._out)
        with self._cv:
            inbox = self._inbox_bytes
        with self._mem_lock:
            m.set_bytes(inbox + out_bytes)

    def _pump_gen(self):
        W = self.W
        devices = self.mesh.devices
        state = [self._fresh_chunk(w) for w in range(W)]
        queue: List[List[_QueuedPage]] = [[] for _ in range(W)]
        pending_delivery = None
        while True:
            with self._cv:
                idle = not any(self._inbox)
            if pending_delivery is not None and idle:
                # about to park: hand the in-flight chunk over now
                yield from self._deliver_gen(pending_delivery)
                pending_delivery = None
            with self._cv:
                t0 = time.perf_counter_ns()
                waited = False
                if not any(self._inbox) and \
                        (self._open_producers is None or self._open_producers > 0) and \
                        self._error is None and not self._closed:
                    # one bounded wait per step: a starved pump frees its
                    # pool thread every STEP_WAIT_S
                    self._cv.wait(timeout=STEP_WAIT_S)
                    waited = True
                    stalled = time.perf_counter_ns() - t0
                    self.stats["stall_s"] += stalled / 1e9
                    if stalled >= 1_000_000:
                        trace.record(trace.EXCHANGE, f"pump_stall f{self.fragment_id}",
                                     t0, stalled)
                drained = self._inbox
                self._inbox = [[] for _ in range(W)]
                producers_done = (self._open_producers is not None and
                                  self._open_producers <= 0)
            self._check_live()
            if waited and not any(drained) and not producers_done:
                yield WAIT
                continue
            for w in range(W):
                for p in drained[w]:
                    queue[w].append(self._page_columns(p, devices[w]))
            pending_delivery = yield from self._absorb_gen(state, queue, pending_delivery)
            if producers_done and not any(queue) and not any(s.count for s in state):
                break
            if producers_done and not any(self._inbox):
                # flush the partial chunks and the carry they generate
                while any(queue) or any(s.count for s in state):
                    self._check_live()
                    pending_delivery = yield from self._absorb_gen(
                        state, queue, pending_delivery, flush=True)
                break
        if pending_delivery is not None:
            yield from self._deliver_gen(pending_delivery)

    # ------------------------------------------------------------ page intake

    def _page_columns(self, page: Page, dev) -> _QueuedPage:
        """A page's columns on the worker's device, widened to the
        exchange's types; a page from host memory counts in host_uploads."""
        if is_host_upload(page, dev):
            record_exchange_stat("host_uploads", 1, self.book)
        datas, nulls = [], []
        for c, t in enumerate(self.types):
            b = page.blocks[c]
            datas.append(b.data.to(dev, torch_dtype(t)))
            nulls.append(b.nulls.to(dev) if b.nulls is not None else
                         torch.zeros(page.capacity, dtype=torch.bool, device=dev))
        return _QueuedPage(tuple(datas), tuple(nulls), page.mask.to(dev),
                           charged_bytes=page_nbytes(page))

    def _resolve_lives(self, queue, include_carry: bool = True) -> None:
        """Unknown live counts in one batched host read. Carry counts are
        outputs of the last dispatch; ``include_carry=False`` defers them
        until a carry entry is reached."""
        unknown = [e for q in queue for e in q
                   if e.live is None and (include_carry or not e.is_carry)]
        if not unknown:
            return
        for e, n in zip(unknown, host_ints([e.mask.sum() for e in unknown])):
            e.live = n
            if e.is_carry:
                self.stats["carry_rows"] += n

    def _fresh_chunk(self, w: int) -> _ChunkState:
        dev = self.mesh.devices[w]
        C = self.chunk_rows
        return _ChunkState(
            tuple(torch.zeros(C, dtype=torch_dtype(t), device=dev) for t in self.types),
            tuple(torch.zeros(C, dtype=torch.bool, device=dev) for _ in self.types),
            torch.zeros(C, dtype=torch.bool, device=dev))

    # ---------------------------------------------------------------- absorb

    def _absorb_gen(self, state, queue, pending_delivery, flush: bool = False):
        """Move queued pages into the chunks; dispatch whenever a worker's
        chunk is full with more rows waiting (or, flushing, whenever any
        rows remain). Returns the still-undelivered dispatch."""
        C = self.chunk_rows
        while True:
            self._check_live()
            self._resolve_lives(queue, include_carry=False)
            for w in range(self.W):
                st = state[w]
                while queue[w] and st.count < C:
                    if queue[w][0].live is None:
                        self._resolve_lives(queue)  # a carry reached the front
                    qp = queue[w].pop(0)
                    if qp.charged_bytes:
                        self._release_bytes(qp.charged_bytes)
                    if not qp.live:
                        continue
                    nd, nn, nm, ld, ln, lm = _fill_chunk(
                        st.datas, st.nulls, st.mask, st.count, qp.datas, qp.nulls, qp.mask, C)
                    st.datas, st.nulls, st.mask = nd, nn, nm
                    absorbed = min(C - st.count, qp.live)
                    st.count += absorbed
                    if not qp.is_carry:
                        self.stats["rows_in"] += absorbed
                    if qp.live > absorbed:
                        # the leftover goes back to the front; its count is
                        # known arithmetically
                        queue[w].insert(0, _QueuedPage(ld, ln, lm, live=qp.live - absorbed,
                                                       is_carry=qp.is_carry))
            must_dispatch = any(state[w].count >= C and queue[w] for w in range(self.W))
            if not must_dispatch and flush and any(s.count for s in state):
                must_dispatch = True
            if not must_dispatch:
                return pending_delivery
            if self._skew is not None:
                # freeze our sample, then wait (boundedly) for the peer's:
                # routing is defined once both sets froze
                if not self._skew.frozen(self._skew_role):
                    own = self._detect_hot(state)
                    self._skew.freeze(self._skew_role, own)
                    self.stats["hot_keys"] = int(len(own))
                while not self._skew.wait_peer(self._skew_role, timeout=STEP_WAIT_S):
                    self._check_live()
                    yield WAIT
            new_pending = self._dispatch(state, queue)
            # deliver the previous chunk now that this one is dispatched
            if pending_delivery is not None:
                yield from self._deliver_gen(pending_delivery)
            pending_delivery = new_pending
            yield AGAIN  # a fairness checkpoint between dispatches

    def _release_bytes(self, n: int) -> None:
        """An absorbed page stops counting against the in-flight budget."""
        with self._cv:
            self._inbox_bytes = max(0, self._inbox_bytes - n)
            self._cv.notify_all()
        self._charge_memory()

    # -------------------------------------------------------------- dispatch

    def _dispatch(self, state, queue):
        """Route the current chunks and queue the carry at the back of the
        absorb queue (its live count is resolved when it is reached).
        -> what :meth:`_deliver_gen` delivers."""
        W = self.W
        devices = self.mesh.devices
        t0 = time.perf_counter_ns()
        arrays = [list(st.datas) + list(st.nulls) for st in state]
        masks = [st.mask for st in state]
        carry = carry_masks = hot = None
        if self.kind == REPARTITION and self._skew is not None \
                and any(len(k) for k in self._skew.plan(self._skew_role)):
            out, out_masks, carry, carry_masks, hot = self._skew_route(arrays, masks)
        elif self.kind == REPARTITION:
            pids = [torch.where(m, partition_ids(self._key(st), W), W).to(torch.int32)
                    for st, m in zip(state, masks)]
            out, out_masks, carry, carry_masks = repartition_by_pid_with_carry(
                arrays, masks, pids, W, self.out_cap, devices)
        elif self.kind == MERGE:
            rkeys = self._merge_range_keys(state)
            pids = [range_partition_ids(rk, self._splitters, m, W)
                    for rk, m in zip(rkeys, masks)]
            out, out_masks, carry, carry_masks = repartition_by_pid_with_carry(
                arrays, masks, pids, W, self.out_cap, devices)
        elif self.kind == BROADCAST:
            out, out_masks = broadcast_gather(arrays, masks, devices)
        elif self.kind == GATHER:
            out, out_masks = gather_to_single(arrays, masks, devices)
        else:
            raise AssertionError(self.kind)
        with self._cv:
            producing = (self._open_producers or 0) > 0
        dt_ns = time.perf_counter_ns() - t0
        self.stats["chunks"] += 1
        chunk_no = self.stats["chunks"]
        self.stats["dispatch_s"] += dt_ns / 1e9
        if producing:
            self.stats["overlap_chunks"] += 1
            self.stats["overlap_s"] += dt_ns / 1e9
        trace.record(trace.EXCHANGE, f"chunk_dispatch f{self.fragment_id}", t0, dt_ns,
                     {"kind": self.kind, "chunk": chunk_no, "overlap": producing}
                     if trace.active() is not None else None)
        if self.book is not None:
            self.book.bump("chunks")
            if producing:
                self.book.bump("overlap_chunks")
        for w in range(W):
            state[w] = self._fresh_chunk(w)
        ncols = len(self.types)
        for cs, cms in ((carry, carry_masks), (hot[2] if hot else None, hot[3] if hot else None)):
            if cms is None:
                continue
            for w in range(W):
                queue[w].append(_QueuedPage(tuple(cs[w][:ncols]), tuple(cs[w][ncols:]),
                                            cms[w], is_carry=True))
        hot_part = (hot[0], hot[1]) if hot else None
        return out, out_masks, hot_part, t0, chunk_no

    def _key(self, st: _ChunkState) -> torch.Tensor:
        return _combined(st.datas, st.nulls, self.key_idx)

    def _skew_route(self, arrays, masks):
        """REPARTITION with hot keys: this side's hot rows spray round-robin
        over the partitions ((chunk + worker + i) mod W for the i-th hot row
        of a worker's chunk); the peer's hot rows replicate to every
        partition through a broadcast lane of ``out_cap`` rows per worker,
        with its own carry."""
        W = self.W
        devices = self.mesh.devices
        ncols = len(self.types)
        spray, repl = self._skew.plan(self._skew_role)
        chunk = self.stats["chunks"]
        hot_cap = self.out_cap
        pids, bases, hbufs, hmasks, hcarry, hcmasks = [], [], [], [], [], []
        for w in range(W):
            arrs, mask = arrays[w], masks[w]
            dev = mask.device
            n = mask.shape[0]
            ck = _combined(arrs[:ncols], arrs[ncols:], self.key_idx)
            spray_hot = mask & torch.isin(ck, torch.as_tensor(spray, device=dev))
            repl_hot = mask & ~spray_hot & torch.isin(ck, torch.as_tensor(repl, device=dev))
            pid = partition_ids(ck, W)
            hidx = torch.cumsum(spray_hot.to(torch.int32), 0) - 1
            pid = torch.where(spray_hot, ((chunk + w + hidx) % W).to(torch.int32), pid)
            base = mask & ~repl_hot
            pids.append(torch.where(base, pid, W).to(torch.int32))
            bases.append(base)
            hpos = torch.cumsum(repl_hot.to(torch.int32), 0) - 1
            into = repl_hot & (hpos < hot_cap)
            htgt = torch.where(into, hpos, hot_cap)
            hmasks.append(_scatter(hot_cap, htgt, into))
            hbufs.append([_scatter(hot_cap, htgt, a) for a in arrs])
            hover = repl_hot & ~into
            hct = torch.where(hover, torch.cumsum(hover.to(torch.int32), 0) - 1, n)
            hcmasks.append(_scatter(n, hct, hover))
            hcarry.append([_scatter(n, hct, a) for a in arrs])
        out, out_masks, carry, carry_masks = repartition_by_pid_with_carry(
            arrays, bases, pids, W, self.out_cap, devices)
        hout, hm = broadcast_gather(hbufs, hmasks, devices)
        return out, out_masks, carry, carry_masks, (hout, hm, hcarry, hcmasks)

    def _merge_range_keys(self, state) -> List[torch.Tensor]:
        """This chunk's routing keys per worker; the splitters fix at the
        first dispatch, so every later chunk routes through the same ranges."""
        ch, desc, nf = self.orderings[0]
        keys = [_range_key_for(st.datas[ch], st.nulls[ch], self.types[ch], self.dicts[ch],
                               desc, nf) for st in state]
        if self._splitters is None:
            samples = []
            for st, k in zip(state, keys):
                if st.count:
                    stride = max(1, st.count // 128)
                    samples.append(k[:st.count:stride][:128].cpu().numpy())
            pooled = np.sort(np.concatenate(samples)) if samples else \
                np.zeros(1, dtype=keys[0].cpu().numpy().dtype)
            self._splitters = torch.from_numpy(np.asarray(
                [pooled[len(pooled) * i // self.W] for i in range(1, self.W)],
                dtype=pooled.dtype))
        return keys

    def _detect_hot(self, state) -> np.ndarray:
        """Heavy hitters of the first chunk's staged rows (every worker's,
        one host read per worker, once per exchange): keys holding at least
        SKEW_HOT_FRACTION of the sample, the top SKEW_MAX_HOT by count."""
        samples = [self._key(st)[:st.count].cpu().numpy() for st in state if st.count]
        pooled = np.concatenate(samples) if samples else np.zeros(0, dtype=np.int64)
        if len(pooled) < SKEW_MIN_SAMPLE:
            return np.zeros(0, dtype=np.int64)
        uniq, counts = np.unique(pooled, return_counts=True)
        top = np.argsort(counts)[::-1][:SKEW_MAX_HOT]
        return uniq[top][counts[top] >= SKEW_HOT_FRACTION * len(pooled)].astype(np.int64)

    # -------------------------------------------------------------- delivery

    def _deliver_gen(self, dispatched):
        """Deliver one dispatch: its regular lane and, with replicated hot
        keys, the broadcast lane."""
        out, out_masks, hot_part, dispatch_t0, chunk_no = dispatched
        t0 = time.perf_counter_ns()
        yield from self._deliver_part(out, out_masks)
        if hot_part is not None:
            replicated = yield from self._deliver_part(*hot_part)
            self.stats["replicated_rows"] += replicated
        self._charge_memory()
        end = time.perf_counter_ns()
        METRICS.histogram("exchange.chunk_latency_s", (end - dispatch_t0) / 1e9)
        trace.record(trace.EXCHANGE, f"chunk_deliver f{self.fragment_id}", t0, end - t0,
                     {"chunk": chunk_no} if trace.active() is not None else None)

    def _deliver_part(self, out, out_masks):
        """One lane -> the consumer queues as standard pages, parking on a
        full queue. Returns the live rows delivered."""
        W, ncols = self.W, len(self.types)
        compacted = [_compact_pad(out[w][:ncols], out[w][ncols:], out_masks[w],
                                  out_masks[w].shape[0]) for w in range(W)]
        # one host read per device: every worker's live count and which
        # columns carry a NULL
        flags = [c for _, nn, m in compacted for c in [m.sum()] + [n.any() for n in nn]]
        vals = host_ints(flags)
        lives = [vals[w * (ncols + 1)] for w in range(W)]
        has_nulls = [vals[w * (ncols + 1) + 1:(w + 1) * (ncols + 1)] for w in range(W)]
        for w in range(W):
            live_w = lives[w]
            if not live_w:
                continue
            out_d, out_n, out_m = compacted[w]
            cap = min(max(self.page_capacity, 1 << 9), out_m.shape[0])
            for off in range(0, -(-live_w // cap) * cap, cap):
                blocks = tuple(Block(self.types[c], out_d[c][off:off + cap],
                                     out_n[c][off:off + cap] if has_nulls[w][c] else None,
                                     self.dicts[c]) for c in range(ncols))
                page = Page(blocks, out_m[off:off + cap])
                while not self._out[w].try_put(page, wait_s=STEP_WAIT_S):
                    self._check_live()
                    yield WAIT  # consumer backpressure parks the step
            self.stats["rows_out"] += live_w
            self.stats["partition_rows"][w] += live_w
            if self.book is not None:
                self.book.bump("rows", live_w)
                self.book.bump("pages", -(-live_w // cap))
        return sum(lives)

    def _publish_stats(self) -> None:
        if self.book is None:
            return
        entry = dict(self.stats)
        for k in ("dispatch_s", "overlap_s", "stall_s"):
            entry[k] = round(entry[k], 6)
        entry["partition_rows"] = list(self.stats["partition_rows"])
        if self._skew_role is not None:
            entry["skew_role"] = self._skew_role
        self.book.add_exchange(entry)
        for k in ("overlap_s", "stall_s", "dispatch_s", "carry_rows"):
            self.book.bump(k, self.stats[k])


# ---------------------------------------------------------------------------
# the consumer and producer operators
# ---------------------------------------------------------------------------

class StreamingExchangeSource(LocalExchangeSource):
    """A consumer over one worker's chunk queue. Closing abandons the queue:
    an early-finishing consumer (a satisfied LIMIT) must not leave a full
    queue wedging the pump and, through the budget, the producers."""

    def close(self) -> None:
        self.buffer.abandon()
        super().close()


class ExchangeSinkOperator(Operator):
    """Tail of a producer driver: pages go to the streaming exchange's
    staging. Parks BLOCKED while the exchange's in-flight budget is full."""

    def __init__(self, context: OperatorContext, exchange: StreamingExchange,
                 types: List[Type]):
        super().__init__(context)
        self.exchange = exchange
        self._types = types
        self._reported = False

    @property
    def output_types(self) -> List[Type]:
        return self._types

    def needs_input(self) -> bool:
        return super().needs_input() and self.exchange.has_capacity()

    def is_blocked(self):
        if self.exchange.has_capacity():
            return None
        return self.exchange.has_capacity

    @timed("add_input_ns")
    def add_input(self, page: Page) -> None:
        self.context.record_input(page, page.capacity)
        self.exchange.add_page(self.context.worker, page)

    def get_output(self) -> Optional[Page]:
        return None

    def finish(self) -> None:
        if not self._reported:
            self._reported = True
            self.exchange.producer_finished()
        super().finish()

    def close(self) -> None:
        self.finish()
        super().close()

    def is_finished(self) -> bool:
        return self._finishing


class ExchangeSinkOperatorFactory(OperatorFactory):
    """The sink of a non-root fragment in streaming mode; ``created`` counts
    its operators, the exchange's exact producer count."""

    def __init__(self, operator_id: int, exchange: StreamingExchange, types: List[Type]):
        super().__init__(operator_id, "ExchangeSink")
        self.exchange = exchange
        self.types = types
        self.created = 0

    def create_operator(self, worker: int = 0) -> Operator:
        self.created += 1
        return ExchangeSinkOperator(self.context(worker), self.exchange, self.types)
