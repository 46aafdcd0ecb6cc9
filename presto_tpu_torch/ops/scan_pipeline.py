"""Staged host->device streaming scan pipeline of the PyTorch port.

Counterpart of ``presto_tpu/ops/scan_pipeline.py``:

    split readers -> ordered staging -> re-batch -> upload -> consumer
    N readers        bytes-bounded      take_rows   pinned    the scan's
                     reorder buffer     pow2 pages  async     driver

- READ: a source that splits itself into row-range readers
  (``ConnectorPageSource.split_readers``) is read by several readers at
  once. A source without split support (the TPC-H connector) runs as ONE
  reader streaming its own pages through the same stages: the passthrough
  path, which keeps the source's page shapes.
- ORDER: read items enter a reorder buffer keyed ``(reader, seq)`` and the
  decode stage takes them in split order, so the output equals the serial
  reader's. Backpressure is by in-flight bytes; the item the decode stage
  needs next always passes a full budget, so readers that finish out of
  order cannot deadlock the pipeline.
- RE-BATCH: split chunks accumulate through ``utils/batching.take_rows``
  and leave as pages of exactly ``target_rows`` rows, the tail clamped to
  its pow2 capacity and masked.
- UPLOAD: its own stage copies each page to the device ahead of the
  consumer, bounded by the same byte budget on uploaded pages the consumer
  has not taken yet. On CUDA each host tensor is pinned
  (``Tensor.pin_memory``, PyTorch's caching host allocator, which keeps a
  block until its copy has ended) and copied with ``non_blocking=True`` on
  the thread's current stream, the device's default stream, which every
  consumer thread also uses, so the copy is ordered before any kernel that
  reads the page.

Every stage is a generator whose step does one bounded unit of work and
whose waits last at most ``shared_pools.STEP_WAIT_S``. With a pool key the
generators run on the process-wide ``SCAN_POOL`` under the query's
fairness slot; without one they run on dedicated threads. A stage that
raises puts ``(_ERR, exc)`` on the output queue (``_fail``), and the
consumer's ``next()`` raises it. ``stats()`` gives each stage's busy and
stall seconds and the counts, which the runner rolls into
``QueryResult.stats["scan_pipeline"]``. When the scan gives it a memory
context, the staged and uploaded-unconsumed bytes are the query's user
memory (``_account``): over ``query_max_memory_bytes`` the stage fails and
the consumer raises the limit's exception. The reference's trace spans,
metric counters and ``rebatch`` switch are not ported: the port re-batches
wherever a source has split readers and a target size.
"""
from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..block import Block, Page
from ..exec.shared_pools import AGAIN, SCAN_POOL, STEP_WAIT_S, WAIT
from ..utils.batching import clamp_capacity, take_rows

_DONE = object()   # per-reader end of stream in the reorder buffer
_EOS = object()    # pipeline end of stream on the output queue
_ERR = object()    # error marker on the output queue: (_ERR, exception)

# engine defaults, used wherever a knob is None or 0
DEFAULT_PREFETCH_BYTES = 256 << 20
DEFAULT_READER_THREADS = min(8, os.cpu_count() or 4)
_WAIT_S = 0.1      # close() re-checks at this cadence while it waits

_STAGE_KEYS = ("read_busy_s", "read_stall_s", "decode_busy_s",
               "decode_stall_s", "upload_busy_s", "upload_stall_s",
               "compute_stall_s")
_COUNT_KEYS = ("chunks", "pages", "rows", "bytes")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def page_nbytes(page: Page) -> int:
    """Bytes of a page's mask, data and null masks: the one size formula of
    the pipeline's budget and the resident cache."""
    n = _nbytes(page.mask)
    for b in page.blocks:
        n += _nbytes(b.data) + (_nbytes(b.nulls) if b.nulls is not None else 0)
    return n


@dataclasses.dataclass
class HostChunk:
    """Decoded rows of one split: live-only host column arrays (numpy).
    ``nulls[i]`` is None when column i has no null in the chunk."""

    cols: List[np.ndarray]
    nulls: List[Optional[np.ndarray]]
    types: Sequence
    dicts: Sequence
    rows: int
    nbytes: int

    @staticmethod
    def build(cols, nulls, types, dicts, rows: Optional[int] = None) -> "HostChunk":
        if rows is None:
            rows = len(cols[0]) if cols else 0
        nbytes = sum(int(c.nbytes) for c in cols) + \
            sum(int(n.nbytes) for n in nulls if n is not None)
        return HostChunk(list(cols), list(nulls), list(types), list(dicts), int(rows), nbytes)


class Rebatcher:
    """Accumulate chunks; emit host pages of exactly ``target_rows`` rows
    (all live), the stream's tail clamped to its pow2 capacity
    (``utils/batching.clamp_capacity``) and masked. The first chunk pins
    the schema: the split readers of one table share its dictionaries."""

    def __init__(self, target_rows: int):
        if target_rows <= 0:
            raise ValueError(f"target_rows must be > 0, got {target_rows}")
        self.target = int(target_rows)
        self._pend: List[List[np.ndarray]] = []
        self._rows = 0
        self._ncols: Optional[int] = None
        self._types: Optional[list] = None
        self._dicts: Optional[list] = None
        self._has_nulls: List[bool] = []
        # null masks are made only once a chunk with nulls arrives; the
        # pending null-free chunks then get all-false masks
        self._nulls_on = False

    def add(self, chunk: HostChunk) -> List[tuple]:
        """-> [(host Page, nbytes, rows)] of the full pages now ready."""
        if chunk.rows == 0:
            return []
        if self._ncols is None:
            self._ncols = len(chunk.cols)
            self._types = list(chunk.types)
            self._dicts = list(chunk.dicts)
            self._has_nulls = [False] * self._ncols
        for i, nl in enumerate(chunk.nulls):
            if nl is not None:
                self._has_nulls[i] = True
        if not self._nulls_on and any(nl is not None for nl in chunk.nulls):
            self._nulls_on = True
            for entry in self._pend:
                n = len(entry[0])
                entry.extend(np.zeros(n, dtype=bool) for _ in range(self._ncols))
        if self._ncols:
            # one entry = the columns, then their null masks once any column
            # has nulls, so one take_rows takes them in lockstep
            entry = [np.asarray(c) for c in chunk.cols]
            if self._nulls_on:
                for nl in chunk.nulls:
                    entry.append(np.asarray(nl) if nl is not None
                                 else np.zeros(chunk.rows, dtype=bool))
            self._pend.append(entry)
        self._rows += chunk.rows
        out = []
        while self._rows >= self.target:
            out.append(self._take(self.target, self.target))
        return out

    def flush(self) -> Optional[tuple]:
        """The stream's tail page (pow2-clamped capacity), or None."""
        if self._rows == 0:
            return None
        return self._take(self._rows, clamp_capacity(self._rows, self.target))

    def _take(self, rows: int, cap: int) -> tuple:
        ncols = self._ncols or 0
        arrays = take_rows(self._pend, rows) if ncols else []
        self._rows -= rows
        blocks = []
        for i in range(ncols):
            data = arrays[i]
            if len(data) < cap:
                data = np.concatenate([data, np.zeros(cap - len(data), dtype=data.dtype)])
            nl = None
            if self._nulls_on and self._has_nulls[i]:
                nl = arrays[ncols + i]
                if len(nl) < cap:
                    nl = np.concatenate([nl, np.zeros(cap - len(nl), dtype=bool)])
                nl = torch.from_numpy(np.ascontiguousarray(nl))
            blocks.append(Block(self._types[i], torch.from_numpy(np.ascontiguousarray(data)),
                                nl, self._dicts[i]))
        mask = torch.ones(cap, dtype=torch.bool) if rows == cap else torch.arange(cap) < rows
        page = Page(tuple(blocks), mask)
        return page, page_nbytes(page), rows


def upload_page(page: Page, device: torch.device) -> Page:
    """Copy a host page to ``device``: pinned and non-blocking on CUDA; on
    the CPU the tensors are returned as they are, and so are tensors already
    on the card (a UNION's replayed pages)."""
    if device.type != "cuda":
        return page

    def up(t):
        if t is None or t.device.type != "cpu":
            return t
        return t.pin_memory().to(device, non_blocking=True)

    blocks = tuple(Block(b.type, up(b.data), up(b.nulls), b.dictionary) for b in page.blocks)
    return Page(blocks, up(page.mask))


class ScanPipeline:
    """One page source driven through the read -> re-batch -> upload
    stages. ``next()`` is the consumer's call (None = exhausted);
    ``close()`` stops the stages and waits, bounded, for every stage step
    to end."""

    def __init__(self, source, device, *, reader_threads: Optional[int] = None,
                 target_rows: Optional[int] = None,
                 prefetch_bytes: Optional[int] = None, pool_key: Optional[str] = None,
                 memory=None):
        self._device = torch.device(device)
        self._memory = memory  # a LocalMemoryContext of the query's user memory
        self._target = int(target_rows) if target_rows else 0
        self._max_bytes = max(int(prefetch_bytes or DEFAULT_PREFETCH_BYTES), 1)
        # a source whose reads can block on outside progress would hold a
        # pool worker past the bounded step: it always gets its own threads
        if getattr(source, "external_wait", False):
            pool_key = None
        self._pool = SCAN_POOL.client(pool_key) if pool_key else None
        readers = None
        if self._target > 0:
            split = getattr(source, "split_readers", None)
            if split is not None:
                readers = split(self._target)
        if readers is None:
            # passthrough: one reader streams the source's own pages
            self._rebatch = False
            self._readers: List[Callable] = [lambda: iter(source)]
        else:
            self._rebatch = True
            self._readers = list(readers)
        self._n_threads = max(1, min(int(reader_threads or DEFAULT_READER_THREADS),
                                     len(self._readers) or 1))
        self._stop = threading.Event()
        self._cv = threading.Condition()   # reorder buffer + staging budget
        self._buf: dict = {}
        self._staged_bytes = 0
        self._needed = (0, 0)
        self._next_reader = 0
        self._upq: queue.Queue = queue.Queue()  # decode -> upload
        self._out: queue.Queue = queue.Queue()
        self._ocv = threading.Condition()  # uploaded-but-unconsumed budget
        self._out_bytes = 0
        self._error: Optional[BaseException] = None
        self._stats_lock = threading.Lock()
        self._stats = {k: 0.0 for k in _STAGE_KEYS}
        self._stats.update({k: 0 for k in _COUNT_KEYS})
        self._started = False
        self._live_gens = 0
        self._threads: List[threading.Thread] = []

    # ------------------------------------------------------------- consumer

    def next(self) -> Optional[Page]:
        """The next uploaded page, or None at the end of the stream. A wait
        here counts as ``compute_stall_s``: the consumer had nothing to
        work on."""
        if not self._started:
            self._start()
        t0 = time.perf_counter_ns()
        while True:
            try:
                item = self._out.get(timeout=STEP_WAIT_S)
                break
            except queue.Empty:
                with self._cv:
                    ended = self._live_gens == 0
                if ended and self._out.empty():
                    raise RuntimeError("scan pipeline stages ended without a result")
        self._add("compute_stall_s", (time.perf_counter_ns() - t0) / 1e9)
        if item is _EOS:
            self._out.put(_EOS)  # later next() calls return None too
            return None
        if isinstance(item, tuple) and item[0] is _ERR:
            self._out.put(item)  # sticky: every later call raises
            raise item[1]
        page, nbytes = item
        with self._ocv:
            self._out_bytes -= nbytes
            self._ocv.notify_all()
        self._account()
        return page

    def close(self, timeout_s: float = 2.0) -> None:
        """Stop every stage, drain the output and wait (bounded) for every
        stage generator to end; a stage still in a backend call after the
        bound is abandoned (daemon thread or dropped pool step)."""
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        with self._ocv:
            self._ocv.notify_all()
        self._upq.put(_EOS)  # wake an upload stage parked on its queue
        try:  # drop the uploaded pages nobody will take
            while True:
                self._out.get_nowait()
        except queue.Empty:
            pass
        deadline = time.perf_counter() + timeout_s
        with self._cv:
            while self._live_gens > 0:
                left = deadline - time.perf_counter()
                if left <= 0:
                    break
                self._cv.wait(min(left, _WAIT_S))
        for t in self._threads:
            t.join(timeout=max(0.0, deadline - time.perf_counter()))
        self._threads = [t for t in self._threads if t.is_alive()]
        if self._pool is not None:
            self._pool.release()
            self._pool = None
        if self._memory is not None:
            self._memory.close()  # the reservation goes with the prefetch

    def stats(self) -> dict:
        with self._stats_lock:
            return {k: (round(v, 6) if isinstance(v, float) else v)
                    for k, v in self._stats.items()}

    # --------------------------------------------------------------- stages

    def _start(self) -> None:
        self._started = True
        if not self._readers:
            self._out.put(_EOS)
            return
        gens = [self._reader_gen() for _ in range(self._n_threads)]
        gens.append(self._decode_gen())
        gens.append(self._upload_gen())
        with self._cv:
            self._live_gens = len(gens)
        if self._pool is not None:
            for g in gens:
                self._pool.submit(self._guard(g))
            return
        names = [f"scan-read-{i}" for i in range(self._n_threads)] + \
            ["scan-decode", "scan-upload"]
        for g, name in zip(gens, names):
            t = threading.Thread(target=self._drive, args=(self._guard(g),), name=name,
                                 daemon=True)
            t.start()
            self._threads.append(t)

    @staticmethod
    def _drive(gen) -> None:
        """Dedicated-thread scheduler: the generator's own bounded waits set
        the cadence."""
        for _ in gen:
            pass

    def _guard(self, gen):
        """Wrap a stage: route its failure to the consumer and retire it
        from the live count that close() waits on."""
        try:
            yield from gen
        except Exception as e:  # noqa: BLE001 - raised again in the consumer's next()
            self._fail(e)
        finally:
            with self._cv:
                self._live_gens -= 1
                self._cv.notify_all()

    def _account(self) -> None:
        """Publish the staged and uploaded-unconsumed bytes into the query's
        user memory; over the query's limit this raises, and the stage's
        guard hands the error to the consumer."""
        if self._memory is not None:
            with self._stats_lock:
                self._memory.set_bytes(self._staged_bytes + self._out_bytes)

    def _add(self, key: str, value) -> None:
        with self._stats_lock:
            self._stats[key] += value

    def _reader_gen(self):
        """Reader stage: claim split readers one at a time and admit their
        items to the reorder buffer under the byte budget."""
        while not self._stop.is_set():
            with self._cv:
                ri = self._next_reader
                if ri >= len(self._readers):
                    return
                self._next_reader = ri + 1
            it = iter(self._readers[ri]())
            seq = 0
            while True:
                t0 = time.perf_counter_ns()
                try:
                    item = next(it)
                except StopIteration:
                    break
                self._add("read_busy_s", (time.perf_counter_ns() - t0) / 1e9)
                nbytes = item.nbytes if isinstance(item, HostChunk) else page_nbytes(item)
                ok = yield from self._stage_put_gen(ri, seq, item, nbytes)
                if not ok:
                    return
                seq += 1
                yield AGAIN  # fairness checkpoint between items
            ok = yield from self._stage_put_gen(ri, seq, _DONE, 0)
            if not ok:
                return

    def _stage_put_gen(self, ri: int, seq: int, item, nbytes: int):
        """Admit one item to the reorder buffer under the byte budget; the
        item the decode stage needs next passes a full budget. False when
        the pipeline stopped."""
        key = (ri, seq)
        t0 = time.perf_counter_ns()
        while True:
            with self._cv:
                if self._stop.is_set():
                    return False
                if not (self._staged_bytes > 0
                        and self._staged_bytes + nbytes > self._max_bytes
                        and key != self._needed):
                    self._buf[key] = (item, nbytes)
                    self._staged_bytes += nbytes
                    self._cv.notify_all()
                    break
                self._cv.wait(STEP_WAIT_S)
            yield WAIT
        self._add("read_stall_s", (time.perf_counter_ns() - t0) / 1e9)
        self._account()
        return True

    def _stage_take_gen(self, ri: int, seq: int):
        """In-order take from the reorder buffer; None when stopped."""
        key = (ri, seq)
        t0 = time.perf_counter_ns()
        while True:
            with self._cv:
                self._needed = key
                self._cv.notify_all()
                if key in self._buf:
                    item, nbytes = self._buf.pop(key)
                    self._staged_bytes -= nbytes
                    self._cv.notify_all()
                    break
                if self._stop.is_set():
                    return None
                self._cv.wait(STEP_WAIT_S)
            yield WAIT
        self._add("decode_stall_s", (time.perf_counter_ns() - t0) / 1e9)
        self._account()
        return item

    def _decode_gen(self):
        """Decode stage: take the reorder buffer in split order, re-batch
        (split path) or pass pages on (passthrough), and hand them to the
        upload stage."""
        rb = Rebatcher(self._target) if self._rebatch else None
        for ri in range(len(self._readers)):
            seq = 0
            while True:
                item = yield from self._stage_take_gen(ri, seq)
                if item is None:
                    return  # stopped
                if item is _DONE:
                    break
                seq += 1
                if rb is not None:
                    t0 = time.perf_counter_ns()
                    batches = rb.add(item)
                    self._add("decode_busy_s", (time.perf_counter_ns() - t0) / 1e9)
                    self._add("chunks", 1)
                    for page, nbytes, rows in batches:
                        ok = yield from self._emit_gen(page, nbytes, rows)
                        if not ok:
                            return
                else:
                    # live rows from the host mask; a device page's capacity
                    # stands in (counting it would cost a sync)
                    rows = int(item.mask.sum()) if item.mask.device.type == "cpu" \
                        else item.capacity
                    ok = yield from self._emit_gen(item, page_nbytes(item), rows)
                    if not ok:
                        return
                yield AGAIN  # fairness checkpoint between items
        if rb is not None:
            tail = rb.flush()
            if tail is not None:
                ok = yield from self._emit_gen(*tail)
                if not ok:
                    return
        self._upq.put(_EOS)

    def _emit_gen(self, page: Page, nbytes: int, rows: int):
        """Admit a page to the upload stage under the budget on uploaded
        pages the consumer has not taken (a stall here means the consumer
        is the bottleneck: the healthy state)."""
        t0 = time.perf_counter_ns()
        while True:
            with self._ocv:
                if self._stop.is_set():
                    return False
                if not (self._out_bytes > 0 and self._out_bytes + nbytes > self._max_bytes):
                    self._out_bytes += nbytes
                    break
                self._ocv.wait(STEP_WAIT_S)
            yield WAIT
        self._add("upload_stall_s", (time.perf_counter_ns() - t0) / 1e9)
        self._account()
        self._upq.put((page, nbytes, rows))
        return True

    def _upload_gen(self):
        """Upload stage: copy each page to the device, apart from the
        re-batching, so host assembly and the copies overlap."""
        while True:
            try:
                item = self._upq.get(timeout=STEP_WAIT_S)
            except queue.Empty:
                if self._stop.is_set():
                    return
                yield WAIT
                continue
            if item is _EOS or self._stop.is_set():
                if self._error is None:  # a _fail already queued _ERR
                    self._out.put(_EOS)
                return
            page, nbytes, rows = item
            t0 = time.perf_counter_ns()
            dev = upload_page(page, self._device)
            self._add("upload_busy_s", (time.perf_counter_ns() - t0) / 1e9)
            with self._stats_lock:
                self._stats["pages"] += 1
                self._stats["rows"] += rows
                self._stats["bytes"] += nbytes
            self._out.put((dev, nbytes))
            yield AGAIN  # fairness checkpoint between uploads

    def _fail(self, e: BaseException) -> None:
        self._error = e
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        with self._ocv:
            self._ocv.notify_all()
        self._upq.put(_EOS)  # wake an upload stage parked on its queue
        self._out.put((_ERR, e))
