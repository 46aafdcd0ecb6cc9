"""Table scan: connector host pages -> device pages -> filter/project.

Counterpart of ``presto_tpu/ops/scan.py`` ``TableScanOperator``:

- With ``scan_pipeline`` (the default) the scan reads its source through
  the staged pipeline of ``ops/scan_pipeline.py``: a reader, the
  re-batching or passthrough stage and an upload stage on background
  threads (the shared scan pool), bounded by in-flight bytes. Without it
  the scan reads and copies each page on the driver's thread; that serial
  path is the differential oracle of the pipeline. (The reference's
  ``scan_pipeline=False`` still stages, passthrough only; for a source
  without ``split_readers``, such as TPC-H, both give the same pages.)
- The resident page cache (``RESIDENT_CACHE``) keeps a deterministic
  source's uploaded pages (``ConnectorPageSource.cache_token``) across
  queries, keyed by the token and the device: a later scan with the same
  token replays them, with no generation and no upload. Nothing on the
  scan path may change a page's tensors in place, or a replay would read
  the change.
- Narrow wire dtypes are widened to the declared types on the device
  (``_widen_page``), then the scan's own filter/project runs, compiled
  once against the table's column dictionaries: its output blocks carry
  those, whatever dictionary objects the stored pages hold.
- A scan given a ``ready`` poll (a UNION's replay of its branches'
  buffers) reports itself blocked through ``is_blocked()`` until the poll
  is true, so the task executor parks its driver instead of spinning.
"""
from __future__ import annotations

import threading
from typing import Callable, Iterator, List, Optional

import torch

from ..block import Block, Page, torch_dtype
from ..spi.connector import ConcatPageSource, ConnectorPageSource
from ..types import Type
from .filter_project import PageProcessor
from .operator import Operator, OperatorFactory, timed
from .scan_pipeline import ScanPipeline, page_nbytes, upload_page


class _ResidentPageCache:
    """Bounded LRU of uploaded device pages per (cache token, device).
    Eviction drops whole streams, least recently used first; dropping the
    last reference frees the device memory."""

    def __init__(self, max_bytes: int = 6 << 30):
        self.max_bytes = max_bytes
        self._pages = {}
        self._order: list = []
        self._bytes = 0
        self._lock = threading.Lock()

    def get(self, token):
        with self._lock:
            hit = self._pages.get(token)
            if hit is not None:
                self._order.remove(token)
                self._order.append(token)
            return hit

    def put(self, token, pages) -> None:
        size = sum(page_nbytes(p) for p in pages)
        if size > self.max_bytes:
            return
        with self._lock:
            if token in self._pages:
                return
            while self._bytes + size > self.max_bytes and self._order:
                old = self._order.pop(0)
                self._bytes -= sum(page_nbytes(p) for p in self._pages.pop(old))
            self._pages[token] = list(pages)
            self._order.append(token)
            self._bytes += size

    def clear(self) -> None:
        with self._lock:
            self._pages.clear()
            self._order.clear()
            self._bytes = 0


RESIDENT_CACHE = _ResidentPageCache()


def _widen_page(page: Page) -> Page:
    """Device-side upcast of narrow wire blocks to their declared dtypes
    (a new tensor where the dtype differs, the same one where it does not:
    no operator changes a page's tensors in place)."""
    blocks = []
    for b in page.blocks:
        want = torch_dtype(b.type)
        data = b.data if b.data.dtype == want else b.data.to(want)
        blocks.append(Block(b.type, data, b.nulls, b.dictionary))
    return Page(tuple(blocks), page.mask.to(torch.bool))


class TableScanOperator(Operator):
    def __init__(self, context, source: ConnectorPageSource, types: List[Type],
                 processor: Optional[PageProcessor], device: torch.device,
                 scan_options: Optional[dict] = None, ready=None):
        super().__init__(context)
        self.source = source
        self._ready = ready  # None = always ready; else polled before reading
        self._types = types
        self.processor = processor
        self.device = device
        # planner-resolved knobs: staged (scan_pipeline), reader threads,
        # target rows, prefetch bytes, pool key
        self._scan_options = scan_options or {}
        self._pipeline: Optional[ScanPipeline] = None
        self._pipeline_stats: Optional[dict] = None
        self._iter: Optional[Iterator[Page]] = None
        self._done = False
        token = getattr(source, "cache_token", None)
        self._cache_token = None if token is None else (token, torch.device(device))
        self._replay: Optional[Iterator[Page]] = None
        self._collected: Optional[List[Page]] = None
        self._collected_bytes = 0
        # replayed pages, for QueryResult.stats["scan_pipeline"]
        self.resident_hits = 0
        if self._cache_token is not None:
            hit = RESIDENT_CACHE.get(self._cache_token)
            if hit is not None:
                self._replay = iter(hit)
            else:
                self._collected = []

    def is_blocked(self):
        """A replay scan blocks until its producers have finished: under the
        threaded executor, pipeline order does not imply completion order."""
        if self._ready is None:
            return None
        if self._ready():
            self._ready = None
            return None
        return self._ready

    @property
    def output_types(self) -> List[Type]:
        return self.processor.output_types if self.processor else self._types

    def needs_input(self) -> bool:
        return False  # source operator

    def add_input(self, page: Page) -> None:
        raise RuntimeError("table scan takes no input")

    def _next_uploaded(self) -> Optional[Page]:
        if self._replay is not None:
            page = next(self._replay, None)
            if page is not None:
                self.resident_hits += 1
            return page
        opts = self._scan_options
        if opts.get("staged", True):
            if self._pipeline is None:
                self._pipeline = ScanPipeline(
                    self.source, self.device,
                    reader_threads=opts.get("reader_threads"),
                    target_rows=opts.get("target_rows"),
                    prefetch_bytes=opts.get("prefetch_bytes"),
                    pool_key=opts.get("pool_key"),
                    # prefetched bytes are the query's user memory
                    memory=self.context.memory.user.new_local_memory_context("scan_prefetch"))
            page = self._pipeline.next()
        else:
            if self._iter is None:
                self._iter = iter(self.source)
            page = next(self._iter, None)
            if page is not None:
                page = upload_page(page, self.device)
        if self._collected is not None:
            if page is None:
                # the stream ended without an error: keep it for later scans
                RESIDENT_CACHE.put(self._cache_token, self._collected)
                self._collected = None
            else:
                # a stream too big for the cache stops collecting as it
                # goes, so it does not pin its pages until the end
                self._collected_bytes += page_nbytes(page)
                if self._collected_bytes > RESIDENT_CACHE.max_bytes // 2:
                    self._collected = None
                else:
                    self._collected.append(page)
        return page

    @timed("get_output_ns")
    def get_output(self) -> Optional[Page]:
        if self._done:
            return None
        page = self._next_uploaded()
        if page is None:
            self._done = True
            self.source.close()
            return None
        self.context.record_input(page, page.capacity)
        page = _widen_page(page)
        if self.processor is not None:
            # the plan-time layout, as the reference's scan kernel: every
            # page leaves the scan bound to the table's own dictionaries
            # (a memory table's CTAS pages carry their source's, whose codes
            # the table's copy shares)
            page = self.processor._process(page)
        self.context.record_output(page, page.capacity)
        return page

    def is_finished(self) -> bool:
        return self._done or self._finishing

    def pipeline_stats(self) -> Optional[dict]:
        """Per-stage busy/stall seconds and counts of this scan's pipeline
        (None when the scan replayed resident pages or read serially). It
        outlives close(), so the runner can roll it up."""
        if self._pipeline is not None:
            return self._pipeline.stats()
        return self._pipeline_stats

    def close(self) -> None:
        if self._pipeline is not None:
            self._pipeline_stats = self._pipeline.stats()
            # stops every stage and waits for them (bounded)
            self._pipeline.close()
            self._pipeline = None
        super().close()


class TableScanOperatorFactory(OperatorFactory):
    """Each create_operator(worker) call consumes the next unclaimed page
    source of that worker. ``page_sources`` maps a worker to its sources (a
    worker's splits, or its exchange pages); ``sources_per_worker`` is the
    count of splits one worker scans, the most drivers the scan can feed.
    ``set_parallelism(n)`` deals each worker's splits into n sources, one
    per driver; ``parallel_drivers`` is the driver count the plan creates
    per worker. ``ready``, when given, maps a worker to the poll its scans
    wait on. Worker w's pages go to ``worker_device(w)``."""

    def __init__(self, operator_id: int, page_sources: Callable[[int], list],
                 types: List[Type], processor: Optional[PageProcessor], device: torch.device,
                 ready=None, sources_per_worker: int = 1):
        super().__init__(operator_id, "TableScan")
        self._ready = ready
        self._sources_fn = page_sources
        self.sources_per_worker = max(1, sources_per_worker)
        self._remaining: dict = {}
        self._types = types
        self._processor = processor
        self.device = torch.device(device)
        # session-resolved pipeline knobs (the planner sets them)
        self.scan_options: Optional[dict] = None
        self.parallel_drivers = 1
        # a filter runs in the scan: a join after it may coalesce its pages
        self.has_filter = processor is not None and processor.filter is not None

    def set_parallelism(self, n: int) -> None:
        """Deal each worker's splits round-robin into ``n`` concatenated
        sources, so ``n`` drivers each scan a share (split g goes to driver
        g mod n)."""
        base = self._sources_fn

        def dealt(w):
            leaves = _leaves(base(w))
            return [ConcatPageSource(leaves[g::n]) for g in range(n)]
        self._sources_fn = dealt

    def create_operator(self, worker: int = 0) -> Operator:
        if worker not in self._remaining:
            self._remaining[worker] = list(self._sources_fn(worker))
        return TableScanOperator(self.context(worker), self._remaining[worker].pop(0),
                                 self._types, self._processor, self.worker_device(worker),
                                 self.scan_options,
                                 ready=self._ready(worker) if self._ready else None)


def _leaves(sources) -> List[ConnectorPageSource]:
    out = []
    for s in sources:
        out.extend(s.sources if isinstance(s, ConcatPageSource) else [s])
    return out
