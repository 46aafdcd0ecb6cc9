"""Page coalescing after a selective filter: dense pages for the operators after it.

Counterpart of ``presto_tpu/ops/coalesce.py`` (``CoalesceOperator`` and its
factory). Pages have a fixed capacity and a row mask; a selective scan
filter leaves most rows of each page dead, and a join probe after it still
works on every row. This operator compacts each page (``block._compact``:
live rows first, in input order) and packs the live rows into an
accumulator, emitting only full pages and one tail, so the work after it
scales with the filter's survivors.

- ``_pack`` places the incoming rows at the accumulator's live count in a
  scratch twice the capacity; the offset is a device tensor, so packing
  reads nothing back. The first ``capacity`` rows are the page to emit, the
  rest the next accumulator. The host reads one flag per page: emit or not.
- The first page decides the mode, with one host read of its mask: above
  half live, packing cannot pay and every page passes through unchanged.
- A page of another capacity flushes the accumulator as a page of its own
  and restarts at the new capacity.

``DictionaryRemapOperator`` serves UNION: a branch whose dictionary is
not the union's maps its codes into the union dictionary, one gather per
remapped column, and every block leaves carrying the union dictionary.

The counters ``coalesce.pages_in`` and ``coalesce.pages_out`` are the
port's own; the reference has none.
"""
from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..block import Block, Page, _compact
from ..types import Type
from ..utils.metrics import METRICS
from .operator import Operator, OperatorContext, OperatorFactory, timed


def _pack(acc: Page, count, page: Page):
    """(accumulator, its live count, compacted incoming page) ->
    (page to emit, emit flag, new accumulator, new count). ``count`` is an
    int or a 0-d device tensor; the flag and the new count are 0-d device
    tensors."""
    cap = acc.capacity
    dev = acc.device
    n_in = page.mask.sum(dtype=torch.int64)
    # the incoming page's slot i lands at count + i of a 2C scratch
    pos = torch.arange(cap, dtype=torch.int64, device=dev) + count
    total = n_in + count
    emit = total >= cap
    out_blocks, rest_blocks = [], []
    for ab, pb in zip(acc.blocks, page.blocks):
        scratch = torch.cat([ab.data, torch.zeros_like(pb.data)])
        scratch[pos] = pb.data
        nulls = None
        if ab.nulls is not None or pb.nulls is not None:
            nulls = torch.cat([ab.null_mask(), torch.zeros_like(pb.null_mask())])
            nulls[pos] = pb.null_mask()
        out_blocks.append(Block(ab.type, scratch[:cap],
                                None if nulls is None else nulls[:cap], ab.dictionary))
        # without an emit the accumulator keeps the packed prefix
        keep = torch.where(emit, scratch[cap:], scratch[:cap])
        kn = None if nulls is None else torch.where(emit, nulls[cap:], nulls[:cap])
        rest_blocks.append(Block(ab.type, keep, kn, ab.dictionary))
    idx = torch.arange(cap, dtype=torch.int64, device=dev)
    out_mask = idx < torch.clamp(total, max=cap)
    new_count = torch.where(emit, total - cap, total)
    return (Page(tuple(out_blocks), out_mask), emit,
            Page(tuple(rest_blocks), idx < new_count), new_count)


class CoalesceOperator(Operator):
    #: live fraction above which packing cannot pay for itself
    PASSTHROUGH_SELECTIVITY = 0.5

    def __init__(self, context: OperatorContext, types: List[Type]):
        super().__init__(context)
        self._types = types
        self._acc: Optional[Page] = None
        self._count = None
        self._first_count: Optional[int] = None
        self._pending: List[Page] = []
        self._flushed = False
        self._mode: Optional[str] = None  # None (undecided) | "pack" | "pass"

    @property
    def output_types(self) -> List[Type]:
        return self._types

    def needs_input(self) -> bool:
        return not self._finishing and not self._pending

    @timed("add_input_ns")
    def add_input(self, page: Page) -> None:
        self.context.record_input(page, page.capacity)
        METRICS.count("coalesce.pages_in")
        if self._mode == "pass":
            self._pending.append(page)
            return
        if self._mode is None:
            # one host read per stream: a scan's selectivity is stationary
            mask = page.mask.cpu()
            if mask.double().mean().item() > self.PASSTHROUGH_SELECTIVITY:
                self._mode = "pass"
                self._pending.append(page)
                return
            self._mode = "pack"
            self._first_count = int(mask.sum())
        compacted = _compact(page)
        if self._acc is not None and self._acc.capacity != compacted.capacity:
            # a source of per-chunk capacities: flush, restart at the new one
            self._pending.append(self._acc)
            self._acc = None
        if self._acc is None:
            count = self._first_count
            if count is None:  # a restart after a capacity change
                count = int(compacted.mask.sum())
            self._first_count = None
            self._acc, self._count = compacted, count
            return
        out, emit, rest, new_count = _pack(self._acc, self._count, compacted)
        self._acc, self._count = rest, new_count
        if bool(emit):  # host read of the 1-byte flag; the page stays on the device
            self._pending.append(out)

    @timed("get_output_ns")
    def get_output(self) -> Optional[Page]:
        if self._pending:
            return self._emit(self._pending.pop(0))
        if self._finishing and not self._flushed:
            self._flushed = True
            if self._acc is not None:
                tail, self._acc = self._acc, None
                return self._emit(tail)
        return None

    def _emit(self, page: Page) -> Page:
        self.context.record_output(page, page.capacity)
        METRICS.count("coalesce.pages_out")
        return page

    def is_finished(self) -> bool:
        return self._finishing and self._flushed and not self._pending


class CoalesceOperatorFactory(OperatorFactory):
    def __init__(self, operator_id: int, types: List[Type]):
        super().__init__(operator_id, "Coalesce")
        self.types = types

    def create_operator(self, worker: int = 0) -> CoalesceOperator:
        return CoalesceOperator(self.context(worker), self.types)


class DictionaryRemapOperator(Operator):
    """Re-encode dictionary codes through per-channel remap tables (the UNION
    dictionary unification: a minority branch maps its codes into the union
    dictionary on the device, one gather per remapped column)."""

    def __init__(self, context: OperatorContext, types: List[Type],
                 remaps: Sequence[Optional[torch.Tensor]], target_dicts=None):
        super().__init__(context)
        self._types = types
        self._remaps = list(remaps)
        self._target_dicts = target_dicts or [None] * len(types)
        self._pending: List[Page] = []

    @property
    def output_types(self) -> List[Type]:
        return self._types

    def needs_input(self) -> bool:
        return not self._finishing and not self._pending

    @timed("add_input_ns")
    def add_input(self, page: Page) -> None:
        self.context.record_input(page, page.capacity)
        blocks = []
        for b, r, td in zip(page.blocks, self._remaps, self._target_dicts):
            # an explicit None test: a virtual dictionary has length 0
            if td is None:
                td = b.dictionary
            if r is None:
                # no codes to translate, but the block must still carry the
                # union dictionary: later page merges take the first block's
                # dictionary, and a NULL branch's block without one would
                # strip the decoding from the whole column
                blocks.append(b if td is b.dictionary else Block(b.type, b.data, b.nulls, td))
            else:
                codes = torch.clamp(b.data.to(torch.int64), 0, r.shape[0] - 1)
                blocks.append(Block(b.type, r[codes], b.nulls, td))
        self._pending.append(Page(tuple(blocks), page.mask))

    @timed("get_output_ns")
    def get_output(self) -> Optional[Page]:
        if self._pending:
            page = self._pending.pop(0)
            self.context.record_output(page, page.capacity)
            return page
        return None

    def is_finished(self) -> bool:
        return self._finishing and not self._pending


class DictionaryRemapOperatorFactory(OperatorFactory):
    """``remaps``: one int32 host array (old code -> union code) or None per
    channel, copied to each worker's device (default ``"cuda"``; raises
    without CUDA) once, not once per page; ``target_dicts``: the union
    dictionary per channel (None = keep)."""

    def __init__(self, operator_id: int, types: List[Type],
                 remaps: Sequence[Optional[np.ndarray]], target_dicts=None, device="cuda"):
        super().__init__(operator_id, "DictionaryRemap")
        self.device = resolve_device(device)
        self.types = types
        self.remaps = [None if r is None
                       else torch.from_numpy(np.ascontiguousarray(r, dtype=np.int32)).to(self.device)
                       for r in remaps]
        self._by_device = {self.device: self.remaps}
        self._lock = threading.Lock()
        self.target_dicts = target_dicts

    def remaps_on(self, device) -> List[Optional[torch.Tensor]]:
        """The remap tables on ``device`` (a worker's), copied on first use."""
        with self._lock:
            if device not in self._by_device:
                self._by_device[device] = [None if r is None else r.to(device)
                                           for r in self.remaps]
            return self._by_device[device]

    def create_operator(self, worker: int = 0) -> DictionaryRemapOperator:
        return DictionaryRemapOperator(self.context(worker), self.types,
                                       self.remaps_on(self.worker_device(worker)),
                                       self.target_dicts)
