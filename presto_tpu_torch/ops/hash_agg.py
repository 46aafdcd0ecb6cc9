"""Grouped aggregation of the PyTorch port: the sort strategy, SINGLE step.

Counterpart of ``presto_tpu/ops/hash_agg.py`` ``GroupedAggregationBuilder`` on
its sort path: each page is grouped by a stable lexicographic sort of its
key columns (adjacent-difference group boundaries, then a segment reduce per
state column) into a partial table; pending partials are folded into one
compact table by the same sort kernel. SQL NULL keys group as their own key
(a null flag rides beside every key column). The direct and global builders,
the hash-table grouping, the PARTIAL/FINAL steps and spill are not ported
yet.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..block import Block, Dictionary, Page, torch_dtype
from ..types import BOOLEAN, Type
from .aggregates import MAX, MIN, SUM, AggregateCall
from .operator import Operator, OperatorContext, OperatorFactory, timed
from .sorting import lexsort_fast

SINGLE = "single"


def _segment_reduce(kind: str, values: torch.Tensor, seg_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Reduce ``values`` into ``num_segments`` segments; empty segments hold
    0 for SUM and the dtype's extreme for MIN/MAX, as ``jax.ops.segment_*``."""
    idx = seg_ids.long()
    if kind == SUM:
        out = torch.zeros(num_segments, dtype=values.dtype, device=values.device)
        return out.index_add_(0, idx, values)
    if kind not in (MIN, MAX):
        raise ValueError(kind)
    info = torch.finfo if values.is_floating_point() else torch.iinfo
    if values.is_floating_point():
        fill = float("inf") if kind == MIN else float("-inf")
    else:
        fill = info(values.dtype).max if kind == MIN else info(values.dtype).min
    out = torch.full((num_segments,), fill, dtype=values.dtype, device=values.device)
    return out.scatter_reduce_(0, idx, values, "amin" if kind == MIN else "amax")


def _null_safe_keys(page: Page, key_channels) -> Tuple[torch.Tensor, ...]:
    """Interleaved (value, is_null) tensors per key channel: the value is
    zeroed under NULL, so two NULL keys always collide and never with 0."""
    out = []
    for c in key_channels:
        b = page.blocks[c]
        if b.nulls is not None:
            flag = b.nulls
            data = b.data.masked_fill(flag, 0)
        else:
            flag = torch.zeros(page.mask.shape, dtype=torch.bool, device=page.device)
            data = b.data
        out.append(data)
        out.append(flag)
    return tuple(out)


def _call_contributions(calls, page: Page):
    """Per-row state contributions for every call; a NULL input row
    contributes nothing."""
    datas = tuple(b.data for b in page.blocks)
    contribs = []
    for call in calls:
        args = tuple(datas[c] for c in call.input_channels)
        m = page.mask
        for c in call.input_channels:
            if page.blocks[c].nulls is not None:
                m = m & ~page.blocks[c].nulls
        if call.mask_channel is not None:
            mc = datas[call.mask_channel].to(torch.bool)
            if page.blocks[call.mask_channel].nulls is not None:
                mc = mc & ~page.blocks[call.mask_channel].nulls
            m = m & mc
        contribs.extend(call.function.input_map(args, m))
    return contribs


def sort_group_reduce(keys: Tuple[torch.Tensor, ...], mask: torch.Tensor,
                      contribs: Tuple, kinds: Tuple[str, ...],
                      identities: Tuple, out_groups: int):
    """Group rows by ``keys`` (exact, multi-column) and reduce ``contribs``.

    Returns (group_keys, group_states, group_valid_mask, num_groups); groups
    are in key order and ``group_valid_mask`` is a prefix. Invalid rows and
    groups beyond ``out_groups`` land in a trash segment.
    """
    n = mask.shape[0]
    dev = mask.device
    order = lexsort_fast(tuple(reversed(keys)) + (~mask,)).long()
    sk = tuple(k[order] for k in keys)
    sv = mask[order]
    sc = tuple(c[order] for c in contribs)
    first = torch.zeros(n, dtype=torch.bool, device=dev)
    first[:1] = True
    diff = torch.zeros(n, dtype=torch.bool, device=dev)
    for k in sk:
        diff = diff | (k != torch.roll(k, 1))
    new_group = sv & (first | diff)
    gid = torch.cumsum(new_group.to(torch.int32), 0, dtype=torch.int32) - 1
    num_groups = gid[-1] + 1 if n > 0 else torch.zeros((), dtype=torch.int32, device=dev)
    gid = torch.where(sv, gid, out_groups)  # trash bin
    gid = torch.clamp(gid, max=out_groups)  # overflow also lands in the bin
    states = [_segment_reduce(kind, c, gid, out_groups + 1)[:out_groups]
              for kind, c in zip(kinds, sc)]
    # group keys: the first sorted row of each group
    first_row = _segment_reduce(MIN, torch.arange(n, dtype=torch.int32, device=dev),
                                gid, out_groups + 1)[:out_groups]
    safe = torch.clamp(first_row, 0, max(n - 1, 0)).long()
    gkeys = tuple(k[safe] for k in sk)
    gvalid = torch.arange(out_groups, device=dev) < torch.clamp(num_groups, max=out_groups)
    # empty-group states hold identities so MIN/MAX never leak sentinels
    fixed = tuple(torch.where(gvalid, s, ident) for s, ident in zip(states, identities))
    return gkeys, fixed, gvalid, num_groups


def _pow2(n: int) -> int:
    return 1 << max(4, (n - 1).bit_length())


class GroupedAggregationBuilder:
    """Sort-strategy accumulator: per-page partials folded into a compact table."""

    def __init__(self, key_types: Sequence[Type], calls: Sequence[AggregateCall],
                 max_groups: int = 1 << 20, device="cuda"):
        # internal key signature interleaves a BOOLEAN null flag per key
        self.key_types = [x for t in key_types for x in (t, BOOLEAN)]
        self.calls = list(calls)
        self.max_groups = max_groups
        self.kinds = tuple(col.reduce for c in calls for col in c.function.state)
        self.identities = tuple(col.identity for c in calls for col in c.function.state)
        self._key_channels: Tuple[int, ...] = ()
        self._acc = None          # (keys, states, valid) compact table
        self._pending: List = []  # (keys, states, valid) partials
        self._pending_rows = 0
        self._table_size: Optional[int] = None
        self._device = torch.device(device)

    def set_channels(self, key_channels: Sequence[int]) -> "GroupedAggregationBuilder":
        self._key_channels = tuple(key_channels)
        return self

    def add_page(self, page: Page) -> None:
        keys = _null_safe_keys(page, self._key_channels)
        contribs = _call_contributions(self.calls, page)
        gkeys, gstates, gvalid, _ng = sort_group_reduce(
            keys, page.mask, tuple(contribs), self.kinds, self.identities,
            page.capacity)
        self._pending.append((gkeys, gstates, gvalid))
        self._pending_rows += int(gvalid.shape[0])
        if self._pending_rows >= 4 * self.max_groups:
            self._fold()

    def _fold(self) -> None:
        """Merge pending partials (+ the current table) into a fresh compact
        table, growing its size bucket until every group fits."""
        parts = self._pending + ([self._acc] if self._acc is not None else [])
        self._pending, self._pending_rows, self._acc = [], 0, None
        keys = tuple(torch.cat([p[0][i] for p in parts]) for i in range(len(self.key_types)))
        states = tuple(torch.cat([p[1][i] for p in parts]) for i in range(len(self.kinds)))
        valid = torch.cat([p[2] for p in parts])
        size = self._table_size or _pow2(min(int(valid.shape[0]), self.max_groups))
        while True:
            gkeys, gstates, gvalid, ngroups = sort_group_reduce(
                keys, valid, states, self.kinds, self.identities, size)
            n = int(ngroups)
            if n <= size or size >= self.max_groups:
                break
            size = min(_pow2(n), self.max_groups)  # grow and refold
        if n > self.max_groups:
            raise NotImplementedError(
                f"{n} groups exceed max_groups={self.max_groups}; spill is not ported yet")
        tight = min(_pow2(max(n, 1)), self.max_groups)
        if tight < size:
            gkeys = tuple(k[:tight] for k in gkeys)
            gstates = tuple(s[:tight] for s in gstates)
            gvalid = gvalid[:tight]
        self._table_size = tight
        self._acc = (gkeys, gstates, gvalid)

    def finish(self):
        """-> (keys, states, valid), compact (valid is a prefix)."""
        if self._pending:
            self._fold()
        if self._acc is None:  # empty input: zero groups
            dev = self._device
            keys = tuple(torch.zeros(0, dtype=torch_dtype(t), device=dev)
                         for t in self.key_types)
            states = tuple(torch.zeros(0, dtype=torch.float64, device=dev) for _ in self.kinds)
            return keys, states, torch.zeros(0, dtype=torch.bool, device=dev)
        out, self._acc, self._table_size = self._acc, None, None
        return out


class HashAggregationOperator(Operator):
    """SINGLE-step grouped aggregation: consumes rows, emits final values."""

    def __init__(self, context: OperatorContext, builder: GroupedAggregationBuilder,
                 key_channels: List[int], key_types: List[Type], key_dicts,
                 calls: List[AggregateCall], output_capacity: int):
        super().__init__(context)
        self.builder = builder.set_channels(key_channels)
        self.key_types = key_types
        self.key_dicts = key_dicts
        self.calls = calls
        self.output_capacity = output_capacity
        self._result_pages: Optional[List[Page]] = None

    @property
    def output_types(self) -> List[Type]:
        return list(self.key_types) + [c.function.output_type for c in self.calls]

    @timed("add_input_ns")
    def add_input(self, page: Page) -> None:
        self.context.record_input(page, page.capacity)
        self.builder.add_page(page)

    @timed("get_output_ns")
    def get_output(self) -> Optional[Page]:
        if self._result_pages:
            out = self._result_pages.pop(0)
            self.context.record_output(out, out.capacity)
            return out
        return None

    def is_finished(self) -> bool:
        return self._finishing and self._result_pages is not None and not self._result_pages

    def finish(self) -> None:
        super().finish()
        if self._result_pages is None:
            self._build_result()

    def _build_result(self) -> None:
        keys, states, valid = self.builder.finish()
        total = int(valid.sum())
        cap = self.output_capacity
        out_cols = []  # (type, data, dictionary, nulls)
        for i, (t, d) in enumerate(zip(self.key_types, self.key_dicts)):
            kv, kf = keys[2 * i], keys[2 * i + 1]
            out_cols.append((t, kv, d, kf if bool(kf.any()) else None))
        si = 0
        for call in self.calls:
            ncols = len(call.function.state)
            out = call.function.final_map(states[si: si + ncols])
            si += ncols
            nulls = None
            if isinstance(out, tuple):  # (data, null_mask) contract
                out, nulls = out
            out_cols.append((call.function.output_type,
                             out.to(torch_dtype(call.function.output_type)), None, nulls))
        pages = []
        for lo in range(0, max(total, 1), cap):
            blocks = [Block(t, _slice_pad(a, lo, cap).to(torch_dtype(t)),
                            None if nl is None else _slice_pad(nl, lo, cap), d)
                      for (t, a, d, nl) in out_cols]
            pages.append(Page(tuple(blocks), _slice_pad(valid, lo, cap)))
        self._result_pages = pages


def _slice_pad(a: torch.Tensor, lo: int, cap: int) -> torch.Tensor:
    """Rows [lo, lo + cap) of ``a``, zero-padded to ``cap``."""
    seg = a[lo:lo + cap]
    if seg.shape[0] < cap:
        seg = torch.cat([seg, torch.zeros(cap - seg.shape[0], dtype=a.dtype, device=a.device)])
    return seg


class HashAggregationOperatorFactory(OperatorFactory):
    def __init__(self, operator_id: int, key_channels, key_types,
                 key_dicts: Sequence[Optional[Dictionary]], calls, step: str,
                 page_capacity: int, max_groups: int = 1 << 20, device="cuda"):
        super().__init__(operator_id, f"HashAggregation({step})")
        if step != SINGLE:
            raise NotImplementedError(f"aggregation step {step} is not ported yet")
        if not key_types:
            raise NotImplementedError("global aggregation is not ported yet")
        self.key_channels = list(key_channels)
        self.key_types = list(key_types)
        self.key_dicts = list(key_dicts)
        self.calls = list(calls)
        self.page_capacity = page_capacity
        self.max_groups = max_groups
        self.device = torch.device(device)

    def create_operator(self) -> Operator:
        builder = GroupedAggregationBuilder(self.key_types, self.calls, self.max_groups,
                                            self.device)
        return HashAggregationOperator(self.context(), builder, self.key_channels,
                                       self.key_types, self.key_dicts, self.calls,
                                       self.page_capacity)
