"""Aggregation of the PyTorch port, SINGLE step: three builders.

Counterpart of ``presto_tpu/ops/hash_agg.py``; ``make_builder`` picks the
builder as the reference does:

1. GLOBAL (no GROUP BY, Q6): scalar states.
2. DIRECT (every key a small dictionary or boolean domain, Q1): a dense
   state table indexed by the linear key code.
3. GROUPED (Q3): each page is grouped by a stable lexicographic sort of its
   key columns into a partial table, and pending partials are folded into
   one compact table by the same sort. With ``hash_grouping`` on, pages
   after the first are grouped instead through the open-addressing insert
   (``ops/pallas_hash.insert_table``: the CUDA kernel on the card, its plain
   version on the CPU) into slot-indexed partials with holes, which the
   fold takes like any other partial.

SQL NULL keys group as their own key (a null flag rides beside every key
column). The PARTIAL/FINAL steps, vector states and spill are not ported
yet.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..block import _NP_TO_TORCH, Block, Dictionary, Page, torch_dtype
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


def _reduce_all(contribs, kinds, gid: torch.Tensor, out_groups: int) -> List[torch.Tensor]:
    """Reduce every contribution column into an (out_groups,) state; rows
    routed to the trash segment (gid == out_groups) are left out."""
    return [_segment_reduce(kind, c, gid, out_groups + 1)[:out_groups]
            for kind, c in zip(kinds, contribs)]


def _merge_tables(kinds, old, new) -> List[torch.Tensor]:
    """Element-wise combine of two same-shape state tables."""
    out = []
    for kind, a, b in zip(kinds, old, new):
        if kind == SUM:
            out.append(a + b)
        elif kind == MIN:
            out.append(torch.minimum(a, b))
        else:
            out.append(torch.maximum(a, b))
    return out


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
    states = _reduce_all(sc, kinds, gid, out_groups)
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
    """Sort-strategy accumulator: per-page partials folded into a compact
    table, with the reference's one-shot strategy pick from the first page."""

    compact_table = True  # finish() returns a prefix-valid table

    def __init__(self, key_types: Sequence[Type], calls: Sequence[AggregateCall],
                 max_groups: int = 1 << 20, device="cuda", hash_grouping: str = "off"):
        if hash_grouping not in ("off", "auto", "force"):
            raise ValueError(f"hash_grouping must be off|auto|force, got {hash_grouping!r}")
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
        # decided once from the first page's true group count
        # (_decide_strategy, one host sync): defer = groups ~ rows, so pages
        # go raw into the fold; _out_groups = later sort partials shrink to
        # the observed count (CPU only: it costs a sync per page);
        # _hash_slots = later pages group through the insert kernel
        self._defer: Optional[bool] = None
        self._out_groups: Optional[int] = None
        self._hash_grouping = hash_grouping
        self._hash_slots: Optional[int] = None

    def set_channels(self, key_channels: Sequence[int]) -> "GroupedAggregationBuilder":
        self._key_channels = tuple(key_channels)
        return self

    # --- per page ---------------------------------------------------------

    def _page_partial(self, page: Page, out_groups: int):
        keys = _null_safe_keys(page, self._key_channels)
        contribs = _call_contributions(self.calls, page)
        return sort_group_reduce(keys, page.mask, tuple(contribs), self.kinds,
                                 self.identities, out_groups)

    def add_page(self, page: Page) -> None:
        if self._defer is True:
            keys = _null_safe_keys(page, self._key_channels)
            self._append((keys, tuple(_call_contributions(self.calls, page)), page.mask),
                         page.capacity)
            return
        if self._hash_slots is not None:
            if self._absorb_hash_page(page):
                return
            # insert overflow: the sort kernel from here on, results stay exact
            self._hash_slots = None
        out_groups = self._page_out_groups(page.capacity)
        if not self.absorb_partial(self._page_partial(page, out_groups),
                                   page.capacity, out_groups):
            # the shrunken table overflowed: redo this page at full size
            out_groups = self._page_out_groups(page.capacity)
            if not self.absorb_partial(self._page_partial(page, out_groups),
                                       page.capacity, out_groups):
                raise AssertionError("a full-size partial cannot overflow")

    def _page_out_groups(self, capacity: int) -> int:
        return capacity if self._out_groups is None else min(capacity, self._out_groups)

    def absorb_partial(self, partial, capacity: int, out_groups: int) -> bool:
        """Install one page's (gkeys, gstates, gvalid, ng) partial. Returns
        False when a shrunken table overflowed: the caller recomputes the
        page at the then-reset full size."""
        gkeys, gstates, gvalid, ng = partial
        if out_groups < capacity:
            if int(ng) > out_groups:
                self._out_groups = None  # the data disproved the bound
                return False
        elif self._defer is None:
            self._decide_strategy(int(ng), capacity)
        self._append((gkeys, gstates, gvalid), int(gvalid.shape[0]))
        return True

    def _append(self, part, rows: int) -> None:
        self._pending.append(part)
        self._pending_rows += rows
        if self._pending_rows >= 4 * self.max_groups:
            self._fold()

    def _decide_strategy(self, first_ng: int, capacity: int) -> None:
        """The reference's one-shot adaptation from the first page's true
        group count. Groups ~ rows: defer pages as raw rows into the fold.
        Groups << rows: on the CPU, shrink later partials to the observed
        count. With hash grouping on, the same count sizes the insert's
        table: "force" engages wherever the table is correct, "auto" only
        where the shrunken-table heuristic engages (the CPU), as the
        reference engages on its CPU backend and not on the TPU."""
        self._defer = first_ng > capacity // 2
        if self._defer:
            return
        on_cpu = self._device.type == "cpu"
        if on_cpu and first_ng <= capacity // 8:
            self._out_groups = max(1024, _pow2(int(first_ng * 1.5) + 1))
        if self._hash_grouping != "off" and self._keys_hashable():
            friendly = capacity // 8 if self._hash_grouping == "auto" else capacity // 2
            # decline when the capped table cannot hold the count at load <= 0.25
            slot_cap = 1 << 16
            if first_ng <= min(friendly, slot_cap // 4) and \
                    (self._hash_grouping == "force" or on_cpu):
                self._hash_slots = max(1 << 10, _pow2(4 * first_ng))

    def _keys_hashable(self) -> bool:
        """The insert compares keys as int64 components: float keys (bit
        equality is not SQL equality on -0.0) stay on the sort path."""
        return all(np.issubdtype(np.dtype(t.np_dtype), np.integer)
                   or np.dtype(t.np_dtype) == np.bool_ for t in self.key_types)

    # --- insert-or-accumulate through the hash table -----------------------

    def _page_hash_partial(self, page: Page, slots: int):
        """One page -> a slot-indexed partial (gkeys, states, used, stats):
        the insert gives every live row its key's slot as the group id, the
        contributions reduce straight into the slot table, and the slot key
        components are the group keys. Unclaimed slots are holes that
        ``used`` masks; the fold routes them to its trash segment."""
        from . import pallas_hash as ph

        mask = page.mask
        keys = _null_safe_keys(page, self._key_channels)
        contribs = _call_contributions(self.calls, page)
        comps = torch.stack([k.to(torch.int64) for k in keys]).contiguous()
        slot_comps, slot_rows, gid, stats = ph.insert_table(comps, mask.contiguous(), slots)
        # masked and overflowed rows -> the trash segment (an overflow also
        # raises the stats flag, and the caller discards this partial)
        gid = torch.where(mask & (gid >= 0), gid, slots)
        states = _reduce_all(contribs, self.kinds, gid, slots)
        used = slot_rows >= 0
        gkeys = tuple(sc.to(torch_dtype(t)) for sc, t in zip(slot_comps, self.key_types))
        fixed = tuple(torch.where(used, st, torch.as_tensor(ident, dtype=st.dtype,
                                                             device=st.device))
                      for st, ident in zip(states, self.identities))
        return gkeys, fixed, used, stats

    def _absorb_hash_page(self, page: Page) -> bool:
        """Group one page through the insert. Returns False on an insert
        overflow (one host sync per page reads the flag): the caller re-runs
        the page through the sort kernel."""
        from ..utils.metrics import METRICS

        gkeys, states, used, stats = self._page_hash_partial(page, self._hash_slots)
        if int(stats[0]):
            METRICS.count("pallas.agg_fallbacks")
            return False
        METRICS.count("pallas.agg_pages")
        self._append((gkeys, states, used), int(used.shape[0]))
        return True

    # --- combine ----------------------------------------------------------

    def _fold(self) -> None:
        """Merge pending partials (+ the current table) into a fresh compact
        table, growing its size bucket until every group fits. Partials with
        holes (slot-indexed, or raw rows) fold like compact ones: their
        invalid rows go to the trash segment."""
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


class DirectAggregationBuilder:
    """Small-domain strategy: a dense state table indexed by the linear key
    code over the product of the key domains (one extra code per key for
    its NULL group). Its table has holes: ``valid`` marks the groups seen."""

    compact_table = False

    def __init__(self, key_types: Sequence[Type], domains: Sequence[int],
                 calls: Sequence[AggregateCall], device="cuda"):
        self.key_types = list(key_types)
        self.base_domains = [int(d) for d in domains]
        self.domains = [int(d) + 1 for d in domains]
        self.calls = list(calls)
        self.D = int(np.prod(self.domains))
        self.kinds = tuple(col.reduce for c in calls for col in c.function.state)
        self.state_cols = [col for c in calls for col in c.function.state]
        self._device = torch.device(device)
        self._key_channels: Tuple[int, ...] = ()
        self._table = None  # tuple of (D,) state tensors
        self._seen = None   # (D,) bool: the group occurred

    def set_channels(self, key_channels) -> "DirectAggregationBuilder":
        self._key_channels = tuple(key_channels)
        return self

    def add_page(self, page: Page) -> None:
        dev = page.device
        if self._table is None:
            self._table = tuple(torch.full((self.D,), col.identity,
                                           dtype=_NP_TO_TORCH[np.dtype(col.dtype)], device=dev)
                                for col in self.state_cols)
            self._seen = torch.zeros(self.D, dtype=torch.bool, device=dev)
        mask = page.mask
        gid = torch.zeros(mask.shape[0], dtype=torch.int32, device=dev)
        for ch, base, dom in zip(self._key_channels, self.base_domains, self.domains):
            code = torch.clamp(page.blocks[ch].data.to(torch.int32), 0, base - 1)
            if page.blocks[ch].nulls is not None:
                code = torch.where(page.blocks[ch].nulls, base, code)
            gid = gid * dom + code
        gid = torch.where(mask, gid, self.D)  # dead rows -> the trash segment
        contribs = _call_contributions(self.calls, page)
        parts = _reduce_all(contribs, self.kinds, gid, self.D)
        self._table = tuple(_merge_tables(self.kinds, self._table, parts))
        hits = _segment_reduce(SUM, mask.to(torch.int32), gid, self.D + 1)[:self.D]
        self._seen = self._seen | (hits > 0)

    def finish(self):
        """-> (interleaved (value, null flag) keys, states, seen)."""
        dev = self._device
        if self._table is None:
            keys = tuple(x for t in self.key_types
                         for x in (torch.zeros(0, dtype=torch_dtype(t), device=dev),
                                   torch.zeros(0, dtype=torch.bool, device=dev)))
            states = tuple(torch.zeros(0, dtype=torch.float64, device=dev) for _ in self.kinds)
            return keys, states, torch.zeros(0, dtype=torch.bool, device=dev)
        rem = torch.arange(self.D, dtype=torch.int32, device=self._seen.device)
        pairs = []
        for base, dom, t in zip(reversed(self.base_domains), reversed(self.domains),
                                reversed(self.key_types)):
            code = rem % dom
            flag = code == base
            pairs.append((torch.where(flag, 0, code).to(torch_dtype(t)), flag))
            rem = rem // dom
        keys = tuple(x for v, f in reversed(pairs) for x in (v, f))
        out = (keys, self._table, self._seen)
        self._table = self._seen = None
        return out


class GlobalAggregationBuilder:
    """No GROUP BY: one scalar state per state column."""

    compact_table = True

    def __init__(self, calls: Sequence[AggregateCall], device="cuda"):
        self.calls = list(calls)
        self.kinds = tuple(col.reduce for c in calls for col in c.function.state)
        self.state_cols = [col for c in calls for col in c.function.state]
        self._device = torch.device(device)
        self._state = None

    def set_channels(self, key_channels) -> "GlobalAggregationBuilder":
        return self

    def _identity_state(self, device):
        return tuple(torch.tensor(col.identity, dtype=_NP_TO_TORCH[np.dtype(col.dtype)],
                                  device=device) for col in self.state_cols)

    def add_page(self, page: Page) -> None:
        if self._state is None:
            self._state = self._identity_state(page.device)
        contribs = _call_contributions(self.calls, page)
        new = []
        for kind, c, st in zip(self.kinds, contribs, self._state):
            if kind == SUM:
                new.append(st + c.sum())
            elif kind == MIN:
                new.append(torch.minimum(st, c.min()))
            else:
                new.append(torch.maximum(st, c.max()))
        self._state = tuple(new)

    def finish(self):
        state = self._state if self._state is not None else self._identity_state(self._device)
        self._state = None
        states = tuple(s.reshape(1) for s in state)
        return (), states, torch.ones(1, dtype=torch.bool, device=states[0].device)


# the largest key-domain product the direct builder's dense table takes
DIRECT_DOMAIN_LIMIT = 1 << 16


def make_builder(key_types, key_domains, calls, max_groups: int = 1 << 20,
                 device="cuda", hash_grouping: str = "off"):
    """The reference's strategy pick: GLOBAL without keys, DIRECT when every
    key has a known small domain, GROUPED otherwise."""
    if not key_types:
        return GlobalAggregationBuilder(calls, device)
    if key_domains is not None and all(d is not None for d in key_domains) \
            and int(np.prod(key_domains)) <= DIRECT_DOMAIN_LIMIT:
        return DirectAggregationBuilder(key_types, key_domains, calls, device)
    return GroupedAggregationBuilder(key_types, calls, max_groups, device, hash_grouping)


class HashAggregationOperator(Operator):
    """SINGLE-step aggregation: consumes rows, emits final values."""

    def __init__(self, context: OperatorContext, builder, key_channels: List[int],
                 key_types: List[Type], key_dicts, calls: List[AggregateCall],
                 output_capacity: int):
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
        # a compact table is trimmed to its live groups; a direct table
        # keeps its (small) domain and the page masks carry liveness
        total = int(valid.sum()) if self.builder.compact_table else int(valid.shape[0])
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
                             out.to(torch_dtype(call.function.output_type)),
                             call.output_dictionary, nulls))
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
    """``key_domains`` (one size per key, or None) and ``hash_grouping``
    (off | auto | force) steer ``make_builder`` as the reference's planner
    steers it; the builder works on ``device``."""

    def __init__(self, operator_id: int, key_channels, key_types,
                 key_dicts: Sequence[Optional[Dictionary]], calls, step: str,
                 page_capacity: int, max_groups: int = 1 << 20, device="cuda",
                 key_domains: Optional[Sequence[Optional[int]]] = None,
                 hash_grouping: str = "off"):
        super().__init__(operator_id, f"HashAggregation({step})")
        if step != SINGLE:
            raise NotImplementedError(f"aggregation step {step} is not ported yet")
        self.key_channels = list(key_channels)
        self.key_types = list(key_types)
        self.key_dicts = list(key_dicts)
        self.calls = list(calls)
        self.page_capacity = page_capacity
        self.max_groups = max_groups
        self.device = torch.device(device)
        self.key_domains = key_domains
        self.hash_grouping = hash_grouping

    def create_operator(self) -> Operator:
        builder = make_builder(self.key_types, self.key_domains, self.calls,
                               self.max_groups, self.device, self.hash_grouping)
        return HashAggregationOperator(self.context(), builder, self.key_channels,
                                       self.key_types, self.key_dicts, self.calls,
                                       self.page_capacity)
