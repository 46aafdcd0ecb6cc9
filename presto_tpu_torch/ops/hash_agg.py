"""Aggregation of the PyTorch port: three builders, three steps.

Counterpart of ``presto_tpu/ops/hash_agg.py``; ``make_builder`` picks the
builder as the reference does (a GROUP BY with a collecting aggregate takes
``ops/collect_agg.CollectAggregationBuilder`` instead):

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
column). Each builder also offers its per-page step as a pure function for
a fused pipeline segment's terminal stage (``ops/fused_segment.py``): the
grouped builder's sort partial (``_page_partial``) or raw rows in defer
mode (``_page_raw``), installed by ``absorb_partial``/``absorb_raw``; the
DIRECT and GLOBAL builders' ``_accumulate(page, state)``, with
``init_state``/``absorb_state``.

When a fold finds more live groups than ``max_groups``, the grouped builder
moves the fold's complete inputs to host RAM (the reference's host-RAM
spill rung) and keeps accumulating; ``finish`` then merges the spilled
parts exactly on the host (``_host_merge_parts``), and the operator pages
the host result onto the device one output page at a time. Each such fold
counts ``agg.spilled_folds``.

A vector (sketch) state is a (groups, width) table: a row's contribution is
a (bucket, value) pair scattered into it (``_reduce_contrib``), and such a
grouping keeps at most ``WIDE_STATE_MAX_GROUPS`` groups on the device,
spilling the rest as above; it never takes the insert. An AMIN/AMAX column
and the ACARRY columns after it (min_by/max_by) reduce jointly in every
builder and in the host merge: the extreme ordering key, then the payload
of the first row holding it, an earlier partial winning a tie.

Under memory pressure the grouped builder accounts its device bytes
(``memory_bytes``, from row counts and dtypes) and, when the operator is
asked to revoke, moves every pending partial and its table to host RAM
(``spill``), where ``finish`` merges them with the rest, as a fold above
``max_groups`` does. When the query has a disk tier (``attach_spill``), the
same revocation goes on to disk (``spill_to_disk``): the host partials are
merged, hash-partitioned on their keys (``_key_row_hash``) and written as
sorted, partially reduced PCOL runs, one per partition; the partition count
grows with the observed rows (``_adapt_disk_parts``). ``finish`` then
merges partition by partition (``_merge_disk``), so the host holds one
partition at a time. A sketch grouping (a vector state, under the wide cap)
keeps its partials in host RAM, as in the reference.

Steps, as the reference wires them: SINGLE consumes rows and emits final
values; PARTIAL consumes rows and emits ``[keys..., state columns...]``
(each call's ``intermediate_types``); FINAL consumes those state columns
(``AggregateCall.intermediate_channels``) and emits final values. A FINAL
builder reads state columns as its contributions (``from_intermediate``);
the GLOBAL builder fills a dead row's with the state's identity.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..block import _NP_TO_TORCH, Block, Dictionary, Page, torch_dtype
from ..exec.spill import storage_type_for
from ..types import BOOLEAN, Type
from ..utils import kernel_cache
from ..utils.metrics import METRICS
from .aggregates import ACARRY, AMAX, AMIN, MAX, MIN, SUM, AggregateCall
from .operator import Operator, OperatorContext, OperatorFactory, timed
from .sorting import lexsort_fast

PARTIAL, FINAL, SINGLE = "partial", "final", "single"


def _builder_key(tag, b, input_dicts) -> tuple:
    """Cache identity of a builder's static config (everything its page
    function reads from the builder) plus its input's dictionary versions."""
    return ("agg", tag,
            tuple(t.name for t in getattr(b, "key_types", ())),
            getattr(b, "_key_channels", None),
            tuple(getattr(b, "domains", ())),
            b.from_intermediate,
            tuple(kernel_cache.dict_key(d) for d in input_dicts),
            tuple(kernel_cache.agg_call_key(c) for c in b.calls))


def _segment_reduce(kind: str, values: torch.Tensor, seg_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Reduce ``values`` (rows, or rows x width) into ``num_segments``
    segments along the rows; empty segments hold 0 for SUM and the dtype's
    extreme for MIN/MAX, as ``jax.ops.segment_*``."""
    if values.dtype == torch.bool:
        return _segment_reduce(kind, values.to(torch.uint8), seg_ids, num_segments) \
            .to(torch.bool)
    idx = seg_ids.long()
    shape = (num_segments,) + tuple(values.shape[1:])
    if kind == SUM:
        out = torch.zeros(shape, dtype=values.dtype, device=values.device)
        return out.index_add_(0, idx, values)
    if kind not in (MIN, MAX):
        raise ValueError(kind)
    if values.is_floating_point():
        fill = float("inf") if kind == MIN else float("-inf")
    else:
        info = torch.iinfo(values.dtype)
        fill = info.max if kind == MIN else info.min
    if values.dim() > 1:
        idx = idx.view(-1, *([1] * (values.dim() - 1))).expand_as(values)
    out = torch.full(shape, fill, dtype=values.dtype, device=values.device)
    return out.scatter_reduce_(0, idx, values, "amin" if kind == MIN else "amax")


WIDE_STATE_MAX_GROUPS = 1 << 13  # group-table bound of the sketch (vector) states


def _state_widths(calls) -> Tuple[int, ...]:
    return tuple(col.width for c in calls for col in c.function.state)


def _empty_state(widths, device) -> Tuple[torch.Tensor, ...]:
    """Zero-group state tensors matching each column's width."""
    return tuple(torch.zeros((0, w) if w > 1 else 0, dtype=torch.float64, device=device)
                 for w in widths)


def _reduce_contrib(kind: str, c, gid: torch.Tensor, num_segments: int, width: int,
                    ident) -> torch.Tensor:
    """Reduce one contribution column into a (num_segments[, width]) state.
    A vector state's contribution is a (bucket, value) pair per row that
    lands in state[group, bucket]; a bucket of ``width`` (a masked row) is
    dropped, into one trash cell past the flattened table (an index out of
    range raises on the CPU and is undefined on the card). Plain columns,
    also 2-D states being re-grouped, reduce along the rows."""
    if isinstance(c, tuple):
        bucket, vals = c
        cells = num_segments * width
        flat = gid.to(torch.int64) * width + bucket.to(torch.int64)
        flat = torch.where(bucket.to(torch.int64) < width, flat, cells)
        base = torch.full((cells + 1,), ident, dtype=vals.dtype, device=vals.device)
        if kind == SUM:
            base.index_add_(0, flat, vals)
        else:
            base.scatter_reduce_(0, flat, vals, "amin" if kind == MIN else "amax")
        return base[:cells].view(num_segments, width)
    return _segment_reduce(kind, c, gid, num_segments)


def _reduce_all(contribs, kinds, identities, widths, gid: torch.Tensor,
                out_groups: int) -> List[torch.Tensor]:
    """Reduce every contribution column into an (out_groups[, width]) state;
    rows routed to the trash segment (gid == out_groups) are left out. An
    AMIN/AMAX column and the ACARRY columns after it reduce jointly: the
    segment's least (greatest) ordering key, then the payload of its FIRST
    row that holds it (min_by/max_by)."""
    n_seg = out_groups + 1
    states = []
    i = 0
    while i < len(kinds):
        kind = kinds[i]
        if kind in (AMIN, AMAX):
            y = contribs[i]
            m = _segment_reduce(MIN if kind == AMIN else MAX, y, gid, n_seg)
            nr = y.shape[0]
            idx = torch.arange(nr, dtype=torch.int64, device=y.device)
            best = torch.where(y == m[gid.long()], idx, nr)
            win = torch.clamp(_segment_reduce(MIN, best, gid, n_seg), 0, max(nr - 1, 0))
            states.append(m[:out_groups])
            i += 1
            while i < len(kinds) and kinds[i] == ACARRY:
                c = contribs[i]
                states.append(c[win][:out_groups] if nr else
                              torch.full((out_groups,), identities[i], dtype=c.dtype,
                                         device=c.device))
                i += 1
            continue
        states.append(_reduce_contrib(kind, contribs[i], gid, n_seg, widths[i],
                                      identities[i])[:out_groups])
        i += 1
    return states


def _merge_tables(kinds, old, new) -> List[torch.Tensor]:
    """Element-wise combine of two same-shape state tables, joint over the
    AMIN/AMAX + ACARRY pairs: the new side wins only when strictly better,
    so the earlier partial keeps a tie."""
    out = []
    i = 0
    while i < len(kinds):
        kind = kinds[i]
        if kind in (AMIN, AMAX):
            better = (new[i] < old[i]) if kind == AMIN else (new[i] > old[i])
            out.append(torch.where(better, new[i], old[i]))
            i += 1
            while i < len(kinds) and kinds[i] == ACARRY:
                out.append(torch.where(better, new[i], old[i]))
                i += 1
            continue
        a, b = old[i], new[i]
        if kind == SUM:
            out.append(a + b)
        elif kind == MIN:
            out.append(torch.minimum(a, b))
        else:
            out.append(torch.maximum(a, b))
        i += 1
    return out


def _where_valid(gvalid: torch.Tensor, s: torch.Tensor, ident) -> torch.Tensor:
    """Identity-fill the invalid group slots, over vector states too."""
    cond = gvalid[:, None] if s.dim() == 2 else gvalid
    return torch.where(cond, s, torch.as_tensor(ident, dtype=s.dtype, device=s.device))


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


def _call_contributions(calls, page: Page, from_intermediate: bool = False):
    """Per-row state contributions for every call; a NULL input row
    contributes nothing (only a NULL ordering value, for min_by/max_by).
    ``from_intermediate`` (a FINAL step): the state columns themselves."""
    datas = tuple(b.data for b in page.blocks)
    contribs = []
    for call in calls:
        if from_intermediate:
            contribs.extend(datas[ch] for ch in call.intermediate_channels)
            continue
        fn = call.function
        args = tuple(_ordering_codes(call, ai, page.blocks[c])
                     for ai, c in enumerate(call.input_channels))
        m = page.mask
        skip = fn.null_skip_channels
        for ai, c in enumerate(call.input_channels):
            if skip is not None and ai not in skip:
                continue  # a NULL here does not exclude the row (min_by's x)
            if page.blocks[c].nulls is not None:
                m = m & ~page.blocks[c].nulls
        if call.mask_channel is not None:
            mc = datas[call.mask_channel].to(torch.bool)
            if page.blocks[call.mask_channel].nulls is not None:
                mc = mc & ~page.blocks[call.mask_channel].nulls
            m = m & mc
        if fn.needs_arg_nulls:
            nulls = tuple(page.blocks[c].null_mask() for c in call.input_channels)
            contribs.extend(fn.input_map(args, nulls, m))
        else:
            contribs.extend(fn.input_map(args, m))
    return contribs


def _ranked_min_max(call) -> bool:
    """min/max over a dictionary whose codes are not in lexicographic order
    reduce ranks instead, as the reference's do."""
    d = call.output_dictionary
    return call.function.name in ("min", "max") and d is not None \
        and hasattr(d, "values") and not d.is_sorted()


def _ordering_codes(call, arg_index: int, block: Block) -> torch.Tensor:
    """An argument as the reduce sees it: an ordering argument (min/max's,
    min_by/max_by's second) over an unsorted dictionary compares ranks.
    min_by/max_by keep no ordering value in their output, so their ranks
    need no mapping back."""
    d = block.dictionary
    if d is None:
        return block.data
    ordering = call.function.name in ("min", "max") or \
        (call.function.name in ("min_by", "max_by") and arg_index == 1)
    if ordering and not hasattr(d, "values") and not getattr(d, "monotonic", False):
        # a virtual dictionary's codes keep the strings' order only when
        # its format does (zero-padded Supplier#%09d)
        raise NotImplementedError(
            f"{call.function.name} over non-monotonic virtual dictionary {d!r} is not ported")
    if _ranked_min_max(call) or (call.function.name in ("min_by", "max_by")
                                 and arg_index == 1 and hasattr(d, "values")
                                 and not d.is_sorted()):
        return d.sort_table("ranks", block.data.device)[block.data.long()]
    return block.data


def sort_group_reduce(keys: Tuple[torch.Tensor, ...], mask: torch.Tensor,
                      contribs: Tuple, kinds: Tuple[str, ...],
                      identities: Tuple, out_groups: int,
                      widths: Optional[Tuple[int, ...]] = None):
    """Group rows by ``keys`` (exact, multi-column) and reduce ``contribs``.

    Returns (group_keys, group_states, group_valid_mask, num_groups); groups
    are in key order and ``group_valid_mask`` is a prefix. Invalid rows and
    groups beyond ``out_groups`` land in a trash segment.
    """
    n = mask.shape[0]
    dev = mask.device
    widths = widths or (1,) * len(kinds)
    order = lexsort_fast(tuple(reversed(keys)) + (~mask,)).long()
    sk = tuple(k[order] for k in keys)
    sv = mask[order]
    sc = tuple((c[0][order], c[1][order]) if isinstance(c, tuple) else c[order]
               for c in contribs)
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
    states = _reduce_all(sc, kinds, identities, widths, gid, out_groups)
    # group keys: the first sorted row of each group
    first_row = _segment_reduce(MIN, torch.arange(n, dtype=torch.int32, device=dev),
                                gid, out_groups + 1)[:out_groups]
    safe = torch.clamp(first_row, 0, max(n - 1, 0)).long()
    gkeys = tuple(k[safe] for k in sk)
    gvalid = torch.arange(out_groups, device=dev) < torch.clamp(num_groups, max=out_groups)
    # empty-group states hold identities so MIN/MAX never leak sentinels
    fixed = tuple(_where_valid(gvalid, s, ident) for s, ident in zip(states, identities))
    return gkeys, fixed, gvalid, num_groups


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor's values in host RAM, as a numpy array."""
    return t.detach().cpu().numpy()


def _pow2(n: int) -> int:
    return 1 << max(4, (n - 1).bit_length())


def _pow2_count(n: int) -> int:
    """The next power of two >= n (no floor): the disk partition count."""
    return 1 << max(0, (n - 1).bit_length())


# disk rung of the grouping: one partition's merge aims at this many bytes,
# with at most this many partitions
_DISK_PARTITION_TARGET_BYTES = 64 << 20
_DISK_MAX_PARTITIONS = 256


def _key_row_hash(keys) -> np.ndarray:
    """Deterministic per-row uint64 hash over the interleaved key columns:
    the disk partitioner, the reference's splitmix64 chain. Values are cast
    (not bit-cast) to int64, so +0.0 and -0.0 hash equal; NULL keys are
    already canonical (a zero value and the flag). Write time and the merge
    agree because it sees only numpy values, which PCOL round-trips
    exactly."""
    n = len(keys[0])
    h = np.full(n, 0x9E3779B97F4A7C15, dtype=np.uint64)
    for k in keys:
        with np.errstate(invalid="ignore"):
            v = np.asarray(k).astype(np.int64, copy=False).view(np.uint64)
        h = h ^ v
        h = (h ^ (h >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        h = (h ^ (h >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        h = h ^ (h >> np.uint64(31))
    return h


class GroupedAggregationBuilder:
    """Sort-strategy accumulator: per-page partials folded into a compact
    table, with the reference's one-shot strategy pick from the first page."""

    compact_table = True  # finish() returns a prefix-valid table
    from_intermediate = False

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
        self.widths = _state_widths(calls)
        # vector (sketch) states scatter into (groups, width) tables: that
        # bounds both the per-page group table and the compact table; folds
        # above it spill to host RAM as usual
        self._wide_cap = WIDE_STATE_MAX_GROUPS if any(w > 1 for w in self.widths) else None
        if self._wide_cap is not None:
            self.max_groups = min(self.max_groups, self._wide_cap)
        self._key_channels: Tuple[int, ...] = ()
        self._acc = None          # (keys, states, valid) compact table
        self._pending: List = []  # (keys, states, valid) partials
        self._pending_rows = 0
        self._table_size: Optional[int] = None
        # folds whose inputs went to host RAM: (keys, states, valid) numpy
        self._spilled: List = []
        self.spilled_folds = 0
        # the disk rung: the query's SpillManager (attach_spill), the runs
        # (meta {"P", "part", "nk"}) and the pow2 partition count, which
        # grows and never shrinks
        self._spill_mgr = None
        self._disk_runs: List = []
        self._disk_parts = 1
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
        contribs = _call_contributions(self.calls, page, self.from_intermediate)
        return sort_group_reduce(keys, page.mask, tuple(contribs), self.kinds,
                                 self.identities, out_groups, self.widths)

    def _page_raw(self, page: Page):
        """Defer mode: per-row keys and contributions, no per-page reduction;
        the fold takes this (keys, contribs, mask) triple like a partial."""
        keys = _null_safe_keys(page, self._key_channels)
        return keys, tuple(_call_contributions(self.calls, page, self.from_intermediate)), page.mask

    def _full_groups(self, capacity: int) -> int:
        return capacity if self._wide_cap is None else min(capacity, self._wide_cap)

    def page_out_groups(self, capacity: int) -> int:
        og = self._full_groups(capacity)
        return og if self._out_groups is None else min(og, self._out_groups)

    def defer_raw(self) -> bool:
        """True once the first page showed that grouping does not reduce."""
        return self._defer is True

    def add_page(self, page: Page) -> None:
        if self.defer_raw():
            self.absorb_raw(self._page_raw(page), page.capacity)
            return
        if self._hash_slots is not None:
            if self._absorb_hash_page(page):
                return
            # insert overflow: the sort kernel from here on, results stay exact
            self._hash_slots = None
        out_groups = self.page_out_groups(page.capacity)
        if not self.absorb_partial(self._page_partial(page, out_groups),
                                   page.capacity, out_groups):
            # the shrunken table overflowed: redo this page at full size
            out_groups = self.page_out_groups(page.capacity)
            if not self.absorb_partial(self._page_partial(page, out_groups),
                                       page.capacity, out_groups):
                raise AssertionError("a full-size partial cannot overflow")

    def absorb_raw(self, raw, capacity: int) -> None:
        """Defer mode: install one page's per-row (keys, contribs, mask)."""
        self._append(raw, capacity)

    def absorb_partial(self, partial, capacity: int, out_groups: int) -> bool:
        """Install one page's (gkeys, gstates, gvalid, ng) partial, computed
        by ``add_page`` or by a fused segment's terminal stage. Returns False
        when a shrunken table overflowed: the caller recomputes the page at
        the then-reset full size."""
        gkeys, gstates, gvalid, ng = partial
        if out_groups < self._full_groups(capacity):
            if int(ng) > out_groups:
                self._out_groups = None  # the data disproved the bound
                return False
        elif self._wide_cap is not None and int(ng) > out_groups:
            # a capped group table would merge groups silently: fail loudly,
            # as the reference does
            raise RuntimeError(f"sketch aggregate over more than {out_groups} groups in one "
                               f"page is not supported")
        elif self._defer is None and self._wide_cap is None:
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
        equality is not SQL equality on -0.0) and vector (sketch) states stay
        on the sort path."""
        if self._wide_cap is not None:
            return False
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
        contribs = _call_contributions(self.calls, page, self.from_intermediate)
        comps = torch.stack([k.to(torch.int64) for k in keys]).contiguous()
        slot_comps, slot_rows, gid, stats = ph.insert_table(comps, mask.contiguous(), slots)
        # masked and overflowed rows -> the trash segment (an overflow also
        # raises the stats flag, and the caller discards this partial)
        gid = torch.where(mask & (gid >= 0), gid, slots)
        states = _reduce_all(contribs, self.kinds, self.identities, self.widths, gid, slots)
        used = slot_rows >= 0
        gkeys = tuple(sc.to(torch_dtype(t)) for sc, t in zip(slot_comps, self.key_types))
        fixed = tuple(_where_valid(used, st, ident) for st, ident in zip(states, self.identities))
        return gkeys, fixed, used, stats

    def _absorb_hash_page(self, page: Page) -> bool:
        """Group one page through the insert. Returns False on an insert
        overflow (one host sync per page reads the flag): the caller re-runs
        the page through the sort kernel."""
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
                keys, valid, states, self.kinds, self.identities, size, self.widths)
            n = int(ngroups)
            if n <= size or size >= self.max_groups:
                break
            size = min(_pow2(n), self.max_groups)  # grow and refold
        if n > self.max_groups:
            # more live groups than the table holds: the fold's (complete)
            # inputs go to host RAM, merged exactly at finish
            self._spilled.append((tuple(_host(k) for k in keys),
                                  tuple(_host(st) for st in states), _host(valid)))
            self.spilled_folds += 1
            METRICS.count("agg.spilled_folds")
            self._table_size = None
            return
        tight = min(_pow2(max(n, 1)), self.max_groups)
        if tight < size:
            gkeys = tuple(k[:tight] for k in gkeys)
            gstates = tuple(s[:tight] for s in gstates)
            gvalid = gvalid[:tight]
        self._table_size = tight
        self._acc = (gkeys, gstates, gvalid)

    def _host_merge_parts(self, parts):
        """Merge (keys, states, valid) numpy triples exactly: keep the valid
        rows, lexsort by the key tuple, and reduce each state column per run
        of equal keys -> ([key col...], [state col...]), one row per
        distinct key, in key order."""
        nk = len(self.key_types)
        valid = np.concatenate([np.asarray(p[2]) for p in parts])
        keys = [np.concatenate([np.asarray(p[0][i]) for p in parts])[valid]
                for i in range(nk)]
        states = [np.concatenate([np.asarray(p[1][i]) for p in parts])[valid]
                  for i in range(len(self.kinds))]
        if len(keys[0]) == 0:
            return keys, states
        order = np.lexsort(tuple(reversed(keys)))
        keys = [k[order] for k in keys]
        boundary = np.zeros(len(keys[0]), dtype=bool)
        boundary[0] = True
        for k in keys:
            boundary[1:] |= k[1:] != k[:-1]
        starts = np.flatnonzero(boundary)
        states = [st[order] for st in states]
        nrows = len(keys[0])
        reduce = {SUM: np.add, MIN: np.minimum, MAX: np.maximum}
        out_states = []
        i = 0
        while i < len(self.kinds):
            kind = self.kinds[i]
            if kind in (AMIN, AMAX):
                # joint pair: the run's extreme ordering key, then the payload
                # of the first (earliest-part) row that holds it
                y = states[i]
                m = (np.minimum if kind == AMIN else np.maximum).reduceat(y, starts)
                counts = np.diff(np.append(starts, nrows))
                cand = np.where(y == np.repeat(m, counts), np.arange(nrows), nrows)
                win = np.clip(np.minimum.reduceat(cand, starts), 0, max(nrows - 1, 0))
                out_states.append(m)
                i += 1
                while i < len(self.kinds) and self.kinds[i] == ACARRY:
                    out_states.append(states[i][win])
                    i += 1
                continue
            out_states.append(reduce[kind].reduceat(states[i], starts))
            i += 1
        return [k[starts] for k in keys], out_states

    def memory_bytes(self) -> int:
        """Device-resident bytes: pending partials and the compact table, as
        rows times the key and state widths plus the valid flag."""
        per_row = sum(np.dtype(t.np_dtype).itemsize for t in self.key_types) + \
            sum(np.dtype(col.dtype).itemsize * col.width
                for c in self.calls for col in c.function.state) + 1
        rows = self._pending_rows
        if self._acc is not None:
            rows += int(self._acc[2].shape[0])
        return rows * per_row

    def spill(self) -> None:
        """Revocation: every pending partial and the table move to host RAM,
        merged exactly at ``finish``."""
        parts = list(self._pending)
        self._pending = []
        self._pending_rows = 0
        if self._acc is not None:
            parts.append(self._acc)
            self._acc = None
            self._table_size = None
        for p in parts:
            host = (tuple(_host(k) for k in p[0]), tuple(_host(st) for st in p[1]), _host(p[2]))
            METRICS.count("memory.revoked_bytes",
                          sum(a.nbytes for a in host[0] + host[1]) + host[2].nbytes)
            self._spilled.append(host)

    def _merge_spilled(self):
        """The spilled parts and the current table merged on the host: the
        merged table may exceed what the device table holds, so it stays
        there (CPU tensors) and the operator pages it out. With disk runs
        the merge goes partition by partition (``_merge_disk``)."""
        parts = list(self._spilled)
        if self._acc is not None:
            parts.append((tuple(_host(k) for k in self._acc[0]),
                          tuple(_host(st) for st in self._acc[1]), _host(self._acc[2])))
        self._spilled, self._acc, self._table_size = [], None, None
        if self._disk_runs:
            keys, states = self._merge_disk(parts)
        else:
            keys, states = self._host_merge_parts(parts)
        n = len(keys[0])
        return (tuple(torch.from_numpy(k) for k in keys),
                tuple(torch.from_numpy(st) for st in states),
                torch.ones(n, dtype=torch.bool))

    # --- the disk rung (host RAM -> PCOL runs; exec/spill.py) --------------

    def attach_spill(self, mgr) -> None:
        """Wire the query's SpillManager (or None), once per operator."""
        self._spill_mgr = mgr

    def _disk_tier(self):
        """The SpillManager when this grouping may go to disk, else None: a
        sketch grouping's (groups, width) states have no PCOL form and stay
        on the host rung. Dtypes are checked per flush."""
        return self._spill_mgr if self._wide_cap is None else None

    def host_spill_bytes(self) -> int:
        """Host-RAM bytes of the spilled partials that a disk flush would
        free (0 without a disk tier): revocable beside the device bytes."""
        if self._disk_tier() is None:
            return 0
        total = 0
        for p in self._spilled:
            total += sum(np.asarray(a).nbytes for a in p[0] + p[1])
            total += np.asarray(p[2]).nbytes
        return total

    def _adapt_disk_parts(self, new_rows: int, row_bytes: int) -> None:
        """Grow the partition count from the rows seen so far (the runs'
        rows bound the distinct keys from above), so one partition's merge
        stays near ``_DISK_PARTITION_TARGET_BYTES``. A run written at a
        coarser count stays addressable: its partition is a suffix of the
        finer one's bits."""
        est_rows = new_rows + sum(r.rows for r in self._disk_runs)
        want = _pow2_count(max(1, (est_rows * max(row_bytes, 1)
                                   + _DISK_PARTITION_TARGET_BYTES - 1)
                               // _DISK_PARTITION_TARGET_BYTES))
        self._disk_parts = min(max(self._disk_parts, want), _DISK_MAX_PARTITIONS)

    def spill_to_disk(self) -> int:
        """Flush the host partials as hash-partitioned, sorted, partially
        reduced PCOL runs; returns the bytes written (0 when it declines: no
        manager, a sketch state, or a dtype PCOL cannot store; the partials
        then stay in host RAM)."""
        mgr = self._disk_tier()
        if mgr is None or not self._spilled:
            return 0
        sample = self._spilled[0]
        if any(np.asarray(a).ndim != 1 or storage_type_for(np.asarray(a).dtype) is None
               for a in sample[0] + sample[1]):
            return 0
        parts, self._spilled = self._spilled, []
        keys, states = self._host_merge_parts(parts)
        n = len(keys[0]) if keys else 0
        if n == 0:
            return 0
        row_bytes = sum(a.dtype.itemsize for a in keys) + sum(a.dtype.itemsize for a in states)
        self._adapt_disk_parts(n, row_bytes)
        P = self._disk_parts
        part = (_key_row_hash(keys) & np.uint64(P - 1)).astype(np.int64)
        names = [f"k{i}" for i in range(len(keys))] + [f"s{i}" for i in range(len(states))]
        written = 0
        for p in range(P):
            sel = part == p
            if not sel.any():
                continue
            # a boolean selection keeps the key order: each run is sorted
            run = mgr.write_columns(names, [a[sel] for a in keys] + [a[sel] for a in states],
                                    kind="agg", meta={"P": P, "part": p, "nk": len(keys)})
            self._disk_runs.append(run)
            written += run.nbytes
        return written

    def _merge_disk(self, resident_parts):
        """The exact merge of the disk runs and the partials still in host
        RAM, one finest partition at a time: a run written at a coarser
        count gives its rows to each fine partition that refines its own,
        filtered by the recomputed hash. -> (key columns, state columns)."""
        mgr = self._spill_mgr
        runs, self._disk_runs = self._disk_runs, []
        res_keys, res_states = (self._host_merge_parts(resident_parts)
                                if resident_parts else ([], []))
        have_res = bool(res_keys) and len(res_keys[0]) > 0
        p_max = self._disk_parts
        res_part = None
        if have_res:
            res_part = (_key_row_hash(res_keys) & np.uint64(p_max - 1)).astype(np.int64)
        out_keys: List[List[np.ndarray]] = [[] for _ in self.key_types]
        out_states: List[List[np.ndarray]] = [[] for _ in self.kinds]
        for f in range(p_max):
            chunk = []
            for run in runs:
                if run.meta["part"] != (f & (run.meta["P"] - 1)):
                    continue
                cols = mgr.read_columns(run)
                nk = run.meta["nk"]
                rkeys = [c[0] for c in cols[:nk]]
                rstates = [c[0] for c in cols[nk:]]
                if run.meta["P"] < p_max:
                    sel = (_key_row_hash(rkeys) & np.uint64(p_max - 1)).astype(np.int64) == f
                    rkeys = [k[sel] for k in rkeys]
                    rstates = [st[sel] for st in rstates]
                if len(rkeys[0]) == 0:
                    continue
                chunk.append((tuple(rkeys), tuple(rstates), np.ones(len(rkeys[0]), dtype=bool)))
            if have_res:
                sel = res_part == f
                if sel.any():
                    chunk.append((tuple(k[sel] for k in res_keys),
                                  tuple(st[sel] for st in res_states),
                                  np.ones(int(sel.sum()), dtype=bool)))
            if not chunk:
                continue
            mk, ms = self._host_merge_parts(chunk)
            if len(mk[0]) == 0:
                continue
            for i, k in enumerate(mk):
                out_keys[i].append(k)
            for i, st in enumerate(ms):
                out_states[i].append(st)
        for run in runs:
            mgr.release(run)
        keys = [np.concatenate(c) if c else np.zeros(0, dtype=t.np_dtype)
                for c, t in zip(out_keys, self.key_types)]
        states = [np.concatenate(c) if c else np.zeros(0, dtype=col.dtype)
                  for c, col in zip(out_states,
                                    [col for call in self.calls for col in call.function.state])]
        return keys, states

    def finish(self):
        """-> (keys, states, valid), compact (valid is a prefix); on the
        host after a spill, else on the builder's device."""
        if self._pending:
            self._fold()
        if self._spilled or self._disk_runs:
            return self._merge_spilled()
        if self._acc is None:  # empty input: zero groups
            dev = self._device
            keys = tuple(torch.zeros(0, dtype=torch_dtype(t), device=dev)
                         for t in self.key_types)
            return keys, _empty_state(self.widths, dev), \
                torch.zeros(0, dtype=torch.bool, device=dev)
        out, self._acc, self._table_size = self._acc, None, None
        return out


class DirectAggregationBuilder:
    """Small-domain strategy: a dense state table indexed by the linear key
    code over the product of the key domains (one extra code per key for
    its NULL group). Its table has holes: ``valid`` marks the groups seen."""

    compact_table = False
    from_intermediate = False

    def __init__(self, key_types: Sequence[Type], domains: Sequence[int],
                 calls: Sequence[AggregateCall], device="cuda"):
        self.key_types = list(key_types)
        self.base_domains = [int(d) for d in domains]
        self.domains = [int(d) + 1 for d in domains]
        self.calls = list(calls)
        self.D = int(np.prod(self.domains))
        self.kinds = tuple(col.reduce for c in calls for col in c.function.state)
        self.state_cols = [col for c in calls for col in c.function.state]
        self.identities = tuple(col.identity for col in self.state_cols)
        self.widths = _state_widths(calls)
        self._device = torch.device(device)
        self._key_channels: Tuple[int, ...] = ()
        self._table = None  # tuple of (D,) or (D, width) state tensors
        self._seen = None   # (D,) bool: the group occurred

    def set_channels(self, key_channels) -> "DirectAggregationBuilder":
        self._key_channels = tuple(key_channels)
        return self

    def _accumulate(self, page: Page, table, seen):
        """One page folded into the (table, seen) state: a new state, the
        given one untouched (a fused segment threads it through)."""
        mask = page.mask
        gid = torch.zeros(mask.shape[0], dtype=torch.int32, device=mask.device)
        for ch, base, dom in zip(self._key_channels, self.base_domains, self.domains):
            code = torch.clamp(page.blocks[ch].data.to(torch.int32), 0, base - 1)
            if page.blocks[ch].nulls is not None:
                code = torch.where(page.blocks[ch].nulls, base, code)
            gid = gid * dom + code
        gid = torch.where(mask, gid, self.D)  # dead rows -> the trash segment
        contribs = _call_contributions(self.calls, page, self.from_intermediate)
        parts = _reduce_all(contribs, self.kinds, self.identities, self.widths, gid, self.D)
        hits = _segment_reduce(SUM, mask.to(torch.int32), gid, self.D + 1)[:self.D]
        return tuple(_merge_tables(self.kinds, table, parts)), seen | (hits > 0)

    def init_state(self):
        """The (table, seen) state, made at first use."""
        if self._table is None:
            dev = self._device
            self._table = tuple(torch.full((self.D, col.width) if col.width > 1 else (self.D,),
                                           col.identity,
                                           dtype=_NP_TO_TORCH[np.dtype(col.dtype)], device=dev)
                                for col in self.state_cols)
            self._seen = torch.zeros(self.D, dtype=torch.bool, device=dev)
        return self._table, self._seen

    def absorb_state(self, state) -> None:
        self._table, self._seen = state

    def add_page(self, page: Page) -> None:
        self.absorb_state(self._accumulate(page, *self.init_state()))

    def finish(self):
        """-> (interleaved (value, null flag) keys, states, seen)."""
        dev = self._device
        if self._table is None:
            keys = tuple(x for t in self.key_types
                         for x in (torch.zeros(0, dtype=torch_dtype(t), device=dev),
                                   torch.zeros(0, dtype=torch.bool, device=dev)))
            return keys, _empty_state(self.widths, dev), \
                torch.zeros(0, dtype=torch.bool, device=dev)
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
    """No GROUP BY: one scalar (or (width,) vector) state per state column."""

    compact_table = True
    from_intermediate = False

    def __init__(self, calls: Sequence[AggregateCall], device="cuda"):
        self.calls = list(calls)
        self.kinds = tuple(col.reduce for c in calls for col in c.function.state)
        self.state_cols = [col for c in calls for col in c.function.state]
        self.widths = _state_widths(calls)
        self._device = torch.device(device)
        self._state = None

    def set_channels(self, key_channels) -> "GlobalAggregationBuilder":
        return self

    def _identity_state(self, device):
        return tuple(torch.full((col.width,) if col.width > 1 else (), col.identity,
                                dtype=_NP_TO_TORCH[np.dtype(col.dtype)], device=device)
                     for col in self.state_cols)

    def _accumulate(self, page: Page, state):
        """One page folded into the state: a new state. An AMIN/AMAX pair
        takes the page's first extreme row (argmin/argmax) and replaces the
        state only when strictly better, so an earlier page keeps a tie."""
        contribs = _call_contributions(self.calls, page, self.from_intermediate)
        if self.from_intermediate:
            # a dead row's state columns are padding: the identity instead
            contribs = [torch.where(page.mask if c.dim() == 1 else page.mask[:, None], c,
                                    torch.tensor(col.identity, dtype=c.dtype, device=c.device))
                        for c, col in zip(contribs, self.state_cols)]
        new = []
        i = 0
        while i < len(self.kinds):
            kind, c, st = self.kinds[i], contribs[i], state[i]
            if kind in (AMIN, AMAX):
                am = (torch.argmin if kind == AMIN else torch.argmax)(c)
                red = c[am]
                better = (red < st) if kind == AMIN else (red > st)
                new.append(torch.where(better, red, st))
                i += 1
                while i < len(self.kinds) and self.kinds[i] == ACARRY:
                    new.append(torch.where(better, contribs[i][am], state[i]))
                    i += 1
                continue
            if isinstance(c, tuple):  # vector state: scatter into one (width,) row
                gid = torch.zeros(c[0].shape[0], dtype=torch.int64, device=c[0].device)
                red = _reduce_contrib(kind, c, gid, 1, self.widths[i],
                                      self.state_cols[i].identity)[0]
            else:
                red = c.sum(dim=0) if kind == SUM else c.min() if kind == MIN else c.max()
            if kind == SUM:
                new.append(st + red)
            elif kind == MIN:
                new.append(torch.minimum(st, red))
            else:
                new.append(torch.maximum(st, red))
            i += 1
        return tuple(new)

    def init_state(self):
        if self._state is None:
            self._state = self._identity_state(self._device)
        return self._state

    def absorb_state(self, state) -> None:
        self._state = state

    def add_page(self, page: Page) -> None:
        self.absorb_state(self._accumulate(page, self.init_state()))

    def finish(self):
        state = self._state if self._state is not None else self._identity_state(self._device)
        self._state = None
        states = tuple(s.reshape(1, -1) if s.dim() else s.reshape(1) for s in state)
        return (), states, torch.ones(1, dtype=torch.bool, device=states[0].device)


# the largest key-domain product the direct builder's dense table takes
DIRECT_DOMAIN_LIMIT = 1 << 16


def make_builder(key_types, key_domains, calls, max_groups: int = 1 << 20,
                 device="cuda", hash_grouping: str = "off", from_intermediate: bool = False):
    """The reference's strategy pick: GLOBAL without keys, DIRECT when every
    key has a known small domain, GROUPED otherwise; COLLECT whenever a
    call is a collecting aggregate (``ops/collect_agg.py``).
    ``from_intermediate``: a FINAL step's builder, fed state columns."""
    b = _make_builder(key_types, key_domains, calls, max_groups, device, hash_grouping)
    if from_intermediate:
        if not isinstance(b, (GroupedAggregationBuilder, DirectAggregationBuilder,
                              GlobalAggregationBuilder)):
            raise ValueError("collect aggregates are single-phase (splittable=False)")
        b.from_intermediate = True
    return b


def _make_builder(key_types, key_domains, calls, max_groups, device, hash_grouping):
    from .collect_agg import COLLECT_NAMES, CollectAggregationBuilder

    if any(c.function.name in COLLECT_NAMES for c in calls):
        # the collectors keep every row; one sorted pass at finish
        return CollectAggregationBuilder(key_types, calls, device)
    if not key_types:
        return GlobalAggregationBuilder(calls, device)
    # vector (sketch) states make the dense table D x width: the direct
    # strategy only while that stays small
    wide = any(w > 1 for w in _state_widths(calls))
    limit = min(DIRECT_DOMAIN_LIMIT, WIDE_STATE_MAX_GROUPS) if wide else DIRECT_DOMAIN_LIMIT
    if key_domains is not None and all(d is not None for d in key_domains) \
            and int(np.prod(key_domains)) <= limit:
        return DirectAggregationBuilder(key_types, key_domains, calls, device)
    return GroupedAggregationBuilder(key_types, calls, max_groups, device, hash_grouping)


class HashAggregationOperator(Operator):
    """Steps: PARTIAL emits [keys..., state columns...]; FINAL consumes
    those; SINGLE does both."""

    def __init__(self, context: OperatorContext, builder, key_channels: List[int],
                 key_types: List[Type], key_dicts, calls: List[AggregateCall],
                 output_capacity: int, step: str = SINGLE):
        super().__init__(context)
        self.builder = builder.set_channels(key_channels)
        # the grouped builder's disk rung takes the query's SpillManager
        if isinstance(self.builder, GroupedAggregationBuilder):
            self.builder.attach_spill(context.spill)
        self.key_types = key_types
        self.key_dicts = key_dicts
        self.calls = calls
        self.output_capacity = output_capacity
        self.step = step
        self._result_pages: Optional[List[Page]] = None

    @property
    def output_types(self) -> List[Type]:
        out = list(self.key_types)
        for c in self.calls:
            if self.step == PARTIAL:
                out.extend(c.function.intermediate_types)
            else:
                out.append(c.function.output_type)
        return out

    @timed("add_input_ns")
    def add_input(self, page: Page) -> None:
        self.context.record_input(page, page.capacity)
        self.builder.add_page(page)
        if getattr(self.builder, "memory_bytes", None) is not None:
            self.context.update_revocable(self.revocable_bytes(), self.start_memory_revoke)

    # one revocation walks the ladder: the builder moves its device table to
    # host RAM, then a grouped builder writes the host partials to disk where
    # it has a disk tier and a state PCOL can store (spill_to_disk declines
    # otherwise); the collecting builder keeps host RAM only
    def revocable_bytes(self) -> int:
        b = getattr(self.builder, "memory_bytes", None)
        total = b() if b is not None else 0
        if isinstance(self.builder, GroupedAggregationBuilder):
            total += self.builder.host_spill_bytes()
        return total

    def start_memory_revoke(self) -> None:
        spill = getattr(self.builder, "spill", None)
        if spill is not None:
            spill()
            if isinstance(self.builder, GroupedAggregationBuilder):
                self.builder.spill_to_disk()
            self.context.revocable_memory.set_bytes(self.revocable_bytes())

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
        self.context.revocable_memory.set_bytes(0)  # the builder's state is consumed
        # a spilled result stays on the host: each output page is sliced
        # there and copied to the device on its own, never the whole table
        dev = self.builder._device
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
            group_states = states[si: si + ncols]
            si += ncols
            if self.step == PARTIAL:
                for it, st in zip(call.function.intermediate_types, group_states):
                    out_cols.append((it, st, None, None))
                continue
            out = call.function.final_map(group_states)
            nulls = None
            if isinstance(out, tuple):  # (data, null_mask) contract
                out, nulls = out
            if _ranked_min_max(call):
                # the winning rank back to its code; an empty group's
                # identity clips to some code, which its null flag masks
                order = call.output_dictionary.sort_table("order", out.device)
                out = order[out.long().clamp(0, len(order) - 1)]
            out_cols.append((call.function.output_type,
                             out.to(torch_dtype(call.function.output_type)),
                             call.output_dictionary, nulls))
        pages = []
        for lo in range(0, max(total, 1), cap):
            blocks = [Block(t, _slice_pad(a, lo, cap).to(dev, torch_dtype(t)),
                            None if nl is None else _slice_pad(nl, lo, cap).to(dev), d)
                      for (t, a, d, nl) in out_cols]
            pages.append(Page(tuple(blocks), _slice_pad(valid, lo, cap).to(dev)))
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
    steers it; the builder works on the worker's device."""

    def __init__(self, operator_id: int, key_channels, key_types,
                 key_dicts: Sequence[Optional[Dictionary]], calls, step: str,
                 page_capacity: int, max_groups: int = 1 << 20, device="cuda",
                 key_domains: Optional[Sequence[Optional[int]]] = None,
                 hash_grouping: str = "off"):
        super().__init__(operator_id, f"HashAggregation({step})")
        if step not in (PARTIAL, FINAL, SINGLE):
            raise ValueError(f"unknown aggregation step {step!r}")
        self.step = step
        self.key_channels = list(key_channels)
        self.key_types = list(key_types)
        self.key_dicts = list(key_dicts)
        self.calls = list(calls)
        self.page_capacity = page_capacity
        self.max_groups = max_groups
        self.device = torch.device(device)
        self.key_domains = key_domains
        self.hash_grouping = hash_grouping

    def create_operator(self, worker: int = 0) -> Operator:
        builder = make_builder(self.key_types, self.key_domains, self.calls,
                               self.max_groups, self.worker_device(worker),
                               self.hash_grouping,
                               from_intermediate=self.step == FINAL)
        return HashAggregationOperator(self.context(worker), builder, self.key_channels,
                                       self.key_types, self.key_dicts, self.calls,
                                       self.page_capacity, self.step)
