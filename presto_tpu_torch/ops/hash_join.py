"""Hash join of the PyTorch port: sorted and open-addressing lookup sources.

Counterpart of ``presto_tpu/ops/hash_join.py`` for the unique-build INNER and
LEFT probes and the SEMI probe, exact-key or with a join filter (one output
page per probe page). Two build strategies:

1. SORTED: build rows sorted by their int64 key; the probe binary-searches
   the sorted keys and verifies the true key (``probe_match_sorted``).
2. PALLAS: the open-addressing table of ``ops/pallas_hash.py``, built by the
   insert kernel and probed by the probe kernel (CUDA on the card, the plain
   versions on the CPU). Only unique single-key INNER/LEFT builds may take
   it (``pallas_join_eligible``); an oversized table, an insert overflow or
   a probe bound above ``PROBE_TRIPS_CAP`` falls back to SORTED at build
   time, as in the reference, and the ``pallas.join_builds`` and
   ``pallas.join_fallbacks`` counters record which happened.

A build row's id is its position in the concatenation of the compacted
build pages, as in the reference. The dense strategy, multi-key builds,
duplicate-key INNER/LEFT expansion, FULL/RIGHT/ANTI joins, INNER/LEFT join
filters and spill are not ported yet.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional, Sequence, Tuple

import torch

from .. import resolve_device
from ..block import Block, Dictionary, Page, _compact, torch_dtype
from ..types import Type
from .operator import Operator, OperatorContext, OperatorFactory, timed

INNER, LEFT, SEMI = "inner", "left", "semi"

# the reference's uint64 mixer constants as their int64 bit patterns
_M1 = 0xFF51AFD7ED558CCD - (1 << 64)
_M2 = 0xC4CEB9FE1A85EC53 - (1 << 64)
_GOLDEN = 0x9E3779B97F4A7C15 - (1 << 64)
_I64_MAX = 2 ** 63 - 1


def _shr33(x: torch.Tensor) -> torch.Tensor:
    # logical >> 33 of the uint64 bit pattern: int64 >> is arithmetic (and
    # torch has no uint64 >> on the CPU), so mask off the sign copies
    return (x >> 33) & (2 ** 31 - 1)


def _mix64(x: torch.Tensor) -> torch.Tensor:
    """The reference's 64-bit mixer (``hash_join._mix64``) on int64 bits,
    with wrapping multiplies: bit-identical to the uint64 original."""
    x = x.to(torch.int64)
    x = (x ^ _shr33(x)) * _M1
    x = (x ^ _shr33(x)) * _M2
    return x ^ _shr33(x)


def combined_key(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Multi-column equi-key -> one int64 (exact for a single int key, mixed otherwise)."""
    if len(keys) == 1:
        return keys[0].to(torch.int64)
    acc = _mix64(keys[0])
    for k in keys[1:]:
        acc = _mix64(acc ^ (k.to(torch.int64) * _GOLDEN))
    return acc


@dataclasses.dataclass
class LookupSource:
    kind: str                             # "sorted" | "pallas"
    key_arrays: Tuple[torch.Tensor, ...]  # true build key columns (compacted)
    payload: Tuple[torch.Tensor, ...]     # build output columns (compacted)
    payload_meta: List[Tuple[Type, Optional[Dictionary]]]
    unique: bool
    # sorted:
    sorted_key: Optional[torch.Tensor] = None  # (n,) int64, invalid rows INT64_MAX
    sorted_row: Optional[torch.Tensor] = None  # (n,) int32 original row index
    # pallas (ops/pallas_hash.py open-addressing table):
    ph_keys: Optional[torch.Tensor] = None  # (slots,) int64 stored keys
    ph_rows: Optional[torch.Tensor] = None  # (slots,) int32 row idx, -1 empty
    ph_trips: int = 0                       # probe trip count (pow2)
    payload_nulls: Tuple = ()

    @property
    def exact_keys(self) -> bool:
        """True when combined-key equality implies true key equality: a
        single integer (or boolean) key."""
        if len(self.key_arrays) != 1:
            return False
        k = self.key_arrays[0]
        return not (k.is_floating_point() or k.is_complex())


class LookupSourceFactory:
    """A future the probes block on: set once by the build, read by probes."""

    def __init__(self):
        self._event = threading.Event()
        self._source: Optional[LookupSource] = None

    def set(self, source: LookupSource) -> None:
        self._source = source
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def get(self) -> LookupSource:
        return self._source


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

def _compact_for_build(page: Page, key_channels: Sequence[int],
                       payload_channels: Sequence[int]) -> Page:
    sel = page.select_channels(list(key_channels) + list(payload_channels))
    # null keys never join: mask them out before compaction
    mask = sel.mask
    for i in range(len(key_channels)):
        if sel.blocks[i].nulls is not None:
            mask = mask & ~sel.blocks[i].nulls
    return _compact(sel.with_mask(mask))


def _concat_parts(pages: Sequence[Page], kc: int):
    """Concat compacted build pages into flat key/payload/nulls/mask tensors."""
    keys = tuple(torch.cat([p.blocks[i].data for p in pages]) for i in range(kc))
    npayload = len(pages[0].blocks) - kc
    payload = tuple(torch.cat([p.blocks[kc + i].data for p in pages])
                    for i in range(npayload))
    pnulls = tuple(
        torch.cat([p.blocks[kc + i].null_mask() for p in pages])
        if any(p.blocks[kc + i].nulls is not None for p in pages) else None
        for i in range(npayload))
    return keys, payload, pnulls, torch.cat([p.mask for p in pages])


def _sorted_index(ck: torch.Tensor, mask: torch.Tensor):
    ck = torch.where(mask, ck, _I64_MAX)
    sorted_key, order = torch.sort(ck, stable=True)
    return sorted_key, order.to(torch.int32)


class JoinBuildOperator(Operator):
    """HashBuilderOperator analogue (sink side of the build pipeline)."""

    def __init__(self, context: OperatorContext, factory: "JoinBuildOperatorFactory"):
        super().__init__(context)
        self.f = factory
        self._pages: List[Page] = []

    @property
    def output_types(self) -> List[Type]:
        return []

    @timed("add_input_ns")
    def add_input(self, page: Page) -> None:
        self.context.record_input(page, page.capacity)
        self._pages.append(_compact_for_build(page, self.f.key_channels,
                                              self.f.payload_channels))

    def get_output(self) -> Optional[Page]:
        return None

    def finish(self) -> None:
        if self._finishing:
            return
        super().finish()
        self.f.lookup_factory.set(self._build())
        self._pages = []  # consumed into the lookup source

    def _build(self) -> LookupSource:
        kc = len(self.f.key_channels)
        if kc != 1:
            raise NotImplementedError("multi-key join builds are not ported yet")
        if not self._pages:
            dev = self.f.device
            return LookupSource(
                kind="sorted", key_arrays=(torch.zeros(1, dtype=torch.int64, device=dev),),
                payload=tuple(torch.zeros(1, dtype=torch_dtype(t), device=dev)
                              for (t, _) in self.f.payload_meta),
                payload_meta=self.f.payload_meta,
                unique=True,
                sorted_key=torch.full((1,), _I64_MAX, dtype=torch.int64, device=dev),
                sorted_row=torch.zeros(1, dtype=torch.int32, device=dev),
                payload_nulls=tuple(None for _ in self.f.payload_meta))
        keys, payload, pnulls, mask = _concat_parts(self._pages, kc)
        src = None
        if self.f.strategy == "pallas":
            src = self._build_pallas(keys, payload, mask)
        if src is None:
            sorted_key, sorted_row = _sorted_index(combined_key(keys), mask)
            src = LookupSource(
                kind="sorted", key_arrays=keys, payload=payload,
                payload_meta=self.f.payload_meta, unique=self.f.unique,
                sorted_key=sorted_key, sorted_row=sorted_row)
        src.payload_nulls = pnulls
        return src

    def _build_pallas(self, keys, payload, mask) -> Optional[LookupSource]:
        """Open-addressing build. One host sync reads the insert's
        [overflow, max_run, distinct] stats, which buys the probe trip count;
        returns None (the caller builds sorted) on an oversized table, an
        insert overflow or an excessive probe bound."""
        from ..utils.metrics import METRICS
        from . import pallas_hash as ph

        n = int(keys[0].shape[0])
        slots = ph.table_slots(n)
        # float keys are ineligible: the table stores int64 values and the
        # probe has no true-key verify
        if keys[0].is_floating_point() or keys[0].is_complex():
            slots = None
        if slots is not None:
            comps = keys[0].to(torch.int64).unsqueeze(0).contiguous()
            slot_comps, slot_rows, _gid, stats = ph.insert_table(comps, mask, slots)
            overflow, max_run, _ng = stats.tolist()
            trips = ph.probe_trips_for(max_run)
            if not overflow and trips <= ph.PROBE_TRIPS_CAP:
                METRICS.count("pallas.join_builds")
                return LookupSource(
                    kind="pallas", key_arrays=keys, payload=payload,
                    payload_meta=self.f.payload_meta,
                    unique=self.f.unique, ph_keys=slot_comps[0],
                    ph_rows=slot_rows, ph_trips=trips)
        METRICS.count("pallas.join_fallbacks")
        return None


class JoinBuildOperatorFactory(OperatorFactory):
    def __init__(self, operator_id: int, key_channels: List[int],
                 payload_channels: List[int],
                 payload_meta: List[Tuple[Type, Optional[Dictionary]]],
                 strategy: str = "sorted", unique: bool = False,
                 device="cuda"):
        super().__init__(operator_id, "JoinBuild")
        if strategy not in ("sorted", "pallas"):
            raise ValueError(
                f"unknown join build strategy {strategy!r}; hash_kernels "
                "picks it (sorted | pallas | auto)")
        if strategy == "pallas" and (not unique or len(key_channels) != 1):
            # the open-addressing table stores one row per key slot
            raise ValueError(
                "pallas join strategy requires a unique single-key "
                "INNER/LEFT build; use hash_kernels='auto' (or 'sorted') so "
                "ineligible builds fall back to the sorted strategy")
        self.key_channels = list(key_channels)
        self.payload_channels = list(payload_channels)
        self.payload_meta = payload_meta
        self.strategy = strategy
        self.unique = unique
        self.device = torch.device(device)
        self.lookup_factory = LookupSourceFactory()

    def create_operator(self) -> JoinBuildOperator:
        return JoinBuildOperator(self.context(), self)


def pallas_join_eligible(join_type: str, key_channels, unique: bool) -> bool:
    """May this join's build use the open-addressing strategy? Unique
    single-key INNER/LEFT only; everything else keeps the sorted strategy."""
    return unique and len(key_channels) == 1 and join_type in (INNER, LEFT)


HASH_KERNELS = ("sorted", "pallas", "auto")


def join_strategy(hash_kernels: str, device, join_type: str, key_channels,
                  unique: bool) -> str:
    """Build-strategy pick for ``hash_kernels`` (the reference planner's
    ``_join_strategy``): ``pallas`` takes the open-addressing table where the
    join is eligible and ``sorted`` elsewhere; ``auto`` is ``pallas``
    exactly when the device is CUDA, so the hand-written kernels run on the
    card (the reference keys the same choice on its TPU backend)."""
    if hash_kernels not in HASH_KERNELS:
        raise ValueError(f"hash_kernels must be one of {HASH_KERNELS}, got {hash_kernels!r}")
    hk = hash_kernels
    if hk == "auto":
        hk = "pallas" if resolve_device(device).type == "cuda" else "sorted"
    if hk == "pallas" and pallas_join_eligible(join_type, key_channels, unique):
        return "pallas"
    return "sorted"


# ---------------------------------------------------------------------------
# probe
# ---------------------------------------------------------------------------

def probe_match_pallas(ph_keys, ph_rows, probe_keys, probe_mask, trips: int):
    """PALLAS unique build: fixed-trip open-addressing scan (the probe kernel)."""
    from .pallas_hash import probe_table

    return probe_table(ph_keys, ph_rows, probe_keys.to(torch.int64).contiguous(),
                       probe_mask.contiguous(), trips)


def probe_match_sorted(sorted_key, sorted_row, ck, probe_keys_list,
                       probe_mask, key_arrays):
    """SORTED build: binary search + verify of the true keys."""
    pos = torch.searchsorted(sorted_key, ck)
    pos = pos.clamp(0, sorted_key.shape[0] - 1)
    hit = (sorted_key[pos] == ck) & probe_mask
    row = torch.where(hit, sorted_row[pos], -1)
    for pk, bk in zip(probe_keys_list, key_arrays):
        bv = bk[torch.where(row >= 0, row, 0).long()]
        row = torch.where((row >= 0) & (bv == pk), row, -1)
    return row


def unique_join_page(page: Page, row, payload, payload_nulls,
                     probe_channels, build_channels, meta,
                     inner: bool, left_outer: bool) -> Page:
    """Unique-build join output: probe-channel passthrough plus a gather per
    build column."""
    matched = row >= 0
    out_mask = page.mask & matched if inner else page.mask
    safe_row = torch.where(matched, row, 0).long()
    blocks = [page.blocks[c] for c in probe_channels]
    for bi, (t, d) in zip(build_channels, meta):
        arr = payload[bi][safe_row]
        bn = payload_nulls[bi] if bi < len(payload_nulls) else None
        nulls = bn[safe_row] if bn is not None else None
        if left_outer:
            unmatched = ~matched  # unmatched probe rows -> null build columns
            nulls = unmatched if nulls is None else (nulls | unmatched)
        blocks.append(Block(t, arr, nulls, d))
    return Page(tuple(blocks), out_mask)


class LookupJoinOperator(Operator):
    """Probe side: one output page per probe page."""

    def __init__(self, context: OperatorContext, factory: "LookupJoinOperatorFactory"):
        super().__init__(context)
        self.f = factory
        self._outputs: List[Page] = []
        self._source: Optional[LookupSource] = None

    @property
    def output_types(self) -> List[Type]:
        return self.f.output_types

    def is_blocked(self):
        if self._source is not None:
            return None
        lf = self.f.lookup_factory
        if lf.done():
            self._source = lf.get()
            return None
        return lf.done

    def needs_input(self) -> bool:
        return (not self._finishing and self._source is not None
                and len(self._outputs) < 4)

    @timed("add_input_ns")
    def add_input(self, page: Page) -> None:
        self.context.record_input(page, page.capacity)
        src = self._source
        jt = self.f.join_type
        probe_keys = [page.blocks[c].data for c in self.f.probe_key_channels]
        probe_mask = page.mask
        for c in self.f.probe_key_channels:
            if page.blocks[c].nulls is not None:
                probe_mask = probe_mask & ~page.blocks[c].nulls
        if len(probe_keys) != 1:
            raise NotImplementedError("multi-key probes are not ported yet")
        if jt == SEMI and (self.f.filter_fn is not None or not src.exact_keys):
            self._outputs.append(self._semi_expanded(page, probe_keys, probe_mask))
            return
        if not src.exact_keys:
            raise NotImplementedError("float-key INNER/LEFT probes are not ported yet")
        if jt in (INNER, LEFT) and not src.unique:
            raise NotImplementedError("duplicate-key join expansion is not ported yet")
        if jt not in (INNER, LEFT, SEMI):
            raise NotImplementedError(f"{jt} join is not ported yet")
        if src.kind == "pallas":
            row = probe_match_pallas(src.ph_keys, src.ph_rows, probe_keys[0],
                                     probe_mask, src.ph_trips)
        else:
            row = probe_match_sorted(src.sorted_key, src.sorted_row,
                                     combined_key(probe_keys), probe_keys,
                                     probe_mask, src.key_arrays)
        matched = row >= 0
        if jt == SEMI:
            sel = page.select_channels(self.f.probe_output_channels)
            self._outputs.append(Page(sel.blocks, page.mask & matched))
            return
        self._outputs.append(unique_join_page(
            page, row, src.payload, src.payload_nulls,
            self.f.probe_output_channels, self.f.build_output_channels,
            [src.payload_meta[i] for i in self.f.build_output_channels],
            jt == INNER, jt == LEFT))

    def _semi_expanded(self, page: Page, probe_keys, probe_mask) -> Page:
        """SEMI with a join filter or inexact keys: range-scan every
        candidate build row of each probe row, verify the true keys, evaluate
        the filter on the (probe, build) pair and OR the result per probe
        row, one page-capacity chunk of candidate pairs at a time
        (the reference's ``_emit_semi_expanded`` + ``_SemiFilterKernel``)."""
        src = self._source
        lo = torch.searchsorted(src.sorted_key, combined_key(probe_keys))
        hi = torch.searchsorted(src.sorted_key, combined_key(probe_keys), right=True)
        count = torch.where(probe_mask, hi - lo, 0)
        offsets = torch.cumsum(count, 0)
        total = int(offsets[-1]) if offsets.numel() else 0
        cap = page.capacity
        any_match = torch.zeros(cap, dtype=torch.bool, device=page.device)
        for base in range(0, total, cap):
            any_match = self._semi_chunk(page, probe_keys, lo, offsets, base, total,
                                         any_match)
        sel = page.select_channels(self.f.probe_output_channels)
        return Page(sel.blocks, page.mask & any_match)

    def _semi_chunk(self, page, probe_keys, lo, offsets, base, total, any_match):
        """Candidate pairs [base, base + capacity): pair j belongs to the
        first probe row whose running count exceeds j."""
        src, f = self._source, self.f
        cap = page.capacity
        j = torch.arange(cap, dtype=torch.int64, device=page.device) + base
        pi = torch.searchsorted(offsets, j, right=True).clamp(0, cap - 1)
        prev = torch.where(pi > 0, offsets[(pi - 1).clamp(min=0)], 0)
        spos = (lo[pi] + (j - prev)).clamp(0, src.sorted_row.shape[0] - 1)
        brow = src.sorted_row[spos].long()
        ok = j < total
        for pk, bk in zip(probe_keys, src.key_arrays):
            ok = ok & (bk[brow] == pk[pi])
        if f.filter_fn is not None:
            datas, nulls = [], []
            for pc in f.filter_probe_channels:
                b = page.blocks[pc]
                datas.append(b.data[pi])
                nulls.append(b.nulls[pi] if b.nulls is not None else None)
            for bc in f.filter_build_channels:
                datas.append(src.payload[bc][brow])
                bn = src.payload_nulls[bc] if bc < len(src.payload_nulls) else None
                nulls.append(bn[brow] if bn is not None else None)
            fd, fnu = f.filter_fn(tuple(datas), tuple(nulls))
            ok = ok & fd
            if fnu is not None:
                ok = ok & ~fnu
        any_match = any_match.clone()
        any_match[pi[ok]] = True
        return any_match

    @timed("get_output_ns")
    def get_output(self) -> Optional[Page]:
        if self._outputs:
            out = self._outputs.pop(0)
            self.context.record_output(out, out.capacity)
            return out
        return None

    def is_finished(self) -> bool:
        return self._finishing and not self._outputs


class LookupJoinOperatorFactory(OperatorFactory):
    def __init__(self, operator_id: int, lookup_factory: LookupSourceFactory,
                 probe_key_channels: List[int], probe_output_channels: List[int],
                 probe_output_meta: List[Tuple[Type, Optional[Dictionary]]],
                 build_output_channels: List[int],
                 build_output_meta: List[Tuple[Type, Optional[Dictionary]]],
                 join_type: str = INNER, filter_fn=None,
                 filter_probe_channels: Optional[List[int]] = None,
                 filter_build_channels: Optional[List[int]] = None):
        super().__init__(operator_id, f"LookupJoin({join_type})")
        # SEMI join filter: a compiled expression over [probe channels...,
        # build payload columns...], evaluated per candidate (probe, build) pair
        self.filter_fn = filter_fn
        self.filter_probe_channels = filter_probe_channels or []
        self.filter_build_channels = filter_build_channels or []
        self.lookup_factory = lookup_factory
        self.probe_key_channels = probe_key_channels
        self.probe_output_channels = probe_output_channels
        self.build_output_channels = build_output_channels
        self.join_type = join_type
        self.output_types = [t for (t, _) in probe_output_meta] + \
                            [t for (t, _) in build_output_meta]

    def create_operator(self) -> LookupJoinOperator:
        return LookupJoinOperator(self.context(), self)
