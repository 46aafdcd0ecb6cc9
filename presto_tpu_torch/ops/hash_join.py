"""Hash join of the PyTorch port: sorted and open-addressing lookup sources.

Counterpart of ``presto_tpu/ops/hash_join.py`` for INNER, LEFT and FULL joins on
any number of keys, with unique or duplicate build keys, and the SEMI and
ANTI probes (null-aware for IN / NOT IN), exact-key or with a join filter.
Three build strategies:

0. DENSE: a unique single-key build scatters its row ids into an int32
   table over ``[dense_min, dense_max]`` (``_build_dense``); the probe is
   one gather (``probe_match_dense``). The SQL planner never picks it:
   only direct operator construction does, as in the reference.

1. SORTED: build rows sorted by their int64 combined key; the probe
   binary-searches the sorted keys and verifies the true keys
   (``probe_match_sorted``). A multi-key build packs its keys into one int64
   exactly when their live ranges fit 62 bits (``_plan_packing``,
   ``_pack_key``) and mixes them with ``combined_key`` otherwise.
2. PALLAS: the open-addressing table of ``ops/pallas_hash.py``, built by the
   insert kernel and probed by the probe kernel (CUDA on the card, the plain
   versions on the CPU). Only unique single-key INNER/LEFT builds may take
   it (``pallas_join_eligible``); a table above ``MAX_TABLE_SLOTS`` for
   its live rows, an insert overflow or a probe bound above
   ``PROBE_TRIPS_CAP`` falls back to SORTED at build time, and the ``pallas.join_builds`` and
   ``pallas.join_fallbacks`` counters record which happened.

A unique build with exact keys emits one output page per probe page
(``probe_match_sorted`` or the probe kernel). On a single key that probe,
and the exact-key SEMI/ANTI probe, is one pure function of the page and
the build's tensors (``apply_probe_stage``), which a fused pipeline
segment calls as a stage and the unfused operator calls alike. Every other
INNER/LEFT join expands: each probe row's match range in the sorted keys
is counted (``_range_kernel``), and the expanded rows are emitted one
page-capacity chunk at a time (``_expand_kernel``), each chunk only when
the consumer asks for it, with the true keys verified and LEFT's
null-build row after a probe row's matches.

A FULL join (RIGHT is planned as a flipped LEFT) builds sorted with
``track_unmatched``: the build keeps its NULL-key rows aside and its live
row count, the probe emits unmatched probe rows with NULL build columns and
ORs every matched build row into a device visited flag (``_mark_rows``,
``_mark_ranges``), and ``finish`` emits, once, the unvisited live build rows
and then the NULL-key rows with NULL probe columns
(``_emit_unmatched_build``). Such a probe runs on one driver.

A build row's id is its position in the concatenation of the compacted
build pages, as in the reference. One factory serves every worker of a
distributed fragment: each worker's build drivers publish that worker's
lookup source, which only that worker's probes read. Under memory pressure one revocation
walks the reference's ladder: a build moves its device pages to host RAM
and, when the query has a disk tier, writes the host pages' live rows as
PCOL runs (``_spill_host_to_disk``; a page with a dtype PCOL cannot store
stays in RAM). ``_build`` reads the runs back to host pages and re-admits
every host page to the build's device before the table is built, so the
insert kernel always sees card tensors. INNER/LEFT join filters
are never planned (the optimizer moves a one-sided residual into a filter
and refuses a two-sided one on an outer join).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..block import Block, Dictionary, Page, _compact, torch_dtype
from ..exec.spill import storage_type_for
from ..types import Type
from ..utils.metrics import METRICS
from .operator import Operator, OperatorContext, OperatorFactory, timed
from .scan_pipeline import upload_page

INNER, LEFT, FULL, SEMI, ANTI = "inner", "left", "full", "semi", "anti"

# the reference's uint64 mixer constants as their int64 bit patterns
_M1 = 0xFF51AFD7ED558CCD - (1 << 64)
_M2 = 0xC4CEB9FE1A85EC53 - (1 << 64)
_GOLDEN = 0x9E3779B97F4A7C15 - (1 << 64)
_I64_MAX = 2 ** 63 - 1
_I64_MIN = -2 ** 63
# a probe key outside the build's packing ranges: never equal to a packed
# build key, which is >= 0
_PACK_SENTINEL = _I64_MIN // 2


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
    kind: str                             # "dense" | "sorted" | "pallas"
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
    # dense: table[key - base] is the build row, -1 for none
    table: Optional[torch.Tensor] = None    # (domain,) int32
    base: int = 0
    # exact multi-key packing (per key column, host ints): when the build
    # keys' live ranges fit 62 bits the combined key is a bijective pack
    pack_offsets: Optional[Tuple[int, ...]] = None
    pack_shifts: Optional[Tuple[int, ...]] = None
    pack_widths: Optional[Tuple[int, ...]] = None
    payload_nulls: Tuple = ()
    # a live build row had a NULL key: NOT IN (null-aware ANTI) then keeps
    # no row
    has_null_key: bool = False
    # FULL joins (a build with track_unmatched): the live build rows (host
    # int), and the NULL-key build rows' payload columns (host numpy), which
    # never match and come out in the unmatched epilogue
    build_count: int = 0
    null_key_payload: Optional[Tuple] = None
    null_key_nulls: Tuple = ()
    null_key_count: int = 0

    @property
    def exact_keys(self) -> bool:
        """True when sorted-key equality implies true key equality: a single
        integer (or boolean) key, or a packed multi-key. A mixed multi-key
        and a float single key (``combined_key`` truncates 1.2 and 1.5 to
        one key) range-scan and verify their candidates instead."""
        if len(self.key_arrays) > 1:
            return self.pack_offsets is not None
        k = self.key_arrays[0]
        return not (k.is_floating_point() or k.is_complex())

    def combine_probe(self, probe_keys) -> torch.Tensor:
        """Probe keys -> the build's combined-key space: packed when the
        build is packed (out-of-range probes map to the sentinel), else
        ``combined_key``."""
        if self.pack_offsets is None:
            return combined_key(probe_keys)
        return _pack_key(probe_keys, self.pack_offsets, self.pack_shifts,
                         self.pack_widths)


class LookupSourceFactory:
    """A future per worker that the probes block on: set once by that
    worker's build, then read by every probe driver of the worker (the
    source is immutable once set)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._slots = {}  # worker -> [Event, LookupSource]

    def _slot(self, worker: int):
        with self._lock:
            slot = self._slots.get(worker)
            if slot is None:
                slot = self._slots[worker] = [threading.Event(), None]
            return slot

    def set(self, source: LookupSource, worker: int = 0) -> None:
        slot = self._slot(worker)
        slot[1] = source
        slot[0].set()

    def done(self, worker: int = 0) -> bool:
        return self._slot(worker)[0].is_set()

    def get(self, worker: int = 0) -> LookupSource:
        return self._slot(worker)[1]


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

def _page_disk_eligible(page: Page) -> bool:
    """Can this host page round-trip through a PCOL run? Every block's data
    must be 1-D with a storage type (a GEOMETRY column's complex values
    have none)."""
    for b in page.blocks:
        if b.data.dim() != 1 or storage_type_for(b.data.numpy().dtype) is None:
            return False
    return True


def _page_from_run(mgr, run) -> Page:
    """The compacted host page a ``_spill_host_to_disk`` run holds (every
    row live; null flags were stored as bool columns, types and
    dictionaries in the run's meta)."""
    cols = mgr.read_columns(run)
    blocks, i = [], 0
    for (btype, bdict, has_nulls) in run.meta["blocks"]:
        data = torch.from_numpy(cols[i][0])
        i += 1
        nulls = None
        if has_nulls:
            nulls = torch.from_numpy(cols[i][0])
            i += 1
        blocks.append(Block(btype, data, nulls, bdict))
    return Page(tuple(blocks), torch.ones(run.rows, dtype=torch.bool))


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


def _pack_key(keys, offsets, shifts, widths) -> torch.Tensor:
    """Bijective multi-key pack: key i, less its offset, in ``widths[i]``
    bits at ``shifts[i]``. A value outside its range maps the row to
    ``_PACK_SENTINEL``."""
    acc = torch.zeros(keys[0].shape[0], dtype=torch.int64, device=keys[0].device)
    oob = torch.zeros(keys[0].shape[0], dtype=torch.bool, device=keys[0].device)
    for k, off, sh, w in zip(keys, offsets, shifts, widths):
        v = k.to(torch.int64) - off
        oob = oob | (v < 0) | (v >= (1 << w))
        acc = acc | (v.clamp(min=0) << sh)
    return torch.where(oob, _PACK_SENTINEL, acc)


def _plan_packing(keys, mask):
    """Host-side packing plan: per-key offsets, shifts and widths (tuples of
    ints) from the live rows' ranges, or None when the widths sum above 62
    bits. One device sync per key column."""
    offsets, widths = [], []
    for k in keys:
        if not k.is_floating_point():
            k = k.to(torch.int64)
        mn, mx = torch.stack([torch.where(mask, k, _I64_MAX).min(),
                              torch.where(mask, k, _I64_MIN).max()]).tolist() \
            if k.numel() else (0, -1)
        mn, mx = int(mn), int(mx)
        if mx < mn:  # no live rows
            mn, mx = 0, 0
        offsets.append(mn)
        widths.append(max((mx - mn).bit_length(), 1))
    if sum(widths) > 62:
        return None
    shifts, acc = [], 0
    for w in reversed(widths):
        shifts.append(acc)
        acc += w
    return tuple(offsets), tuple(reversed(shifts)), tuple(widths)


def _dense_kernel(key: torch.Tensor, mask: torch.Tensor, base: int, domain: int) -> torch.Tensor:
    """Row id per key slot over ``[base, base + domain)``; a dead row, or a
    key outside the domain, writes the trash slot past the end, which is
    sliced off (the reference's scatter with ``mode="drop"``)."""
    idx = key.to(torch.int64) - base
    idx = torch.where(mask & (idx >= 0) & (idx < domain), idx, domain)
    table = torch.full((domain + 1,), -1, dtype=torch.int32, device=key.device)
    rows = torch.arange(key.shape[0], dtype=torch.int32, device=key.device)
    table[idx] = rows
    return table[:domain]


def _build_dense(keys, payload, mask, payload_meta, base: int, domain: int,
                 unique: bool) -> "LookupSource":
    """DENSE unique build: one int32 row table over the key domain."""
    return LookupSource(kind="dense", key_arrays=keys, payload=payload,
                        payload_meta=payload_meta, unique=unique,
                        table=_dense_kernel(keys[0], mask, base, domain), base=base)


def _build_sorted(keys, payload, mask, payload_meta, unique: bool) -> "LookupSource":
    """SORTED build: a multi-key build packs its keys when they fit and
    mixes them otherwise, then the combined keys are sorted, stably."""
    pack = _plan_packing(keys, mask) if len(keys) > 1 else None
    ck = _pack_key(keys, *pack) if pack is not None else combined_key(keys)
    sorted_key, sorted_row = _sorted_index(ck, mask)
    return LookupSource(kind="sorted", key_arrays=keys, payload=payload,
                        payload_meta=payload_meta, unique=unique,
                        sorted_key=sorted_key, sorted_row=sorted_row,
                        pack_offsets=pack[0] if pack else None,
                        pack_shifts=pack[1] if pack else None,
                        pack_widths=pack[2] if pack else None)


class JoinBuildOperator(Operator):
    """HashBuilderOperator analogue (sink side of the build pipeline)."""

    def __init__(self, context: OperatorContext, factory: "JoinBuildOperatorFactory"):
        super().__init__(context)
        self.f = factory
        self._pages: List[Page] = []
        self._host_pages: List[Page] = []  # revoked to host RAM
        self._disk_runs: List = []         # spilled to disk (exec/spill.py runs)
        self._saw_null_key = None  # device bool, read once at the build
        # FULL joins: the payload of NULL-key build rows, kept aside (they
        # match nothing but come out unmatched); masked here, not synced
        self._null_key_pages: List[Page] = []
        self._null_keys_on_host = 0  # how many of them a revocation moved
        # this worker's device: revoked pages come back here
        self.device = factory.worker_device(context.worker)

    @property
    def output_types(self) -> List[Type]:
        return []

    @timed("add_input_ns")
    def add_input(self, page: Page) -> None:
        self.context.record_input(page, page.capacity)
        for c in self.f.key_channels:
            if page.blocks[c].nulls is not None:
                seen = (page.blocks[c].nulls & page.mask).any()
                self._saw_null_key = seen if self._saw_null_key is None \
                    else (self._saw_null_key | seen)
        self._pages.append(_compact_for_build(page, self.f.key_channels,
                                              self.f.payload_channels))
        if self.f.track_unmatched and any(page.blocks[c].nulls is not None
                                          for c in self.f.key_channels):
            nk = torch.zeros_like(page.mask)
            for c in self.f.key_channels:
                if page.blocks[c].nulls is not None:
                    nk = nk | page.blocks[c].nulls
            sel = page.select_channels(self.f.payload_channels)
            self._null_key_pages.append(sel.with_mask(nk & page.mask))
        self.context.update_revocable(self.revocable_bytes(), self.start_memory_revoke)

    def revocable_bytes(self) -> int:
        """The device-resident pages' bytes, from capacities and dtypes, and
        with a disk tier the host pages that can go to disk."""
        total = sum(p.accounted_bytes() for p in
                    self._pages + self._null_key_pages[self._null_keys_on_host:])
        if self.context.spill is not None:
            total += sum(p.accounted_bytes() for p in self._host_pages
                         if _page_disk_eligible(p))
        return total

    def start_memory_revoke(self) -> None:
        """One revocation walks the ladder: every device page moves to host
        RAM, then, with a disk tier, the host pages go to disk."""
        moved = [p.to_host() for p in self._pages]
        METRICS.count("memory.revoked_bytes", sum(p.accounted_bytes() for p in moved))
        self._host_pages.extend(moved)
        self._pages = []
        self._null_key_pages = [p.to_host() for p in self._null_key_pages]
        self._null_keys_on_host = len(self._null_key_pages)
        if self.context.spill is not None:
            self._spill_host_to_disk()
        self.context.revocable_memory.set_bytes(self.revocable_bytes())

    def _spill_host_to_disk(self) -> None:
        """The disk rung: each eligible host page's live rows become one
        PCOL run (data columns ``c<i>``, null flags ``n<i>``); the blocks'
        types and dictionaries ride in the run's meta, so the read side
        rebuilds the blocks exactly. Ineligible pages stay in host RAM."""
        mgr = self.context.spill
        keep: List[Page] = []
        for p in self._host_pages:
            if not _page_disk_eligible(p):
                keep.append(p)
                continue
            live = np.flatnonzero(p.mask.numpy())
            if len(live) == 0:
                continue  # nothing to rebuild: the page goes
            names, cols, specs = [], [], []
            for i, b in enumerate(p.blocks):
                names.append(f"c{i}")
                cols.append(np.ascontiguousarray(b.data.numpy()[live]))
                if b.nulls is not None:
                    names.append(f"n{i}")
                    cols.append(np.ascontiguousarray(b.nulls.numpy()[live]))
                specs.append((b.type, b.dictionary, b.nulls is not None))
            self._disk_runs.append(mgr.write_columns(names, cols, kind="join",
                                                     meta={"blocks": specs}))
        self._host_pages = keep

    def get_output(self) -> Optional[Page]:
        return None

    def finish(self) -> None:
        if self._finishing:
            return
        super().finish()
        self.f._builder_done(self)
        self.context.revocable_memory.set_bytes(0)

    def _build(self) -> LookupSource:
        kc = len(self.f.key_channels)
        if self._disk_runs:  # disk runs back to host RAM first
            runs, self._disk_runs = self._disk_runs, []
            mgr = self.context.spill
            for run in runs:
                self._host_pages.append(_page_from_run(mgr, run))
                mgr.release(run)
        if self._host_pages:
            # re-admit revoked pages to the build's device: on the card the
            # kernels must never see host tensors
            dev = self.device
            self._pages = [upload_page(p, dev) for p in self._host_pages] + self._pages
            self._host_pages = []
        if not self._pages:
            dev = self.device
            return LookupSource(
                kind="sorted",
                key_arrays=tuple(torch.zeros(1, dtype=torch.int64, device=dev)
                                 for _ in range(kc)),
                payload=tuple(torch.zeros(1, dtype=torch_dtype(t), device=dev)
                              for (t, _) in self.f.payload_meta),
                payload_meta=self.f.payload_meta,
                unique=True,
                sorted_key=torch.full((1,), _I64_MAX, dtype=torch.int64, device=dev),
                sorted_row=torch.zeros(1, dtype=torch.int32, device=dev),
                payload_nulls=tuple(None for _ in self.f.payload_meta))
        keys, payload, pnulls, mask = _concat_parts(self._pages, kc)
        src = None
        if self.f.strategy == "dense":
            src = _build_dense(keys, payload, mask, self.f.payload_meta, self.f.dense_min,
                               self.f.dense_max - self.f.dense_min + 1, self.f.unique)
        elif self.f.strategy == "pallas":
            src = self._build_pallas(keys, payload, mask)
        if src is None:
            src = _build_sorted(keys, payload, mask, self.f.payload_meta, self.f.unique)
        src.payload_nulls = pnulls
        if self._saw_null_key is not None:
            src.has_null_key = bool(self._saw_null_key)  # host sync, once per build
        if self.f.track_unmatched:
            src.build_count = int(mask.sum())
            self._side_buffer(src)
        return src

    def _side_buffer(self, src: LookupSource) -> None:
        """A FULL build's NULL-key rows into the source, as host columns."""
        if not self._null_key_pages:
            return
        # on the host: a revocation may have moved some of them already
        pages = [p.to_host() for p in self._null_key_pages]
        keep = torch.cat([p.mask for p in pages]).numpy()
        cols, nils = [], []
        for i in range(len(self.f.payload_channels)):
            cols.append(torch.cat([p.blocks[i].data for p in pages]).numpy()[keep])
            if any(p.blocks[i].nulls is not None for p in pages):
                nils.append(torch.cat([p.blocks[i].null_mask() for p in pages])
                            .numpy()[keep])
            else:
                nils.append(None)
        src.null_key_payload = tuple(cols)
        src.null_key_nulls = tuple(nils)
        src.null_key_count = int(keep.sum())

    def _build_pallas(self, keys, payload, mask) -> Optional[LookupSource]:
        """Open-addressing build. Two host syncs: the live row count, which
        sizes the table, and the insert's [overflow, max_run, distinct]
        stats, which buy the probe trip count; returns None (the caller
        builds sorted) on an oversized table, an insert overflow or an
        excessive probe bound.

        The table is sized from the live rows, where the reference sizes it
        from the pages' capacity: a build of one coalesced or grouped page
        of 2^22 rows with a few live keys would otherwise ask for more than
        ``MAX_TABLE_SLOTS`` and fall back."""
        from . import pallas_hash as ph

        slots = ph.table_slots(int(mask.sum()))
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
                 device="cuda", track_unmatched: bool = False,
                 dense_min: int = 0, dense_max: int = 0):
        super().__init__(operator_id, "JoinBuild")
        # FULL joins keep the NULL-key build rows and the live row count for
        # the probe's unmatched-build epilogue
        self.track_unmatched = track_unmatched
        if strategy not in ("dense", "sorted", "pallas"):
            raise ValueError(
                f"unknown join build strategy {strategy!r}; the planner "
                "selects it from the `hash_kernels` session property "
                "(sorted | pallas | auto)")
        if strategy == "dense" and not unique:
            # one row id per key slot: a duplicate key would keep one row
            raise ValueError(
                "dense join strategy requires unique build keys; use "
                "strategy='sorted' (the `hash_kernels=sorted` session "
                "default) for duplicate-key builds")
        if strategy == "dense" and len(key_channels) != 1:
            raise ValueError(
                "dense join strategy requires a single key channel; the "
                "`hash_kernels` session property only routes single-key "
                "builds off the sorted path")
        if strategy == "pallas" and (not unique or len(key_channels) != 1 or track_unmatched):
            # the open-addressing table stores one row per key slot, and has
            # no sorted_row order for the FULL join's unmatched epilogue
            raise ValueError(
                "pallas join strategy requires a unique single-key "
                "INNER/LEFT build; use hash_kernels='auto' (or 'sorted') so "
                "ineligible builds fall back to the sorted strategy")
        self.key_channels = list(key_channels)
        self.payload_channels = list(payload_channels)
        self.payload_meta = payload_meta
        self.strategy = strategy
        self.unique = unique
        self.dense_min = int(dense_min)
        self.dense_max = int(dense_max)
        self.device = torch.device(device)
        self.lookup_factory = LookupSourceFactory()
        self._builders_lock = threading.Lock()
        self._created = {}   # worker -> [JoinBuildOperator]
        self._finished = {}  # worker -> count

    def create_operator(self, worker: int = 0) -> JoinBuildOperator:
        op = JoinBuildOperator(self.context(worker), self)
        with self._builders_lock:
            self._created.setdefault(worker, []).append(op)
        return op

    def _builder_done(self, op: JoinBuildOperator) -> None:
        """Called by each build driver's finish(). The worker's last to
        finish takes its siblings' collected pages and null-key state,
        builds the worker's lookup source and publishes it (the plan creates
        every driver before any runs, so the count is final). With one build
        driver this is the plain build."""
        w = op.context.worker
        with self._builders_lock:
            self._finished[w] = self._finished.get(w, 0) + 1
            if self._finished[w] < len(self._created[w]):
                return
            for o in self._created[w]:
                if o is op:
                    continue
                op._pages.extend(o._pages)
                # a revoked sibling's rows are in its host pages and runs
                op._host_pages.extend(o._host_pages)
                op._disk_runs.extend(o._disk_runs)
                op._null_key_pages.extend(o._null_key_pages)
                if o._saw_null_key is not None:
                    op._saw_null_key = o._saw_null_key if op._saw_null_key is None \
                        else (op._saw_null_key | o._saw_null_key)
                o._pages, o._host_pages, o._null_key_pages = [], [], []
                o._disk_runs = []
            source = op._build()
            op._pages, op._null_key_pages = [], []  # consumed into the lookup source
            self.lookup_factory.set(source, w)


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
# probe stage: the page-local probes as one pure page -> page function
# ---------------------------------------------------------------------------
#
# The unique-build INNER/LEFT probe and the exact-key SEMI/ANTI probe emit one
# output page per probe page, so a fused pipeline segment
# (ops/fused_segment.py) can call them as a stage; the unfused probe calls the
# same function, so the two paths cannot drift apart. The build side's
# tensors arrive in ``aux`` and the static config in ``ProbeStageConfig``.


@dataclasses.dataclass(frozen=True)
class ProbeStageConfig:
    """Static config of a page-local probe stage; the tensors it reads from
    the build side are the aux of :func:`probe_stage_aux`."""

    kind: str                              # "dense" | "sorted" | "pallas"
    join_type: str                         # INNER | LEFT | SEMI | ANTI
    probe_key_channels: Tuple[int, ...]
    probe_output_channels: Tuple[int, ...]
    build_output_channels: Tuple[int, ...]
    payload_meta: Tuple                    # ((type, dict), ...) per selected build column
    null_aware: bool = False
    # the probe kernel's fixed trip count (ops/pallas_hash.py)
    pallas_trips: int = 0


def probe_plan_fusible(join_type: str, key_channels, unique: bool, filter_fn=None) -> bool:
    """Plan-time test: does every page of this probe take the page-local
    stage? INNER/LEFT need a unique single-key build (one output row per
    probe row); SEMI/ANTI need a single key and no join filter. FULL joins
    track visited build rows across pages and are never page-local."""
    if len(key_channels) != 1:
        return False  # multi-key exactness is a run-time (packing) property
    if join_type in (SEMI, ANTI):
        return filter_fn is None
    if join_type in (INNER, LEFT):
        return unique
    return False


def probe_stage_cfg(f: "LookupJoinOperatorFactory", src: LookupSource) -> ProbeStageConfig:
    return ProbeStageConfig(
        kind=src.kind, join_type=f.join_type,
        probe_key_channels=tuple(f.probe_key_channels),
        probe_output_channels=tuple(f.probe_output_channels),
        build_output_channels=tuple(f.build_output_channels),
        payload_meta=tuple(src.payload_meta[i] for i in f.build_output_channels),
        null_aware=f.null_aware, pallas_trips=src.ph_trips)


def probe_stage_aux(src: LookupSource):
    """Every tensor the stage reads from the build side, ``has_null_key`` as
    a 0-d bool tensor beside the build's keys."""
    if src.kind == "dense":
        match = (src.table, src.base)
    elif src.kind == "pallas":
        match = (src.ph_keys, src.ph_rows)
    else:
        match = (src.sorted_key, src.sorted_row, tuple(src.key_arrays))
    has_null = torch.tensor(bool(src.has_null_key), device=src.key_arrays[0].device)
    return match, tuple(src.payload), tuple(src.payload_nulls), has_null


def probe_stage_key(cfg: ProbeStageConfig) -> tuple:
    """Cache identity of a stage (``utils/kernel_cache``), dictionary
    versions included: the payload dictionaries ride into output blocks."""
    from ..utils import kernel_cache as kc

    return ("probe-stage", cfg.kind, cfg.join_type, cfg.probe_key_channels,
            cfg.probe_output_channels, cfg.build_output_channels,
            tuple((t.name, kc.dict_key(d)) for t, d in cfg.payload_meta),
            cfg.null_aware, cfg.pallas_trips)


def apply_probe_stage(page: Page, aux, cfg: ProbeStageConfig) -> Page:
    """Pure page -> page probe: match the rows, then emit. A NULL probe key
    never matches; SEMI keeps the matches and ANTI the rest (null-aware NOT
    IN also drops NULL probe keys, and every row when a build key was
    NULL); LEFT emits NULL build columns for an unmatched probe row. On a
    CUDA page the PALLAS kind launches the probe kernel."""
    match = aux[0]
    probe_keys = tuple(page.blocks[c].data for c in cfg.probe_key_channels)
    probe_mask = page.mask
    for c in cfg.probe_key_channels:
        if page.blocks[c].nulls is not None:
            probe_mask = probe_mask & ~page.blocks[c].nulls
    if cfg.kind == "dense":
        table, base = match
        row = probe_match_dense(table, base, probe_keys[0], probe_mask)
    elif cfg.kind == "pallas":
        ph_keys, ph_rows = match
        row = probe_match_pallas(ph_keys, ph_rows, probe_keys[0], probe_mask,
                                 cfg.pallas_trips)
    else:
        sorted_key, sorted_row, key_arrays = match
        row = probe_match_sorted(sorted_key, sorted_row, combined_key(probe_keys),
                                 probe_keys, probe_mask, key_arrays)
    return emit_matches(page, row, probe_mask, aux, cfg)


def emit_matches(page: Page, row, probe_mask, aux, cfg: ProbeStageConfig) -> Page:
    """The output page of a page-local probe from each row's build row
    (-1: no match); ``probe_mask`` is the page mask less NULL probe keys."""
    _match, payload, payload_nulls, has_null_key = aux
    matched = row >= 0
    if cfg.join_type in (SEMI, ANTI):
        if cfg.join_type == SEMI:
            keep = page.mask & matched
        else:
            keep = page.mask & ~matched
            if cfg.null_aware:
                keep = keep & probe_mask & ~has_null_key
        sel = page.select_channels(list(cfg.probe_output_channels))
        return Page(sel.blocks, keep)
    return unique_join_page(page, row, payload, payload_nulls, cfg.probe_output_channels,
                            cfg.build_output_channels, cfg.payload_meta,
                            cfg.join_type == INNER, cfg.join_type in (LEFT, FULL))


# ---------------------------------------------------------------------------
# probe
# ---------------------------------------------------------------------------

def probe_match_dense(table, base: int, probe_keys, probe_mask):
    """DENSE unique build: one gather, the build row per probe row (-1: no
    match)."""
    domain = table.shape[0]
    idx = probe_keys.to(torch.int64) - base
    in_range = (idx >= 0) & (idx < domain) & probe_mask
    row = table[torch.where(in_range, idx, 0)]
    return torch.where(in_range, row, -1)


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


def _range_kernel(sorted_key, probe_ck, probe_mask, emit_mask, left: bool = False):
    """Match ranges per probe row: ``(lo, emit_counts, match_counts, total)``,
    the first three int32 as in the reference, ``total`` an int64 scalar
    (not synced here). LEFT emits one row for a live probe row without
    matches (its null-build row)."""
    lo = torch.searchsorted(sorted_key, probe_ck, out_int32=True)
    hi = torch.searchsorted(sorted_key, probe_ck, right=True, out_int32=True)
    lo = torch.where(probe_mask, lo, 0)
    match = torch.where(probe_mask, hi, 0) - lo
    emit = torch.where(emit_mask, match.clamp(min=1), 0) if left else match
    return lo, emit, match, emit.sum(dtype=torch.int64)


def _expand_kernel(page: Page, probe_keys, lo, offsets, match_counts, sorted_row,
                   key_arrays, payload, payload_nulls, probe_channels, build_channels,
                   out_base: int, total: int, left: bool, payload_meta) -> Page:
    """Expanded output rows [out_base, out_base + capacity) as one page of
    the probe page's capacity. Output slot j belongs to the first probe row
    whose running emit count (``offsets``, int64) exceeds j; for LEFT an emit
    slot beyond the row's match count is its null-build row. Candidates are
    verified on the true keys."""
    cap = page.mask.shape[0]
    j = torch.arange(cap, dtype=torch.int64, device=page.device) + out_base
    live = j < total
    pi = torch.searchsorted(offsets, j, right=True).clamp(0, cap - 1)
    prev = torch.where(pi > 0, offsets[(pi - 1).clamp(min=0)], 0)
    k = j - prev
    is_match = k < match_counts[pi]
    spos = (lo[pi] + k).clamp(0, sorted_row.shape[0] - 1)
    brow = torch.where(is_match, sorted_row[spos], 0).long()
    ok = live
    for pk, bk in zip(probe_keys, key_arrays):
        same = bk[brow] == pk[pi]
        ok = ok & (~is_match | same) if left else ok & same
    blocks = []
    for c in probe_channels:
        b = page.blocks[c]
        nulls = b.nulls[pi] if b.nulls is not None else None
        blocks.append(Block(b.type, b.data[pi], nulls, b.dictionary))
    for bi, (t, d) in zip(build_channels, payload_meta):
        bn = payload_nulls[bi] if bi < len(payload_nulls) else None
        nulls = bn[brow] if bn is not None else None
        if left:
            nulls = ~is_match if nulls is None else (nulls | ~is_match)
        blocks.append(Block(t, payload[bi][brow], nulls, d))
    return Page(tuple(blocks), ok)


@dataclasses.dataclass
class _Expansion:
    """One probe page's expansion, emitted chunk by chunk."""
    page: Page
    probe_keys: Tuple[torch.Tensor, ...]
    lo: torch.Tensor
    offsets: torch.Tensor  # int64 running emit counts
    match_counts: torch.Tensor
    total: int
    next_base: int = 0


class LookupJoinOperator(Operator):
    """Probe side: one output page per probe page for a unique build with
    exact keys; otherwise the probe page's expansion, one chunk per
    ``get_output``."""

    def __init__(self, context: OperatorContext, factory: "LookupJoinOperatorFactory"):
        super().__init__(context)
        self.f = factory
        self._outputs: List[Page] = []
        self._source: Optional[LookupSource] = None
        self._expansion: Optional[_Expansion] = None
        # FULL: a device bool per build row, ORed in by every probe page
        self._visited: Optional[torch.Tensor] = None
        self._unmatched_emitted = False
        # the page-local stage's config and build tensors, from the live source
        self._stage_cfg: Optional[ProbeStageConfig] = None
        self._stage_aux = None

    @property
    def output_types(self) -> List[Type]:
        return self.f.output_types

    def is_blocked(self):
        if self._source is not None:
            return None
        lf = self.f.lookup_factory
        w = self.context.worker
        if lf.done(w):
            self._source = lf.get(w)
            return None
        return lambda: lf.done(w)

    def needs_input(self) -> bool:
        return (not self._finishing and self._source is not None
                and self._expansion is None and len(self._outputs) < 4)

    @timed("add_input_ns")
    def add_input(self, page: Page) -> None:
        self.context.record_input(page, page.capacity)
        if self._source is None:  # a caller that drives without is_blocked
            w = self.context.worker
            assert self.f.lookup_factory.done(w), "probe received input before build finished"
            self._source = self.f.lookup_factory.get(w)
        src = self._source
        jt = self.f.join_type
        probe_keys = tuple(page.blocks[c].data for c in self.f.probe_key_channels)
        probe_mask = page.mask
        for c in self.f.probe_key_channels:
            if page.blocks[c].nulls is not None:
                probe_mask = probe_mask & ~page.blocks[c].nulls
        if jt not in (INNER, LEFT, FULL, SEMI, ANTI):
            raise NotImplementedError(f"{jt} join is not ported yet")
        if jt == FULL and self._visited is None:
            self._visited = torch.zeros(src.key_arrays[0].shape[0], dtype=torch.bool,
                                        device=page.device)
        if jt in (SEMI, ANTI) and (self.f.filter_fn is not None or not src.exact_keys):
            self._outputs.append(self._semi_expanded(page, probe_keys, probe_mask))
        elif jt in (SEMI, ANTI) or (src.unique and (src.kind == "dense" or src.exact_keys)):
            cfg, aux = self._stage(src)
            if self._stage_eligible(src):
                self._outputs.append(apply_probe_stage(page, aux, cfg))
            else:  # a packed multi-key build, or a FULL join
                row = self._match_rows(src, probe_keys, probe_mask)
                if jt == FULL:
                    self._visited = _mark_rows(self._visited, row, page.mask)
                self._outputs.append(emit_matches(page, row, probe_mask, aux, cfg))
        else:
            self._start_expansion(page, probe_keys, probe_mask)

    def _stage_eligible(self, src: LookupSource) -> bool:
        """The plan-time fusion predicate on the live build: the fused and
        the unfused probe take the one stage function alike. ``exact_keys``
        is the run-time condition: a float single key range-scans instead."""
        f = self.f
        return probe_plan_fusible(f.join_type, f.probe_key_channels, src.unique,
                                  f.filter_fn) and src.exact_keys

    def _stage(self, src: LookupSource):
        """The page-local probe's config and build tensors, made once."""
        if self._stage_cfg is None:
            self._stage_cfg = probe_stage_cfg(self.f, src)
            self._stage_aux = probe_stage_aux(src)
        return self._stage_cfg, self._stage_aux

    @staticmethod
    def _match_rows(src: LookupSource, probe_keys, probe_mask):
        if src.kind == "dense":
            return probe_match_dense(src.table, src.base, probe_keys[0], probe_mask)
        if src.kind == "pallas":
            return probe_match_pallas(src.ph_keys, src.ph_rows, probe_keys[0],
                                      probe_mask, src.ph_trips)
        return probe_match_sorted(src.sorted_key, src.sorted_row,
                                  src.combine_probe(probe_keys), probe_keys,
                                  probe_mask, src.key_arrays)

    def _start_expansion(self, page: Page, probe_keys, probe_mask) -> None:
        """Count the page's expanded rows (one host sync) and keep what its
        chunks need; ``get_output`` emits them one at a time."""
        src = self._source
        left = self.f.join_type in (LEFT, FULL)
        if left and not src.exact_keys:
            # a mixed-hash collision would mask a probe row's only match slots and
            # silently drop the row; LEFT semantics need exact combined keys
            raise NotImplementedError(
                "multi-key LEFT join on a non-unique build needs exact-key "
                "verification with null-row fallback (single-key LEFT is exact)")
        lo, emit, match_counts, total = _range_kernel(
            src.sorted_key, src.combine_probe(probe_keys), probe_mask, page.mask, left)
        if self.f.join_type == FULL:
            # exact keys (checked above): every build row in a live probe
            # row's [lo, lo + matches) range is a true match
            self._visited = _mark_ranges(self._visited, src.sorted_row, lo, lo + match_counts,
                                         probe_mask & page.mask)
        total = int(total)  # host sync: the page's output cardinality
        METRICS.count("join.expanded_rows", total)
        if total > 0:
            self._expansion = _Expansion(page, probe_keys, lo,
                                         torch.cumsum(emit, 0, dtype=torch.int64),
                                         match_counts, total)

    def _next_chunk(self) -> Page:
        e, src, f = self._expansion, self._source, self.f
        out = _expand_kernel(e.page, e.probe_keys, e.lo, e.offsets, e.match_counts,
                             src.sorted_row, src.key_arrays, src.payload,
                             src.payload_nulls, f.probe_output_channels,
                             f.build_output_channels, e.next_base, e.total,
                             f.join_type in (LEFT, FULL),
                             [src.payload_meta[i] for i in f.build_output_channels])
        e.next_base += e.page.capacity
        if e.next_base >= e.total:
            self._expansion = None
        METRICS.count("join.expansion_chunks")
        return out

    def _semi_expanded(self, page: Page, probe_keys, probe_mask) -> Page:
        """SEMI or ANTI with a join filter or inexact keys: range-scan every
        candidate build row of each probe row, verify the true keys, evaluate
        the filter on the (probe, build) pair and OR the result per probe
        row, one page-capacity chunk of candidate pairs at a time
        (the reference's ``_emit_semi_expanded`` + ``_SemiFilterKernel``)."""
        src = self._source
        lo, count, _match, total = _range_kernel(
            src.sorted_key, src.combine_probe(probe_keys), probe_mask, page.mask)
        offsets = torch.cumsum(count, 0, dtype=torch.int64)
        total = int(total)
        cap = page.capacity
        any_match = torch.zeros(cap, dtype=torch.bool, device=page.device)
        METRICS.count("join.semi_pages")
        for base in range(0, total, cap):
            any_match = self._semi_chunk(page, probe_keys, lo, offsets, base, total,
                                         any_match)
            METRICS.count("join.semi_chunks")
        if self.f.join_type == SEMI:
            keep = page.mask & any_match
        else:
            keep = page.mask & ~any_match
            if self.f.null_aware:
                keep = keep & probe_mask & (not src.has_null_key)
        sel = page.select_channels(self.f.probe_output_channels)
        return Page(sel.blocks, keep)

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
        elif self._expansion is not None:
            out = self._next_chunk()
        else:
            return None
        self.context.record_output(out, out.capacity)
        return out

    def finish(self) -> None:
        if self.f.join_type == FULL and not self._unmatched_emitted:
            self._unmatched_emitted = True
            self._emit_unmatched_build()
        super().finish()

    def _emit_unmatched_build(self) -> None:
        """The FULL join's epilogue, once, after the last probe page: the
        live build rows no probe row visited, then the NULL-key build rows,
        with NULL probe columns, in pages of at most 2^16 rows. A probe that
        saw no page emits every build row."""
        lf = self.f.lookup_factory
        if self._source is None:
            if not lf.done():
                return  # the build never finished: nothing to emit
            self._source = lf.get()
        src = self._source
        rows = np.zeros(0, dtype=np.int64)
        if src.build_count > 0:
            # the sort put the live rows first, so sorted_row[:build_count]
            # is the live rows' index set (the compacted pages are padded)
            live = src.sorted_row[:src.build_count].cpu().numpy().astype(np.int64)
            if self._visited is not None:
                rows = live[~self._visited.cpu().numpy()[live]]
            else:
                rows = live
        n_un, n_null = len(rows), src.null_key_count
        total = n_un + n_null
        if total == 0:
            return
        METRICS.count("join.unmatched_build_rows", total)
        cap = min(max(1 << 10, 1 << (total - 1).bit_length()), 1 << 16)
        cols = []
        for bi in self.f.build_output_channels:
            t, d = src.payload_meta[bi]
            data = [src.payload[bi].cpu().numpy()[rows]]
            bn = src.payload_nulls[bi] if bi < len(src.payload_nulls) else None
            nul = [bn.cpu().numpy()[rows] if bn is not None else np.zeros(n_un, dtype=bool)]
            if n_null:
                data.append(src.null_key_payload[bi])
                nk = src.null_key_nulls[bi]
                nul.append(nk if nk is not None else np.zeros(n_null, dtype=bool))
            cols.append((t, d, np.concatenate(data), np.concatenate(nul)))
        dev = self._visited.device if self._visited is not None else src.sorted_row.device
        for lo in range(0, total, cap):
            hi = min(lo + cap, total)
            blocks = [Block(t, torch.zeros(cap, dtype=torch_dtype(t), device=dev),
                            torch.ones(cap, dtype=torch.bool, device=dev), d)
                      for (t, d) in self.f.probe_output_meta]
            for t, d, data, nul in cols:
                seg = np.zeros(cap, dtype=np.dtype(t.np_dtype))
                seg[:hi - lo] = data[lo:hi]
                nseg = np.zeros(cap, dtype=bool)
                nseg[:hi - lo] = nul[lo:hi]
                blocks.append(Block(t, torch.from_numpy(seg).to(dev),
                                    torch.from_numpy(nseg).to(dev) if nseg.any() else None, d))
            mask = torch.from_numpy(np.arange(cap) < (hi - lo)).to(dev)
            self._outputs.append(Page(tuple(blocks), mask))

    def is_finished(self) -> bool:
        return self._finishing and not self._outputs and self._expansion is None


def _mark_rows(visited: torch.Tensor, row: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """OR the build rows this probe page matched into the visited set."""
    n = visited.shape[0]
    idx = torch.where((row >= 0) & mask, row, n).long()
    ext = torch.cat([visited, visited.new_zeros(1)])
    ext[idx] = True  # a dropped row writes the extra cell
    return ext[:n]


def _mark_ranges(visited: torch.Tensor, sorted_row: torch.Tensor, lo: torch.Tensor,
                 hi: torch.Tensor, probe_mask: torch.Tensor) -> torch.Tensor:
    """OR every build row in a live probe row's sorted range [lo, hi) into
    the visited set: coverage through a difference array, O(n) whatever the
    matches."""
    n = sorted_row.shape[0]
    add = probe_mask.to(torch.int32)
    delta = torch.zeros(n + 1, dtype=torch.int32, device=visited.device)
    delta.index_add_(0, torch.where(probe_mask, lo, n).long(), add)
    delta.index_add_(0, torch.where(probe_mask, hi, n).long(), -add)
    covered = torch.cumsum(delta[:-1], 0) > 0
    by_row = torch.zeros_like(visited)
    by_row[sorted_row.long()] = covered  # sorted_row is a permutation of the rows
    return visited | by_row


class LookupJoinOperatorFactory(OperatorFactory):
    def __init__(self, operator_id: int, lookup_factory: LookupSourceFactory,
                 probe_key_channels: List[int], probe_output_channels: List[int],
                 probe_output_meta: List[Tuple[Type, Optional[Dictionary]]],
                 build_output_channels: List[int],
                 build_output_meta: List[Tuple[Type, Optional[Dictionary]]],
                 join_type: str = INNER, filter_fn=None,
                 filter_probe_channels: Optional[List[int]] = None,
                 filter_build_channels: Optional[List[int]] = None,
                 null_aware: bool = False, unique_build: bool = False):
        super().__init__(operator_id, f"LookupJoin({join_type})")
        # the build's plan-time uniqueness claim: a fused segment takes an
        # INNER/LEFT probe as a stage only on a unique build
        self.unique_build = unique_build
        # SQL IN / NOT IN: a NULL probe key compares UNKNOWN (the row goes),
        # and under NOT IN any NULL build key empties the result; False is
        # EXISTS semantics, where a NULL key just never matches
        self.null_aware = null_aware
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
        self.probe_output_meta = list(probe_output_meta)
        self.output_types = [t for (t, _) in probe_output_meta] + \
                            [t for (t, _) in build_output_meta]

    def create_operator(self, worker: int = 0) -> LookupJoinOperator:
        return LookupJoinOperator(self.context(worker), self)
