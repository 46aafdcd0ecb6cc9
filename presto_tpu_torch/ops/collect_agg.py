"""Collecting aggregation of the PyTorch port: array_agg, map_agg, histogram.

Counterpart of ``presto_tpu/ops/collect_agg.py``. The builder keeps every
input page on the device. At finish ONE lexicographic sort by the null-safe
group keys (``_collect_combined``, over ``lexsort_fast``) makes each group's
rows a contiguous segment: the group boundaries are the offsets of the
ragged (offsets, values) pair. The algebraic aggregates of the same GROUP
BY reduce over the same permutation (``_reduce_all``), so their groups line
up with the collected ones. At the output boundary the segments are
decoded on the host and installed in the call's ``ArrayValues`` store (one
``extend`` per call), and the output column is the int32 handle array.

- ``array_agg`` keeps NULL elements; ``map_agg`` and ``histogram`` skip
  rows whose key is NULL, and ``map_agg`` keeps a key's first value.
- A group with no collected row gets handle -1 (NULL), and a global
  collect over no input is one all-NULL group.
- Element order inside an array is the sorted order, which is
  engine-defined, as the reference's.

Under memory pressure the kept pages move to host RAM (``spill``) and come
back to the device when the result is built, as in the reference.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..block import _NP_TO_TORCH, Block, Page, torch_dtype
from ..types import (BOOLEAN, BigintType, BooleanType, DoubleType, IntegerType, RealType,
                     SmallintType, Type, is_floating)
from ..utils.metrics import METRICS
from .aggregates import AggregateCall
from .hash_agg import (_call_contributions, _host, _null_safe_keys, _reduce_all,
                       _state_widths, _where_valid)
from .scan_pipeline import upload_page
from .sorting import lexsort_fast

#: the aggregate names the collect builder implements
COLLECT_NAMES = ("array_agg", "map_agg", "histogram")

# types whose to_python is the numpy scalar's own Python value
_PLAIN_TYPES = (BigintType, IntegerType, SmallintType, DoubleType, RealType, BooleanType)


def _pow2(n: int) -> int:
    return 1 << max(10, (max(n, 1) - 1).bit_length())


def _collect_combined(keys, mask, contribs, cols, kinds, identities, widths):
    """One sort by the null-safe keys feeds both halves: the algebraic
    states by segment reduction over the permutation, and the collect
    columns permuted, with the group-boundary mask."""
    n = mask.shape[0]
    dev = mask.device
    order = lexsort_fast(tuple(reversed(keys)) + (~mask,)).long()
    sk = tuple(k[order] for k in keys)
    sv = mask[order]
    sc = tuple((c[0][order], c[1][order]) if isinstance(c, tuple) else c[order]
               for c in contribs)
    scol = tuple(c[order] for c in cols)
    first = torch.zeros(n, dtype=torch.bool, device=dev)
    first[:1] = True
    diff = torch.zeros(n, dtype=torch.bool, device=dev)
    for k in sk:
        diff = diff | (k != torch.roll(k, 1))
    new_group = sv & (first | diff)
    gid = torch.cumsum(new_group.to(torch.int32), 0, dtype=torch.int32) - 1
    num_groups = gid[-1] + 1 if n > 0 else torch.zeros((), dtype=torch.int32, device=dev)
    gid = torch.where(sv, gid, n)  # dead rows into the trash segment
    states = _reduce_all(sc, kinds, identities, widths, gid, n)
    gkeys = []
    for k in sk:
        # every row of a group holds the same key, so any writer wins
        out = torch.zeros(n + 1, dtype=k.dtype, device=dev)
        out[gid.long()] = k
        gkeys.append(out[:n])
    gvalid = torch.arange(n, device=dev) < num_groups
    states = [_where_valid(gvalid, s, ident) for s, ident in zip(states, identities)]
    return tuple(gkeys), tuple(states), gvalid, scol, sv, new_group


def _decode(vals: np.ndarray, nulls: Optional[np.ndarray], t: Type, d) -> list:
    """Host values -> Python values (``Page.to_pylists``'s decoding)."""
    if d is not None:
        out = list(d.lookup(vals.astype(np.int64)))
    elif isinstance(t, _PLAIN_TYPES):
        out = vals.tolist()
    else:
        out = [t.to_python(v) for v in vals]
    if nulls is not None:
        out = [None if n else v for v, n in zip(out, nulls.tolist())]
    return out


def _count_pairs(gids: np.ndarray, vals: np.ndarray):
    """The distinct (group, value) pairs, sorted, and how often each
    occurs: through one int64 key when the value range allows it (a
    dictionary's codes), else a row-wise unique."""
    if len(vals) == 0:
        return gids, vals, np.zeros(0, dtype=np.int64)
    lo, span = int(vals.min()), int(vals.max()) - int(vals.min()) + 1
    if (int(gids.max()) + 1) * span < 2 ** 62:
        keys, n = np.unique(gids.astype(np.int64) * span + (vals - lo), return_counts=True)
        return keys // span, keys % span + lo, n
    pairs, n = np.unique(np.stack([gids, vals]), axis=1, return_counts=True)
    return pairs[0], pairs[1], n


class CollectAggregationBuilder:
    """Keeps all input rows; one sorted pass at finish (module doc)."""

    compact_table = True
    from_intermediate = False

    def __init__(self, key_types: Sequence[Type], calls: Sequence[AggregateCall],
                 device="cuda"):
        self.user_key_types = list(key_types)
        # the internal key signature interleaves a BOOLEAN null flag per key
        self.key_types = [x for t in key_types for x in (t, BOOLEAN)]
        self.calls = list(calls)
        self._device = torch.device(device)
        self._key_channels = ()
        self._pages: List[Page] = []
        self._host_pages: List[Page] = []  # revoked to host RAM
        self._bytes = 0

    def set_channels(self, key_channels) -> "CollectAggregationBuilder":
        self._key_channels = tuple(key_channels)
        return self

    def add_page(self, page: Page) -> None:
        self._pages.append(page)
        self._bytes += sum(b.data.numel() * b.data.element_size() for b in page.blocks)

    def memory_bytes(self) -> int:
        """The kept pages' data bytes on the device."""
        return self._bytes

    def spill(self) -> None:
        """Revocation: the kept pages move to host RAM."""
        METRICS.count("memory.revoked_bytes", self._bytes)
        self._host_pages.extend(p.to_host() for p in self._pages)
        self._pages = []
        self._bytes = 0

    def _concat_page(self) -> Optional[Page]:
        """Every kept page as one page of a power-of-two capacity, revoked
        pages re-admitted to the device first."""
        pages = [upload_page(p, self._device) for p in self._host_pages] + self._pages
        self._host_pages, self._pages = [], []
        if not pages:
            return None
        total = sum(p.capacity for p in pages)
        pad = _pow2(total) - total
        dev = pages[0].device

        def cat(parts, dtype):
            if pad:
                parts = parts + [torch.zeros(pad, dtype=dtype, device=dev)]
            return torch.cat(parts)

        blocks = []
        for i, b0 in enumerate(pages[0].blocks):
            data = cat([p.blocks[i].data for p in pages], b0.data.dtype)
            nulls = None
            if any(p.blocks[i].nulls is not None for p in pages):
                nulls = cat([p.blocks[i].null_mask() for p in pages], torch.bool)
            blocks.append(Block(b0.type, data, nulls, b0.dictionary))
        return Page(tuple(blocks), cat([p.mask for p in pages], torch.bool))

    def _collect_columns(self, page: Page):
        """Per collect call: the tensors to permute (its row filter, then
        each argument's data and null flags) and what the host decoding
        needs; None for an algebraic call."""
        cols, meta = [], []
        for call in self.calls:
            name = call.function.name
            if name not in COLLECT_NAMES:
                meta.append(None)
                continue
            part = page.mask
            if call.mask_channel is not None:
                mc = page.blocks[call.mask_channel]
                mcv = mc.data.to(torch.bool)
                if mc.nulls is not None:
                    mcv = mcv & ~mc.nulls
                part = part & mcv
            if name in ("map_agg", "histogram"):  # no NULL keys or values
                b = page.blocks[call.input_channels[0]]
                if b.nulls is not None:
                    part = part & ~b.nulls
            arrs, slots = [part], []
            for ch in call.input_channels:
                b = page.blocks[ch]
                arrs.append(b.data)
                if b.nulls is not None:
                    arrs.append(b.nulls)
                slots.append((b.type, b.dictionary, b.nulls is not None))
            cols.extend(arrs)
            meta.append((slots, len(arrs)))
        return cols, meta

    @staticmethod
    def _entries(name: str, decoded: List[list], bounds: np.ndarray) -> list:
        """One store entry per group: rows ``bounds[g]:bounds[g + 1]`` of the
        decoded argument columns, or None for a group with no row (a counted
        histogram's two columns are its distinct values and their counts)."""
        out = []
        for g in range(len(bounds) - 1):
            lo, hi = int(bounds[g]), int(bounds[g + 1])
            if lo == hi:
                out.append(None)
            elif name == "array_agg":
                out.append(tuple(decoded[0][lo:hi]))
            elif name == "map_agg":
                seen = {}
                for k, v in zip(decoded[0][lo:hi], decoded[1][lo:hi]):
                    if k not in seen:
                        seen[k] = v
                out.append(tuple(seen.items()))
            elif len(decoded) == 2:  # histogram of counted distinct values
                out.append(tuple(zip(decoded[0][lo:hi], decoded[1][lo:hi])))
            else:  # histogram
                counts = {}
                for k in decoded[0][lo:hi]:
                    counts[k] = counts.get(k, 0) + 1
                out.append(tuple(counts.items()))
        return out

    def finish(self):
        page = self._concat_page()
        if page is None:
            return self._empty()
        keys = _null_safe_keys(page, self._key_channels) if self._key_channels else \
            (torch.zeros(page.capacity, dtype=torch.int32, device=page.device),
             torch.zeros(page.capacity, dtype=torch.bool, device=page.device))
        algebraic = [c for c in self.calls if c.function.name not in COLLECT_NAMES]
        contribs = _call_contributions(algebraic, page)
        kinds = tuple(col.reduce for c in algebraic for col in c.function.state)
        idents = tuple(col.identity for c in algebraic for col in c.function.state)
        cols, meta = self._collect_columns(page)
        gkeys, states, gvalid, scol, sv, new_group = _collect_combined(
            keys, page.mask, tuple(contribs), tuple(cols), kinds, idents,
            _state_widths(algebraic))
        alg_states, it = {}, iter(states)
        for c in algebraic:
            alg_states[id(c)] = [next(it) for _ in c.function.state]

        # the host boundary: group boundaries are the ragged offsets
        sv_h, ng_h = _host(sv), _host(new_group)
        gid = np.cumsum(ng_h) - 1  # each sorted row's group (live rows)
        num_groups = int(ng_h.sum())
        handles_of = []
        cursor = 0
        for call, m in zip(self.calls, meta):
            if m is None:
                continue
            slots, n_arrs = m
            arrs = [_host(scol[cursor + k]) for k in range(n_arrs)]
            cursor += n_arrs
            keep = np.flatnonzero(arrs[0] & sv_h)
            t0, d0, _ = slots[0]
            if call.function.name == "histogram" and (d0 is not None or not is_floating(t0)):
                # equal values are equal raw values here: count (group,
                # value) pairs first, so only the distinct values decode
                gids, vals, n = _count_pairs(gid[keep], arrs[1][keep].astype(np.int64))
                decoded = [_decode(vals, None, t0, d0), n.tolist()]
            else:
                decoded, ai = [], 1
                for t, d, has_nulls in slots:
                    vals = arrs[ai][keep]
                    ai += 1
                    nulls = arrs[ai][keep] if has_nulls else None
                    ai += int(has_nulls)
                    decoded.append(_decode(vals, nulls, t, d))
                gids = gid[keep]
            counts = np.bincount(gids, minlength=num_groups) if num_groups else \
                np.zeros(0, dtype=np.int64)
            bounds = np.concatenate([[0], np.cumsum(counts)])
            entries = self._entries(call.function.name, decoded, bounds)
            handles = np.full(max(num_groups, 1), -1, dtype=np.int32)
            filled = [g for g, e in enumerate(entries) if e is not None]
            if filled:
                store = call.function.output_dict
                handles[filled] = store.extend([entries[g] for g in filled])
            handles_of.append(handles)

        dev = page.device
        out_states, it = [], iter(handles_of)
        if not self.user_key_types:  # global: exactly one group
            for call, m in zip(self.calls, meta):
                if m is None:
                    out_states.extend(s[:1] for s in alg_states[id(call)])
                else:
                    out_states.append(torch.from_numpy(next(it)[:1]).to(dev))
            return (), tuple(out_states), torch.ones(1, dtype=torch.bool, device=dev)
        # grouped: the handles are in sorted group order, as gkeys and states
        cap = page.capacity
        for call, m in zip(self.calls, meta):
            if m is None:
                out_states.extend(alg_states[id(call)])
            else:
                h = next(it)
                full = np.full(cap, -1, dtype=np.int32)
                full[:min(len(h), cap)] = h[:cap]
                out_states.append(torch.from_numpy(full).to(dev))
        return gkeys, tuple(out_states), gvalid

    def _empty(self):
        """No input: zero groups, or one all-NULL group for a global collect."""
        dev = self._device
        n = 0 if self.user_key_types else 1
        states = []
        for call in self.calls:
            if call.function.name in COLLECT_NAMES:
                states.append(torch.full((n,), -1, dtype=torch.int32, device=dev))
                continue
            for col in call.function.state:
                shape = (n, col.width) if col.width > 1 else (n,)
                states.append(torch.full(shape, col.identity,
                                         dtype=_NP_TO_TORCH[np.dtype(col.dtype)], device=dev))
        keys = tuple(torch.zeros(0, dtype=torch_dtype(t), device=dev) for t in self.key_types)
        return keys, tuple(states), torch.ones(n, dtype=torch.bool, device=dev)

