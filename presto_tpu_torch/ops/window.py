"""Window functions of the PyTorch port: one sort, then segmented scans.

Counterpart of ``presto_tpu/ops/window.py``. The operator buffers its whole
input (a window sees every row of its partition), concatenates it into one
page at ``finish`` and evaluates every call of one window specification
over ONE sorted layout:

1. a stable sort of the rows by (partition keys..., order keys...), dead
   rows last;
2. partition starts and peer-group starts from adjacent differences;
3. each function as a gather or a scan over that layout:
   ``row_number``, ``rank``, ``dense_rank``, ``ntile``, ``percent_rank``,
   ``cume_dist``, ``nth_value``, ``lag``/``lead``/``first_value``/
   ``last_value`` (clamped positional gathers), and ``count``/``sum``/
   ``avg``/``min``/``max`` as a segmented running scan (ROWS), the scan's
   value at the row's last peer (RANGE) or the whole partition's total
   broadcast back (no ORDER BY);
4. the results scattered back to the input row order.

Sums scan as the reference does: a global cumulative sum less its value
before the segment's start. Min and max have no segmented scan in torch:
each value is encoded with its segment as ``segment * n + rank`` (its rank
among the sorted values, so one int64), a running ``cummax`` takes the
segment's extreme, and the rank decodes back to the value.

The kernel is plain torch ops on the page's device (the reference's is a
jitted JAX function, not a Pallas kernel). Under memory pressure the
buffered pages move to host RAM and come back to the device at ``finish``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..block import Block, Dictionary, Page, torch_dtype
from ..types import Type
from ..utils.metrics import METRICS
from .operator import Operator, OperatorContext, OperatorFactory, timed
from .scan_pipeline import upload_page
from .sorting import lexsort_fast

_I64_MAX = 2 ** 63 - 1
_I64_MIN = -2 ** 63


def _start_positions(new_seg: torch.Tensor) -> torch.Tensor:
    """Each row's segment start (new_seg[0] must be True)."""
    pos = torch.arange(new_seg.shape[0], dtype=torch.int64, device=new_seg.device)
    return torch.cummax(torch.where(new_seg, pos, 0), 0).values


def _seg_scan(op: str, values: torch.Tensor, new_seg: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented scan, reset where ``new_seg`` is True."""
    n = values.shape[0]
    if n == 0:
        return values
    if op == "sum":
        total = torch.cumsum(values, 0)
        start = _start_positions(new_seg)
        base = torch.where(start > 0, total[(start - 1).clamp(min=0)],
                           torch.zeros((), dtype=total.dtype, device=total.device))
        return total - base
    # min/max: (segment, rank of the value) packed in one int64, then cummax
    sorted_vals, _ = torch.sort(values)
    rank = torch.searchsorted(sorted_vals, values)          # int64 in [0, n)
    if op == "min":
        rank = (n - 1) - rank
    seg = torch.cumsum(new_seg.to(torch.int64), 0) - 1
    run = torch.cummax(seg * n + rank, 0).values - seg * n
    if op == "min":
        run = (n - 1) - run
    return sorted_vals[run]


def _segment_total(kind: str, values: torch.Tensor, seg: torch.Tensor, n_seg: int):
    """Reduce ``values`` per segment id (sum/min/max), one entry per segment."""
    if kind == "sum":
        return torch.zeros(n_seg, dtype=values.dtype, device=values.device) \
            .index_add_(0, seg, values)
    fill = _identity_for(kind, values.dtype)
    out = torch.full((n_seg,), fill, dtype=values.dtype, device=values.device)
    return out.scatter_reduce_(0, seg, values, "amin" if kind == "min" else "amax")


def _identity_for(name: str, dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("inf") if name == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if name == "min" else info.min


def _window_kernel(keys, args_and_nulls, mask, calls, n_keys: int, n_ord: int):
    """Evaluate every window call of one specification over one sorted
    layout. ``calls``: (name, n_args, frame_mode, scale_div, offset) each.
    Returns one (values, null_mask or None) per call, in input row order."""
    n = mask.shape[0]
    dev = mask.device
    order = lexsort_fast(tuple(reversed(keys)) + (~mask,)).long()  # dead rows last
    inv = torch.empty(n, dtype=torch.int64, device=dev)
    inv[order] = torch.arange(n, dtype=torch.int64, device=dev)
    sm = mask[order]
    skeys = [k[order] for k in keys]

    first = torch.zeros(n, dtype=torch.bool, device=dev)
    first[:1] = True
    new_part = first | (sm != torch.roll(sm, 1))
    for k in skeys[:n_keys]:
        new_part = new_part | (k != torch.roll(k, 1))
    new_peer = new_part
    for k in skeys[n_keys:n_keys + n_ord]:
        new_peer = new_peer | (k != torch.roll(k, 1))

    pos = torch.arange(n, dtype=torch.int64, device=dev)
    part_start = _start_positions(new_part)
    peer_start = _start_positions(new_peer)
    # the last position of each row's peer group and partition: the same
    # scan over the reversed layout
    peer_end_rev = torch.roll(new_peer, -1)
    peer_end_rev[-1:] = True
    peer_last = (n - 1) - _start_positions(peer_end_rev.flip(0)).flip(0)
    part_end_rev = torch.roll(new_part, -1)
    part_end_rev[-1:] = True
    part_last = (n - 1) - _start_positions(part_end_rev.flip(0)).flip(0)
    part_id = torch.cumsum(new_part.to(torch.int64), 0) - 1

    outs = []
    ai = 0
    for (name, n_args, frame_mode, scale_div, offset) in calls:
        cargs = args_and_nulls[ai: ai + 2 * n_args]
        ai += 2 * n_args
        if name == "row_number":
            outs.append(((pos - part_start + 1)[inv], None))
            continue
        if name == "rank":
            outs.append(((peer_start - part_start + 1)[inv], None))
            continue
        if name == "dense_rank":
            vals = _seg_scan("sum", new_peer.to(torch.int64), new_part)
            outs.append((vals[inv], None))
            continue
        if name == "ntile":
            # the first (s mod b) buckets get ceil(s / b) rows
            s = part_last - part_start + 1
            r = pos - part_start
            q, rem = s // offset, s % offset
            big = rem * (q + 1)
            vals = torch.where(
                q == 0, r + 1,
                torch.where(r < big, r // torch.clamp(q + 1, min=1) + 1,
                            rem + (r - big) // torch.clamp(q, min=1) + 1))
            outs.append((vals[inv], None))
            continue
        if name == "percent_rank":
            s = part_last - part_start + 1
            vals = (peer_start - part_start).to(torch.float64) / \
                torch.clamp(s - 1, min=1).to(torch.float64)
            outs.append((vals[inv], None))
            continue
        if name == "cume_dist":
            s = part_last - part_start + 1
            vals = (peer_last - part_start + 1).to(torch.float64) / s.to(torch.float64)
            outs.append((vals[inv], None))
            continue
        if name == "nth_value":
            v = cargs[0][order]
            vn = cargs[1][order] if cargs[1] is not None else None
            target = part_start + (offset - 1)
            frame_end = peer_last if frame_mode == "range" else pos
            oob = target > frame_end  # beyond the frame, or the partition
            clipped = torch.clamp(target, 0, n - 1)
            nul = oob if vn is None else (vn[clipped] | oob)
            outs.append((v[clipped][inv], nul[inv]))
            continue
        if name in ("lag", "lead", "first_value", "last_value"):
            v = cargs[0][order]
            vn = cargs[1][order] if cargs[1] is not None else None
            if name == "first_value":
                src = part_start
                oob = torch.zeros(n, dtype=torch.bool, device=dev)
            elif name == "last_value":
                # a RANGE frame ends at the last peer, a ROWS frame at the row
                src = peer_last if frame_mode == "range" else pos
                oob = torch.zeros(n, dtype=torch.bool, device=dev)
            else:
                src = pos - (offset if name == "lag" else -offset)
                clipped = torch.clamp(src, 0, n - 1)
                oob = (src < 0) | (src > n - 1) | (part_id[clipped] != part_id)
                src = clipped
            nul = oob if vn is None else (vn[src] | oob)
            outs.append((v[src][inv], nul[inv]))
            continue
        # aggregates: count / sum / avg / min / max
        if n_args == 0:  # count(*)
            live = sm
            contrib = sm.to(torch.int64)
        else:
            v = cargs[0][order]
            vn = cargs[1][order] if cargs[1] is not None else None
            live = sm if vn is None else (sm & ~vn)
            contrib = v
        live_i = live.to(torch.int64)
        if name in ("count", "sum", "avg"):
            c = contrib.to(torch.int64) if name == "count" else contrib
            c = torch.where(live, c, torch.zeros((), dtype=c.dtype, device=dev))
            if n_ord == 0:
                run = _segment_total("sum", c, part_id, n)[part_id]
                nrun = _segment_total("sum", live_i, part_id, n)[part_id]
            else:
                run = _seg_scan("sum", c, new_part)
                nrun = _seg_scan("sum", live_i, new_part)
                if frame_mode == "range":
                    run, nrun = run[peer_last], nrun[peer_last]
            if name == "count":
                outs.append((nrun[inv] if n_args else run[inv], None))
            elif name == "avg":
                vals = run.to(torch.float64) / (torch.clamp(nrun, min=1) * scale_div)
                outs.append((vals[inv], (nrun == 0)[inv]))
            else:
                outs.append((run[inv], (nrun == 0)[inv]))
        else:  # min / max
            c = torch.where(live, contrib, _identity_for(name, contrib.dtype))
            if n_ord == 0:
                run = _segment_total(name, c, part_id, n)[part_id]
                nrun = _segment_total("sum", live_i, part_id, n)[part_id]
            else:
                run = _seg_scan(name, c, new_part)
                nrun = _seg_scan("sum", live_i, new_part)
                if frame_mode == "range":
                    run, nrun = run[peer_last], nrun[peer_last]
            outs.append((run[inv], (nrun == 0)[inv]))
    return tuple(outs)


def _order_encode_float(v: torch.Tensor) -> torch.Tensor:
    """Order-preserving int64 encode of float64 (the IEEE bit trick)."""
    bits = v.to(torch.float64).view(torch.int64)
    return torch.where(bits < 0, (-1 ^ bits) | _I64_MIN, bits)


class WindowOperator(Operator):
    """Buffers every input page (windows are global), evaluates the calls at
    ``finish`` with one kernel and emits one page in input row order."""

    def __init__(self, context: OperatorContext, f: "WindowOperatorFactory"):
        super().__init__(context)
        self.f = f
        self._pages: List[Page] = []       # on the device
        self._host_pages: List[Page] = []  # revoked to host RAM
        self._device = None
        self._results: Optional[List[Page]] = None

    @property
    def output_types(self) -> List[Type]:
        return self.f.output_types

    @timed("add_input_ns")
    def add_input(self, page: Page) -> None:
        self.context.record_input(page, page.capacity)
        self._device = page.device
        self._pages.append(page)
        self.context.update_revocable(self.revocable_bytes(), self.start_memory_revoke)

    # the buffered input takes part in revocation: offloaded to host RAM,
    # re-admitted to the device when the window is computed
    def revocable_bytes(self) -> int:
        return sum(p.accounted_bytes() for p in self._pages)

    def start_memory_revoke(self) -> None:
        METRICS.count("memory.revoked_bytes", self.revocable_bytes())
        self._host_pages.extend(p.to_host() for p in self._pages)
        self._pages = []
        self.context.revocable_memory.set_bytes(0)

    def finish(self) -> None:
        if self._finishing:
            return
        super().finish()
        self._pages = [upload_page(p, self._device) for p in self._host_pages] + self._pages
        self._host_pages = []
        self._results = self._compute()
        self._pages = []
        self.context.revocable_memory.set_bytes(0)

    def _concat(self) -> Page:
        """Every buffered page as one page (dead rows included)."""
        if len(self._pages) == 1:
            return self._pages[0]
        blocks = []
        for c in range(len(self._pages[0].blocks)):
            b0 = self._pages[0].blocks[c]
            data = torch.cat([p.blocks[c].data for p in self._pages])
            nulls = None
            if any(p.blocks[c].nulls is not None for p in self._pages):
                nulls = torch.cat([p.blocks[c].null_mask() for p in self._pages])
            blocks.append(Block(b0.type, data, nulls, b0.dictionary))
        return Page(tuple(blocks), torch.cat([p.mask for p in self._pages]))

    def _compute(self) -> List[Page]:
        if not self._pages:
            return []
        page = self._concat()
        f = self.f
        keys = [self._sort_key(page.blocks[ch], False, False) for ch in f.partition_channels]
        keys += [self._sort_key(page.blocks[o.channel], o.descending, o.nulls_first)
                 for o in f.orderings]
        args_and_nulls = []
        # min/max over a dictionary VARCHAR order by rank, not code: they run
        # on ranks and map the result back to codes
        unrank: List[Optional[torch.Tensor]] = []
        for (name, arg_chs, _fm, _sd, _off) in f.call_channels:
            post = None
            for i, ch in enumerate(arg_chs):
                b = page.blocks[ch]
                data = b.data
                if i == 0 and name in ("min", "max") and b.dictionary is not None \
                        and hasattr(b.dictionary, "values"):
                    data = b.dictionary.sort_table("ranks", data.device)[data.long()]
                    post = b.dictionary.sort_table("order", data.device)  # rank -> code
                args_and_nulls.append(data)
                args_and_nulls.append(b.nulls)
            unrank.append(post)
        outs = _window_kernel(tuple(keys), tuple(args_and_nulls), page.mask,
                              tuple(f.call_channels_static()),
                              len(f.partition_channels), len(f.orderings))
        blocks = list(page.blocks)
        for (vals, nulls), (t, d), post in zip(outs, f.call_meta, unrank):
            if post is not None:
                vals = post[torch.clamp(vals.long(), 0, post.shape[0] - 1)]
            blocks.append(Block(t, vals.to(torch_dtype(t)), nulls, d))
        out = Page(tuple(blocks), page.mask)
        self.context.record_output(out, out.capacity)
        return [out]

    @staticmethod
    def _sort_key(block: Block, descending: bool, nulls_first: bool) -> torch.Tensor:
        """Order-preserving int64 encode of a column with its NULL placement
        (a dictionary VARCHAR by rank, floats by the IEEE bit trick)."""
        d = block.dictionary
        if d is not None and hasattr(d, "values"):
            v = d.sort_table("ranks", block.data.device)[block.data.long()].to(torch.int64)
        elif d is not None and not getattr(d, "monotonic", False):
            raise NotImplementedError(
                f"window ordering over non-monotonic virtual dictionary {d!r}")
        elif block.data.is_floating_point():
            v = _order_encode_float(block.data)
        else:
            v = block.data.to(torch.int64)
        if descending:
            v = -v
        if block.nulls is not None:
            big = _I64_MAX - 1
            v = torch.where(block.nulls, -big if nulls_first else big, v)
        return v

    @timed("get_output_ns")
    def get_output(self) -> Optional[Page]:
        if self._results:
            return self._results.pop(0)
        return None

    def is_finished(self) -> bool:
        return self._finishing and not self._results


class WindowOperatorFactory(OperatorFactory):
    """``call_channels``: (function name, argument channels, frame mode,
    DECIMAL scale divisor for avg, offset) per call; ``call_meta``: the
    output (type, dictionary) per call."""

    def __init__(self, operator_id: int, partition_channels: List[int], orderings: List,
                 call_channels: List[Tuple[str, List[int], str, int, int]],
                 call_meta: List[Tuple[Type, Optional[Dictionary]]],
                 input_types: List[Type]):
        super().__init__(operator_id, "Window")
        self.partition_channels = partition_channels
        self.orderings = orderings      # [SortOrder(channel, descending, nulls_first)]
        self.call_channels = call_channels
        self.call_meta = call_meta
        self.output_types = list(input_types) + [t for t, _ in call_meta]

    def call_channels_static(self):
        return [(name, len(chs), fm, sd, off) for (name, chs, fm, sd, off) in self.call_channels]

    def create_operator(self, worker: int = 0) -> WindowOperator:
        return WindowOperator(self.context(worker), self)
