"""The hand-built TPC-H Q1 page function of the PyTorch port, and the Q1
scans built on it.

Counterpart of ``presto_tpu/models/kernels.py``:

- ``q1_partials``: one page of Q1 in int64 scaled decimals, which the
  distributed Q1 stage (``parallel/distributed.dist_q1_step``) runs per
  worker and the step of the two scans below runs per batch;
- ``q1_stream``: Q1 streamed through the device over generated
  ``lineitem``, host generation overlapped with the upload and the step;
- ``q1_resident``: Q1 over one batch kept on the device, the warm-table
  rate.

Both scans upload the reference's narrow wire format (``_narrow``: 12
bytes a row) and widen it on the device (``q1_stream_step``). The
reference's ``q1_lane_step`` splits its metrics into 8-bit f32 lanes
because the TPU has no native int64; the card has, so the port keeps int64
throughout and has no lane step (ROADMAP standing difference 33).
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..utils.batching import take_rows

# 1998-12-01 minus 90 days, as days since the epoch (Q1's shipdate cutoff)
Q1_CUTOFF_DAYS = 10471
Q1_N_FLAGS = 3    # l_returnflag domain: A N R
Q1_N_STATUS = 2   # l_linestatus domain: F O
_N_GROUPS = Q1_N_FLAGS * Q1_N_STATUS
_LANES = 1 << 10   # copies of each segment that _segment_sum's adds spread over

# the six partial sums of q1_partials, in its order
Q1_SUMS = ("sum_qty", "sum_base_price", "sum_disc_price", "sum_charge", "sum_disc", "count")


def _segment_sum(values: torch.Tensor, gid: torch.Tensor, num_segments: int) -> torch.Tensor:
    """The (num_segments, k) sums of the rows of ``values`` (n, k) by
    ``gid``. Row i adds into copy i % ``_LANES`` of its segment, so the
    atomic adds of the one ``index_add_`` spread over ``num_segments *
    _LANES`` addresses, not ``num_segments``; a sum folds the copies. Into a
    handful of segments the plain form serialises on its atomics (PERF.md
    has both forms' device times on an H100)."""
    lane = torch.arange(gid.shape[0], device=gid.device) & (_LANES - 1)
    out = torch.zeros((_LANES * num_segments, values.shape[1]), dtype=values.dtype,
                      device=values.device)
    out.index_add_(0, gid.long() + num_segments * lane, values)
    return out.view(_LANES, num_segments, -1).sum(0)


def q1_partials(rf, ls, qty, ep, disc, tax, sd, mask,
                cutoff=Q1_CUTOFF_DAYS, n_flags=Q1_N_FLAGS, n_status=Q1_N_STATUS):
    """One page of TPC-H Q1 -> per-group partial sums (dense direct grouping).

    Inputs: rf/ls int32 dictionary codes, qty/ep/disc/tax int64 scaled
    decimals (cents), sd int32 days, mask the live rows. Returns 6 int64
    tensors of shape (n_flags * n_status,): sum_qty, sum_base_price,
    sum_disc_price (scale 4), sum_charge (scale 6), sum_disc, count.
    """
    D = n_flags * n_status
    keep = mask & (sd <= cutoff)
    gid = torch.where(keep, rf.to(torch.int32) * n_status + ls.to(torch.int32), D)  # D: dump
    zero = torch.zeros((), dtype=torch.int64, device=mask.device)
    disc_price = ep * (100 - disc)        # scale 2 + 2 = 4
    charge = disc_price * (100 + tax)     # scale 4 + 2 = 6
    cols = torch.stack([torch.where(keep, c, zero) for c in (qty, ep, disc_price, charge, disc)]
                       + [keep.to(torch.int64)], dim=1)
    return tuple(_segment_sum(cols, gid, D + 1)[:D].T.contiguous().unbind(0))


_Q1_STREAM_COLS = ["l_returnflag", "l_linestatus", "l_quantity",
                   "l_extendedprice", "l_discount", "l_tax", "l_shipdate"]

# the wire format, in _narrow's order: ep, qty, sd, disc, tax, rf, ls
_WIRE_DTYPES = (torch.int32, torch.int16, torch.int16, torch.int8, torch.int8,
                torch.int8, torch.int8)
# what a padded tail row carries: l_shipdate past the cutoff sends it to
# the dump segment
_PAD_VALUES = (0, 0, 32767, 0, 0, 0, 0)
_CHUNK_ORDERS = 1 << 17   # orders a producer generates at a time
_RING_DEPTH = 3           # staging slots on the card


def _narrow(data: Dict[str, np.ndarray]) -> Tuple[np.ndarray, ...]:
    """Host-side dtype narrowing: the wire format of the streaming scan."""
    return (data["l_extendedprice"].astype(np.int32),
            data["l_quantity"].astype(np.int16),
            data["l_shipdate"].astype(np.int16),
            data["l_discount"].astype(np.int8),
            data["l_tax"].astype(np.int8),
            data["l_returnflag"].astype(np.int8),
            data["l_linestatus"].astype(np.int8))


def q1_stream_step(ep, qty, sd, disc, tax, rf, ls, acc: torch.Tensor) -> torch.Tensor:
    """One uploaded narrow batch of Q1, added into ``acc`` in place.

    The columns are in ``_narrow``'s order and dtypes, on ``acc``'s device;
    every row is live, and a padded row carries ``l_shipdate = 32767`` so
    that it falls past the cutoff. The step widens them and runs
    ``q1_partials``; ``acc`` is the (6, 6) int64 accumulator (``Q1_SUMS`` x
    group), which never leaves the device here.
    """
    i32, i64 = torch.int32, torch.int64
    live = torch.ones(ep.shape[0], dtype=torch.bool, device=ep.device)
    acc += torch.stack(q1_partials(rf.to(i32), ls.to(i32), qty.to(i64), ep.to(i64),
                                   disc.to(i64), tax.to(i64), sd.to(i32), live))
    return acc


def q1_stream_finish(acc: torch.Tensor) -> Dict[str, np.ndarray]:
    """The accumulator -> the reference ``q1_lane_finish``'s contract: six
    int64 arrays of shape (6,), sum_qty (scale 2), sum_base_price (scale
    2), sum_disc_price (scale 4), sum_charge (scale 6), sum_disc (scale 2),
    count."""
    host = acc.cpu().numpy()
    return {k: host[i].copy() for i, k in enumerate(Q1_SUMS)}


def _new_acc(device: torch.device) -> torch.Tensor:
    return torch.zeros((len(Q1_SUMS), _N_GROUPS), dtype=torch.int64, device=device)


class _Staging:
    """Fixed-size batches from the host to the step's device.

    On the card: a ring of pinned host buffers and device buffers, the
    copies on a stream of their own, the step waiting on each copy's event.
    A slot's host buffers are refilled only once its last copy has
    completed, and its device buffers are overwritten only behind the step
    that read them, and freed only behind the copy stream's work. On the
    CPU one slot of host buffers is the batch itself.
    """

    def __init__(self, batch_rows: int, device: torch.device):
        self.device = device
        self.on_card = device.type == "cuda"
        self.copy_stream = torch.cuda.Stream(device) if self.on_card else None
        self.slots = []
        for _ in range(_RING_DEPTH if self.on_card else 1):
            host = tuple(torch.empty(batch_rows, dtype=dt, pin_memory=self.on_card)
                         for dt in _WIRE_DTYPES)
            dev = tuple(torch.empty(batch_rows, dtype=dt, device=device)
                        for dt in _WIRE_DTYPES) if self.on_card else host
            if self.on_card:
                for d in dev:  # freed (an error included) only behind the copies into it
                    d.record_stream(self.copy_stream)
            events = (torch.cuda.Event(), torch.cuda.Event()) if self.on_card else None
            self.slots.append((host, dev, events))
        self._next = 0
        self._current = None  # the events of the slot last uploaded

    def upload(self, cols, n: int):
        """``n`` rows of narrow columns, padded to the batch, on the device
        (behind their copy on the current stream). Call ``consumed`` once
        the step that reads them is queued."""
        host, dev, events = self.slots[self._next]
        self._next = (self._next + 1) % len(self.slots)
        if self.on_card:
            events[0].synchronize()  # the slot's last copy has read its host buffers
        for buf, col, pad in zip(host, cols, _PAD_VALUES):
            arr = buf.numpy()
            arr[:n] = col
            arr[n:] = pad
        if self.on_card:
            with torch.cuda.stream(self.copy_stream):
                self.copy_stream.wait_event(events[1])  # the step that read dev is queued
                for d, h in zip(dev, host):
                    d.copy_(h, non_blocking=True)
                events[0].record(self.copy_stream)
            torch.cuda.current_stream(self.device).wait_event(events[0])
        self._current = events
        return dev

    def consumed(self) -> None:
        if self.on_card:
            self._current[1].record(torch.cuda.current_stream(self.device))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def q1_stream(sf: float, seconds_budget: float = 60.0, batch_rows: int = 1 << 21,
              gen_threads: int = 3, max_rows: Optional[int] = None, device="cuda"):
    """Streaming Q1 over generated lineitem, generation overlapped with the
    device.

    ``gen_threads`` producers generate order-range chunks of 2^17 orders
    and narrow them; the caller's thread re-batches them into
    ``batch_rows``-row batches (the last one padded), uploads each and
    queues ``q1_stream_step`` on an accumulator that stays on the device.
    It stops once ``seconds_budget`` is spent or ``max_rows`` rows were
    dispatched, and a producer's error surfaces as ``RuntimeError``.

    Returns (rows, wall_s, gen_stall_s, first_dispatch_s, finish): the rows
    dispatched, the wall, the seconds spent waiting for a producer, the
    wall of the first batch's upload and step (CUDA's lazy start
    included; the reference's third field is its first compile), and
    ``q1_stream_finish``'s dict.
    """
    from ..connectors.tpch import generator as g

    device = resolve_device(device)
    if batch_rows < 1 or gen_threads < 1:
        raise ValueError("batch_rows and gen_threads must be positive")
    orders = g.TPCH_TABLES["orders"].row_count(sf)
    chunks: queue.Queue = queue.Queue(maxsize=gen_threads * 2)
    stop = threading.Event()
    producer_errors: list = []

    def put(item) -> None:
        while not stop.is_set():
            try:
                chunks.put(item, timeout=0.05)
                return
            except queue.Full:
                continue

    def producer(tid: int) -> None:
        try:
            for lo in range(tid * _CHUNK_ORDERS, orders, gen_threads * _CHUNK_ORDERS):
                if stop.is_set():
                    break
                hi = min(lo + _CHUNK_ORDERS, orders)
                put(_narrow(g.lineitem_for_orders(lo, hi, sf, _Q1_STREAM_COLS)))
        except BaseException as e:  # noqa: BLE001 - surfaced to the caller below
            producer_errors.append(e)
        finally:
            put(None)

    staging = _Staging(batch_rows, device)
    acc = _new_acc(device)
    pend: list = []           # narrow chunks not yet dispatched
    pend_rows = 0
    total_rows = 0
    first_s = None

    def dispatch(n: int) -> None:
        nonlocal pend_rows, total_rows, first_s
        tc = time.perf_counter()
        cols = take_rows(pend, n)
        pend_rows -= n
        q1_stream_step(*staging.upload(cols, n), acc)
        staging.consumed()
        if first_s is None:
            _sync(device)
            first_s = time.perf_counter() - tc
        total_rows += n

    threads = [threading.Thread(target=producer, args=(t,), name=f"q1-stream-producer-{t}",
                                daemon=True) for t in range(gen_threads)]
    for t in threads:
        t.start()
    gen_stall = 0.0
    t0 = time.perf_counter()
    try:
        done = 0
        while done < len(threads):
            ts = time.perf_counter()
            item = chunks.get()
            gen_stall += time.perf_counter() - ts
            if item is None:
                done += 1
                continue
            pend.append(item)
            pend_rows += len(item[0])
            while pend_rows >= batch_rows:
                dispatch(batch_rows)
            if time.perf_counter() - t0 > seconds_budget or \
                    (max_rows is not None and total_rows >= max_rows):
                break
        else:
            if pend_rows > 0 and not producer_errors:
                dispatch(pend_rows)  # the padded tail
        _sync(device)
        wall = time.perf_counter() - t0
    finally:
        stop.set()
        while any(t.is_alive() for t in threads):  # unblock producers on a full queue
            try:
                chunks.get(timeout=0.05)
            except queue.Empty:
                pass
        for t in threads:
            t.join()
    if producer_errors:
        raise RuntimeError("q1_stream producer failed") from producer_errors[0]
    return total_rows, wall, gen_stall, first_s, q1_stream_finish(acc)


def resident_batch(batch_rows: int, sf: float = 1.0) -> Tuple[np.ndarray, ...]:
    """The narrow batch ``q1_resident`` keeps on the device: the first
    orders' lineitem at ``max(sf, 1)``, tiled to ``batch_rows`` rows."""
    from ..connectors.tpch import generator as g

    sf = max(sf, 1.0)
    need_orders = int(batch_rows / g.AVG_LINES_PER_ORDER) + 1
    orders = min(need_orders, g.TPCH_TABLES["orders"].row_count(sf))
    args = _narrow(g.lineitem_for_orders(0, orders, sf, _Q1_STREAM_COLS))
    reps = batch_rows // len(args[0]) + 1
    return tuple(np.tile(a, reps)[:batch_rows] for a in args)


def q1_resident(sf: float, batch_rows: int = 1 << 22, runs: int = 10, device="cuda"):
    """Warm-table Q1 rate: the presto-benchmark LocalQueryRunner pattern
    (the data already in memory; here, on the device as narrow columns).

    Uploads ``resident_batch`` once, runs one step, then times ``runs``
    chained ``q1_stream_step`` calls on the host clock, ending in a
    synchronize; every call adds into the one accumulator, so each works
    on distinct state.

    Returns (rows_per_sec, batch_rows, step_ms, one_batch), ``one_batch``
    the finish dict of the first step alone.
    """
    device = resolve_device(device)
    args = tuple(torch.from_numpy(a).to(device) for a in resident_batch(batch_rows, sf))
    acc = _new_acc(device)
    q1_stream_step(*args, acc)
    one_batch = q1_stream_finish(acc)
    t0 = time.perf_counter()
    for _ in range(runs):
        q1_stream_step(*args, acc)
    _sync(device)
    dt = (time.perf_counter() - t0) / runs
    return batch_rows / dt, batch_rows, dt * 1000.0, one_batch
