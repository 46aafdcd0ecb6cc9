"""Collective exchanges: the data plane between logical workers.

Counterpart of ``presto_tpu/parallel/exchange.py``. The reference's
exchanges run inside ``shard_map``: each worker sorts its rows by target
partition into ``(n_parts, cap)`` send buffers, and one ``all_to_all``
(``all_gather`` for a broadcast) moves them over the mesh. Here the same
per-worker halves run on each worker's tensors, and the collective is a
plain PyTorch op over the per-worker list (``all_to_all``, ``all_gather``,
``psum``): worker p receives every worker's partition-p slice, in source
order, on its own device.

Every function takes and returns per-worker lists: ``arrays[w]`` is worker
w's list of column tensors, ``masks[w]`` its live-row mask. Partition ids
equal the reference's bit for bit (``partition_ids`` builds the unsigned
64-bit remainder from the int64 bit pattern), and each worker receives its
rows in the reference's order: a stable sort by partition id, then source
order. A scatter that the reference writes with ``mode="drop"`` writes a
trash slot past the end here, which is sliced off.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..ops.hash_join import _mix64

_LO32 = 0xFFFFFFFF


def _unsigned_mod(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` read as uint64, modulo ``n`` (n < 2^31), from its 32-bit
    halves: (hi * 2^32 + lo) mod n = ((hi mod n) * (2^32 mod n) + lo) mod n,
    every term well inside int64."""
    hi = (x >> 32) & _LO32
    lo = x & _LO32
    return ((hi % n) * ((1 << 32) % n) + lo) % n


def partition_ids(key: torch.Tensor, n_parts: int) -> torch.Tensor:
    """Row -> target partition: mix, then the unsigned modulo, so dense keys
    spread. The mix is the join kernels' ``_mix64``, so exchange routing
    and build hashing never diverge."""
    return _unsigned_mod(_mix64(key.to(torch.int64)), n_parts).to(torch.int32)


def range_partition_ids(range_key: torch.Tensor, splitters: torch.Tensor,
                        mask: torch.Tensor, n_parts: int) -> torch.Tensor:
    """Row -> partition by value range: worker w receives keys in
    (splitters[w-1], splitters[w]] (a distributed ORDER BY's routing);
    ``n_parts`` for a dead row."""
    splitters = splitters.to(device=range_key.device, dtype=range_key.dtype)
    pid = torch.searchsorted(splitters, range_key.contiguous(), right=False).to(torch.int32)
    return torch.where(mask, pid.clamp(0, n_parts - 1), n_parts).to(torch.int32)


# ---------------------------------------------------------------------------
# the collectives over per-worker lists
# ---------------------------------------------------------------------------

def all_to_all(send: Sequence[torch.Tensor], devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """``send[w]`` is worker w's ``(W, cap)`` buffer; worker p receives the
    ``(W * cap,)`` concatenation of every worker's row p, in source order."""
    return [torch.cat([s[p].to(dev) for s in send]) for p, dev in enumerate(devices)]


def all_gather(xs: Sequence[torch.Tensor], devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """Every worker receives the concatenation of all workers' tensors."""
    return [torch.cat([x.to(dev) for x in xs]) for dev in devices]


def psum(xs: Sequence[torch.Tensor], devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """Every worker receives the sum of all workers' tensors."""
    out = []
    for dev in devices:
        acc = xs[0].to(dev)
        for x in xs[1:]:
            acc = acc + x.to(dev)
        out.append(acc)
    return out


def _devices(masks: Sequence[torch.Tensor], devices) -> List[torch.device]:
    return list(devices) if devices is not None else [m.device for m in masks]


def _scatter(n: int, tgt: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Zeros of length ``n`` with ``values`` written at ``tgt``; a target of
    ``n`` is the trash slot, dropped."""
    out = torch.zeros(n + 1, dtype=values.dtype, device=values.device)
    out[tgt.long()] = values
    return out[:n]


# ---------------------------------------------------------------------------
# repartition: the per-worker halves and the collective
# ---------------------------------------------------------------------------

def _sort_by_pid(pid: torch.Tensor):
    """Stable order by partition, and each row's slot within its partition."""
    n = pid.shape[0]
    order = torch.argsort(pid, stable=True)
    pid_s = pid[order]
    pos = torch.arange(n, dtype=torch.int32, device=pid.device) - \
        torch.searchsorted(pid_s, pid_s, right=False).to(torch.int32)
    return order, pid_s, pos


def _send_buffers(arrays, order, pid_s, pos, keep, n_parts: int, cap: int):
    """The kept (pid-sorted) rows scattered into ``(n_parts, cap)`` send
    buffers, and the send mask."""
    tgt = torch.where(keep, pid_s * cap + pos, n_parts * cap)
    send_mask = _scatter(n_parts * cap, tgt, keep).reshape(n_parts, cap)
    bufs = [_scatter(n_parts * cap, tgt, a[order]).reshape(n_parts, cap) for a in arrays]
    return bufs, send_mask


def _route_kept(send_per_worker, n_arrays: int, devices):
    """all_to_all of every worker's send buffers -> (arrays, mask) per worker."""
    outs = [all_to_all([s[0][i] for s in send_per_worker], devices) for i in range(n_arrays)]
    recv_masks = all_to_all([s[1] for s in send_per_worker], devices)
    return [[outs[i][w] for i in range(n_arrays)] for w in range(len(devices))], recv_masks


def repartition(arrays, masks, keys, n_parts: int, out_cap_per_peer: int, devices=None):
    """All-to-all repartition by key hash. Each worker sends at most
    ``out_cap_per_peer`` rows to each peer; the rest are DROPPED and counted.
    -> (arrays, masks, dropped) per worker; a worker's received arrays have
    ``n_parts * out_cap_per_peer`` rows."""
    pids = [torch.where(m, partition_ids(k, n_parts), n_parts).to(torch.int32)
            for k, m in zip(keys, masks)]
    return repartition_by_pid(arrays, masks, pids, n_parts, out_cap_per_peer, devices)


def repartition_by_pid(arrays, masks, pids, n_parts: int, out_cap_per_peer: int,
                       devices=None):
    """Route rows to the peers named by ``pids`` (``n_parts`` = dead). The
    shared tail of the hash REPARTITION and range MERGE exchanges."""
    devices = _devices(masks, devices)
    sends, dropped = [], []
    for arrs, pid in zip(arrays, pids):
        order, pid_s, pos = _sort_by_pid(pid)
        keep = (pid_s < n_parts) & (pos < out_cap_per_peer)
        dropped.append(((pid_s < n_parts) & ~keep).sum())
        sends.append(_send_buffers(arrs, order, pid_s, pos, keep, n_parts, out_cap_per_peer))
    outs, recv_masks = _route_kept(sends, len(arrays[0]), devices)
    return outs, recv_masks, dropped


def repartition_by_pid_with_carry(arrays, masks, pids, n_parts: int,
                                  out_cap_per_peer: int, devices=None):
    """The streaming exchange's variant: a worker's overflow rows (those
    ``repartition_by_pid`` would drop) come back compacted to the front of
    same-shape carry buffers, which the pump feeds into the next chunk.
    -> (arrays, masks, carry arrays, carry masks) per worker."""
    devices = _devices(masks, devices)
    sends, carries, carry_masks = [], [], []
    for arrs, pid in zip(arrays, pids):
        n = pid.shape[0]
        order, pid_s, pos = _sort_by_pid(pid)
        live = pid_s < n_parts
        keep = live & (pos < out_cap_per_peer)
        overflow = live & ~keep
        sends.append(_send_buffers(arrs, order, pid_s, pos, keep, n_parts, out_cap_per_peer))
        ctgt = torch.where(overflow, torch.cumsum(overflow.to(torch.int32), 0) - 1, n)
        carry_masks.append(_scatter(n, ctgt, overflow))
        carries.append([_scatter(n, ctgt, a[order]) for a in arrs])
    outs, recv_masks = _route_kept(sends, len(arrays[0]), devices)
    return outs, recv_masks, carries, carry_masks


def broadcast_gather(arrays, masks, devices=None):
    """FIXED_BROADCAST: every worker receives every worker's rows."""
    devices = _devices(masks, devices)
    n = len(arrays[0])
    outs = [all_gather([a[i] for a in arrays], devices) for i in range(n)]
    return [[outs[i][w] for i in range(n)] for w in range(len(devices))], \
        all_gather(masks, devices)


def gather_to_single(arrays, masks, devices=None):
    """SINGLE: every row on worker 0, masked off elsewhere."""
    outs, ms = broadcast_gather(arrays, masks, devices)
    return outs, [m if w == 0 else torch.zeros_like(m) for w, m in enumerate(ms)]


def psum_scalar(xs, devices=None) -> List[torch.Tensor]:
    return psum(xs, _devices(xs, devices))
