"""Distributed stage programs over the mesh.

Counterpart of ``presto_tpu/parallel/distributed.py``. A reference stage is
one SPMD program under ``shard_map``: every worker runs the same function on
its shard, and the stage's exchanges are collectives inside it. Here a
stage runs the same per-worker function on each worker's tensors, and the
collectives of ``parallel/exchange.py`` join them. Each ``dist_*_step``
returns the stage: it takes global arrays (split evenly over the workers,
as the reference's ``P(WORKER_AXIS)`` inputs) and returns the reference's
outputs, a replicated output once (worker 0's copy) and a sharded one as
the workers' shards concatenated.

- ``dist_q1_step``: direct grouping per worker, then a psum (Q1's shape).
- ``dist_join_agg_step``: both join sides repartitioned by key, a local
  sort-merge join, a partial aggregation and a psum (Q3's shape).
- ``dist_grouped_agg_step``: local sort-group partials, repartitioned by
  key hash, then a final sort-group combine.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..ops.hash_agg import sort_group_reduce
from .exchange import psum, repartition
from .mesh import MeshContext

_I64_MAX = int(np.iinfo(np.int64).max)


def _shard(mesh_ctx: MeshContext, args) -> List[List[torch.Tensor]]:
    """Global arrays -> per-worker lists of shards on each worker's device."""
    shards = [mesh_ctx.sharded(torch.as_tensor(np.asarray(a))) for a in args]
    return [[s[w] for s in shards] for w in range(mesh_ctx.n_workers)]


def _segment_sum(values: torch.Tensor, gid: torch.Tensor, num_segments: int) -> torch.Tensor:
    out = torch.zeros(num_segments, dtype=values.dtype, device=values.device)
    return out.index_add_(0, gid.long(), values)


def dist_q1_step(mesh_ctx: MeshContext, n_flags: int = 3, n_status: int = 2):
    """Distributed TPC-H Q1: per-worker direct grouping, then one psum.

    Inputs (global, split over the workers): rf, ls int32 codes; qty, ep,
    disc, tax int64 cents; sd int32 days; mask. Output: the 6 replicated
    (n_flags * n_status,) group tables."""
    from ..models.kernels import q1_partials

    devices = mesh_ctx.devices

    def step(*args):
        parts = [q1_partials(*w_args, n_flags=n_flags, n_status=n_status)
                 for w_args in _shard(mesh_ctx, args)]
        return tuple(psum([p[i] for p in parts], devices)[0] for i in range(6))
    return step


def dist_join_agg_step(mesh_ctx: MeshContext, probe_cap_per_peer: int):
    """Q3's stage shape: both sides repartitioned by join key (all_to_all),
    a local sort-merge join on unique build keys, a partial aggregation by
    build value bucket, and psums of the partials and drop counts."""
    W = mesh_ctx.n_workers
    devices = mesh_ctx.devices

    def local_join(bk, bv, bm, pk, pv, pm):
        skey = torch.where(bm, bk, _I64_MAX)
        order = torch.argsort(skey, stable=True)
        skey_s = skey[order]
        pos = torch.searchsorted(skey_s, pk).clamp(0, skey_s.shape[0] - 1)
        hit = (skey_s[pos] == pk) & pm
        brow = torch.where(hit, order[pos], 0)
        joined = torch.where(hit, pv + bv[brow], 0)
        gid = torch.where(hit, bv[brow] % 64, 64)
        return (_segment_sum(joined, gid, 65)[:64],
                _segment_sum(hit.to(torch.int64), gid, 65)[:64])

    def step(*args):
        per = _shard(mesh_ctx, args)
        bsides, bmasks, bkeys = [[a[0], a[1]] for a in per], [a[2] for a in per], \
            [a[0] for a in per]
        (b_out, bm, bdrop) = repartition(bsides, bmasks, bkeys, W, probe_cap_per_peer, devices)
        psides, pmasks, pkeys = [[a[3], a[4]] for a in per], [a[5] for a in per], \
            [a[3] for a in per]
        (p_out, pm, pdrop) = repartition(psides, pmasks, pkeys, W, probe_cap_per_peer, devices)
        parts = [local_join(b_out[w][0], b_out[w][1], bm[w], p_out[w][0], p_out[w][1], pm[w])
                 for w in range(W)]
        total = psum([p[0] for p in parts], devices)[0]
        count = psum([p[1] for p in parts], devices)[0]
        dropped = psum([bd + pd for bd, pd in zip(bdrop, pdrop)], devices)[0]
        return total, count, dropped
    return step


def dist_grouped_agg_step(mesh_ctx: MeshContext, n_keys: int, n_states: int,
                          kinds, identities, max_groups: int):
    """General distributed GROUP BY: local sort-group partials, each group
    repartitioned to the worker owning its key, a final sort-group
    combine. Distinct groups past ``max_groups`` count as dropped, so a
    truncated result fails loudly. -> keys..., states..., valid (sharded)
    and the total drop count (replicated)."""
    W = mesh_ctx.n_workers
    devices = mesh_ctx.devices
    kinds, identities = tuple(kinds), tuple(identities)

    def step(*args):
        per = _shard(mesh_ctx, args)
        arrays, masks, keys = [], [], []
        for a in per:
            cap = a[-1].shape[0]
            gkeys, gstates, gvalid, _ = sort_group_reduce(
                tuple(a[:n_keys]), a[-1], tuple(a[n_keys:n_keys + n_states]),
                kinds, identities, cap)
            arrays.append(list(gkeys) + list(gstates))
            masks.append(gvalid)
            keys.append(gkeys[0])
        routed, rmasks, dropped = repartition(arrays, masks, keys, W, max_groups, devices)
        outs, overflow = [], []
        for w in range(W):
            fkeys, fstates, fvalid, fnum = sort_group_reduce(
                tuple(routed[w][:n_keys]), rmasks[w], tuple(routed[w][n_keys:]),
                kinds, identities, max_groups)
            outs.append(list(fkeys) + list(fstates) + [fvalid])
            overflow.append(dropped[w] + (fnum - max_groups).clamp(min=0).to(dropped[w].dtype))
        cols = tuple(torch.cat([o[i].to(devices[0]) for o in outs])
                     for i in range(n_keys + n_states + 1))
        return cols + (psum(overflow, devices)[0],)
    return step
