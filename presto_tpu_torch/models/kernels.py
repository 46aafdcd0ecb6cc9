"""The hand-built TPC-H Q1 page function of the PyTorch port.

Counterpart of ``presto_tpu/models/kernels.py`` ``q1_partials``, which the
distributed Q1 stage (``parallel/distributed.dist_q1_step``) runs per
worker. The reference's ``q1_lane_step``, ``q1_stream`` and
``q1_resident`` work around the TPU's missing native int64 and drive
``bench.py``; they are not ported.
"""
from __future__ import annotations

import torch

# 1998-12-01 minus 90 days, as days since the epoch (Q1's shipdate cutoff)
Q1_CUTOFF_DAYS = 10471
Q1_N_FLAGS = 3    # l_returnflag domain: A N R
Q1_N_STATUS = 2   # l_linestatus domain: F O


def _segment_sum(values: torch.Tensor, gid: torch.Tensor, num_segments: int) -> torch.Tensor:
    out = torch.zeros(num_segments, dtype=values.dtype, device=values.device)
    return out.index_add_(0, gid.long(), values)


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
    gid = torch.where(keep, rf.to(torch.int32) * n_status + ls.to(torch.int32), D)
    zero = torch.zeros((), dtype=torch.int64, device=mask.device)
    disc_price = ep * (100 - disc)        # scale 2 + 2 = 4
    charge = disc_price * (100 + tax)     # scale 4 + 2 = 6
    cols = (torch.where(keep, qty, zero), torch.where(keep, ep, zero),
            torch.where(keep, disc_price, zero), torch.where(keep, charge, zero),
            torch.where(keep, disc, zero), keep.to(torch.int64))
    return tuple(_segment_sum(c, gid, D + 1)[:D] for c in cols)
