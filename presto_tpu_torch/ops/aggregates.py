"""Aggregate functions of the PyTorch port: sum, count and avg.

Counterpart of ``presto_tpu/ops/aggregates.py``. A function is a descriptor
whose per-row contributions (``input_map``), per-state-column reduce kind
and final transform (``final_map``) slot into the grouping kernels: state is
a struct of arrays indexed by group id.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..types import BIGINT, DOUBLE, DecimalType, Type, is_floating

SUM, MIN, MAX = "sum", "min", "max"  # reduce kinds of the grouping kernels


@dataclasses.dataclass
class StateColumn:
    """One array in the aggregate's state struct."""
    dtype: np.dtype
    reduce: str          # SUM | MIN | MAX
    identity: object     # fill value for empty groups


@dataclasses.dataclass
class AggregateFunction:
    """How to turn input rows into state contributions and state into output."""
    name: str
    output_type: Type
    state: List[StateColumn]
    # (input_tensors, valid_mask) -> per-row contributions, one per state column
    input_map: Callable
    # state tensors -> output tensor, or (output, null_mask)
    final_map: Callable
    intermediate_types: List[Type] = dataclasses.field(default_factory=list)
    # string-producing aggregates carry their output dictionary here; none
    # of the ported ones produces strings
    output_dict: object = None


def _ones(mask):
    return torch.where(mask, 1, 0).to(torch.int64)


def resolve_aggregate(name: str, arg_types: Sequence[Type], distinct: bool = False,
                      params: Sequence[object] = ()) -> AggregateFunction:
    """Aggregate lookup by name and argument types, with the reference's
    signature: ``sum``, ``avg`` and ``count``/``count(*)``. DISTINCT and
    literal parameters are not ported and raise."""
    name = name.lower()
    if distinct:
        raise NotImplementedError(f"{name}(DISTINCT ...) is not ported yet")
    if params:
        raise NotImplementedError(f"{name} with literal parameters is not ported yet")
    if name == "count":
        return AggregateFunction(
            "count", BIGINT, [StateColumn(np.dtype(np.int64), SUM, 0)],
            lambda args, mask: (_ones(mask),), lambda s: s[0], [BIGINT])
    if name == "sum":
        t = arg_types[0]
        # second state column = contributing-row count: SQL sum over an
        # empty/all-null group is NULL
        if isinstance(t, DecimalType):
            out = DecimalType(18, t.scale)
            return AggregateFunction(
                "sum", out,
                [StateColumn(np.dtype(np.int64), SUM, 0),
                 StateColumn(np.dtype(np.int64), SUM, 0)],
                lambda args, mask: (torch.where(mask, args[0].to(torch.int64), 0),
                                    _ones(mask)),
                lambda s: (s[0], s[1] == 0), [out, BIGINT])
        if is_floating(t):
            return AggregateFunction(
                "sum", DOUBLE,
                [StateColumn(np.dtype(np.float64), SUM, 0.0),
                 StateColumn(np.dtype(np.int64), SUM, 0)],
                lambda args, mask: (torch.where(mask, args[0].to(torch.float64), 0.0),
                                    _ones(mask)),
                lambda s: (s[0], s[1] == 0), [DOUBLE, BIGINT])
        return AggregateFunction(
            "sum", BIGINT,
            [StateColumn(np.dtype(np.int64), SUM, 0),
             StateColumn(np.dtype(np.int64), SUM, 0)],
            lambda args, mask: (torch.where(mask, args[0].to(torch.int64), 0),
                                _ones(mask)),
            lambda s: (s[0], s[1] == 0), [BIGINT, BIGINT])
    if name == "avg":
        t = arg_types[0]
        if isinstance(t, DecimalType):
            # exact: sum the scaled integers (as sum() does) and take the
            # reciprocal multiply once, on the sum. The reference sums
            # float64 per-row contributions; over SF1 Q1's 1.5 M rows a group
            # that way drifts 1.3e-12 from the exact average on the card,
            # this way it stays within a few ulps of it
            inv = 1.0 / 10.0 ** t.scale
            return AggregateFunction(
                "avg", DOUBLE,
                [StateColumn(np.dtype(np.int64), SUM, 0),
                 StateColumn(np.dtype(np.int64), SUM, 0)],
                lambda args, mask: (torch.where(mask, args[0].to(torch.int64), 0),
                                    _ones(mask)),
                lambda s: (s[0].to(torch.float64) * inv
                           / torch.clamp(s[1], min=1).to(torch.float64), s[1] == 0),
                [DecimalType(18, t.scale), BIGINT])
        return AggregateFunction(
            "avg", DOUBLE,
            [StateColumn(np.dtype(np.float64), SUM, 0.0),
             StateColumn(np.dtype(np.int64), SUM, 0)],
            lambda args, mask: (torch.where(mask, args[0].to(torch.float64), 0.0),
                                _ones(mask)),
            lambda s: (s[0] / torch.clamp(s[1], min=1).to(torch.float64), s[1] == 0),
            [DOUBLE, BIGINT])
    raise NotImplementedError(f"aggregate {name} is not ported yet")


@dataclasses.dataclass
class AggregateCall:
    """One aggregate in a GROUP BY: function + input channels."""
    function: AggregateFunction
    input_channels: List[int]
    mask_channel: Optional[int] = None  # FILTER (WHERE ...) channel
    # channels of the state columns when consuming partial states (a FINAL
    # step; the port runs SINGLE steps only, so the planner leaves it None)
    intermediate_channels: Optional[List[int]] = None
    # dictionary of the output block (min/max over varchar pass codes through)
    output_dictionary: Optional[object] = None
