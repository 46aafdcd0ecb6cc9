"""Aggregate functions of the PyTorch port.

Counterpart of ``presto_tpu/ops/aggregates.py``. A function is a descriptor
whose per-row contributions (``input_map``), per-state-column reduce kind
and final transform (``final_map``) slot into the grouping kernels: state is
a struct of arrays indexed by group id.

- ``count``, ``sum``, ``avg``, ``min``, ``max``;
- ``min_by``/``max_by``: an AMIN/AMAX column holds an order-preserving int64
  ordering key and the ACARRY columns right after it carry the winning
  row's payload; the grouping kernels reduce the pair jointly;
- the variance family, ``covar_*``/``corr`` (sums of powers, the
  reference's formulas), ``bool_and``/``bool_or``/``every``, ``count_if``,
  ``arbitrary``/``any_value``;
- the sketches, each ONE vector state (``StateColumn.width`` > 1) whose
  per-row contribution is a ``(bucket, value)`` pair: ``approx_distinct``
  (HyperLogLog, m = 2048) and ``approx_percentile`` (a 769-bucket log
  histogram, the fraction a literal parameter).

- the collecting aggregates ``array_agg``, ``map_agg`` and ``histogram``:
  one "collect" state column of int32 handles into an ``ArrayValues``
  store, filled by ``ops/collect_agg.CollectAggregationBuilder``.

Plugin aggregates (``regr_*``, ``learn_*`` of ``presto_tpu_torch.functions.ml``)
resolve through ``register_aggregate``; a name that no built-in and no
registered resolver knows raises ``NotImplementedError`` naming itself.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..block import _NP_TO_TORCH
from ..types import (BIGINT, BOOLEAN, DOUBLE, DecimalType, Type, is_floating,
                     is_string)

SUM, MIN, MAX = "sum", "min", "max"  # reduce kinds of the grouping kernels
# paired (joint) kinds: an AMIN/AMAX column holds the ordering key, and the
# ACARRY columns right after it take the payload of the row that won it
AMIN, AMAX, ACARRY = "amin", "amax", "acarry"

_I64_MAX = 2 ** 63 - 1
_I64_MIN = -2 ** 63


@dataclasses.dataclass
class StateColumn:
    """One array in the aggregate's state struct. ``width`` > 1 makes it a
    VECTOR state: a (width,) entry per group, reduced over rows only."""
    dtype: np.dtype
    reduce: str          # SUM | MIN | MAX | AMIN | AMAX | ACARRY
    identity: object     # fill value for empty groups
    width: int = 1


@dataclasses.dataclass
class AggregateFunction:
    """How to turn input rows into state contributions and state into output."""
    name: str
    output_type: Type
    state: List[StateColumn]
    # (input_tensors, valid_mask) -> per-row contributions, one per state
    # column; a vector state's contribution is a (bucket, value) pair
    input_map: Callable
    # state tensors -> output tensor, or (output, null_mask)
    final_map: Callable
    intermediate_types: List[Type] = dataclasses.field(default_factory=list)
    # states that may ride pages between PARTIAL and FINAL steps (vector
    # states and the joint pairs may not)
    splittable: bool = True
    # cache identity (utils/kernel_cache.agg_call_key), set by resolve_aggregate
    fingerprint: tuple = ()
    # the output block's dictionary: the ArrayValues store of a collecting
    # aggregate
    output_dict: object = None
    # which argument indices' NULLs exclude the row; None = all of them.
    # min_by/max_by skip only NULL ordering values: a NULL payload can win
    null_skip_channels: Optional[tuple] = None
    # input_map is called as input_map(args, arg_null_masks, mask) when set
    needs_arg_nulls: bool = False
    # the literal parameters it was resolved with (approx_percentile's fraction)
    params: tuple = ()


def _ones(mask):
    return torch.where(mask, 1, 0).to(torch.int64)


def resolve_aggregate(name: str, arg_types: Sequence[Type], distinct: bool = False,
                      params: Sequence[object] = ()) -> AggregateFunction:
    """Aggregate lookup by name, argument types and literal parameters, with
    the reference's signature. DISTINCT is planned away before this (the
    port raises on it here)."""
    fn = _resolve_aggregate(name, arg_types, distinct, params)
    # the resolve arguments fully determine the function's behaviour
    fn.fingerprint = (name.lower(), tuple(t.name for t in arg_types),
                      bool(distinct), tuple(params))
    fn.params = tuple(params)
    return fn


def _resolve_aggregate(name: str, arg_types: Sequence[Type], distinct: bool,
                       params: Sequence[object]) -> AggregateFunction:
    name = name.lower()
    if distinct:
        raise NotImplementedError(f"{name}(DISTINCT ...) is not ported yet")
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
    if name in ("min", "max"):
        t = arg_types[0]
        if is_string(t):
            # VARCHAR reduces dictionary codes, as the reference does (ranks
            # for an unsorted dictionary, ops/hash_agg.py); the planner hands
            # the column's dictionary to the output block
            dtype = np.dtype(np.int32)
            ident = np.int32(2**31 - 1) if name == "min" else np.int32(-(2**31))
        else:
            dtype = np.dtype(t.np_dtype)
            if dtype.kind == "f":
                ident = np.inf if name == "min" else -np.inf
            else:
                info = np.iinfo(dtype)
                ident = info.max if name == "min" else info.min
        # a masked-off row contributes the identity; the row count marks an
        # empty group NULL
        tdtype, fill = _NP_TO_TORCH[dtype], _scalar(dtype, ident)
        return AggregateFunction(
            name, t,
            [StateColumn(dtype, MIN if name == "min" else MAX, ident),
             StateColumn(np.dtype(np.int64), SUM, 0)],
            lambda args, mask: (torch.where(mask, args[0].to(tdtype), fill), _ones(mask)),
            lambda s: (s[0], s[1] == 0), [t, BIGINT])
    if name in ("min_by", "max_by"):
        return _min_max_by(name, arg_types)
    if name in ("array_agg", "map_agg", "histogram"):
        # the collecting aggregates (ops/collect_agg.py): the state column is
        # the int32 handle into the ArrayValues store made here, which the
        # output block carries as its dictionary
        from ..block import ArrayValues
        from ..types import ArrayType, MapType
        if name == "array_agg":
            out_t, store = ArrayType(arg_types[0]), ArrayValues("array")
        elif name == "map_agg":
            out_t, store = MapType(arg_types[0], arg_types[1]), ArrayValues("map")
        else:
            out_t, store = MapType(arg_types[0], BIGINT), ArrayValues("map")
        return AggregateFunction(
            name, out_t, [StateColumn(np.dtype(np.int32), "collect", -1)],
            None,  # the collect builder takes the rows themselves
            lambda s: (s[0], s[0] < 0), [], splittable=False, output_dict=store)
    if name in ("stddev", "stddev_samp", "stddev_pop", "variance", "var_samp", "var_pop"):
        return _variance(name, arg_types[0])
    if name in ("bool_or", "bool_and"):
        is_or = name == "bool_or"
        ident = 0 if is_or else 1
        return AggregateFunction(
            name, BOOLEAN,
            [StateColumn(np.dtype(np.int64), MAX if is_or else MIN, ident),
             StateColumn(np.dtype(np.int64), SUM, 0)],
            lambda args, mask: (torch.where(mask, args[0].to(torch.int64), ident),
                                _ones(mask)),
            lambda s: (s[0] != 0, s[1] == 0), [BOOLEAN, BIGINT])
    if name == "count_if":
        return AggregateFunction(
            "count_if", BIGINT, [StateColumn(np.dtype(np.int64), SUM, 0)],
            lambda args, mask: (_ones(mask & args[0].to(torch.bool)),),
            lambda s: s[0], [BIGINT])
    if name == "every":
        return resolve_aggregate("bool_and", arg_types, distinct)
    if name in ("arbitrary", "any_value"):
        # deterministic "any": the max value (dictionary codes for VARCHAR,
        # whatever their order: any value is acceptable)
        t = arg_types[0]
        dtype = np.dtype(np.int32) if is_string(t) else np.dtype(t.np_dtype)
        if dtype.kind == "f":
            ident = -np.inf
        elif dtype.kind == "b":
            ident = False
        else:
            ident = np.iinfo(dtype).min
        tdtype, fill = _NP_TO_TORCH[dtype], _scalar(dtype, ident)
        return AggregateFunction(
            name, t,
            [StateColumn(dtype, MAX, ident), StateColumn(np.dtype(np.int64), SUM, 0)],
            lambda args, mask: (torch.where(mask, args[0].to(tdtype), fill), _ones(mask)),
            lambda s: (s[0], s[1] == 0), [t, BIGINT])
    if name in ("covar_samp", "covar_pop", "corr"):
        return _covariance(name, arg_types[0], arg_types[1])
    if name == "approx_distinct":
        return _approx_distinct()
    if name == "approx_percentile":
        return _approx_percentile(arg_types[0], params)
    ext = EXTERNAL_AGGREGATES.get(name)
    if ext is not None:
        return ext(arg_types, distinct, params)
    raise NotImplementedError(f"aggregate {name} is not ported yet")


# pluggable aggregates: ``(arg_types, distinct, params) -> AggregateFunction``
# resolvers, registered by the function libraries beside
# sql/analyzer.register_aggregate_name, which routes the name through
# aggregation planning
EXTERNAL_AGGREGATES: dict = {}


def register_aggregate(name: str, resolver) -> None:
    EXTERNAL_AGGREGATES[name.lower()] = resolver


def _scalar(dtype: np.dtype, value):
    """A numpy identity as the Python scalar ``torch.where`` takes."""
    if dtype.kind == "f":
        return float(value)
    if dtype.kind == "b":
        return bool(value)
    return int(value)


def _min_max_by(name: str, arg_types: Sequence[Type]) -> AggregateFunction:
    """min_by(x, y): x of the row with the least y. State = (sortable int64
    ordering key, carried payload, carried payload-null flag, row count)."""
    if len(arg_types) != 2:
        raise NotImplementedError(
            f"{name} takes exactly 2 arguments (the top-n form is not supported)")
    tx = arg_types[0]
    is_min = name == "min_by"
    okind = AMIN if is_min else AMAX
    oident = _I64_MAX if is_min else _I64_MIN
    carry_dtype = np.dtype(np.int32) if is_string(tx) else np.dtype(tx.np_dtype)
    carry_ident = False if carry_dtype.kind == "b" else carry_dtype.type(0)
    carry_torch, carry_fill = _NP_TO_TORCH[carry_dtype], _scalar(carry_dtype, carry_ident)

    def input_map(args, arg_nulls, mask):
        ys = torch.where(mask, _sortable_i64(args[1]), oident)
        carry = torch.where(mask, args[0].to(carry_torch), carry_fill)
        carry_null = torch.where(mask, arg_nulls[0].to(torch.int64), 0)
        return ys, carry, carry_null, _ones(mask)

    return AggregateFunction(
        name, tx,
        [StateColumn(np.dtype(np.int64), okind, oident),
         StateColumn(carry_dtype, ACARRY, carry_ident),
         StateColumn(np.dtype(np.int64), ACARRY, 0),
         StateColumn(np.dtype(np.int64), SUM, 0)],
        input_map,
        lambda s: (s[1], (s[3] == 0) | (s[2] != 0)),
        [], splittable=False, null_skip_channels=(1,), needs_arg_nulls=True)


def _variance(name: str, t: Type) -> AggregateFunction:
    """The reference's sum / sum-of-squares formula (not Welford's), so a
    DOUBLE result agrees with it to rounding."""
    pop = name.endswith("_pop")
    is_std = name.startswith("stddev")
    div = 10.0 ** (t.scale if isinstance(t, DecimalType) else 0)

    def input_map(args, mask):
        x = torch.where(mask, args[0].to(torch.float64) / div, 0.0)
        return x, x * x, _ones(mask)

    def final_map(s):
        n = torch.clamp(s[2], min=1).to(torch.float64)
        mean = s[0] / n
        var = s[1] / n - mean * mean
        if not pop:
            var = var * n / torch.clamp(n - 1, min=1)
        var = torch.clamp(var, min=0.0)
        return (torch.sqrt(var) if is_std else var), s[2] == 0

    return AggregateFunction(
        name, DOUBLE,
        [StateColumn(np.dtype(np.float64), SUM, 0.0),
         StateColumn(np.dtype(np.float64), SUM, 0.0),
         StateColumn(np.dtype(np.int64), SUM, 0)],
        input_map, final_map, [DOUBLE, DOUBLE, BIGINT])


def _covariance(name: str, tx: Type, ty: Type) -> AggregateFunction:
    """covar_samp/covar_pop/corr over the reference's state layout: sums of
    x, y, xy, x^2, y^2 and the row count."""
    dx = 10.0 ** (tx.scale if isinstance(tx, DecimalType) else 0)
    dy = 10.0 ** (ty.scale if isinstance(ty, DecimalType) else 0)
    want_corr = name == "corr"
    pop = name == "covar_pop"

    def input_map(args, mask):
        x = torch.where(mask, args[0].to(torch.float64) / dx, 0.0)
        y = torch.where(mask, args[1].to(torch.float64) / dy, 0.0)
        return x, y, x * y, x * x, y * y, _ones(mask)

    def final_map(s):
        n = torch.clamp(s[5], min=1).to(torch.float64)
        mx, my = s[0] / n, s[1] / n
        cov = s[2] / n - mx * my
        if want_corr:
            vx = torch.clamp(s[3] / n - mx * mx, min=0.0)
            vy = torch.clamp(s[4] / n - my * my, min=0.0)
            denom = torch.sqrt(vx * vy)
            out = torch.where(denom > 0, cov / torch.clamp(denom, min=1e-300), 0.0)
            return out, (s[5] == 0) | (denom <= 0)
        if not pop:
            return cov * n / torch.clamp(n - 1, min=1), s[5] <= 1
        return cov, s[5] == 0

    return AggregateFunction(
        name, DOUBLE,
        [StateColumn(np.dtype(np.float64), SUM, 0.0) for _ in range(5)]
        + [StateColumn(np.dtype(np.int64), SUM, 0)],
        input_map, final_map, [DOUBLE] * 5 + [BIGINT])


# --- sketches -------------------------------------------------------------

HLL_M = 2048
HLL_LOG2M = 11
_INV_LN2 = 1.0 / math.log(2.0)


def _approx_distinct() -> AggregateFunction:
    """HyperLogLog with m = 2048 registers, one vector state per group:
    register j holds the largest rho of the hashes that land in bucket j.
    Masked rows go to bucket m, one past the table, which the grouping
    kernels drop."""

    def input_map(args, mask):
        h = _hash_to_u64(args[0])
        bucket = ((h >> (64 - HLL_LOG2M)) & (HLL_M - 1)).to(torch.int32)
        rest = (h << HLL_LOG2M) | (HLL_M - 1)
        rho = _hll_rho(rest)
        return ((torch.where(mask, bucket, HLL_M), rho),)

    def final_map(s):
        regs = s[0]                             # (groups, m) float32
        # the reference sums the float32 powers in float32; the sum is taken
        # here exactly in float64 and rounded once, so the card and the CPU
        # agree bit for bit
        total = torch.exp2(-regs.to(torch.float64)).sum(dim=-1).to(torch.float32)
        k = (0.7213 / (1 + 1.079 / HLL_M)) * HLL_M * HLL_M
        est = (torch.tensor(k, dtype=torch.float32, device=regs.device) / total) \
            .to(torch.float64)
        zeros = (regs == 0).sum(dim=-1)
        # small-range correction (linear counting)
        small = HLL_M * torch.log(HLL_M / torch.clamp(zeros, min=1).to(torch.float64))
        est = torch.where((est <= 2.5 * HLL_M) & (zeros > 0), small, est)
        return torch.round(est).to(torch.int64)

    return AggregateFunction(
        "approx_distinct", BIGINT,
        [StateColumn(np.dtype(np.float32), MAX, 0.0, width=HLL_M)],
        input_map, final_map, [], splittable=False)


def _u64_to_f64(u: torch.Tensor) -> torch.Tensor:
    """The uint64 bit pattern in int64 ``u`` as the nearest float64, as a
    native unsigned conversion rounds it. Values at or above 2^63 (negative
    in int64) convert ``(u >> 1) | (u & 1)``, which keeps the sticky bit,
    and double it: one rounding, never two."""
    half = ((u >> 1) & _I64_MAX) | (u & 1)
    return torch.where(u < 0, half.to(torch.float64) * 2.0, u.to(torch.float64))


def _floor_log2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) of positive float64 ``x`` as the reference computes it:
    its log2 is log(x) * (1 / ln 2), which is not exact at powers of two
    (log2(2^k) may round below k). An exact power of two reads that result
    from a table made once on the host, so the card and the CPU agree."""
    mant, exp = torch.frexp(x)
    pow2 = mant == 0.5
    table = _pow2_floor_log2(x.device)
    idx = torch.clamp(exp.to(torch.int64) - 1 + _POW2_LO, 0, table.shape[0] - 1)
    return torch.where(pow2, table[idx], torch.floor(torch.log(x) * _INV_LN2))


_POW2_LO = 1022     # 2^-1022, the least normal float64, is table entry 0
_POW2_TABLES = {}


def _pow2_floor_log2(device) -> torch.Tensor:
    dev = torch.device(device)
    if dev not in _POW2_TABLES:
        powers = torch.tensor([math.ldexp(1.0, k) for k in range(-_POW2_LO, 1024)],
                              dtype=torch.float64)
        vals = torch.floor(torch.log(powers) * _INV_LN2)
        _POW2_TABLES[dev] = vals.to(dev)
    return _POW2_TABLES[dev]


def _hll_rho(rest: torch.Tensor) -> torch.Tensor:
    """rho = leading zeros + 1 of ``rest``, from the float exponent of its
    float64 value as the reference takes it (a value just below 2^k may
    round up to 2^k there, and then so here), clipped to [1, 54], float32."""
    msb = _floor_log2(_u64_to_f64(rest))
    return torch.clamp(64.0 - msb, 1.0, 64.0 - HLL_LOG2M + 1.0).to(torch.float32)


# approx_percentile's histogram: octaves 2^-16 .. 2^31 x 8 sub-buckets x 2
# signs, and one zero bucket
_OCT_LO, _OCT_HI, _SUB = -16, 31, 8
_N_OCT = _OCT_HI - _OCT_LO + 1
_HALF = _N_OCT * _SUB
PCT_BUCKETS = 2 * _HALF + 1


def _percentile_centers() -> np.ndarray:
    centers = np.zeros(PCT_BUCKETS, dtype=np.float64)
    for i in range(_N_OCT):
        for sub_i in range(_SUB):
            mid = 2.0 ** (_OCT_LO + i) * (1.0 + (sub_i + 0.5) / _SUB)
            centers[_HALF + 1 + i * _SUB + sub_i] = mid
            centers[_HALF - 1 - i * _SUB - sub_i] = -mid
    return centers


_EXP2_TABLES = {}


def _octave_scale(device) -> torch.Tensor:
    """2^e for e in [-16, 31] as the reference computes it (exp(e * ln 2),
    a few ulps from the power of two), made once on the host."""
    dev = torch.device(device)
    if dev not in _EXP2_TABLES:
        e = torch.arange(_OCT_LO, _OCT_HI + 1, dtype=torch.float64)
        _EXP2_TABLES[dev] = torch.exp(e * math.log(2.0)).to(dev)
    return _EXP2_TABLES[dev]


def _percentile_bucket(v: torch.Tensor) -> torch.Tensor:
    """The histogram bucket of each value: octave, sub-bucket, sign."""
    mag = torch.abs(v.to(torch.float64))
    exp = torch.clamp(_floor_log2(torch.clamp(mag, min=1e-300)), _OCT_LO, _OCT_HI)
    scale = _octave_scale(v.device)[(exp - _OCT_LO).to(torch.int64)]
    sub = torch.clamp(torch.floor((mag / scale - 1.0) * _SUB), 0, _SUB - 1)
    off = ((exp - _OCT_LO) * _SUB + sub + 1).to(torch.int32)
    return torch.where(v == 0, _HALF, torch.where(v > 0, _HALF + off, _HALF - off)) \
        .to(torch.int32)


def _approx_percentile(t: Type, params: Sequence[object]) -> AggregateFunction:
    """A log-bucketed histogram sketch as one vector state of float64 counts;
    the percentile is read off the cumulative histogram at the bucket's
    midpoint. Masked rows go to bucket K, one past the table."""
    int_out = not is_floating(t)  # decimals and integers stay scaled integers
    centers = _percentile_centers()
    pct = float(params[0]) if params else 0.5
    if not 0.0 < pct <= 1.0:
        raise ValueError("approx_percentile fraction must be in (0, 1]")

    def input_map(args, mask):
        b = torch.where(mask, _percentile_bucket(args[0]), PCT_BUCKETS)
        return ((b, torch.ones(b.shape[0], dtype=torch.float64, device=b.device)),)

    def final_map(s):
        hist = s[0]                             # (groups, K) float64 counts
        total = hist.sum(dim=-1)
        target = torch.ceil(pct * torch.clamp(total, min=1.0))
        cum = torch.cumsum(hist, dim=-1)
        idx = torch.argmax((cum >= target[..., None]).to(torch.uint8), dim=-1)
        vals = torch.from_numpy(centers).to(hist.device)[idx]
        out = torch.round(vals).to(torch.int64) if int_out else vals
        return out, total == 0

    return AggregateFunction(
        "approx_percentile", t if int_out else DOUBLE,
        [StateColumn(np.dtype(np.float64), SUM, 0.0, width=PCT_BUCKETS)],
        input_map, final_map, [], splittable=False)


# --- helpers --------------------------------------------------------------

def _sortable_i64(y: torch.Tensor) -> torch.Tensor:
    """Order-preserving map of a column into int64 (the min_by/max_by
    ordering key): integers, dates and booleans widen; floats take the
    IEEE-754 total-order bit trick (a negative value flips every bit but
    the sign, a positive one stays)."""
    if y.is_floating_point():
        u = y.to(torch.float64).view(torch.int64)
        return torch.where(u < 0, ~u ^ _I64_MIN, u)
    return y.to(torch.int64)


def _hash_to_u64(a0: torch.Tensor) -> torch.Tensor:
    """Column -> uniform 64-bit hash, its uint64 bits in an int64 tensor
    (floats hash their bit pattern, so 1.25 != 1.75)."""
    if a0.is_floating_point():
        x = a0.to(torch.float64).view(torch.int64)
    else:
        x = a0.to(torch.int64)
    return _sketch_mix(x)


def _sketch_mix(x: torch.Tensor) -> torch.Tensor:
    from .hash_join import _mix64

    return _mix64(x)


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
