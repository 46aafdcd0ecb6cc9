"""ML-in-SQL functions of the PyTorch port (``presto_tpu/functions/ml.py``).

- ``regr_slope(y, x)``, ``regr_intercept(y, x)``, ``regr_r2(y, x)``: the SQL
  simple-regression aggregates over six scalar sum states.
- ``learn_linear_regressor(y, x1..xk)`` (alias ``learn_regressor``) and
  ``learn_classifier(label, x1..xk)``: one vector state holding the normal
  equations' sufficient statistics (XᵀX and Xᵀy flattened, an intercept
  feature first), summed by the grouping like ``sum``; ``final_map`` solves
  each group's d×d system on the host and emits the model as a VARCHAR JSON
  of coefficients, through a dictionary made when the aggregate resolves.
  The classifier fits ±1 labels the same way.
- ``regress(model, x1..xk)`` and ``classify(model, x1..xk)``: the
  coefficients decode once per distinct model string, and the dot product
  runs on the device.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from ..block import Dictionary
from ..ops.aggregates import SUM, AggregateFunction, StateColumn, register_aggregate
from ..ops.expressions import Call, register_compiler
from ..sql.analyzer import (SemanticError, cast_to, register_aggregate_name,
                            register_scalar_function)
from ..types import BIGINT, BOOLEAN, DOUBLE, VARCHAR, DecimalType, is_numeric, is_string


def _to_double(arr: torch.Tensor, t) -> torch.Tensor:
    """A raw column in float64 value space (a DECIMAL is a scaled int)."""
    v = arr.to(torch.float64)
    if isinstance(t, DecimalType):
        v = v / (10 ** t.scale)
    return v


def _check_numeric_args(name, arg_types, expect=None):
    if expect is not None and len(arg_types) != expect:
        raise SemanticError(f"{name}() takes {expect} arguments, got {len(arg_types)}")
    for t in arg_types:
        if not (is_numeric(t) or t is BOOLEAN):
            raise SemanticError(f"{name}() arguments must be numeric (got {t.name})")


def _regr_resolver(which: str):
    def resolve(arg_types, distinct, params):
        if distinct:
            raise SemanticError(f"{which} DISTINCT is not defined")
        _check_numeric_args(which, arg_types, expect=2)
        tys = list(arg_types)

        def input_map(args, mask):
            y = torch.where(mask, _to_double(args[0], tys[0]), 0.0)
            x = torch.where(mask, _to_double(args[1], tys[1]), 0.0)
            n = torch.where(mask, 1.0, 0.0).to(torch.float64)
            return (x, y, x * y, x * x, y * y, n)

        def final_map(states):
            sx, sy, sxy, sxx, syy, n = states
            empty = n == 0.0  # an aggregate over no rows is NULL
            n = torch.clamp(n, min=1.0)
            cov = sxy - sx * sy / n
            varx = sxx - sx * sx / n
            vary = syy - sy * sy / n
            slope = cov / torch.where(varx == 0, 1.0, varx)
            if which == "regr_slope":
                out = slope
            elif which == "regr_intercept":
                out = (sy - slope * sx) / n
            else:  # regr_r2
                flat = (varx == 0) | (vary == 0)
                out = torch.where(flat, 0.0, cov * cov / torch.where(flat, 1.0, varx * vary))
            return out, empty

        return AggregateFunction(
            which, DOUBLE, [StateColumn(np.dtype(np.float64), SUM, 0.0) for _ in range(6)],
            input_map, final_map, intermediate_types=[DOUBLE] * 6)
    return resolve


def _learn_resolver(classifier: bool):
    name = "learn_classifier" if classifier else "learn_linear_regressor"

    def resolve(arg_types, distinct, params):
        if distinct:
            raise SemanticError("learn_* DISTINCT is not defined")
        k = len(arg_types) - 1
        if k < 1:
            raise SemanticError("learn_* takes (label, feature1[, feature2 ...])")
        _check_numeric_args(name, arg_types)
        d = k + 1                 # + the intercept feature
        width = d * d + d         # XᵀX flattened, then Xᵀy
        tys = list(arg_types)

        def input_map(args, mask):
            y = torch.where(mask, _to_double(args[0], tys[0]), 0.0)
            if classifier:
                y = torch.where(mask, torch.where(y > 0, 1.0, -1.0), 0.0)
            feats = [torch.where(mask, 1.0, 0.0).to(torch.float64)]  # intercept
            for a, t in zip(args[1:], tys[1:]):
                feats.append(torch.where(mask, _to_double(a, t), 0.0))
            x = torch.stack(feats, dim=-1)                  # (rows, d)
            xtx = x[:, :, None] * x[:, None, :]             # (rows, d, d)
            xty = x * y[:, None]                            # (rows, d)
            return (torch.cat([xtx.reshape(x.shape[0], -1), xty], dim=-1),)

        # the output dictionary exists at plan time (downstream layouts hold
        # this object) and fills with the model JSON at finish
        model_dict = Dictionary([])

        def final_map(states):
            flat = states[0].cpu().numpy().astype(np.float64).reshape(-1, width)
            # xtx[0, 0] sums the intercept column of ones: the group's row
            # count; a group of no rows gets a NULL model
            empty = flat[:, 0] == 0.0
            models = []
            for row in flat:
                xtx = row[:d * d].reshape(d, d)
                xty = row[d * d:]
                coef = np.linalg.solve(xtx + 1e-9 * np.eye(d), xty)  # ridge keeps it solvable
                models.append(json.dumps({
                    "type": "classifier" if classifier else "regressor",
                    "intercept": coef[0], "coefficients": list(coef[1:])}))
            dev = states[0].device
            codes = torch.as_tensor(np.asarray(model_dict.extend(models), dtype=np.int64),
                                    device=dev)
            return codes, (torch.as_tensor(empty, device=dev) if empty.any() else None)

        return AggregateFunction(
            name, VARCHAR, [StateColumn(np.dtype(np.float64), SUM, 0.0, width=width)],
            input_map, final_map, splittable=False, output_dict=model_dict)
    return resolve


def _t_apply_model(name, args):
    if len(args) < 2:
        raise SemanticError(f"{name}(model, feature1[, ...])")
    if not is_string(args[0].type):
        raise SemanticError(f"{name}() first argument must be a model (varchar from learn_*)")
    feats = tuple(cast_to(a, DOUBLE) for a in args[1:])
    return Call(BIGINT if name == "classify" else DOUBLE, name, (args[0],) + feats)


def _c_apply_model(classify: bool):
    def compile_(compiler, expr):
        fmodel, d = compiler._compile(expr.args[0])
        if d is None or not hasattr(d, "values"):
            raise NotImplementedError(
                "model argument needs a materialized dictionary column (the learn_* output)")
        ffeats = [compiler._compile(a)[0] for a in expr.args[1:]]
        k = len(ffeats)
        cache = {}

        def coef_table(device) -> torch.Tensor:
            # read when a page arrives: learn_*'s dictionary fills when its
            # aggregation finishes, before the first page reaches this
            # projection; a longer dictionary makes a new table
            key = (len(d.values), device)
            if key not in cache:
                coefs = np.zeros((max(len(d.values), 1), k + 1))
                for i, v in enumerate(d.values):
                    try:
                        m = json.loads(str(v))
                    except (ValueError, TypeError) as e:
                        raise ValueError(
                            f"{'classify' if classify else 'regress'}(): model column value "
                            f"{str(v)[:40]!r} is not a learn_* model JSON") from e
                    got = list(m.get("coefficients", []))[:k]
                    coefs[i, 0] = float(m.get("intercept", 0.0))
                    coefs[i, 1:1 + len(got)] = got
                cache.clear()
                cache[key] = torch.from_numpy(coefs).to(device)
            return cache[key]

        def fn(datas, nulls):
            code, n = fmodel(datas, nulls)
            t = coef_table(code.device)
            c = t[code.to(torch.int64).clamp(0, t.shape[0] - 1)]   # (rows, k + 1)
            acc = c[:, 0]
            for j, f in enumerate(ffeats):
                v, nv = f(datas, nulls)
                acc = acc + c[:, j + 1] * v.to(torch.float64)
                n = nv if n is None else (n if nv is None else n | nv)
            if classify:
                return (acc > 0).to(torch.int64), n
            return acc, n
        return fn, None
    return compile_


def _regr_output_typer(which):
    def typer(arg_types):
        _check_numeric_args(which, arg_types, expect=2)  # fails at analysis
        return DOUBLE
    return typer


def _learn_output_typer(which):
    def typer(arg_types):
        if len(arg_types) < 2:
            raise SemanticError(f"{which}(label, feature1[, ...])")
        _check_numeric_args(which, arg_types)
        return VARCHAR
    return typer


for _w in ("regr_slope", "regr_intercept", "regr_r2"):
    register_aggregate(_w, _regr_resolver(_w))
    register_aggregate_name(_w, _regr_output_typer(_w))

register_aggregate("learn_linear_regressor", _learn_resolver(False))
register_aggregate("learn_regressor", _learn_resolver(False))
register_aggregate("learn_classifier", _learn_resolver(True))
for _n in ("learn_linear_regressor", "learn_regressor", "learn_classifier"):
    register_aggregate_name(_n, _learn_output_typer(_n))

register_scalar_function("regress", _t_apply_model)
register_scalar_function("classify", _t_apply_model)
register_compiler("regress", _c_apply_model(False))
register_compiler("classify", _c_apply_model(True))
