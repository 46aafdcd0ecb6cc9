"""Structured JSON codec for the cluster control plane.

The port's copy of ``presto_tpu/cluster/codec.py``: the same wire forms and
the same allow-list, naming the port's own ``types``, ``ops/expressions``,
``spi/connector``, ``sql/planner/plan`` and fragmenter classes. A class is
identified by ``__name__`` alone, so the two packages' frames of one plan
are the same JSON.

Replaces pickle on every coordinator<->worker HTTP body. The reference
deliberately uses JSON/SMILE codecs on this boundary
(server/InternalCommunicationConfig.java:92-98, jackson codecs for
TaskUpdateRequest/TaskInfo/PlanFragment); pickle here was
remote-code-execution-by-design for anything that can reach a worker port.

Design: every wire object is a frozen/plain dataclass (plan nodes,
expressions, types, handles, session, task DTOs). One reflective codec walks
dataclass fields; decoding instantiates ONLY classes in the explicit
ALLOWED registry — an unknown tag is an error, never an import or a call.

Wire forms:
  dataclass      -> {"$c": "ClassName", "f": {field: value, ...}}
  tuple          -> {"$t": [items]}           (tuple/list distinction matters:
                                               plan dataclasses hash tuples)
  dict           -> {"$d": [[k, v], ...]}     (keys may be ints)
  Decimal        -> {"$dec": "1.23"}
  datetime.date  -> {"$date": "1995-06-17"}
  bytes          -> {"$b": base64}
  numpy scalar   -> plain int/float
  int/float/str/bool/None/list pass through natively.
"""
from __future__ import annotations

import base64
import dataclasses
import datetime
import decimal
import json
from typing import Any, Dict, List

import numpy as np


def _allowed_classes() -> Dict[str, type]:
    from .. import types as t
    from ..metadata import Session
    from ..ops import expressions as e
    from ..spi.connector import (ColumnHandle, SchemaTableName, TableHandle)
    from ..sql.planner import plan as p
    from ..sql.planner.fragmenter import Fragment, SubPlan

    classes: List[type] = [
        # task DTOs (registered lazily to dodge the circular import with task.py)
        # types
        t.BigintType, t.IntegerType, t.SmallintType, t.DoubleType, t.RealType,
        t.BooleanType, t.DateType, t.TimestampType, t.DecimalType,
        t.VarcharType, t.CharType, t.UnknownType,
        # expressions
        e.InputRef, e.Constant, e.SymbolRef, e.Call, e.SpecialForm,
        # handles / session
        ColumnHandle, SchemaTableName, TableHandle, Session,
        # plan
        p.Symbol, p.AggregationCall, p.Ordering, p.WindowCall,
        p.TableScanNode, p.FilterNode, p.ProjectNode, p.AggregationNode,
        p.JoinNode, p.SemiJoinNode, p.SortNode, p.WindowNode, p.TopNNode,
        p.LimitNode, p.ValuesNode, p.ExchangeNode, p.RemoteSourceNode,
        p.OutputNode, p.EnforceSingleRowNode, p.UnionNode,
        Fragment, SubPlan,
    ]
    extra = [c for c in (getattr(p, n, None)
                         for n in ("DistinctLimitNode", "MarkDistinctNode",
                                   "AssignUniqueIdNode", "GroupIdNode",
                                   "UnnestNode", "SampleNode",
                                   "TableWriterNode", "TableFinishNode",
                                   "DeleteNode", "ExplainAnalyzeNode",
                                   "RowNumberNode", "TopNRowNumberNode"))
             if c is not None]
    return {c.__name__: c for c in classes + extra}


_REGISTRY: Dict[str, type] = {}
_BOOTSTRAPPED = False


def register(cls: type) -> type:
    """Add a dataclass to the wire allow-list (used by task.py's DTOs)."""
    _REGISTRY[cls.__name__] = cls  # prestocheck: ignore[unbounded-cache] - one entry per DTO class, fixed at import
    return cls


def _registry() -> Dict[str, type]:
    global _BOOTSTRAPPED
    if not _BOOTSTRAPPED:
        _REGISTRY.update(_allowed_classes())
        _BOOTSTRAPPED = True
    return _REGISTRY


def encode(obj: Any) -> Any:
    """Python object -> JSON-compatible structure."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, np.bool_):
        return bool(obj)
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, decimal.Decimal):
        return {"$dec": str(obj)}
    if isinstance(obj, datetime.date):
        return {"$date": obj.isoformat()}
    if isinstance(obj, bytes):
        return {"$b": base64.b64encode(obj).decode("ascii")}
    if isinstance(obj, tuple):
        return {"$t": [encode(v) for v in obj]}
    if isinstance(obj, list):
        return [encode(v) for v in obj]
    if isinstance(obj, dict):
        return {"$d": [[encode(k), encode(v)] for k, v in obj.items()]}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        name = type(obj).__name__
        if name not in _registry():
            raise TypeError(f"{name} is not wire-registered")
        fields = {f.name: encode(getattr(obj, f.name))
                  for f in dataclasses.fields(obj)}
        return {"$c": name, "f": fields}
    raise TypeError(f"cannot encode {type(obj).__name__} on the control plane")


def decode(obj: Any) -> Any:
    """JSON structure -> Python object (allow-listed classes only)."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, list):
        return [decode(v) for v in obj]
    if isinstance(obj, dict):
        if "$c" in obj:
            cls = _registry().get(obj["$c"])
            if cls is None:
                raise ValueError(f"unknown wire class {obj['$c']!r}")
            fields = {k: decode(v) for k, v in obj.get("f", {}).items()}
            return cls(**fields)
        if "$t" in obj:
            return tuple(decode(v) for v in obj["$t"])
        if "$d" in obj:
            return {decode(k): decode(v) for k, v in obj["$d"]}
        if "$dec" in obj:
            return decimal.Decimal(obj["$dec"])
        if "$date" in obj:
            return datetime.date.fromisoformat(obj["$date"])
        if "$b" in obj:
            return base64.b64decode(obj["$b"])
        raise ValueError(f"unrecognized wire object keys: {list(obj)[:4]}")
    raise ValueError(f"cannot decode {type(obj).__name__}")


def dumps(obj: Any) -> bytes:
    return json.dumps(encode(obj), separators=(",", ":")).encode("utf-8")


def loads(data: bytes) -> Any:
    return decode(json.loads(data.decode("utf-8")))
