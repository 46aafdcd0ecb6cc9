"""What decides ``correct``: each answer against the plain reference.

An answer is compared value by value with the reference's rows for the same
statement, by the column types of the query's file: DECIMAL, BIGINT,
INTEGER, DATE and VARCHAR exactly (a DECIMAL by its value, whatever its
written scale), DOUBLE by its relative gap. Rows are compared in order;
where the reference's sort key ties, rows may come in either order, so a
group of rows that tie on the key is compared as a multiset.

The numbers compared, each with its limit (``LIMITS``):
- ``failed_queries``: answers that never came or came as an error;
- ``wrong_results``: answers whose row count or any exact value differs;
- ``double_rel_err``: the widest relative gap of a DOUBLE value, in a cell
  whose queries return DOUBLE columns (elsewhere it reads nothing).
"""
from __future__ import annotations

from decimal import Decimal, InvalidOperation
from typing import Iterable, List, Optional, Tuple

# Each limit lies between the lower reading (the largest that sound runs of
# the program gave) and the upper one (the smallest that the float32
# control gave); PERF.md gives the readings.
LIMITS = {"failed_queries": 0, "wrong_results": 0, "double_rel_err": 1e-9}


def _exact(kind: str, got, want) -> bool:
    if want is None or got is None:
        return got is None and want is None
    if kind == "decimal":
        try:
            return Decimal(str(got)) == want
        except InvalidOperation:
            return False
    if kind in ("bigint", "integer"):
        return isinstance(got, int) and not isinstance(got, bool) and got == want
    return isinstance(got, str) and got == want


def _double_gap(got, want) -> Optional[float]:
    """Relative gap of a DOUBLE, or None where the values cannot be compared."""
    if want is None or got is None:
        return 0.0 if got is None and want is None else None
    if not isinstance(got, (int, float)) or isinstance(got, bool):
        return None
    got, want = float(got), float(want)
    if want == 0.0:
        return abs(got)
    return abs(got - want) / abs(want)


def _row_gap(kinds, got, want) -> Tuple[bool, float]:
    """(exact columns equal, widest DOUBLE gap) of one row pair."""
    if not isinstance(got, list) or len(got) != len(want):
        return False, 0.0
    ok, gap = True, 0.0
    for kind, a, b in zip(kinds, got, want):
        if kind == "double":
            g = _double_gap(a, b)
            if g is None:
                ok = False
            else:
                gap = max(gap, g)
        elif not _exact(kind, a, b):
            ok = False
    return ok, gap


def _key(row, order_by) -> tuple:
    return tuple(str(row[i]) for i in order_by)


def _tie_groups(rows, order_by) -> List[Tuple[int, int]]:
    groups, start = [], 0
    for i in range(1, len(rows) + 1):
        if i == len(rows) or _key(rows[i], order_by) != _key(rows[start], order_by):
            groups.append((start, i))
            start = i
    return groups


def _match_group(kinds, got, want) -> Tuple[bool, float]:
    """Multiset match of rows that tie on the sort key: each wanted row takes
    the first unused answer row that equals it."""
    used = [False] * len(got)
    gap = 0.0
    for w in want:
        for i, g in enumerate(got):
            if not used[i]:
                ok, gp = _row_gap(kinds, g, w)
                if ok:
                    used[i] = True
                    gap = max(gap, gp)
                    break
        else:
            return False, gap
    return True, gap


def compare(query: dict, got: List[list], want: List[list]) -> Tuple[bool, float]:
    """(exact values and row count equal, widest DOUBLE relative gap)."""
    kinds = query["columns"]
    if not isinstance(got, list) or len(got) != len(want):
        return False, 0.0
    ok, gap = True, 0.0
    for a, b in zip(got, want):
        r_ok, r_gap = _row_gap(kinds, a, b)
        ok &= r_ok
        gap = max(gap, r_gap)
    if ok or not query.get("order_by"):
        return ok, gap
    ok, gap = True, 0.0
    for lo, hi in _tie_groups(want, query["order_by"]):
        g_ok, g_gap = _match_group(kinds, got[lo:hi], want[lo:hi])
        ok &= g_ok
        gap = max(gap, g_gap)
    return ok, gap


def judge(answers: Iterable[dict], queries: dict, wanted: dict) -> dict:
    """The numbers compared over every answer: ``answers`` are the client's
    records (``rows`` or ``error`` or ``never``), ``wanted`` maps a
    statement's (query, params) to the reference's rows."""
    failed = wrong = compared = 0
    gap = 0.0
    for a in answers:
        if a.get("never") or "error" in a:
            failed += 1
            continue
        ok, g = compare(queries[a["query"]], a["rows"], wanted[(a["query"], a["params"])])
        compared += 1
        wrong += not ok
        gap = max(gap, g)
    readings = {"failed_queries": failed, "wrong_results": wrong, "double_rel_err": gap}
    if not any("double" in q["columns"] for q in queries.values()):
        del readings["double_rel_err"]
    correct = compared > 0 and all(v <= LIMITS[k] for k, v in readings.items())
    return {"correct": correct, "compared": compared, "failed": failed + wrong,
            "checks": {k: {"value": v, "limit": LIMITS[k]} for k, v in readings.items()}}
