"""Intervals on one clock: union, gaps, and the innermost span at a time."""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple


def merge(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def clip(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


def union_length(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` inside [lo, hi]."""
    return sum(b - a for a, b in merge(clip(intervals, lo, hi)))


def gaps(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for a, b in merge(clip(intervals, lo, hi)):
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if at < hi:
        out.append((at, hi))
    return out


def innermost(spans: Sequence[Tuple[float, float, str]], t: float) -> Optional[str]:
    """The label of the shortest span open at ``t``, or None."""
    best = None
    for a, b, label in spans:
        if a <= t < b and (best is None or b - a < best[0]):
            best = (b - a, label)
    return None if best is None else best[1]
