"""Shared arithmetic of the reference queries.

Every query sums through an ``Arith``: ``EXACT`` sums integers (the
generator's cents) exactly and takes ratios as exact fractions before one
rounding to a float, which is what the configuration's guarantees state
(DECIMAL exact, DOUBLE to float64 rounding). ``FLOAT32`` is the control: the
same queries with every sum and ratio taken in float32, the precision below
float64, which a correct comparison must refuse.
"""
from __future__ import annotations

import datetime
from decimal import Decimal
from fractions import Fraction
from typing import Tuple

import numpy as np

_EPOCH = datetime.date(1970, 1, 1)
# rows summed at a time, so int64 partial sums cannot overflow
_SUM_CHUNK = 1 << 22


def day(text: str) -> int:
    """'YYYY-MM-DD' -> days since 1970-01-01."""
    return (datetime.date.fromisoformat(text) - _EPOCH).days


def iso(days: int) -> str:
    return (_EPOCH + datetime.timedelta(days=int(days))).isoformat()


def add_months(text: str, months: int) -> int:
    d = datetime.date.fromisoformat(text)
    m = d.month - 1 + months
    return (datetime.date(d.year + m // 12, m % 12 + 1, d.day) - _EPOCH).days


def lookup_table(keys: np.ndarray, size: int) -> np.ndarray:
    """Position of each key in ``keys`` (-1 where absent), indexed by key."""
    pos = np.full(size, -1, dtype=np.int64)
    pos[keys] = np.arange(len(keys), dtype=np.int64)
    return pos


class Exact:
    name = "exact"

    def total(self, a: np.ndarray):
        """Exact sum of an integer array, as a Python int."""
        a = np.asarray(a, dtype=np.int64)
        return sum(int(a[i:i + _SUM_CHUNK].sum()) for i in range(0, len(a), _SUM_CHUNK))

    def group_totals(self, keys: np.ndarray, values: np.ndarray) -> Tuple[np.ndarray, list]:
        """(sorted unique keys, each key's exact sum of ``values``)."""
        if len(keys) == 0:
            return keys[:0], []
        order = np.argsort(keys, kind="stable")
        k = keys[order]
        starts = np.flatnonzero(np.r_[True, k[1:] != k[:-1]])
        sums = np.add.reduceat(np.asarray(values, dtype=np.int64)[order], starts)
        return k[starts], [int(s) for s in sums]

    def dec(self, total, scale: int) -> Decimal:
        """A DECIMAL of ``scale`` digits from its unscaled total."""
        return Decimal(int(total)).scaleb(-scale)

    def ratio(self, num, den) -> float:
        return float(Fraction(int(num), int(den)))

    def greater(self, a: np.ndarray, num, den) -> np.ndarray:
        """a > num / den, elementwise, for integer ``a``."""
        return np.asarray(a, dtype=np.int64) * int(den) > int(num)


class Float32(Exact):
    name = "float32"

    def total(self, a):
        return float(np.sum(np.asarray(a, dtype=np.float32), dtype=np.float32))

    def group_totals(self, keys, values):
        if len(keys) == 0:
            return keys[:0], []
        order = np.argsort(keys, kind="stable")
        k = keys[order]
        starts = np.flatnonzero(np.r_[True, k[1:] != k[:-1]])
        sums = np.add.reduceat(np.asarray(values, dtype=np.float32)[order], starts)
        return k[starts], [float(s) for s in sums]

    def dec(self, total, scale):
        return Decimal(repr(float(np.float32(total) / np.float32(10 ** scale))))

    def ratio(self, num, den):
        return float(np.float32(num) / np.float32(den))

    def greater(self, a, num, den):
        return np.asarray(a, dtype=np.float32) > np.float32(num) / np.float32(den)


EXACT = Exact()
FLOAT32 = Float32()
ARITH = {"exact": EXACT, "float32": FLOAT32}
