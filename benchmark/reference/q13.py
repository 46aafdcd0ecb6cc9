"""TPC-H Q13 (customer distribution): WORD1 and WORD2.

``o_comment not like '%WORD1%WORD2%'`` on the decoded comment, six words
joined by spaces. Neither word holds a space, so the pattern matches where
some word contains WORD1 and a later word contains WORD2, or one word
contains WORD2 after its first WORD1: both tests run on each word of the
vocabulary once and then on the packed word codes.
"""
from __future__ import annotations

import numpy as np

from . import tpch_gen as g


def _after(word: str, w1: str, w2: str) -> bool:
    at = word.find(w1)
    return at >= 0 and word.find(w2, at + len(w1)) >= 0


def run(db, p, arith):
    d = g.DICT_COMMENT
    w1, w2 = p["WORD1"], p["WORD2"]
    has1 = np.asarray([w1 in w for w in d.words], dtype=bool)
    has2 = np.asarray([w2 in w for w in d.words], dtype=bool)
    both = np.asarray([_after(w, w1, w2) for w in d.words], dtype=bool)
    c = db.column("customer", "c_custkey")
    o = db.columns("orders", ["o_custkey", "o_comment"])
    fields = d.fields_of(o["o_comment"]) % len(d.words)
    seen1 = np.zeros(len(o["o_custkey"]), dtype=bool)
    match = np.zeros(len(o["o_custkey"]), dtype=bool)
    for f in range(d.n_fields):
        match |= both[fields[f]] | (seen1 & has2[fields[f]])
        seen1 |= has1[fields[f]]
    per_customer = np.bincount(o["o_custkey"][~match], minlength=int(c.max()) + 1)[c]
    counts, dist = np.unique(per_customer, return_counts=True)
    rows = [[int(k), int(n)] for k, n in zip(counts, dist)]
    rows.sort(key=lambda r: (-r[1], -r[0]))
    return rows
