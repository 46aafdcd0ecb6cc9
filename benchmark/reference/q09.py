"""TPC-H Q9 (product type profit): COLOR.

``p_name like '%COLOR%'`` is a substring test on the decoded name, five
words joined by spaces. COLOR holds no space, so it matches exactly where
one of the five words contains it: the test runs on each word of the
vocabulary once and then on the packed word codes.
"""
from __future__ import annotations

import numpy as np

from . import tpch_gen as g
from .common import lookup_table


def run(db, p, arith):
    d = g.DICT_P_NAME
    word_has = np.asarray([p["COLOR"] in w for w in d.words], dtype=bool)
    part = db.columns("part", ["p_partkey", "p_name"])
    fields = d.fields_of(part["p_name"]) % len(d.words)
    green = part["p_partkey"][word_has[fields].any(axis=0)]
    is_green = np.zeros(int(part["p_partkey"].max()) + 1, dtype=bool)
    is_green[green] = True
    li = db.columns("lineitem", ["l_orderkey", "l_partkey", "l_suppkey", "l_quantity",
                                 "l_extendedprice", "l_discount"])
    keep = is_green[li["l_partkey"]]
    li = {k: v[keep] for k, v in li.items()}
    ps = db.columns("partsupp", ["ps_partkey", "ps_suppkey", "ps_supplycost"])
    width = int(ps["ps_suppkey"].max()) + 1
    ps_key = ps["ps_partkey"] * width + ps["ps_suppkey"]
    order = np.argsort(ps_key, kind="stable")
    want = li["l_partkey"] * width + li["l_suppkey"]
    at = np.clip(np.searchsorted(ps_key[order], want), 0, len(order) - 1)
    pshit = ps_key[order][at] == want
    cost = ps["ps_supplycost"][order][at]
    o = db.columns("orders", ["o_orderkey", "o_orderdate"])
    opos = lookup_table(o["o_orderkey"], int(o["o_orderkey"].max()) + 1)[li["l_orderkey"]]
    s = db.columns("supplier", ["s_suppkey", "s_nationkey"])
    spos = lookup_table(s["s_suppkey"], int(s["s_suppkey"].max()) + 1)[li["l_suppkey"]]
    n = db.columns("nation", ["n_nationkey", "n_name"])
    hit = pshit & (opos >= 0) & (spos >= 0)
    nation = n["n_name"][lookup_table(n["n_nationkey"], 25)[s["s_nationkey"][spos[hit]]]]
    years = o["o_orderdate"][opos[hit]].astype("datetime64[D]").astype("datetime64[Y]") \
        .astype(np.int64) + 1970
    amount = li["l_extendedprice"][hit] * (100 - li["l_discount"][hit]) - \
        cost[hit] * li["l_quantity"][hit]
    keys, sums = arith.group_totals(nation * 10_000 + years, amount)
    rows = [[g.DICT_NATION_NAME.values[int(k) // 10_000], int(k) % 10_000, arith.dec(v, 4)]
            for k, v in zip(keys, sums)]
    rows.sort(key=lambda r: (r[0], -r[1]))
    return rows
