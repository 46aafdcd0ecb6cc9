"""TPC-H Q3 (shipping priority): SEGMENT and DATE."""
from __future__ import annotations

import numpy as np

from . import tpch_gen as g
from .common import day, iso, lookup_table


def run(db, p, arith):
    cut = day(p["DATE"])
    c = db.columns("customer", ["c_custkey", "c_mktsegment"])
    in_segment = np.zeros(int(c["c_custkey"].max()) + 1, dtype=bool)
    in_segment[c["c_custkey"][c["c_mktsegment"] == g.DICT_SEGMENT.code_of(p["SEGMENT"])]] = True
    o = db.columns("orders", ["o_orderkey", "o_custkey", "o_orderdate", "o_shippriority"])
    keep = (o["o_orderdate"] < cut) & in_segment[o["o_custkey"]]
    okey = o["o_orderkey"][keep]
    li = db.columns("lineitem", ["l_orderkey", "l_shipdate", "l_extendedprice", "l_discount"])
    posmap = lookup_table(okey, int(o["o_orderkey"].max()) + 1)
    pos = posmap[li["l_orderkey"]]
    hit = (li["l_shipdate"] > cut) & (pos >= 0)
    rev = li["l_extendedprice"][hit] * (100 - li["l_discount"][hit])
    keys, sums = arith.group_totals(li["l_orderkey"][hit], rev)
    opos = posmap[keys]
    odate = o["o_orderdate"][keep][opos]
    oprio = o["o_shippriority"][keep][opos]
    top = np.lexsort((keys, odate, -np.asarray(sums)))[:10]
    return [[int(keys[i]), arith.dec(sums[i], 4), iso(odate[i]), int(oprio[i])] for i in top]
