"""TPC-H Q1 (pricing summary): DELTA days before 1998-12-01."""
from __future__ import annotations

from . import tpch_gen as g
from .common import day


def run(db, p, arith):
    li = db.columns("lineitem", ["l_returnflag", "l_linestatus", "l_quantity",
                                 "l_extendedprice", "l_discount", "l_tax", "l_shipdate"])
    keep = li["l_shipdate"] <= day("1998-12-01") - int(p["DELTA"])
    group = (li["l_returnflag"] * 2 + li["l_linestatus"])[keep]
    qty, price, disc, tax = (li[c][keep] for c in ("l_quantity", "l_extendedprice",
                                                     "l_discount", "l_tax"))
    disc_price = price * (100 - disc)
    charge = disc_price * (100 + tax)
    rows = []
    for code in range(6):
        sel = group == code
        n = int(sel.sum())
        if n == 0:
            continue
        s_qty, s_price, s_disc = (arith.total(v[sel]) for v in (qty, price, disc))
        rows.append([g.DICT_RETURNFLAG.values[code // 2], g.DICT_LINESTATUS.values[code % 2],
                     arith.dec(s_qty, 2), arith.dec(s_price, 2),
                     arith.dec(arith.total(disc_price[sel]), 4),
                     arith.dec(arith.total(charge[sel]), 6),
                     arith.ratio(s_qty, 100 * n), arith.ratio(s_price, 100 * n),
                     arith.ratio(s_disc, 100 * n), n])
    return rows
