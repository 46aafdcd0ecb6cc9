"""TPC-H Q14 (promotion effect): DATE, the first day of a month."""
from __future__ import annotations

import numpy as np

from . import tpch_gen as g
from .common import add_months, day, lookup_table


def run(db, p, arith):
    li = db.columns("lineitem", ["l_partkey", "l_extendedprice", "l_discount", "l_shipdate"])
    keep = (li["l_shipdate"] >= day(p["DATE"])) & (li["l_shipdate"] < add_months(p["DATE"], 1))
    part = db.columns("part", ["p_partkey", "p_type"])
    ppos = lookup_table(part["p_partkey"], int(part["p_partkey"].max()) + 1)[li["l_partkey"][keep]]
    hit = ppos >= 0
    promo_type = np.asarray([t.startswith("PROMO") for t in g.DICT_P_TYPE.values], dtype=bool)
    promo = hit & promo_type[part["p_type"][np.where(hit, ppos, 0)]]
    rev = li["l_extendedprice"][keep] * (100 - li["l_discount"][keep])
    total = arith.total(rev[hit])
    if not hit.any() or total == 0:
        return [[None]]
    return [[arith.ratio(100 * arith.total(rev[promo]), total)]]
